"""Signal sources (numpy only): the Source protocol, recorded-file replay
and the synthetic emanation generator, copied from the JAX package so the
port imports nothing of it."""

from .base import Source, SourceBlock, load_source  # noqa: F401
from .rawfile import RawFileSource  # noqa: F401
from .synthetic import SyntheticSource, render_test_pattern, synth_iq  # noqa: F401
