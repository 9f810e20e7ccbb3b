"""Signal sources (numpy, sockets, subprocesses and ctypes only), copied from
the JAX package so the port imports nothing of it: the Source protocol,
recorded-file replay, the synthetic emanation generator, the simulated live
source (simlive), rtl_tcp, an external process (exec) and the reference's
binary C plugin ABI (cplugin). The ring-backed sources run over the native
IO runtime in ..native. The tee that records what a live source delivered,
and its playback, are test and measurement fixtures in .tee, not exported
here."""

from .base import Source, SourceBlock, load_source  # noqa: F401
from .rawfile import RawFileSource  # noqa: F401
from .synthetic import SyntheticSource, render_test_pattern, synth_iq  # noqa: F401
from .live import SimulatedLiveSource  # noqa: F401
from .rtltcp import RtlTcpSource  # noqa: F401
from .subproc import ExternalProcessSource  # noqa: F401
from .cplugin import CPluginSource  # noqa: F401
