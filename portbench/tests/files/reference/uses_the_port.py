"""A reference that imports the program under test, which no reference may."""

from tempestsdr_tpu_torch.config import PipelineConfig  # noqa: F401
from .step import ARRAYS, INTEGERS, LEAVES, Reference  # noqa: F401
