"""step.py's reference with every frame 0.01 brighter: a receiver checked
against it reads a frame_err of 0.01."""

from .step import ARRAYS, INTEGERS, LEAVES  # noqa: F401
from .step import Reference as StepReference


class Reference(StepReference):
    def step(self, st, raw, raw_format, dropped=0):
        st, frames, plots = super().step(st, raw, raw_format, dropped)
        return st, [f + 0.01 for f in frames], plots
