"""step.py's reference, noting the geometry of each one made."""

from .step import ARRAYS, INTEGERS, LEAVES  # noqa: F401
from .step import Reference as StepReference

MADE = []


class Reference(StepReference):
    def __init__(self, geometry, *args, **kwargs):
        super().__init__(geometry, *args, **kwargs)
        MADE.append(geometry.key)
