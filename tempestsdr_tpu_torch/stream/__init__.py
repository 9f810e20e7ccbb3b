"""Block-streaming runtime: the per-block step and the host Session."""

from .state import StreamState, StepOutputs, init_state  # noqa: F401
from .pipeline import StepControls, make_step  # noqa: F401
from .session import Session, SessionCallbacks  # noqa: F401
