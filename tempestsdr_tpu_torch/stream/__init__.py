"""Block-streaming runtime: the per-block step, the channel steps, the host
Session and MultiSession."""

from .state import StreamState, StepOutputs, init_state  # noqa: F401
from .pipeline import (  # noqa: F401
    StepControls,
    make_step,
    make_multi_step,
    make_channels_step,
    make_channels_step_unrolled,
)
from .session import Session, SessionCallbacks  # noqa: F401
from .multisession import MultiSession  # noqa: F401
