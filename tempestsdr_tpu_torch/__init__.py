"""PyTorch/CUDA port of tempestsdr_tpu for NVIDIA H100 cards: the whole
receiver, from the front door down to the kernels.

  - api.TSDR and `python -m tempestsdr_tpu_torch.cli`: the reference C API
    surface and the command line (auto-resolution, manual lag selection,
    snapshots, plots, preferences; --tui, the terminal viewer in tui.py);
  - stream.Session: the streaming loop with batching, live params,
    framerate nudge, async start/stop, autocorrelation dump, warm start and
    superresolution (superband.py); stream.make_step: the per-block step;
    stream.MultiSession and the channel steps: several targets on one card;
  - parallel/: the receiver sharded over torch.distributed ranks (channels,
    a wideband block's time shards, or both);
  - kernels/ and csrc/: the box resamplers as hand-written CUDA kernels for
    Hopper (strided, with a range entry for one time shard; fused decode +
    demod + resample; chunked; windows and their gather), each beside its
    plain PyTorch version;
  - ops/, estimate/, sources/, native/, snapshot, prefs, utils.profiling.

Entry points take an explicit `device` (default "cuda"); without a CUDA
device they raise unless the caller asks for "cpu", where every kernel
wrapper runs its plain PyTorch version.
"""

import torch

# float32 matmuls and convolutions in full float32 everywhere in the port:
# TF32 keeps ~3 decimal digits, and the parity contract with the JAX package
# (pixels within 1e-6, exact sync positions) has no room for that. Set once,
# here, on import of the package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .errors import TSDRStatus, TSDRError  # noqa: E402,F401
from .params import Params, PARAM  # noqa: E402,F401
from .config import PipelineConfig  # noqa: E402,F401
from .device import resolve_device  # noqa: E402,F401
from .stream.session import Session, SessionCallbacks  # noqa: E402,F401
from .api import TSDR  # noqa: E402,F401

__version__ = "0.1.0"
