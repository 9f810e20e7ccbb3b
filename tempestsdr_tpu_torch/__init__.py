"""PyTorch/CUDA port of tempestsdr_tpu: the single-channel streaming step and
Session, with the m == 2 strided box resampler as a hand-written CUDA kernel
for Hopper (kernels/strided_resample.py, csrc/strided_resample.cu).

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

from .config import PipelineConfig  # noqa: E402,F401
from .params import Params  # noqa: E402,F401
from .device import resolve_device  # noqa: E402,F401
