"""Hand-written CUDA kernels for Hopper and their wrappers. Each wrapper runs
its kernel's plain PyTorch version on CPU tensors, launches the kernel on
CUDA tensors (or raises), and counts its launches."""

from .chunked_resample import (  # noqa: F401
    box_resample_pallas_cuda,
    box_resample_pallas_windows_cuda,
    gather_windows,
)
from .fused_demod_resample import (  # noqa: F401
    fused_demod_resample_cuda,
    fused_demod_resample_u16_cuda,
)
from .post_process import post_process_cuda  # noqa: F401
from .strided_resample import box_resample_range_strided_cuda, box_resample_strided_cuda  # noqa: F401

# the resamplers' wrappers, for launch accounting a block at a time (the
# post-process kernels' wrapper, post_process_cuda, runs on every path and
# counts on its own)
WRAPPERS = (
    box_resample_strided_cuda,
    box_resample_range_strided_cuda,
    fused_demod_resample_cuda,
    fused_demod_resample_u16_cuda,
    box_resample_pallas_cuda,
    box_resample_pallas_windows_cuda,
    gather_windows,
)

# the CUDA sources under csrc/, one library each (graph_cond: the step's
# branch nodes, kernels/graph_cond.py)
SOURCES = ("strided_resample", "fused_demod_resample", "chunked_resample", "graph_cond",
           "post_process")


def reset_launch_counts() -> None:
    for fn in (*WRAPPERS, post_process_cuda):
        fn.launches = 0
