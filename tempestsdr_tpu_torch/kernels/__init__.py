"""Hand-written CUDA kernels for Hopper and their wrappers. Each wrapper runs
its kernel's plain PyTorch version on CPU tensors, launches the kernel on
CUDA tensors (or raises), and counts its launches."""

from .strided_resample import box_resample_strided_cuda  # noqa: F401

# every kernel wrapper of the port, for launch accounting
WRAPPERS = (box_resample_strided_cuda,)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
