"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. "cuda" (the default) raises when no
    CUDA device is present: the port never carries on silently on the CPU.
    The CPU runs only when the caller asks for it (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tempestsdr_tpu_torch: no CUDA device; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev
