"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller passes
``device="cpu"``.  With no card and no explicit CPU request it raises:
a run that was meant for the GPU never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); any
    other value is taken as given, and a CUDA request without a card
    raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nbodysimproject_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def dtype_of(cfg) -> torch.dtype:
    """float32 on the fast path, float64 otherwise (the JAX package's
    ``cfg.fast_float32`` switch)."""
    return torch.float32 if cfg.fast_float32 else torch.float64
