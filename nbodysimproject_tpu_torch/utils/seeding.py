"""Global seeding.

Counterpart of ``nbodysimproject_tpu/utils/seeding.py`` (parity:
``minbody/utils.py:17``): seeds ``random``, numpy and torch, the CUDA
generators included.  The port's drawing functions take explicit
``torch.Generator`` objects; with ``generator=None`` they draw from
torch's default generator of their device, which this seeds.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_global_seed(seed: int = 42) -> None:
    """Seed ``random``, numpy, torch on the CPU and every CUDA device,
    and make cuDNN deterministic (minbody/utils.py:17-28)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
