"""Stability-classifier architecture.

Counterpart of ``nbodysimproject_tpu/ml/model_zoo.py`` (parity:
``minbody/model_zoo.py:18-37``): input -> 128 -> 64 -> 1, ReLU, dropout
0.25, logits out, with the reference checkpoint's parameter names
(``fc1``, ``dropout1``, ``fc2``, ``dropout2``, ``fc3``; the JAX
package's ``make_torch_mlp``).  The JAX package computes these products
in flax ``Dense`` layers (XLA), outside any Pallas kernel, so
``nn.Linear`` is their counterpart here.  Dropout is flax's: in
training mode it draws from the ``torch.Generator`` passed to
``forward`` (never from torch's global generator unless given none) and
divides what it keeps by the keep probability; in eval mode (the
default after ``.eval()``, and how the predictor serves) it is the
identity.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.device import resolve_device


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training mode each unit is kept where a
    uniform draw is below 1 - rate (``jax.random.bernoulli``) and the
    kept ones are divided by 1 - rate; rate 0, and eval mode, are the
    identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class MLP(nn.Module):
    """128-64-1 ReLU classifier with dropout 0.25 (model_zoo.py:18-33).
    ``forward(x, generator)``: ``generator`` feeds both dropout layers in
    training mode."""

    def __init__(self, input_dim: int, hidden1: int = 128,
                 hidden2: int = 64, dropout_rate: float = 0.25):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, hidden1)
        self.dropout1 = Dropout(dropout_rate)
        self.fc2 = nn.Linear(hidden1, hidden2)
        self.dropout2 = Dropout(dropout_rate)
        self.fc3 = nn.Linear(hidden2, 1)

    def forward(self, x, generator=None):
        x = self.dropout1(torch.relu(self.fc1(x)), generator)
        x = self.dropout2(torch.relu(self.fc2(x)), generator)
        return self.fc3(x)


def make_mlp(input_dim: int, seed: int = 0, device=None) -> MLP:
    """An MLP initialised from an explicit ``torch.Generator`` seeded
    with ``seed``, as flax ``Dense`` initialises (the JAX package's
    ``make_mlp``): LeCun-normal weights (a normal of variance 1 / fan_in
    truncated at two standard deviations) and zero biases.  The weights
    are drawn on the CPU and so do not depend on ``device`` (``None``:
    the card)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    model = MLP(input_dim)
    with torch.no_grad():
        for layer in (model.fc1, model.fc2, model.fc3):
            # flax's lecun_normal: variance_scaling(1, "fan_in",
            # "truncated_normal"), whose std is corrected for the cut
            std = math.sqrt(1.0 / layer.in_features) / .87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std,
                                  b=2.0 * std, generator=gen)
            nn.init.zeros_(layer.bias)
    return model.to(resolve_device(device))


def make_torch_mlp(input_dim: int) -> MLP:
    """The reference architecture (the JAX package's name for its torch
    twin); here the port's ``MLP`` itself."""
    return MLP(input_dim)
