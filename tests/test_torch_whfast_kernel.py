"""PyTorch port vs the JAX package: the fused WHFast kernel's plain
version (``ops/whfast_kernels.py``) on the CPU.

Inputs: the planetary systems of ``tests/test_pallas_whfast.py`` (a unit
central mass and 1e-3 planets near radii 1 and 2; N = 3, d = 2; numpy-
seeded perturbations; eps^2 = 1e-6).

* The plain ``whfast_multistep`` against the JAX Pallas kernel in
  interpret mode at B = 16, lanes = 2: 40 steps in float32 within rtol
  1e-5 / atol 1e-7 (the tolerance of the JAX package's own
  ``test_matches_xla_scan``; the two packages' float32 cos, sin, exp and
  rsqrt round differently), 10 steps in float64 to round-off (rtol
  1e-10 / atol 1e-12: both then run the kernel's float32-rounded
  constants in float64).
* One fused step against one scan substep of the port on the LC-8
  solver (rtol 1e-6 / atol 1e-8, as ``test_single_step_matches_substep``:
  the kernel's reciprocal masses and exp-based cosh/sinh round apart).
* A zero-mass padded slot stays inert to 1e-12.
* On CPU tensors the wrapper runs the plain version (no launch); it
  refuses d other than 2 and 3 (d = 3: ``tests/test_torch_d3_variants.py``),
  n_steps < 1 and N > 8.
"""

import numpy as np
import pytest
import torch

from nbodysimproject_tpu_torch.integrators import whfast as tw
from nbodysimproject_tpu_torch.ops import whfast_kernels as wk
from test_torch_whfast import _build, _close, _planets


def _kernel_args(dtype, B=16):
    m, q, v, _ = _planets(B)
    e2 = np.full(B, 1e-6)
    return [np.asarray(a, dtype) for a in (q, v, m, e2)]


@pytest.mark.parametrize("dtype,n_steps,rtol,atol", [
    (np.float32, 40, 1e-5, 1e-7), (np.float64, 10, 1e-10, 1e-12)])
def test_plain_multistep_matches_pallas_interpret(dtype, n_steps, rtol,
                                                  atol):
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_whfast import whfast_multistep

    args = _kernel_args(dtype)
    po, vo = whfast_multistep(*(jnp.asarray(a) for a in args), h=0.01,
                              G=1.0, n_steps=n_steps, lanes=2,
                              interpret=True)
    before = wk.whfast_multistep.launches
    tp, tv = wk.whfast_multistep(*(torch.as_tensor(a) for a in args),
                                 h=0.01, G=1.0, n_steps=n_steps)
    assert wk.whfast_multistep.launches == before  # CPU: plain version
    assert tp.dtype == torch.from_numpy(args[0]).dtype
    _close(po, tp, rtol=rtol, atol=atol, msg="pos")
    _close(vo, tv, rtol=rtol, atol=atol, msg="vel")


def test_one_fused_step_matches_one_scan_substep():
    (_cj, _sj, _dj), (ct, st, dt) = _build(8, B=8)
    ref = tw.whfast_substep(st, dt, ct, torch.full((8,), 0.01,
                                                   dtype=torch.float64))
    po, vo = wk.whfast_multistep_plain(st.pos, st.vel, st.mass, st.step_s2,
                                       h=0.01, G=1.0, n_steps=1, iters=8)
    _close(ref.pos, po, rtol=1e-6, atol=1e-8, msg="pos")
    _close(ref.vel, vo, rtol=1e-6, atol=1e-8, msg="vel")


def test_masked_slots_stay_inert():
    """A zero-mass padded slot neither moves nor perturbs the live bodies
    (the JAX package's test_masked_slots_stay_inert, on the plain
    version)."""
    q, v, m, e2 = (torch.as_tensor(a) for a in _kernel_args(np.float64,
                                                             B=8))
    pad = lambda x: torch.cat([x, torch.zeros_like(x[:, :1])], 1)
    kw = dict(h=0.01, G=1.0, n_steps=20)
    p3, v3 = wk.whfast_multistep_plain(q, v, m, e2, **kw)
    p4, v4 = wk.whfast_multistep_plain(pad(q), pad(v), pad(m), e2, **kw)
    torch.testing.assert_close(p4[:, :3], p3, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(v4[:, :3], v3, rtol=1e-12, atol=1e-12)
    assert torch.isfinite(p4).all() and torch.isfinite(v4).all()


def test_kernel_wrapper_refuses_what_it_was_not_built_for():
    q, v, m, e2 = (torch.as_tensor(a) for a in _kernel_args(np.float32,
                                                             B=4))
    with pytest.raises(NotImplementedError, match="d = 4"):
        wk.whfast_multistep(torch.cat([q, q], -1), torch.cat([v, v], -1),
                            m, e2, h=0.01, G=1.0, n_steps=1)
    with pytest.raises(ValueError, match="n_steps"):
        wk.whfast_multistep(q, v, m, e2, h=0.01, G=1.0, n_steps=0)
    with pytest.raises(NotImplementedError, match="N <= 8"):
        wk._library(9, 2)
