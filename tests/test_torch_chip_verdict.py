"""``chip_smoke.py``'s verdict on a kernel-vs-plain case, on the CPU.

``judge_case`` is held on planted columns: a case within its tolerances
passes; a row outside them fails its columns, each named (two failing
columns in a row, so the report goes on past the first); a row that
``branch_walk`` allows passes, but no more than MAX_WIDENED such rows,
and its is_stable stays gated.  ``fold_ulps`` and ``switch_ulps``
measure a branch input's distance to its threshold in float32 ulps.
No card is needed: these are the script's numpy and PyTorch helpers.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

ROWS = 40
STATE = ("analysis.pos", "analysis.vel", "analysis.eps", "analysis.pi",
         "megno.pos", "megno.vel", "megno.eps", "megno.pi")


def _columns(seed=0):
    """Plain and kernel columns a few float32 roundings apart, and the
    plain version's other runs as far apart again."""
    rng = np.random.default_rng(seed)
    rp = {c: rng.uniform(0.5, 2.0, ROWS) for c in cs.TOL}
    rp.update({c: rng.uniform(0.5, 2.0, (ROWS, 8, 2)) if c.endswith(
        ("pos", "vel")) else rng.uniform(0.5, 2.0, ROWS) for c in STATE})
    # is_stable from the verdict's inputs, far from their thresholds
    for c in cs.VERDICT:
        rp[c] = np.where(np.arange(ROWS) % 2 == 0, 1e-4, 1e3) \
            if c != "com_drift_mean" else np.full(ROWS, 1e-3)
    rp["is_stable"] = (np.arange(ROWS) % 2 == 0).astype(np.float64)
    rk = {c: v * (1.0 + 1e-7) for c, v in rp.items()}
    rk["is_stable"] = rp["is_stable"].copy()
    others = {r: {c: v * (1.0 - 1e-7) for c, v in rp.items()}
              for r in ("plain float64", "plain reversed", "plain rolled")}
    return rp, rk, others


def _plant(rk, row, cols=("analysis.pi", "megno.vel")):
    for c in cols:
        rk[c][row] = rk[c][row] + 1.0


def _judge(rp, rk, others, allowed):
    return cs.judge_case(rp, rk, others, {}, allowed)


@pytest.mark.parametrize("case", ["clean", "outside", "allowed",
                                  "allowed_flip", "too_many_allowed"])
def test_judge_case(case):
    rp, rk, others = _columns()
    allowed = np.zeros(ROWS, bool)
    if case == "clean":
        lines, failures, outside = _judge(rp, rk, others, allowed)
        assert failures == [] and not outside.any()
        return
    rows = [3] if case != "too_many_allowed" else list(
        range(cs.MAX_WIDENED + 1))
    for r in rows:
        _plant(rk, r)
    if case == "outside":
        lines, failures, outside = _judge(rp, rk, others, allowed)
        assert failures == ["analysis.pi", "megno.vel"]
        assert np.nonzero(outside)[0].tolist() == [3]
        assert any("row 3" in line for line in lines)
        return
    allowed[rows] = True
    if case == "allowed_flip":
        rk["is_stable"][3] = 1.0 - rk["is_stable"][3]
    lines, failures, outside = _judge(rp, rk, others, allowed)
    assert np.nonzero(outside)[0].tolist() == rows
    want = {"allowed": [], "allowed_flip": ["is_stable"],
            "too_many_allowed": [f"{len(rows)} rows allowed at a branch"]}
    assert failures == want[case]
    assert f"{len(rows)} rows allowed at a branch" in lines[-2]


def test_branch_distances_in_float32_ulps():
    class Walls:
        flo = torch.tensor([1.0, 1.0, 1.0, 1.0], dtype=torch.float64)
        cap = torch.tensor([2.0, 2.0, 2.0, 2.0], dtype=torch.float64)

    ulp = cs.F32_ULP
    # 4 ulps above the cap, 3 below the floor's next period, on the
    # floor itself (a fold's own output), and well inside
    e = torch.tensor([2.0 * (1 + 4 * ulp), 3.0 * (1 - 3 * ulp), 1.0, 1.5],
                     dtype=torch.float64)
    got = cs.fold_ulps(Walls, e).numpy()
    assert np.allclose(got[:2], [4.0, 3.0], rtol=1e-6)
    assert got[2] == np.inf and got[3] > 1e5
    thr = torch.tensor([1e-9, 1e-9, 0.0], dtype=torch.float64)
    gmax = torch.tensor([1e-9 * (1 + 2 * ulp), 1e-6, 1e-12 * (1 - ulp)],
                        dtype=torch.float64)
    got = cs.switch_ulps(gmax, thr).numpy()
    assert np.allclose(got, [2.0, got[1], 1.0], rtol=1e-6) and got[1] > 1e5
