"""The training half of the port's ``ml/`` against the JAX package's, on
the CPU.

* ``DataUtils.split_and_scale`` and the scaler's fit: the JAX package's
  rows and statistics bit for bit (it splits and scales with sklearn;
  the port needs none);
* ``bce_with_logits`` against optax's within 1e-7; flax-style dropout
  (rate, 1 / keep scaling, the same mask for the same generator seed,
  the identity in eval mode);
* ``MLPTrainer.train`` with dropout off, from the JAX trainer's own
  initial parameters carried across (``mlp_state_dict_from_flax``) and
  the same numpy permutations: parameters and per-epoch validation
  losses within float32 round-off (``TRAIN_TOL``), and the same
  early-stopping epoch on a split whose validation loss turns;
* ``_binary_metrics``, ``_auroc_np`` and the Youden threshold bit for
  bit on the same scores;
* ``train_gbdt`` on 2000 rows of ``data/stability_131k.csv.gz`` (fast
  grid, cv = 2): the same metrics and probabilities;
* the trained artifacts served by the port's ``StabilityPredictor`` and
  reloaded by ``load_model``, with numpy alone.

The JAX trainer's per-epoch validation losses are read by wrapping its
jitted epoch (``jax.jit`` patched for the test's duration only).
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from nbodysimproject_tpu.ml import data_utils as jdu
from nbodysimproject_tpu.ml import train_mlp as jtm
from nbodysimproject_tpu.ml.model_zoo import MLP as JaxMLP
from nbodysimproject_tpu.ml.train_lightgbm import train_gbdt as jax_train_gbdt
from nbodysimproject_tpu_torch.ml import data_utils as tdu
from nbodysimproject_tpu_torch.ml import train_mlp as ttm
from nbodysimproject_tpu_torch.ml.artifacts import (load_artifacts,
                                                    mlp_state_dict_from_flax)
from nbodysimproject_tpu_torch.ml.dataset import StabilityDataset
from nbodysimproject_tpu_torch.ml.gbdt import TreeEnsemble
from nbodysimproject_tpu_torch.ml.model_zoo import MLP, Dropout
from nbodysimproject_tpu_torch.ml.predict import StabilityPredictor
from nbodysimproject_tpu_torch.ml.train_lightgbm import train_gbdt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = os.path.join(REPO, "data", "stability_131k.csv.gz")
#: parameters and validation losses after a few Adam steps in float32:
#: XLA and torch round the same formulas differently (measured 6e-8 to
#: 9e-8 in the parameters, 3e-8 to 1.2e-7 in the losses)
TRAIN_TOL = dict(rtol=0.0, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The trainers' steps are tiny: beside the suite's other workers,
    torch's intra-op threads would only wait on each other (a 30-epoch
    run took 0.3 s alone and 22.7 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _separable(n, f, noise, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] + noise * rng.normal(size=n)) > 0
         ).astype(np.float32)
    k = int(0.7 * n)
    return X[:k], y[:k], X[k:], y[k:]


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("n,f,pos", [(1000, 7, 0.3), (513, 3, 0.5),
                                     (20000, 40, 0.05), (40, 4, 0.04)])
def test_split_and_scale_bitwise(n, f, pos):
    """The JAX package's split (sklearn, stratified or, with a class too
    small, not) and scaler bit for bit; (40, 0.04) degrades to
    unstratified."""
    rng = np.random.default_rng(n)
    X = (rng.normal(size=(n, f)) * rng.uniform(0.1, 1e4, f)
         + rng.uniform(-1e5, 1e5, f))
    X[:, 0] = 3.0  # a constant column: scale 1
    y = (rng.uniform(size=n) < pos).astype(np.float64)
    ref = jdu.DataUtils.split_and_scale(X, y, 0.15, 0.15, 42)
    got = tdu.DataUtils.split_and_scale(X, y, 0.15, 0.15, 42)
    for a, b in zip(ref[:6], got[:6]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(ref[6].mean_, got[6].mean_)
    assert np.array_equal(ref[6].scale_, got[6].scale_)
    tr, va, te = tdu.DataUtils.split_indices(y, 0.15, 0.15, 42)
    assert np.array_equal(ref[6].transform(X[te]), ref[2])
    assert np.array_equal(y[tr], ref[3]) and np.array_equal(y[te], ref[5])
    assert sorted(np.concatenate([tr, va, te]).tolist()) == list(range(n))


@pytest.mark.parametrize("stratified", [False, True])
def test_train_test_split_is_sklearns(stratified):
    """The port's sklearn-free split draws sklearn's rows: random sizes,
    fractions, seeds and class counts (``_approximate_mode``'s random
    tie breaks among them)."""
    from sklearn.model_selection import train_test_split

    rng = np.random.default_rng(int(stratified))
    n_cases = 0
    while n_cases < 60:
        n = int(rng.integers(10, 3000))
        y = rng.integers(0, int(rng.integers(2, 5)), n).astype(np.float64)
        frac = float(rng.choice([0.15, 0.15 / 0.85, 0.2, 0.25, 0.5]))
        seed = int(rng.integers(0, 100))
        strat = y if stratified else None
        try:
            ref = train_test_split(np.arange(n), test_size=frac,
                                   random_state=seed, stratify=strat)
        except ValueError:
            continue
        got = tdu._train_test_split(n, frac, seed, strat)
        assert all(np.array_equal(a, b) for a, b in zip(ref, got))
        n_cases += 1


def test_scaler_fit_is_sklearns_with_nans():
    from sklearn.preprocessing import StandardScaler as SkScaler

    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 5)) * 1e3 + 7.0
    X[rng.uniform(size=X.shape) < 0.1] = np.nan
    sk, port = SkScaler().fit(X), tdu.StandardScaler().fit(X)
    assert np.array_equal(sk.mean_, port.mean_)
    assert np.array_equal(sk.scale_, port.scale_)
    np.testing.assert_array_equal(sk.transform(X), port.transform(X))


def test_stratifiable_matches():
    for y, frac in (([0, 0, 1, 1, 1], 0.4), ([0, 1, 1, 1], 0.5),
                    ([1, 1, 1], 0.3), ([0, 1] * 10, 0.05),
                    ([0, 1] * 10, 0.1)):
        y = np.asarray(y, np.float64)
        assert tdu._stratifiable(y, frac) == jdu._stratifiable(y, frac)


# ---------------------------------------------------------------- model


def test_bce_with_logits_matches_optax():
    rng = np.random.default_rng(0)
    logits = np.concatenate([rng.normal(size=500) * 3.0,
                             [-80.0, -20.0, 0.0, 20.0, 80.0]]
                            ).astype(np.float32)[:, None]
    for labels in ((rng.uniform(size=505) < 0.5).astype(np.float32),
                   rng.uniform(size=505).astype(np.float32)):
        ref = float(jnp.mean(optax.sigmoid_binary_cross_entropy(
            jnp.asarray(logits[:, 0]), jnp.asarray(labels))))
        got = float(ttm.bce_with_logits(torch.from_numpy(logits),
                                        torch.from_numpy(labels)))
        assert abs(got - ref) <= 1e-7
        assert float(jtm.bce_with_logits(jnp.asarray(logits),
                                         jnp.asarray(labels))) == ref


def test_dropout_rate_scaling_generator_and_eval():
    drop = Dropout(0.25).train()
    x = torch.ones(400, 500)
    g = lambda s: torch.Generator().manual_seed(s)
    y = drop(x, g(7))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.75))
    assert torch.equal(y, drop(x, g(7)))
    assert not torch.equal(y, drop(x, g(8)))
    assert torch.equal(drop.eval()(x, g(7)), x)
    assert torch.equal(Dropout(0.0).train()(x, g(7)), x)
    # the MLP's dropout layers draw from the generator passed to forward,
    # and eval mode is deterministic
    m = MLP(6).train()
    xs = torch.randn(64, 6, generator=g(1))
    assert torch.equal(m(xs, g(3)), m(xs, g(3)))
    assert not torch.equal(m(xs, g(3)), m(xs, g(4)))
    m.eval()
    assert torch.equal(m(xs, g(3)), m(xs))


# ---------------------------------------------------------------- trainer


def _jax_train(Xtr, ytr, Xv, yv, monkeypatch, **kw):
    """The JAX trainer with dropout off; returns (trainer, per-epoch
    validation losses, its stdout)."""
    trainer = jtm.MLPTrainer("", seed=42)
    trainer.model = JaxMLP(dropout_rate=0.0)
    vals, real_jit = [], jax.jit

    def recording_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "train_epoch":
            return jitted

        def run(*args):
            out = jitted(*args)
            vals.append(float(out[4]))
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    _, log = _quiet(trainer.train, Xtr, ytr, Xv, yv, **kw)
    monkeypatch.setattr(jax, "jit", real_jit)
    return trainer, np.asarray(vals), log


def _jax_initial_state(f):
    """The JAX trainer's initial parameters (its PRNGKey(seed) split) as
    the port's state dict."""
    _key, init_key = jax.random.split(jax.random.PRNGKey(42))
    p0 = JaxMLP(dropout_rate=0.0).init(init_key, jnp.zeros((1, f)))
    return mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, p0))


def _port_train(Xtr, ytr, Xv, yv, **kw):
    trainer = ttm.MLPTrainer("", device="cpu", seed=42)
    trainer.dropout_rate = 0.0
    _quiet(trainer.train, Xtr, ytr, Xv, yv,
           init_state=_jax_initial_state(Xtr.shape[1]), **kw)
    return trainer


def test_two_epochs_match_the_jax_trainer(monkeypatch):
    Xtr, ytr, Xv, yv = _separable(512, 6, 0.3)
    jt, jvals, _ = _jax_train(Xtr, ytr, Xv, yv, monkeypatch, epochs=2)
    pt = _port_train(Xtr, ytr, Xv, yv, epochs=2)
    ref = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          jt.params))
    for k, v in ref.items():
        np.testing.assert_allclose(pt.params[k].numpy(), v.numpy(),
                                   **TRAIN_TOL, err_msg=k)
    assert len(jvals) == len(pt.history) == 2
    np.testing.assert_allclose([h[1] for h in pt.history], jvals,
                               **TRAIN_TOL)
    np.testing.assert_allclose(pt.predict_proba(Xv), jt.predict_proba(Xv),
                               **TRAIN_TOL)


def test_early_stopping_epoch_matches(monkeypatch):
    """Noisy labels and 20 features: the validation loss falls, turns at
    epoch 9 and rises, so both stop at epoch 12 with patience 3."""
    Xtr, ytr, Xv, yv = _separable(512, 20, 3.0)
    jt, jvals, log = _jax_train(Xtr, ytr, Xv, yv, monkeypatch, epochs=60,
                                patience=3)
    pt = _port_train(Xtr, ytr, Xv, yv, epochs=60, patience=3)
    stops = [l for l in log.splitlines() if l.startswith("Early stopping")]
    assert stops == [f"Early stopping at epoch {len(pt.history) - 1}"]
    assert len(jvals) == len(pt.history) < 60
    assert pt.best_epoch == int(np.argmin(jvals)) < len(jvals) - 1
    np.testing.assert_allclose([h[1] for h in pt.history], jvals,
                               **TRAIN_TOL)
    ref = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          jt.params))
    for k, v in ref.items():
        np.testing.assert_allclose(pt.params[k].numpy(), v.numpy(),
                                   **TRAIN_TOL, err_msg=k)


def test_metrics_and_threshold_bitwise(monkeypatch):
    rng = np.random.default_rng(5)
    y = (rng.uniform(size=3001) < 0.4).astype(np.float32)
    prob = np.clip(0.6 * y + rng.normal(size=3001) * 0.3, 0, 1
                   ).astype(np.float32)
    pred = (prob > 0.5).astype(int)
    assert ttm._binary_metrics(y, pred, prob) == \
        jtm._binary_metrics(y, pred, prob)
    assert ttm._auroc_np(y, prob) == jtm._auroc_np(y, prob)
    assert np.isnan(ttm._auroc_np(np.ones(4), prob[:4]))
    jt, pt = jtm.MLPTrainer(""), ttm.MLPTrainer("", device="cpu")
    for tr in (jt, pt):
        monkeypatch.setattr(tr, "predict_proba", lambda X: prob)
        _quiet(tr.compute_optimal_threshold, None, y)
    assert pt.optimal_threshold == jt.optimal_threshold != 0.5


# ---------------------------------------------------------------- GBDT


@pytest.fixture(scope="module")
def small_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("gbdt") / "rows_2000.csv"
    pd.read_csv(CSV, comment="#", nrows=2000).to_csv(path, index=False)
    return str(path)


def test_train_gbdt_matches_jax(small_csv, tmp_path, monkeypatch):
    """Both trainers' grid search runs in this process on one thread: the
    fits are the same, and a pool of processes, each with its own OpenMP
    threads, oversubscribes the CPU beside the other test workers."""
    import joblib
    from threadpoolctl import threadpool_limits

    monkeypatch.setenv("NB_GBDT_GRID", "fast")
    kw = dict(cv=2, features="pre", hold_out_val=True, return_probs=True)
    with joblib.parallel_config(backend="sequential"), \
            threadpool_limits(1):
        (m_ref, x_ref), _ = _quiet(jax_train_gbdt, small_csv,
                                   prefix=str(tmp_path / "jax_"), **kw)
        (m_got, x_got), _ = _quiet(train_gbdt, small_csv,
                                   prefix=str(tmp_path / "port_"), **kw)
    assert m_got == m_ref and m_got["auroc"] > 0.8
    for k in ("prob_val", "y_val", "prob_test", "y_test"):
        assert np.array_equal(x_got[k], x_ref[k]), k
    # the port writes no pickle; its npz loads with numpy alone and its
    # trees walk to sklearn's raw scores bit for bit
    assert [p for p in os.listdir(tmp_path) if p.startswith("port_")] == \
        ["port_torch.npz"]
    arrays = load_artifacts(str(tmp_path / "port_torch.npz"))
    (X, y, _names), _ = _quiet(StabilityDataset.load, small_csv,
                               features="pre")
    _tr, _va, te = tdu.DataUtils.split_indices(y, 0.15, 0.15, 42)
    Xs = tdu.ScalerUtils.rebuild_scaler(
        arrays["gbdt_scaler_mean"], arrays["gbdt_scaler_scale"]
    ).transform(X[te])
    raw = TreeEnsemble(arrays, "cpu").raw_predict(torch.from_numpy(Xs))
    assert np.array_equal(raw.numpy(),
                          x_got["model"]._raw_predict(Xs)[:, 0])


# ---------------------------------------------------------------- artifacts


def test_trained_mlp_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 4))
    y = (X[:, 0] - X[:, 2] > 0).astype(float)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(4)])
    df["is_stable"] = y
    csv = tmp_path / "rt.csv"
    df.to_csv(csv, index=False)

    trainer = ttm.MLPTrainer(str(csv), device="cpu")
    data, _ = _quiet(trainer.load_and_prepare_data)
    X_train, y_train, X_val, y_val, X_test, y_test = data
    _quiet(trainer.train, X_train, y_train, X_val, y_val, epochs=30,
           patience=10)
    _quiet(trainer.compute_optimal_threshold, X_val, y_val)
    metrics, _ = _quiet(trainer.evaluate, X_test, y_test)
    assert metrics["auroc"] > 0.95
    prefix = str(tmp_path / "m_")
    _quiet(trainer.save_model, prefix=prefix)
    assert sorted(os.listdir(tmp_path)) == ["m_model_metadata.json",
                                           "m_torch.npz", "rt.csv"]

    loaded = ttm.MLPTrainer.load_model(prefix=prefix, device="cpu")
    assert loaded.optimal_threshold == trainer.optimal_threshold
    assert loaded.feature_names == trainer.feature_names
    assert np.array_equal(loaded.predict_proba(X_test),
                          trainer.predict_proba(X_test))
    assert np.array_equal(loaded.scaler.mean_, trainer.scaler.mean_)

    # the port's predictor serves the trained model from the raw test rows
    _tr, _va, te = tdu.DataUtils.split_indices(y, 0.15, 0.15, 42)
    pred = StabilityPredictor(prefix, model="mlp", device="cpu")
    _prob, _stable, raw = pred.predict_frame(df.iloc[te], return_raw=True)
    np.testing.assert_allclose(raw, trainer.predict_proba(X_test),
                               rtol=0, atol=1e-6)
