"""MLP stability-classifier training.

Counterpart of ``nbodysimproject_tpu/ml/train_mlp.py`` (parity:
``minbody/train_mlp.py:29-267``, MLPTrainer): load and scale, Adam at
lr 1e-3, BCE with logits, batch 32, at most 200 epochs with early
stopping (patience 20) keeping the best parameters, the optimal
threshold by Youden's J over 100 thresholds on the validation split,
the test metrics (accuracy, precision, recall, F1, AUROC: sklearn's
``roc_auc_score`` bit for bit through ``ml/calibrate.py::roc_auc``, with
no sklearn), and the artifacts.

The protocol is the JAX package's: each epoch takes the batches of
``np.random.default_rng(seed).permutation(n)[:steps * batch]`` (the
remainder dropped), the validation loss is taken on the whole
validation split with dropout off, and dropout draws from an explicit
``torch.Generator`` seeded with ``seed``.  The data stay on the device
for the whole run: one index tensor goes to it per epoch, and the one
host read of an epoch is its two losses, as in the JAX loop.  Products
are float32 with TF32 off.  The initial parameters are ``make_mlp``'s
LeCun-normal draws from ``seed`` (torch cannot replay flax's), or a
state dict passed to ``train`` (``ml/artifacts.py::
mlp_state_dict_from_flax`` carries a flax tree across).  This is plain
PyTorch: the JAX package trains in XLA, with no Pallas kernel.

Artifacts (``save_model`` / ``load_model``), read by the port's
``StabilityPredictor`` with numpy and ``json`` alone:
  <prefix>torch.npz            ``mlp.fc{1,2,3}.{weight,bias}`` and
                               ``mlp_scaler_mean`` / ``mlp_scaler_scale``
                               (``ml/artifacts.py``; a GBDT's arrays in
                               the same file are kept)
  <prefix>model_metadata.json  feature_names, optimal_threshold,
                               input_dim (the JAX package's keys)
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..utils.seeding import set_global_seed
from .artifacts import load_artifacts, store_artifacts
from .calibrate import roc_auc
from .data_utils import DataUtils, ScalerUtils
from .dataset import StabilityDataset
from .model_zoo import MLP, make_mlp
from .predict import full_float32_matmul


def bce_with_logits(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy`` of (B, 1) logits, mean
    over the batch: -y log sigmoid(x) - (1 - y) log sigmoid(-x)."""
    x = logits.squeeze(-1)
    return torch.mean(-labels * F.logsigmoid(x)
                      - (1.0 - labels) * F.logsigmoid(-x))


class MLPTrainer:
    def __init__(self, csv_path: str = "stability_data.csv", device=None,
                 seed: int = 42, features: str = "all"):
        """``features``: 'all' | 'pre' | 'post' (the honest headline
        classifier trains on 'pre', as in the JAX package).  ``device``:
        ``None`` trains on the current CUDA device and raises without
        one; ``"cpu"`` trains on the CPU.  ``dropout_rate`` (0.25) may
        be set before ``train``."""
        self.csv_path = csv_path
        self.device = resolve_device(device)
        self.seed = seed
        self.features = features
        self.dropout_rate = 0.25
        self.model = None
        self.scaler = None
        self.optimal_threshold = 0.5
        self.feature_names = None
        #: per epoch of the last ``train``: (train loss, validation loss)
        self.history = []
        self.best_epoch = None

    @property
    def params(self):
        """The trained parameters as an ``MLP`` state dict."""
        return None if self.model is None else self.model.state_dict()

    # ------------------------------------------------------------------
    def load_and_prepare_data(self):
        X, y, feature_names = StabilityDataset.load(self.csv_path,
                                                    features=self.features)
        self.feature_names = feature_names
        if len(X) == 0:
            print("[error] No data loaded")
            return None
        out = DataUtils.split_and_scale(X, y, test_size=0.15, val_size=0.15,
                                        seed=42)
        if out[0] is None:
            print("[error] Data splitting failed")
            return None
        X_train, X_val, X_test, y_train, y_val, y_test, scaler = out
        self.scaler = scaler
        print(f"Data shapes: train={X_train.shape}, val={X_val.shape}, "
              f"test={X_test.shape}")
        return (X_train.astype(np.float32), y_train.astype(np.float32),
                X_val.astype(np.float32), y_val.astype(np.float32),
                X_test.astype(np.float32), y_test.astype(np.float32))

    # ------------------------------------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def train(self, X_train, y_train, X_val, y_val, epochs: int = 200,
              patience: int = 20, batch_size: int = 32, lr: float = 1e-3,
              init_state=None):
        """Train from ``init_state`` (an ``MLP`` state dict; default
        ``make_mlp(input_dim, seed)``) and keep the parameters of the
        epoch with the lowest validation loss."""
        dev = self.device
        model = MLP(X_train.shape[1], dropout_rate=self.dropout_rate)
        model.load_state_dict(
            make_mlp(X_train.shape[1], self.seed, device="cpu").state_dict()
            if init_state is None else init_state)
        model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self.seed))

        n = len(X_train)
        steps = max(1, n // batch_size)
        Xd, yd = self._tensor(X_train), self._tensor(y_train)
        Xv, yv = self._tensor(X_val), self._tensor(y_val)
        losses = torch.empty(steps, dtype=torch.float32, device=dev)

        best_val = np.inf
        best_state = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
        patience_ctr = 0
        rng = np.random.default_rng(self.seed)
        self.history = []
        with full_float32_matmul():
            for epoch in range(epochs):
                perm = rng.permutation(n)[: steps * batch_size].reshape(
                    steps, batch_size)
                idx = torch.as_tensor(perm, device=dev)
                model.train()
                for s in range(steps):
                    rows = idx[s]
                    loss = bce_with_logits(model(Xd[rows], gen), yd[rows])
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
                    losses[s] = loss.detach()
                model.eval()
                with torch.no_grad():
                    val = bce_with_logits(model(Xv), yv)
                ep_loss, val_loss = torch.stack(
                    [losses.mean(), val]).tolist()
                self.history.append((ep_loss, val_loss))
                if epoch % 10 == 0:
                    print(f"Epoch {epoch}: Train Loss = {ep_loss:.4f}, "
                          f"Val Loss = {val_loss:.4f}")
                if val_loss < best_val:
                    best_val = val_loss
                    best_state = {k: v.detach().clone()
                                  for k, v in model.state_dict().items()}
                    self.best_epoch = epoch
                    patience_ctr = 0
                else:
                    patience_ctr += 1
                if patience_ctr >= patience:
                    print(f"Early stopping at epoch {epoch}")
                    break

        model.load_state_dict(best_state)
        self.model = model.eval()

    # ------------------------------------------------------------------
    def predict_proba(self, X):
        """sigmoid of the logits, (n,) float32, dropout off."""
        with torch.no_grad(), full_float32_matmul():
            logits = self.model(self._tensor(X))
        return torch.sigmoid(logits).squeeze(-1).cpu().numpy()

    def compute_optimal_threshold(self, X_val, y_val):
        """Youden's J over 100 thresholds (train_mlp.py:141-187)."""
        probs = self.predict_proba(X_val)
        best_j, best_t = -1.0, 0.5
        for t in np.linspace(0.1, 0.9, 100):
            preds = (probs > t).astype(int)
            tp = np.sum((preds == 1) & (y_val == 1))
            tn = np.sum((preds == 0) & (y_val == 0))
            fp = np.sum((preds == 1) & (y_val == 0))
            fn = np.sum((preds == 0) & (y_val == 1))
            tpr = tp / (tp + fn) if (tp + fn) > 0 else 0
            tnr = tn / (tn + fp) if (tn + fp) > 0 else 0
            j = tpr + tnr - 1
            if j > best_j:
                best_j, best_t = j, t
        self.optimal_threshold = best_t
        print(f"Optimal threshold (Youden index): {best_t:.3f}")

    def evaluate(self, X_test, y_test) -> dict:
        probs = self.predict_proba(X_test)
        preds = (probs > self.optimal_threshold).astype(int)
        metrics = _binary_metrics(y_test, preds, probs)
        print("\nTest Set Performance:")
        print(f"Threshold used: {self.optimal_threshold:.3f}")
        for k in ("accuracy", "precision", "recall", "f1", "auroc"):
            print(f"{k.capitalize()}: {metrics[k]:.4f}")
        return metrics

    def save_model(self, prefix: str = ""):
        arrays = {f"mlp.{k}": v.detach().cpu().numpy()
                  for k, v in self.model.state_dict().items()}
        arrays["mlp_scaler_mean"] = np.asarray(self.scaler.mean_, np.float64)
        arrays["mlp_scaler_scale"] = np.asarray(self.scaler.scale_,
                                                np.float64)
        store_artifacts(prefix + "torch.npz", arrays, "mlp")
        print(f"Model and scaler saved to {prefix}torch.npz")
        metadata = {
            "feature_names": self.feature_names,
            "optimal_threshold": float(self.optimal_threshold),
            "input_dim": int(self.model.fc1.in_features),
        }
        with open(prefix + "model_metadata.json", "w") as f:
            json.dump(metadata, f, indent=2)
        print("Model metadata saved to model_metadata.json")

    @classmethod
    def load_model(cls, prefix: str = "", csv_path: str = "", device=None):
        """An inference-ready trainer from ``save_model``'s artifacts (or
        from ``export_artifacts``' file of the JAX package's models)."""
        with open(prefix + "model_metadata.json") as f:
            meta = json.load(f)
        trainer = cls(csv_path, device=device, features="pre")
        trainer.feature_names = meta["feature_names"]
        trainer.optimal_threshold = float(meta["optimal_threshold"])
        arrays = load_artifacts(prefix + "torch.npz")
        model = MLP(int(meta["input_dim"]))
        model.load_state_dict({k[4:]: torch.from_numpy(v)
                               for k, v in arrays.items()
                               if k.startswith("mlp.")})
        trainer.model = model.to(trainer.device).eval()
        trainer.scaler = ScalerUtils.rebuild_scaler(
            arrays["mlp_scaler_mean"], arrays["mlp_scaler_scale"])
        return trainer

    def run(self):
        data = self.load_and_prepare_data()
        if data is None:
            return
        X_train, y_train, X_val, y_val, X_test, y_test = data
        print("Starting training...")
        self.train(X_train, y_train, X_val, y_val)
        print("\nComputing optimal threshold on validation set...")
        self.compute_optimal_threshold(X_val, y_val)
        print("\nEvaluating on test set...")
        metrics = self.evaluate(X_test, y_test)
        self.save_model()
        return metrics


def _binary_metrics(y_true, y_pred, y_prob) -> dict:
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    tp = np.sum((y_pred == 1) & (y_true == 1))
    tn = np.sum((y_pred == 0) & (y_true == 0))
    fp = np.sum((y_pred == 1) & (y_true == 0))
    fn = np.sum((y_pred == 0) & (y_true == 1))
    acc = (tp + tn) / max(len(y_true), 1)
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    tpr = tp / (tp + fn) if (tp + fn) else 0.0
    tnr = tn / (tn + fp) if (tn + fp) else 0.0
    auroc = roc_auc(y_true, y_prob)
    return dict(accuracy=float(acc), precision=float(prec),
                recall=float(rec), f1=float(f1), auroc=auroc,
                balanced_accuracy=float(0.5 * (tpr + tnr)),
                tpr=float(tpr), tnr=float(tnr))


def _auroc_np(y_true, y_prob) -> float:
    order = np.argsort(y_prob)
    ranks = np.empty_like(order, dtype=float)
    ranks[order] = np.arange(1, len(y_prob) + 1)
    pos = y_true == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def main():
    set_global_seed(42)
    trainer = MLPTrainer()
    trainer.run()


if __name__ == "__main__":
    main()
