"""The headline models' weights, carried across from the JAX package.

The JAX package ships its trained classifiers in formats that need flax,
msgpack and scikit-learn to read (``tools/run_headline_dataset.py``
writes them):

    <prefix>mlp_model.msgpack        flax ``serialization`` msgpack
    <prefix>scaler.pkl               pickled sklearn ``StandardScaler``
    <prefix>gbdt_gbdt_model.pkl      pickled ``HistGradientBoostingClassifier``
    <prefix>gbdt_scaler.pkl          pickled sklearn ``StandardScaler``

``export_artifacts`` reads them once, on a CPU host that has sklearn and
msgpack, and writes one numpy ``.npz`` file, ``<prefix>torch.npz``
(``data/headline_pre_torch.npz`` for the shipped 2-D models)::

    python -m nbodysimproject_tpu_torch.ml.artifacts data/headline_pre_

``load_artifacts`` reads it with numpy alone, so the port serves the
models where none of flax, msgpack or sklearn is installed.  The port's
own trainers (``ml/train_mlp.py``, ``ml/train_lightgbm.py``) write the
same file through ``store_artifacts``.  Keys:
``mlp.fc{1,2,3}.{weight,bias}`` (float32, the ``ml/model_zoo.py::MLP``
state dict), ``mlp_scaler_mean`` / ``mlp_scaler_scale`` and
``gbdt_scaler_mean`` / ``gbdt_scaler_scale`` (float64), and the tree
ensemble, one row per tree padded with leaves to the largest tree:
``gbdt_feature_idx``, ``gbdt_num_threshold``,
``gbdt_missing_go_to_left``, ``gbdt_left``, ``gbdt_right``,
``gbdt_is_leaf``, ``gbdt_value``, ``gbdt_n_nodes`` and
``gbdt_baseline`` (sklearn's ``_baseline_prediction``).  The metadata
JSON files stay where they are; the predictor reads them with ``json``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

#: flax's msgpack extension codes (flax/serialization.py _MsgpackExtType)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

GBDT_NODE_FIELDS = ("feature_idx", "num_threshold", "missing_go_to_left",
                    "left", "right", "is_leaf", "value")
_GBDT_DTYPES = {"feature_idx": np.int64, "num_threshold": np.float64,
                "missing_go_to_left": np.bool_, "left": np.int64,
                "right": np.int64, "is_leaf": np.bool_,
                "value": np.float64}


def read_flax_msgpack(path: str) -> dict:
    """The parameter tree of a flax ``serialization.to_bytes`` file, as
    nested dicts of numpy arrays, decoded with the ``msgpack`` package
    and flax's ndarray extension (code 1, payload ``(shape, dtype name,
    C-order bytes)``) without importing flax."""
    import msgpack

    def ext_hook(code, data):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported flax msgpack extension {code}")
        shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()))
        arr = arr.reshape(shape, order="C")
        return arr[()] if code == _EXT_NPSCALAR else arr

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)


def mlp_state_dict_from_flax(params) -> dict:
    """The ``MLP`` state dict of a flax ``MLP`` parameter tree (numpy
    leaves, with or without the top ``"params"`` key): ``Dense_i/kernel``
    of shape (in, out) becomes ``fc{i+1}.weight`` of shape (out, in), the
    bias is copied; float32 CPU tensors."""
    tree = params.get("params", params)
    out = {}
    for i in range(3):
        layer = tree[f"Dense_{i}"]
        out[f"fc{i + 1}.weight"] = torch.from_numpy(
            np.array(layer["kernel"], np.float32).T.copy())
        out[f"fc{i + 1}.bias"] = torch.from_numpy(
            np.array(layer["bias"], np.float32))
    return out


def gbdt_arrays_from_sklearn(model) -> dict:
    """The tree arrays of a fitted binary
    ``HistGradientBoostingClassifier``: each node field of
    ``GBDT_NODE_FIELDS`` as a (n_trees, n_nodes_max) array in sklearn's
    tree order, padded with leaves of value 0, plus ``n_nodes`` and the
    ``baseline`` raw score.  Raises on categorical splits or on more
    than one tree per iteration."""
    if int(model.n_trees_per_iteration_) != 1:
        raise ValueError("only one tree per iteration (a binary "
                         "classifier) is supported")
    if getattr(model, "_preprocessor", None) is not None:
        raise ValueError("categorical features are not supported")
    trees = [pred.nodes for it in model._predictors for pred in it]
    if any(t["is_categorical"].any() for t in trees):
        raise ValueError("categorical splits are not supported")
    M = max(len(t) for t in trees)
    out = {}
    for f in GBDT_NODE_FIELDS:
        a = np.zeros((len(trees), M), _GBDT_DTYPES[f])
        if f == "is_leaf":
            a[:] = True
        for i, t in enumerate(trees):
            a[i, :len(t)] = t[f]
        out[f] = a
    out["n_nodes"] = np.asarray([len(t) for t in trees], np.int64)
    out["baseline"] = np.asarray(model._baseline_prediction,
                                 np.float64).reshape(1)
    return out


def export_artifacts(prefix: str, out_path: str | None = None) -> str:
    """Read ``<prefix>``'s MLP and GBDT artifacts (whichever are there;
    needs msgpack and sklearn) and write them to ``out_path`` (default
    ``<prefix>torch.npz``).  Returns the path written."""
    import pickle

    out_path = out_path or prefix + "torch.npz"
    arrays = {}

    def scaler(path, key):
        with open(path, "rb") as f:
            sc = pickle.load(f)
        arrays[f"{key}_scaler_mean"] = np.asarray(sc.mean_, np.float64)
        arrays[f"{key}_scaler_scale"] = np.asarray(sc.scale_, np.float64)

    if os.path.exists(prefix + "mlp_model.msgpack"):
        sd = mlp_state_dict_from_flax(
            read_flax_msgpack(prefix + "mlp_model.msgpack"))
        arrays.update({f"mlp.{k}": v.numpy() for k, v in sd.items()})
        scaler(prefix + "scaler.pkl", "mlp")
    gp = prefix + "gbdt_"
    if os.path.exists(gp + "gbdt_model.pkl"):
        with open(gp + "gbdt_model.pkl", "rb") as f:
            model = pickle.load(f)
        arrays.update({f"gbdt_{k}": v
                       for k, v in gbdt_arrays_from_sklearn(model).items()})
        scaler(gp + "scaler.pkl", "gbdt")
    if not arrays:
        raise FileNotFoundError(f"no model artifacts under prefix {prefix!r}")
    np.savez_compressed(out_path, **arrays)
    return out_path


def store_artifacts(path: str, arrays: dict, kind: str) -> str:
    """Write one model's arrays (keys ``mlp.*`` / ``mlp_*`` or ``gbdt_*``,
    by ``kind``) into the ``export_artifacts`` file at ``path``, keeping
    the other model's arrays where the file already holds them: what the
    port's trainers save, and the predictor reads."""
    keep = {}
    if os.path.exists(path):
        keep = {k: v for k, v in load_artifacts(path).items()
                if not k.startswith((kind + ".", kind + "_"))}
    np.savez_compressed(path, **keep, **arrays)
    return path


def load_artifacts(path: str) -> dict:
    """The arrays of an ``export_artifacts`` file (numpy only)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: export it once with `python -m "
            f"nbodysimproject_tpu_torch.ml.artifacts <prefix>` on a host "
            f"with sklearn and msgpack")
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":
    for p in sys.argv[1:] or ["data/headline_pre_"]:
        print(export_artifacts(p))
