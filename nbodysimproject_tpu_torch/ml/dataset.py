"""Dataset I/O for the ML pipeline.

Counterpart of ``nbodysimproject_tpu/ml/dataset.py`` (parity:
``minbody/stability_dataset.py:18-122``): CSV with an optional
``# feature_names:`` header comment, ``scaler_mean_*`` /
``scaler_scale_*`` metadata columns, exclusion of simulation_id /
is_stable / mode / dataset_version, NaN-row drop on labels and NaN->0 on
features, and the pre-/post-integration column split.  pandas and numpy
only.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


_EXCLUDE = ["simulation_id", "is_stable", "mode", "dataset_version"]


def _open_text(path: str):
    if str(path).endswith(".gz"):
        import gzip

        return gzip.open(path, "rt")
    return open(path, "r")


# Columns knowable BEFORE any integration: sim metadata, per-body ICs,
# and the initial_* static features (computed on the initial state).
# Everything else is a product of the integration — the quantities that
# *define* the is_stable label (energy/L drift, COM drift, MEGNO) or
# proxy it; training on them is label leakage (VERDICT round-1 item 1).
_PRE_INTEGRATION_EXACT = frozenset({
    "n_bodies", "G", "softening", "min_softening", "adaptive",
    # schedule demand: a pure function of the ICs (frozen-schedule
    # calibration), knowable before integrating
    "n_sub", "n_sub_capped",
})
_PRE_INTEGRATION_PREFIXES = ("mass_", "x_", "y_", "z_",
                             "vx_", "vy_", "vz_", "initial_")


def is_pre_integration(col: str) -> bool:
    return (col in _PRE_INTEGRATION_EXACT
            or col.startswith(_PRE_INTEGRATION_PREFIXES))


class StabilityDataset:
    @staticmethod
    def split_feature_groups(feature_names: List[str]):
        """(pre_integration, post_integration) column-name split."""
        pre = [c for c in feature_names if is_pre_integration(c)]
        post = [c for c in feature_names if not is_pre_integration(c)]
        return pre, post

    @staticmethod
    def load(path: str, features: str = "all"
             ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        import pandas as pd

        feature_names = None
        with _open_text(path) as f:
            first_line = f.readline()
            if first_line.startswith("# feature_names:"):
                feature_names = first_line.strip().split(":", 1)[1].strip().split(",")

        df = pd.read_csv(path, comment="#")
        if "is_stable" not in df.columns:
            print("[error] CSV must contain 'is_stable' column")
            return np.array([]), np.array([]), []

        exclude = list(_EXCLUDE)
        scaler_cols = [c for c in df.columns if c.startswith("scaler_")]
        exclude.extend(scaler_cols)
        # also exclude non-numeric tag columns the analyzers add
        for c in df.columns:
            if c not in exclude and not pd.api.types.is_numeric_dtype(df[c]):
                exclude.append(c)

        feature_cols = [c for c in df.columns if c not in exclude]
        if features == "pre":
            feature_cols = [c for c in feature_cols if is_pre_integration(c)]
        elif features == "post":
            feature_cols = [c for c in feature_cols
                            if not is_pre_integration(c)]
        if feature_names is None or features != "all":
            feature_names = feature_cols

        X = df[feature_cols].values.astype(np.float64)
        y = df["is_stable"].values.astype(np.float64)

        valid = ~np.isnan(y)
        X, y = X[valid], y[valid]
        print(f"Loaded {len(X)} samples with {X.shape[1]} features")

        if np.any(np.isnan(X)) or np.any(~np.isfinite(X)):
            print("[warning] NaN values found in features. Replacing with 0.")
            X = np.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0)
        return X, y, feature_names

    @staticmethod
    def get_metadata(path: str) -> Dict:
        import pandas as pd

        metadata = {"feature_names": None, "scaler_mean": None,
                    "scaler_scale": None}
        with _open_text(path) as f:
            first_line = f.readline()
            if first_line.startswith("# feature_names:"):
                metadata["feature_names"] = (
                    first_line.strip().split(":", 1)[1].strip().split(","))
        df = pd.read_csv(path, comment="#", nrows=1)
        mean_cols = sorted(c for c in df.columns if c.startswith("scaler_mean_"))
        scale_cols = sorted(c for c in df.columns if c.startswith("scaler_scale_"))
        if mean_cols:
            metadata["scaler_mean"] = df[mean_cols].iloc[0].values
        if scale_cols:
            metadata["scaler_scale"] = df[scale_cols].iloc[0].values
        return metadata

    @staticmethod
    def feature_columns(df) -> List[str]:
        """The columns the loader will treat as features (everything
        numeric that is not excluded or a scaler column)."""
        import pandas as pd

        out = []
        for c in df.columns:
            if c in _EXCLUDE or c.startswith("scaler_"):
                continue
            if not pd.api.types.is_numeric_dtype(df[c]):
                continue
            out.append(c)
        return out

    @staticmethod
    def save(path: str, df, feature_names: List[str] | None = None,
             include_scaler: bool = False) -> None:
        """Write a results DataFrame with the ``# feature_names:`` header
        the loader understands (format parity with the reference CSVs,
        minbody/stability_dataset.py:26-64).

        ``include_scaler`` additionally writes ``scaler_mean_<col>`` /
        ``scaler_scale_<col>`` metadata columns (StandardScaler
        statistics over the finite entries of each feature column),
        which ``get_metadata``/``load`` expose as scaler info.
        """
        if feature_names is None:
            feature_names = StabilityDataset.feature_columns(df)
        if include_scaler:
            import pandas as pd

            scaler_cols = {}
            for c in feature_names:
                col = np.asarray(df[c], np.float64)
                finite = np.isfinite(col)
                mean = float(col[finite].mean()) if finite.any() else 0.0
                std = float(col[finite].std()) if finite.any() else 1.0
                scaler_cols[f"scaler_mean_{c}"] = mean
                scaler_cols[f"scaler_scale_{c}"] = std if std > 0.0 else 1.0
            df = pd.concat([df, pd.DataFrame(scaler_cols, index=df.index)],
                           axis=1)
        compression = "gzip" if str(path).endswith(".gz") else None
        if compression:
            import gzip

            with gzip.open(path, "wt") as f:
                if feature_names:
                    f.write("# feature_names: "
                            + ",".join(feature_names) + "\n")
                df.to_csv(f, index=False)
        else:
            with open(path, "w") as f:
                if feature_names:
                    f.write("# feature_names: "
                            + ",".join(feature_names) + "\n")
                df.to_csv(f, index=False)
