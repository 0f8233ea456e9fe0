"""Fittable preprocessors over Datasets.

Counterpart of ``ray_tpu/data/preprocessor.py`` (Ray's
python/ray/data/preprocessor.py: the Preprocessor ABC with
fit/transform/fit_transform/transform_batch, and
python/ray/data/preprocessors/: scalers, encoders, imputer,
concatenator).  Fitting is one streaming pass over numpy batches, no
materialization, and the fitted state is plain data, so a preprocessor
pickles into train workers and serve replicas.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class PreprocessorNotFittedError(RuntimeError):
    pass


class Preprocessor:
    _is_fittable = True

    def __init__(self):
        self._fitted = False

    # -- API ---------------------------------------------------------------
    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform(self, ds):
        if self._is_fittable and not self._fitted:
            raise PreprocessorNotFittedError(
                f"{type(self).__name__} must be fit before transform")
        return ds.map_batches(self.transform_batch, batch_format="numpy")

    def transform_batch(self, batch: Dict[str, np.ndarray]):
        raise NotImplementedError

    def _fit(self, ds):
        raise NotImplementedError

    # -- shared fitting pass ----------------------------------------------
    @staticmethod
    def _numeric_stats(ds, columns: List[str]) -> Dict[str, dict]:
        """One streaming pass: count/sum/sumsq/min/max per column."""
        stats = {c: {"n": 0, "sum": 0.0, "sumsq": 0.0,
                     "min": np.inf, "max": -np.inf} for c in columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in columns:
                col = np.asarray(batch[c], dtype=np.float64)
                s = stats[c]
                s["n"] += col.size
                s["sum"] += float(col.sum())
                s["sumsq"] += float((col * col).sum())
                if col.size:
                    s["min"] = min(s["min"], float(col.min()))
                    s["max"] = max(s["max"], float(col.max()))
        return stats

    @staticmethod
    def _uniques(ds, columns: List[str]) -> Dict[str, list]:
        vals: Dict[str, set] = {c: set() for c in columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in columns:
                vals[c].update(np.asarray(batch[c]).tolist())
        return {c: sorted(v) for c, v in vals.items()}


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (Ray's preprocessors/scaler.py)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        raw = self._numeric_stats(ds, self.columns)
        for c, s in raw.items():
            mean = s["sum"] / max(1, s["n"])
            var = max(0.0, s["sumsq"] / max(1, s["n"]) - mean * mean)
            self.stats_[c] = (mean, float(np.sqrt(var)) or 1.0)

    def transform_batch(self, batch):
        out = dict(batch)
        for c, (mean, std) in self.stats_.items():
            out[c] = (np.asarray(batch[c], np.float64) - mean) / (std or 1.0)
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        raw = self._numeric_stats(ds, self.columns)
        for c, s in raw.items():
            self.stats_[c] = (s["min"], s["max"])

    def transform_batch(self, batch):
        out = dict(batch)
        for c, (lo, hi) in self.stats_.items():
            rng = (hi - lo) or 1.0
            out[c] = (np.asarray(batch[c], np.float64) - lo) / rng
        return out


class LabelEncoder(Preprocessor):
    """Category -> int index for one label column."""

    def __init__(self, label_column: str):
        super().__init__()
        self.label_column = label_column
        self.classes_: list = []

    def _fit(self, ds):
        self.classes_ = self._uniques(ds, [self.label_column])[
            self.label_column]
        self._index_ = {v: i for i, v in enumerate(self.classes_)}

    def transform_batch(self, batch):
        index = getattr(self, "_index_", None)
        if index is None:  # fitted instance unpickled from an older state
            index = self._index_ = {v: i for i, v in enumerate(self.classes_)}
        out = dict(batch)
        vals = np.asarray(batch[self.label_column]).tolist()
        unseen = [v for v in vals if v not in index]
        if unseen:
            raise ValueError(
                f"LabelEncoder saw unseen label(s) {sorted(set(unseen))!r} "
                f"at transform time; fitted classes: {self.classes_!r}")
        out[self.label_column] = np.array([index[v] for v in vals],
                                          dtype=np.int64)
        return out


class OneHotEncoder(Preprocessor):
    """Category columns -> one {col}_{value} 0/1 column per category."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns
        self.categories_: Dict[str, list] = {}

    def _fit(self, ds):
        self.categories_ = self._uniques(ds, self.columns)

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        for c in self.columns:
            col = np.asarray(batch[c])
            for cat in self.categories_[c]:
                out[f"{c}_{cat}"] = (col == cat).astype(np.int8)
        return out


class SimpleImputer(Preprocessor):
    """Fill NaNs with the column mean (strategy='mean') or a constant."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Optional[float] = None):
        super().__init__()
        if strategy not in ("mean", "constant"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.columns = columns
        self.strategy = strategy
        self.fill_value = fill_value
        self.fills_: Dict[str, float] = {}

    def _fit(self, ds):
        if self.strategy == "constant":
            self.fills_ = {c: float(self.fill_value or 0.0)
                           for c in self.columns}
            return
        # mean over non-NaN values, single pass
        acc = {c: [0.0, 0] for c in self.columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                col = np.asarray(batch[c], np.float64)
                mask = ~np.isnan(col)
                acc[c][0] += float(col[mask].sum())
                acc[c][1] += int(mask.sum())
        self.fills_ = {c: (s / n if n else 0.0) for c, (s, n) in acc.items()}

    def transform_batch(self, batch):
        out = dict(batch)
        for c, fill in self.fills_.items():
            col = np.asarray(batch[c], np.float64).copy()
            col[np.isnan(col)] = fill
            out[c] = col
        return out


class Concatenator(Preprocessor):
    """Merge feature columns into one float vector column — the shape
    train loops consume (Ray's preprocessors/concatenator.py)."""

    _is_fittable = False

    def __init__(self, columns: List[str], output_column_name: str = "features",
                 dtype=np.float32):
        super().__init__()
        self.columns = columns
        self.output_column_name = output_column_name
        self.dtype = dtype
        self._fitted = True

    def _fit(self, ds):
        return self

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        cols = [np.asarray(batch[c]).reshape(len(batch[c]), -1)
                for c in self.columns]
        out[self.output_column_name] = np.concatenate(
            cols, axis=1).astype(self.dtype)
        return out


class Chain(Preprocessor):
    """Apply preprocessors in sequence (Ray: preprocessor.Chain)."""

    def __init__(self, *preprocessors: Preprocessor):
        super().__init__()
        self.preprocessors = list(preprocessors)

    def fit(self, ds):
        for p in self.preprocessors:
            if p._is_fittable:
                p.fit(ds)
            ds = p.transform(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch

    def _fit(self, ds):
        raise AssertionError("Chain overrides fit()")
