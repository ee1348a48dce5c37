#
# Input dataset abstraction of the PyTorch port: the numpy / list-of-arrays /
# pandas subset of the JAX package's core/dataset.py (reference
# core.py:463-562 `_pre_process_data`). Arrow, scipy.sparse and Spark inputs
# are not ported yet and raise TypeError.
#
# Extraction stays on the host: estimators stage the (n, d) matrix onto their
# device in one copy (core/estimator.py).
#

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


def _is_pandas_df(dataset: Any) -> bool:
    import pandas as pd

    return isinstance(dataset, pd.DataFrame)


@dataclass
class FeatureData:
    """Extracted, host-side training data: the product of `_pre_process_data`."""

    features: np.ndarray  # (n, d)
    label: Optional[np.ndarray] = None  # (n,)
    weight: Optional[np.ndarray] = None  # (n,)
    row_id: Optional[np.ndarray] = None  # (n,) int64, from the id column

    @property
    def n_rows(self) -> int:
        return self.features.shape[0]

    @property
    def n_cols(self) -> int:
        return self.features.shape[1]


def _stack_feature_column(col: Any) -> np.ndarray:
    """A pandas column whose cells are lists/arrays/pyspark Vectors -> (n, d) float
    array (reference's ArrayType/VectorUDT unwrap, core.py:496-527)."""
    first = col.iloc[0]
    if np.isscalar(first):
        return col.to_numpy().reshape(-1, 1)
    if hasattr(first, "toArray"):  # pyspark.ml.linalg Dense/SparseVector cells
        return np.stack([v.toArray() for v in col.to_numpy()])
    return np.stack([np.asarray(v) for v in col.to_numpy()])


def extract_feature_data(
    dataset: Any,
    input_col: Optional[str] = None,
    input_cols: Optional[List[str]] = None,
    label_col: Optional[str] = None,
    weight_col: Optional[str] = None,
    id_col: Optional[str] = None,
    float32: bool = True,
) -> FeatureData:
    """Column selection + dtype casting + layout normalization (reference
    core.py:463-562), producing a host array ready to stage on the device."""
    dtype = np.float32 if float32 else np.float64

    if isinstance(dataset, np.ndarray):
        return FeatureData(features=np.atleast_2d(np.asarray(dataset, dtype=dtype)))

    if isinstance(dataset, (list, tuple)) and dataset and isinstance(dataset[0], np.ndarray):
        # pre-partitioned arrays (one per worker shard)
        X = np.concatenate([np.asarray(a, dtype=dtype) for a in dataset], axis=0)
        return FeatureData(features=np.atleast_2d(X))

    if _is_pandas_df(dataset):
        if len(dataset) == 0:
            raise RuntimeError(
                "Fit/transform input is empty (the reference raises on empty partitions "
                "too, core.py:959-962)."
            )
        if input_cols:
            missing = [c for c in input_cols if c not in dataset.columns]
            if missing:
                raise ValueError(
                    f"feature columns {missing} not found in dataset columns "
                    f"{list(dataset.columns)}"
                )
            X = dataset[list(input_cols)].to_numpy(dtype=dtype)
        elif input_col:
            if input_col not in dataset.columns:
                raise ValueError(
                    f"feature column '{input_col}' not found in dataset columns "
                    f"{list(dataset.columns)}"
                )
            X = _stack_feature_column(dataset[input_col]).astype(dtype)
        else:
            raise ValueError("input_col or input_cols must be provided for DataFrame input")
        for col_name, kind in ((label_col, "label"), (weight_col, "weight"), (id_col, "id")):
            if col_name is not None and col_name not in dataset.columns:
                raise ValueError(
                    f"{kind} column '{col_name}' not found in dataset columns "
                    f"{list(dataset.columns)}"
                )
        label = None if label_col is None else dataset[label_col].to_numpy(dtype=dtype)
        weight = None if weight_col is None else dataset[weight_col].to_numpy(dtype=dtype)
        row_id = None if id_col is None else dataset[id_col].to_numpy(dtype=np.int64)
        return FeatureData(features=X, label=label, weight=weight, row_id=row_id)

    raise TypeError(
        f"Unsupported dataset type: {type(dataset)} (the port takes numpy arrays, "
        "lists of arrays and pandas DataFrames)"
    )


def ensure_dtype(X: np.ndarray, float32: bool = True) -> np.ndarray:
    """Host-cast a dense block to the compute dtype (no copy when it already is)."""
    X = np.asarray(X)
    dt = np.float32 if float32 else np.float64
    return X if X.dtype == dt else X.astype(dt)


def require_finite_rows(X: Any, what: str) -> None:
    """Raise ValueError naming the first row of the (m, d) tensor X (on any
    device) with a NaN or infinite feature: one pass over X, before any kernel
    sees it."""
    import torch

    finite = torch.isfinite(X).all(dim=1)
    if not bool(finite.all()):
        row = int((~finite).nonzero()[0, 0])
        raise ValueError(f"{what} row {row} has a NaN or infinite feature; the port takes finite features")


def ensure_id_col(dataset: Any, id_col_name: str) -> Any:
    """A pandas frame without the column `id_col_name` comes back as a copy
    with it, 0..n-1 int64 (reference params.py:110-129 `_ensureIdCol`); other
    inputs come back as they are, and their rows are numbered 0..n-1."""
    if _is_pandas_df(dataset) and id_col_name not in dataset.columns:
        dataset = dataset.copy()
        dataset[id_col_name] = np.arange(len(dataset), dtype=np.int64)
    return dataset


def append_output_columns(dataset: Any, outputs: Dict[str, np.ndarray]) -> Any:
    """Append transform() outputs to the input, preserving its flavor
    (the reference appends Spark columns via withColumn, core.py:1846-1899)."""
    import pandas as pd

    def _colify(v: np.ndarray) -> Any:
        return v if v.ndim == 1 else list(v)  # one array cell per row

    if _is_pandas_df(dataset):
        out = dataset.copy()
        for name, v in outputs.items():
            out[name] = _colify(v)
        return out
    # numpy input: outputs as a DataFrame (no original columns to carry)
    return pd.DataFrame({name: _colify(v) for name, v in outputs.items()})
