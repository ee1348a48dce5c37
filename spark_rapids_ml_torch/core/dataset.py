#
# Input dataset abstraction of the PyTorch port: the numpy / list-of-arrays /
# pandas / Arrow subset of the JAX package's core/dataset.py (reference
# core.py:463-562 `_pre_process_data`). scipy.sparse and Spark inputs are not
# ported yet and raise TypeError.
#
# Extraction stays on the host: estimators stage the (n, d) matrix onto their
# device (core/estimator.py) or stream it (ops/streaming.py).
#
# Arrow (pyarrow is optional, as in the JAX package: without it an Arrow input
# is an unsupported type): a null-free FixedSizeList feature column whose value
# buffer the device casts exactly becomes an (n, d) VIEW of the Arrow buffer in
# its source dtype, no copy; nulls, several chunks, other dtypes and
# multi-column layouts take a counted host conversion (ops/ingest.py
# count_conversion). transform() of an Arrow input returns a pandas frame of the
# outputs alone, as the JAX package's append_output_columns does.
#

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

try:  # pyarrow is optional: it feeds the zero-copy Arrow ingest
    import pyarrow as pa

    _PYARROW = True
except ImportError:  # pragma: no cover
    _PYARROW = False


def _is_arrow(dataset: Any) -> bool:
    return _PYARROW and isinstance(dataset, (pa.Table, pa.RecordBatch))


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


def _arrow_combined(col: Any) -> Any:
    """ChunkedArray/Array -> one contiguous Array: a single chunk as it is (no
    copy); several chunks combined, a counted copy."""
    if not isinstance(col, pa.ChunkedArray):
        return col
    if col.num_chunks == 1:
        return col.chunk(0)
    from ..ops.ingest import count_conversion

    t0 = time.perf_counter()
    out = col.combine_chunks()
    count_conversion(col.nbytes, time.perf_counter() - t0)
    return out


def _arrow_numpy(arr: Any) -> Optional[np.ndarray]:
    """A numpy view of a primitive Arrow array; None when its layout forbids one
    (nulls, non-primitive types)."""
    try:
        return arr.to_numpy(zero_copy_only=True)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError, TypeError):
        return None


def _arrow_converted(arr: Any, dtype: np.dtype) -> np.ndarray:
    """The counted host conversion of an Arrow column."""
    from ..ops.ingest import count_conversion

    t0 = time.perf_counter()
    out = np.asarray(arr.to_numpy(zero_copy_only=False), dtype=dtype)
    count_conversion(out.nbytes, time.perf_counter() - t0)
    return out


def _arrow_column(dataset: Any, name: str, dtype: np.dtype) -> np.ndarray:
    """A scalar column (label, weight, id) in `dtype`: a view when it is
    null-free and already in `dtype`, else a counted conversion."""
    arr = _arrow_combined(dataset.column(name))
    out = _arrow_numpy(arr) if arr.null_count == 0 else None
    if out is None or out.dtype != dtype:
        out = _arrow_converted(arr, dtype)
    return out


def _extract_arrow(
    dataset: Any,
    input_col: Optional[str],
    input_cols: Optional[List[str]],
    label_col: Optional[str],
    weight_col: Optional[str],
    id_col: Optional[str],
    float32: bool,
) -> FeatureData:
    """Arrow Table/RecordBatch input (module header): the JAX package's
    _extract_arrow."""
    from ..ops import ingest

    dtype = np.dtype(np.float32 if float32 else np.float64)
    names = list(dataset.schema.names)
    if dataset.num_rows == 0:
        raise RuntimeError(
            "Fit/transform input is empty (the reference raises on empty partitions "
            "too, core.py:959-962)."
        )
    if input_cols:
        missing = [c for c in input_cols if c not in names]
        if missing:
            raise ValueError(f"feature columns {missing} not found in dataset columns {names}")
        stacked = [
            _arrow_combined(dataset.column(c)).to_numpy(zero_copy_only=False)
            for c in input_cols
        ]
        t0 = time.perf_counter()
        X = np.stack(stacked, axis=1)
        if not ingest._device_castable(X.dtype, dtype):
            X = X.astype(dtype)
        ingest.count_conversion(X.nbytes, time.perf_counter() - t0)
    elif input_col:
        if input_col not in names:
            raise ValueError(f"feature column '{input_col}' not found in dataset columns {names}")
        arr = _arrow_combined(dataset.column(input_col))
        X = None
        if pa.types.is_fixed_size_list(arr.type) and arr.null_count == 0:
            # flatten() (not .values) honors a slice's offset; no copy when the
            # child holds no nulls
            flat = _arrow_numpy(arr.flatten())
            if flat is not None and ingest._device_castable(flat.dtype, dtype):
                X = flat.reshape(-1, int(arr.type.list_size))
                ingest.counters["bytes_zero_copy"] += X.nbytes
        if X is None:  # the counted conversion, through the pandas cell stack
            X = _stack_feature_column(dataset.column(input_col).to_pandas())
            t0 = time.perf_counter()
            X = np.ascontiguousarray(X, dtype=dtype)
            ingest.count_conversion(X.nbytes, time.perf_counter() - t0)
    else:
        raise ValueError("input_col or input_cols must be provided for Arrow input")
    for col_name, kind in ((label_col, "label"), (weight_col, "weight"), (id_col, "id")):
        if col_name is not None and col_name not in names:
            raise ValueError(f"{kind} column '{col_name}' not found in dataset columns {names}")
    return FeatureData(
        features=X,
        label=None if label_col is None else _arrow_column(dataset, label_col, dtype),
        weight=None if weight_col is None else _arrow_column(dataset, weight_col, dtype),
        row_id=None if id_col is None else _arrow_column(dataset, id_col, np.dtype(np.int64)),
    )


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

    if _is_arrow(dataset):
        return _extract_arrow(
            dataset, input_col, input_cols, label_col, weight_col, id_col, float32
        )

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
        "lists of arrays, pandas DataFrames and, with pyarrow, Arrow tables)"
    )


def empty_partition(dataset: Any, multiprocess: bool, dtype: Any, width: int = 0, *,
                    label: bool = False, weight: bool = False,
                    row_id: bool = False) -> Optional[FeatureData]:
    """Under a process group an empty pandas or Arrow frame is this rank's
    empty partition: no rows, of `width` columns (0: the group's width, which
    the caller takes from the other ranks), with empty label, weight and id
    arrays where asked. None for any other input."""
    frame = _is_pandas_df(dataset) or _is_arrow(dataset)
    if not (multiprocess and frame and len(dataset) == 0):
        return None
    empty = np.zeros((0,), dtype)
    return FeatureData(features=np.zeros((0, width), dtype),
                       label=empty if label else None,
                       weight=empty if weight else None,
                       row_id=np.zeros((0,), np.int64) if row_id else None)


def ensure_dtype(X: np.ndarray, float32: bool = True) -> np.ndarray:
    """Host-cast a dense block to the compute dtype (no copy when it already
    is), counted as a conversion. The Arrow view may come in its source dtype;
    the streamed fits cast it on the device (ops/ingest.py), in-core staging
    and transform here."""
    X = np.asarray(X)
    dt = np.float32 if float32 else np.float64
    if X.dtype == dt:
        return X
    from ..ops.ingest import count_conversion

    t0 = time.perf_counter()
    out = X.astype(dt)
    count_conversion(out.nbytes, time.perf_counter() - t0)
    return out


def require_finite_rows(X: Any, what: str, offset: int = 0) -> None:
    """Raise ValueError naming the first row of the (m, d) tensor X (on any
    device) with a NaN or infinite feature, its rows numbered from `offset`:
    one pass over X, before any kernel sees it."""
    import torch

    finite = torch.isfinite(X).all(dim=1)
    if not bool(finite.all()):
        row = offset + int((~finite).nonzero()[0, 0])
        raise ValueError(f"{what} row {row} has a NaN or infinite feature; the port takes finite features")


def ensure_id_col(dataset: Any, id_col_name: str, offset: int = 0) -> Any:
    """A pandas frame without the column `id_col_name` comes back as a copy
    with it, offset..offset+n-1 int64 (reference params.py:110-129
    `_ensureIdCol`); other inputs come back as they are, and their rows are
    numbered from offset too. Under a process group `offset` is the rank's
    global row offset, so the default ids are the global row numbers that one
    process would give the ranks' rows in rank order."""
    if _is_pandas_df(dataset) and id_col_name not in dataset.columns:
        dataset = dataset.copy()
        dataset[id_col_name] = np.arange(offset, offset + len(dataset), dtype=np.int64)
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
