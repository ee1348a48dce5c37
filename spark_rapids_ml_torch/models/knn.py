#
# Exact k-NN estimator/model of the PyTorch port (counterpart of the exact half
# of the JAX package's models/knn.py; reference spark_rapids_ml.knn,
# knn.py:76-835):
#   * NearestNeighbors.fit() stores the item set, its user ids and its squared
#     norms, computed once on the device and cached (reference knn.py:347-367:
#     no other compute at fit);
#   * NearestNeighborsModel.kneighbors() runs the exact search on the model's
#     device through ops/knn.py::exact_knn_single (the top-k kernel on the
#     card) and returns Euclidean distances and user item ids. The config key
#     knn_precision picks the scan's form once per call: float32 (exact), or
#     bfloat16 / int8, which rank an oversampled pool that an exact f32
#     re-rank cuts back to k (exact distances, approximate id set); their
#     bf16 or int8 copy of the items is made at the first search in that form
#     and kept with the staged items (8,388,608 x 256 items: 4.3 GB bf16,
#     2.1 GB int8 beside the 8.6 GB of f32 items the re-rank reads);
#   * a query row with a NaN or infinite feature raises ValueError before any
#     kernel runs: its distances would all be NaN, and the JAX package fails
#     on it too;
#   * exactNearestNeighborsJoin() flattens that into (query id, item id,
#     distance) rows (reference knn.py:435-482); a slot naming no real item
#     (id -1) or with a non-finite distance is dropped.
#
# Across processes (parallel/partitioner.py): under a process group each rank
# calls fit() with its own items, and the model is distributed, as the
# reference's item_df is: each rank keeps its shard, its ids and norms, and
# the group's layout (one all-gather at fit). The default ids (a frame without
# the id column, or numpy input) are the global row numbers, items and
# queries alike. kneighbors() and exactNearestNeighborsJoin() are then
# collective calls: each rank passes its own queries (none at all is fine) and
# gets their neighbors among every rank's items, by the all-gather merge below
# _RING_QUERY_THRESHOLD global queries and by the ring at or above it
# (ops/knn.py); one all-gather of every rank's (query count, non-finite flag,
# no room for the ring) picks the route, so every rank takes the same one, and
# a non-finite query on any rank raises ValueError on every rank (a rank short
# of memory for the ring, MemoryError). k is clamped to the global item
# count. A model built by `from_attributes` holds all its items in each
# process; under a group its search raises NotImplementedError, before any
# collective.
#
# In-core (the items' f32 bytes at or below config.stream_threshold_bytes) the
# items stay on the device between calls: fit stages them once, and a model
# built from attributes stages them at its first search; a search that does
# not fit the card raises MemoryError. Above the threshold, in one process,
# the items stay on the host (the JAX package's out-of-core tier): fit
# computes their squared norms a tile at a time and stages nothing, and each
# search streams the item tiles through the top-k kernel
# (ops/pairwise_streaming.py::streaming_exact_knn), reading the stored norms,
# in exact f32 whatever knn_precision says; a model built from attributes
# streams too. Rows a carried `item_valid` marks dead are left out of the
# stream by a host gather, as in the JAX package.
#
# Not ported: ApproximateNearestNeighbors (IVF-Flat, IVF-PQ, CAGRA), the
# streamed ring under a process group (a distributed model keeps its in-core
# routes whatever the size), the mesh variants of the JAX package's streamed
# tier, the incremental tier (add_items / delete_items /
# compact_items; a carried `item_valid` mask is honored), serving,
# persistence (the estimator is not persistable, as in the reference; the
# JAX package saves its model through the ANN index store, not ported, so
# the port's model refuses to write or read); k above the kernel's K_MAX
# raises (above 205 in a narrow form, whose pool of k + max(8, k // 4) must
# fit K_MAX).
#

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from .. import config as _config
from ..core.backend_params import HasFeaturesCols, HasIDCol, _TorchClass
from ..core.dataset import (
    _is_pandas_df,
    empty_partition,
    ensure_dtype,
    extract_feature_data,
    require_finite_rows,
)
from ..core.estimator import _TorchEstimator, _TorchModel, stage
from ..core.params import HasInputCol, Param, ParamMap, TypeConverters
from ..ops import ingest
from ..ops.knn import center_norms_sq, exact_knn_distributed, exact_knn_ring, exact_knn_single
from ..ops.pairwise_streaming import streaming_exact_knn, streaming_norms
from ..ops.selection import resolve_fused_precision
from ..ops.topk import narrow_rows
from ..parallel.partition import PartitionDescriptor
from ..parallel.partitioner import Partitioner, active_partitioner
from ..utils import span

# at or above this many queries over the group the search takes the ring,
# below it the all-gather merge (the JAX package's threshold)
_RING_QUERY_THRESHOLD = 65536


class _NNParams(HasInputCol, HasFeaturesCols, HasIDCol):
    k: Param[int] = Param(
        "undefined", "k", "number of nearest neighbors to retrieve (> 0).",
        TypeConverters.toInt,
    )

    def getK(self) -> int:
        return self.getOrDefault("k")

    def setK(self, value: int):
        return self._set_params(k=value)

    def setInputCol(self, value: str):
        return self._set(inputCol=value)


def _extract_rows(est: Any, dataset: Any, part: Partitioner, width: int = 0):
    """The rows of `dataset` in f32, with their user ids where the input has
    the id column (else row_id is None: the caller numbers the rows). Under a
    process group an empty frame is this rank's empty partition, of `width`
    columns (0: the group's width, which the caller takes from the layout)."""
    id_col = est._id_col_name()
    if _is_pandas_df(dataset) and id_col not in dataset.columns:
        id_col = None  # numbered by the caller
    empty = empty_partition(dataset, part.is_multiprocess, np.float32, width,
                            row_id=id_col is not None)
    if empty is not None:
        return empty
    input_col, input_cols = est._get_input_columns()
    fd = extract_feature_data(dataset, input_col=input_col, input_cols=input_cols,
                              id_col=id_col, float32=True)
    fd.features = ensure_dtype(fd.features)
    return fd


class _NearestNeighborsClass(_TorchClass):
    @classmethod
    def _param_mapping(cls):
        return {"k": "n_neighbors", "inputCol": "", "featuresCols": "", "idCol": ""}

    @classmethod
    def _get_torch_params_default(cls) -> Dict[str, Any]:
        return {"n_neighbors": 5}

    def _check_supported(self) -> None:
        super()._check_supported()  # type: ignore[misc]
        if not self._float32_inputs:  # type: ignore[attr-defined]
            raise NotImplementedError(
                "NearestNeighbors with float32_inputs=False (f64 features) is not "
                "ported to the PyTorch backend: its top-k kernel takes f32"
            )


def _check_fits(device: torch.device, nbytes: int) -> None:
    """Raise when `nbytes` more would not fit the card's free memory: the
    in-core route's limit."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        if nbytes > free:
            raise MemoryError(
                f"the kNN item set needs {nbytes / 2**30:.2f} GiB on {device}, "
                f"{free / 2**30:.2f} GiB are free for the in-core search"
            )


def _streams(device: torch.device, nbytes: int, part: Partitioner) -> bool:
    """Whether an item set of `nbytes` f32 bytes takes the out-of-core route:
    above the stream threshold, in one process (module header)."""
    threshold = _config.stream_threshold_bytes(device)
    return not part.is_multiprocess and bool(threshold) and nbytes > threshold


class NearestNeighbors(_NearestNeighborsClass, _TorchEstimator, _NNParams):
    """Exact k-NN on one device (the card by default; `device="cpu"` asks for
    the CPU), or across the ranks of a process group, each holding its share
    of the items (module header). fit() stores the items; kneighbors()
    searches them.

    Example
    -------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch.knn import NearestNeighbors
    >>> X = np.random.rand(500, 8).astype(np.float32)
    >>> model = NearestNeighbors(k=3, inputCol="features", device="cpu").fit(X)
    >>> _, _, knn_df = model.kneighbors(X[:4])   # query ids, indices, distances
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(k=5)
        self.initialize_torch_params()
        self._set_params(**kwargs)

    def _get_torch_fit_func(self):
        raise NotImplementedError("NearestNeighbors.fit stores the items; no kernel runs.")

    def _create_pyspark_model(self, attrs: Dict[str, Any]) -> "NearestNeighborsModel":
        return NearestNeighborsModel(**attrs)

    def fit(self, dataset: Any, params: Optional[ParamMap] = None) -> "NearestNeighborsModel":
        if params is not None:
            return self.copy(params).fit(dataset)
        self._validate_param_bounds()
        self._check_supported()
        device = self.device
        part = active_partitioner()
        with span("extract"):
            fd = _extract_rows(self, dataset, part)
        layout = part.descriptor(fd.n_rows, fd.n_cols)
        if layout.m == 0:
            raise RuntimeError("Fit input is empty.")
        items = fd.features.reshape(fd.n_rows, layout.n)
        dataset = self._ensureIdCol(dataset, layout.offset)
        streamed = _streams(device, items.nbytes, part)
        if streamed:
            with span("norms"):  # a tile at a time; the items stay on the host
                x2 = streaming_norms(items, device)
        else:
            _check_fits(device, items.nbytes + 12 * fd.n_rows)
            with span("stage"):
                X = stage(items, device)
            with span("norms"):  # Σ X², once: no search recomputes it
                x2 = center_norms_sq(X)
        model = NearestNeighborsModel(
            item_features=items,
            item_ids=(fd.row_id if fd.row_id is not None
                      else np.arange(layout.offset, layout.offset + fd.n_rows, dtype=np.int64)),
            item_norms_sq=x2 if streamed else x2.cpu().numpy(),
            item_df=dataset,
        )
        if not streamed:
            model._staged = (device, X, x2, None)
        model._layout = layout if part.is_multiprocess else None
        self._copyValues(model)
        return model

    def write(self):
        raise NotImplementedError("NearestNeighbors is not persistable (reference knn.py:384-408).")


_MODEL_NOT_PERSISTABLE = (
    "NearestNeighborsModel is not persistable in the port: the JAX package saves it through "
    "its ANN index store, which is not ported")


class NearestNeighborsModel(_NearestNeighborsClass, _TorchModel, _NNParams):
    def __init__(
        self,
        item_features: np.ndarray,
        item_ids: np.ndarray,
        item_df: Any = None,
        item_norms_sq: Optional[np.ndarray] = None,
        item_valid: Optional[np.ndarray] = None,
    ) -> None:
        attrs = dict(item_features=item_features, item_ids=item_ids)
        if item_norms_sq is not None:
            attrs["item_norms_sq"] = np.asarray(item_norms_sq, np.float32)
        if item_valid is not None:  # the JAX package's incremental tier
            attrs["item_valid"] = np.asarray(item_valid, bool)
        super().__init__(**attrs)
        self._item_df = item_df
        self._setDefault(k=5)
        self.initialize_torch_params()
        # (device, items, norms, valid or None) on the device of the last search
        self._staged: Optional[Tuple[torch.device, torch.Tensor, torch.Tensor, Any]] = None
        # the narrow forms' item operands for the staged items, by form
        self._narrow: Dict[str, Any] = {}
        # the group's item layout when the model was fit across ranks: the
        # items are then this rank's shard (module header)
        self._layout: Optional[PartitionDescriptor] = None
        self._ids_dev: Optional[torch.Tensor] = None

    def _transform_arrays(self, X: torch.Tensor) -> Dict[str, np.ndarray]:
        raise NotImplementedError("Use kneighbors() / exactNearestNeighborsJoin().")

    def write(self):
        raise NotImplementedError(_MODEL_NOT_PERSISTABLE)

    @classmethod
    def read(cls):
        raise NotImplementedError(_MODEL_NOT_PERSISTABLE)

    def _items_on(self, device: torch.device):
        """The items, their norms and their valid mask on `device`, staged once."""
        if self._staged is None or self._staged[0] != device:
            a = self._model_attributes
            items = ensure_dtype(np.asarray(a["item_features"]))
            self._staged = None  # let a copy on another device go first
            _check_fits(device, items.nbytes + 4 * len(items))
            with span("stage"):
                X = stage(items, device)
                x2 = a.get("item_norms_sq")
                x2 = center_norms_sq(X) if x2 is None else stage(np.asarray(x2, np.float32), device)
                valid = a.get("item_valid")
                valid = None if valid is None else stage(np.asarray(valid, bool), device)
            self._staged = (device, X, x2, valid)
            self._narrow = {}
        return self._staged[1:]

    def _narrow_items(self, precision: str):
        """The staged items' operand of a narrow form, made once a form."""
        if precision == "float32":
            return None
        if precision not in self._narrow:
            X = self._staged[1]
            nbytes = X.shape[0] * (-(-X.shape[1] // 8) * 16 if precision == "bfloat16"
                                   else -(-X.shape[1] // 16) * 16 + 4)
            _check_fits(X.device, nbytes)
            with span("narrow_items", precision=precision):
                self._narrow[precision] = narrow_rows(X, precision)
        return self._narrow[precision]

    def _search(self, query_df: Any):
        """(query_df with its id column, query ids, item ids (nq, k), Euclidean
        distances (nq, k)) of the k nearest items of each query row; under a
        process group, of this rank's query rows among every rank's items (a
        collective call)."""
        self._validate_param_bounds()
        self._check_supported()
        device = self.device
        part = active_partitioner()
        layout = self._layout
        ranks = 1 if layout is None else len(layout.parts_rank_size)
        if part.process_count != ranks:
            raise NotImplementedError(
                f"this NearestNeighborsModel holds the items of {ranks} process(es) (a model "
                "built from attributes holds them all): search it under the group it was fit "
                f"in, not under {part.process_count} process(es)"
            )
        with span("extract"):
            fd = _extract_rows(self, query_df, part,
                               np.shape(self._model_attributes["item_features"])[1])
        Qh = fd.features
        precision = resolve_fused_precision()
        if layout is None and _streams(
                device, 4 * np.size(self._model_attributes["item_features"]), part):
            query_df = self._ensureIdCol(query_df)
            ids, d2 = self._search_streamed(Qh, device)
            query_ids = fd.row_id if fd.row_id is not None else np.arange(fd.n_rows, dtype=np.int64)
            return query_df, query_ids, ids, np.sqrt(d2)
        X, x2, valid = self._items_on(device)
        with span("stage"):
            Q = stage(Qh, device)
            if valid is None:
                valid = torch.ones((X.shape[0],), dtype=torch.bool, device=device)
        if layout is None:
            require_finite_rows(Q, "kNN query")
            query_df = self._ensureIdCol(query_df)
            items = self._narrow_items(precision)
            d2, idx = exact_knn_single(Q, X, valid, self.getK(), x2=x2, precision=precision,
                                       items=items)
            with span("select"):  # the read back to the host, charged to the search
                d2, idx = d2.cpu().numpy(), idx.cpu().numpy()
            # a deleted item of a carried model names id -1, as in the JAX package
            ids = np.asarray(self._model_attributes["item_ids"])[idx]
            q0 = 0
        else:
            # the ring holds two padded shards (the one held, the one arriving)
            shard = max(r for _, r in layout.parts_rank_size)
            ring_bytes = 2 * shard * (4 * layout.n + 13) + 12 * Q.shape[0] * self.getK()
            short = device.type == "cuda" and ring_bytes > torch.cuda.mem_get_info(device)[0]
            bad = not bool(torch.isfinite(Q).all())
            # one all-gather: every rank takes the same route, or raises
            shapes = part.all_gather_ints(Q.shape[0], bad, short)
            if any(flag for _, flag, _ in shapes):
                require_finite_rows(Q, "kNN query")
                raise ValueError("a kNN query row of another rank has a NaN or infinite feature; "
                                 "the port takes finite features")
            query_rows = [r for r, _, _ in shapes]
            q0 = sum(query_rows[: part.process_index])
            query_df = self._ensureIdCol(query_df, q0)
            if sum(query_rows) >= _RING_QUERY_THRESHOLD:
                if any(low for _, _, low in shapes):
                    _check_fits(device, ring_bytes)
                    raise MemoryError("another rank has no room for the kNN ring's two padded "
                                      f"item shards of {shard} rows")
                d2, ids = exact_knn_ring(Q, X, valid, self.getK(), part, layout, x2=x2,
                                         ids=self._ids_on(device))
            else:
                d2, ids = exact_knn_distributed(
                    Q, X, valid, self.getK(), part, layout, x2=x2, precision=precision,
                    items=self._narrow_items(precision) if X.shape[0] else None,
                    ids=self._ids_on(device), query_rows=query_rows)
            with span("select"):
                d2, ids = d2.cpu().numpy(), ids.cpu().numpy()
        query_ids = (fd.row_id if fd.row_id is not None
                     else np.arange(q0, q0 + fd.n_rows, dtype=np.int64))
        return query_df, query_ids, ids, np.sqrt(d2)

    def _search_streamed(self, Qh: np.ndarray, device: torch.device
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(item ids, squared distances) of the out-of-core search: the
        items stay on the host and stream a tile at a time, with their stored
        norms (module header)."""
        a = self._model_attributes
        items = ensure_dtype(np.asarray(a["item_features"]))
        item_ids = np.asarray(a["item_ids"])
        x2 = a.get("item_norms_sq")
        x2 = None if x2 is None else np.asarray(x2, np.float32)
        if a.get("item_valid") is not None:
            # the stream has no valid operand: a host gather of the live rows
            live = np.asarray(a["item_valid"], bool)
            items, item_ids = np.ascontiguousarray(items[live]), item_ids[live]
            x2 = None if x2 is None else x2[live]
        require_finite_rows(ingest.host_tensor(np.ascontiguousarray(Qh)), "kNN query")
        d2, pos = streaming_exact_knn(Qh, items, self.getK(), device, norms=x2)
        return np.where(pos >= 0, item_ids[np.maximum(pos, 0)], -1), d2

    def _ids_on(self, device: torch.device) -> torch.Tensor:
        """The shard's user ids on `device` (int64), staged once."""
        if self._ids_dev is None or self._ids_dev.device != device:
            self._ids_dev = torch.tensor(np.asarray(self._model_attributes["item_ids"]),
                                         dtype=torch.int64, device=device)
        return self._ids_dev

    def kneighbors(self, query_df: Any) -> Tuple[Any, Any, pd.DataFrame]:
        """(item_df, query_df, knn_df): knn_df has the query ids and, per query,
        arrays of the k nearest items' ids and Euclidean distances (reference
        knn.py:574-660). k is clamped to the number of items."""
        query_df, query_ids, ids, dist = self._search(query_df)
        with span("output"):
            knn_df = pd.DataFrame({
                f"query_{self.getIdCol()}": query_ids,
                "indices": list(ids),
                "distances": list(dist),
            })
        return self._item_df, query_df, knn_df

    def exactNearestNeighborsJoin(self, query_df: Any, distCol: str = "distCol") -> pd.DataFrame:
        """Flattened (query id, item id, distance) rows, query by query in
        neighbor order (reference knn.py:435-482). Slots naming no real item
        (id -1) or with a non-finite distance are dropped."""
        _, query_ids, ids, dist = self._search(query_df)
        id_col = self.getIdCol()
        with span("output"):
            keep = (ids >= 0) & np.isfinite(dist)
            return pd.DataFrame({
                f"query_{id_col}": np.broadcast_to(query_ids[:, None], ids.shape)[keep],
                f"item_{id_col}": ids[keep],
                distCol: dist[keep],
            })
