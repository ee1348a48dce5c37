#
# DBSCAN estimator/model of the PyTorch port (counterpart of the JAX package's
# models/dbscan.py; reference spark_rapids_ml.clustering.DBSCAN,
# clustering.py:607-1186):
#   * fit() does no compute: it returns a model carrying the params; the
#     clustering runs at transform() time on the rows it is given (reference
#     clustering.py:904-918, "_fit returns empty model")
#   * int64 labels, noise -1
#   * under a process group (parallel/bootstrap.py) each rank passes its own
#     rows to transform(), which clusters every rank's rows together through
#     the ring of ops/dbscan.py (the rows' global offsets from
#     Partitioner.descriptor) and returns each rank its own rows' labels, in
#     the global first-appearance compaction; an empty rank passes an empty
#     frame and takes part in every collective
#   * save/load in the JAX package's directory format (core/persistence.py):
#     the model has no fitted state and writes an empty attributes.json
#
#   * out-of-core (one process): when the rows' f32 bytes exceed
#     config.stream_threshold_bytes, transform() keeps them on the host and
#     clusters them through ops/pairwise_streaming.py (the count kernel and the
#     min-label scan a tile at a time), before anything is staged
#
# Not ported: f64 features (raise NotImplementedError on every rank, before
# any collective), the streamed ring under a process group (a group keeps the
# in-core ring whatever the size), the mesh variants of the JAX package's
# streamed tier, the sklearn twin.
#

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import config as _config
from ..core.backend_params import HasFeaturesCols, HasIDCol, _TorchClass
from ..core.estimator import _TorchEstimator, _TorchModel
from ..core.params import HasFeaturesCol, HasPredictionCol, Param, ParamMap, TypeConverters
from ..ops.dbscan import dbscan_fit_predict
from ..ops.pairwise_streaming import streaming_dbscan_fit_predict
from ..parallel.partitioner import active_partitioner


class _DBSCANClass(_TorchClass):
    @classmethod
    def _param_mapping(cls):
        return {
            "eps": "eps",
            "min_samples": "min_samples",
            "metric": "metric",
            "max_mbytes_per_batch": "max_mbytes_per_batch",
            # cuML's 'algorithm' selects brute vs rbc neighbor search, both exact;
            # the port always runs the blocked brute scan
            "algorithm": "algorithm",
            "featuresCol": "",
            "featuresCols": "",
            "predictionCol": "",
            "idCol": "",
        }

    @classmethod
    def _param_value_mapping(cls):
        return {
            "metric": lambda x: x if x in ("euclidean", "cosine") else None,
            "algorithm": lambda x: x if x in ("brute", "rbc") else None,
        }

    @classmethod
    def _get_torch_params_default(cls) -> Dict[str, Any]:
        return {
            "eps": 0.5,
            "min_samples": 5,
            "metric": "euclidean",
            "max_mbytes_per_batch": None,
            "algorithm": "brute",
        }

    def _check_supported(self) -> None:
        super()._check_supported()  # type: ignore[misc]
        if not self._float32_inputs:  # type: ignore[attr-defined]
            raise NotImplementedError(
                "DBSCAN with float32_inputs=False (f64 features) is not ported to the "
                "PyTorch backend yet: its count kernel takes f32"
            )


class _DBSCANParams(HasFeaturesCol, HasFeaturesCols, HasPredictionCol, HasIDCol):
    eps: Param[float] = Param(
        "undefined",
        "eps",
        "The maximum distance between two samples for one to be considered as in the "
        "neighborhood of the other.",
        TypeConverters.toFloat,
    )
    min_samples: Param[int] = Param(
        "undefined",
        "min_samples",
        "The number of samples in a neighborhood for a point to be considered as a "
        "core point (including the point itself).",
        TypeConverters.toInt,
    )
    metric: Param[str] = Param(
        "undefined", "metric", "Distance metric (euclidean|cosine).",
        TypeConverters.toString,
    )
    max_mbytes_per_batch: Param[int] = Param(
        "undefined",
        "max_mbytes_per_batch",
        "Batch size cap for the pairwise-distance computation.",
        TypeConverters.toInt,
    )
    algorithm: Param[str] = Param(
        "undefined", "algorithm",
        "Neighbor-search algorithm ('brute' or 'rbc'; both exact, the port always "
        "runs the blocked brute scan).",
        TypeConverters.toString,
    )

    def _set_defaults(self) -> None:
        self._setDefault(
            featuresCol="features",
            predictionCol="prediction",
            eps=0.5,
            min_samples=5,
            metric="euclidean",
            algorithm="brute",
        )

    def setFeaturesCol(self, value: str):
        return self._set(featuresCol=value)


class DBSCAN(_DBSCANClass, _TorchEstimator, _DBSCANParams):
    """Density-based clustering on one device (the card by default;
    `device="cpu"` asks for the CPU). fit() only checks the params; transform()
    clusters the rows it is given, under a process group every rank's rows.

    Example
    -------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch.clustering import DBSCAN
    >>> X = np.random.rand(500, 3).astype(np.float32)
    >>> model = DBSCAN(eps=0.1, min_samples=5, device="cpu").fit(X)
    >>> model.transform(X)   # a 'prediction' column, noise -1
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_defaults()
        self.initialize_torch_params()
        self._set_params(**kwargs)

    def _get_torch_fit_func(self):
        raise NotImplementedError("DBSCAN defers all compute to transform().")

    def _create_pyspark_model(self, attrs: Dict[str, Any]) -> "DBSCANModel":
        return DBSCANModel()

    def fit(self, dataset: Any, params: Optional[ParamMap] = None) -> "DBSCANModel":
        """No compute (reference clustering.py:904-918); bad params still fail
        here, not inside the deferred transform."""
        if params is not None:
            return self.copy(params).fit(dataset)
        self._validate_param_bounds()
        self._check_supported()
        model = DBSCANModel()
        self._copyValues(model)
        return model


class DBSCANModel(_DBSCANClass, _TorchModel, _DBSCANParams):
    # transform() is collective under a process group
    _collective_transform = True

    def __init__(self) -> None:
        super().__init__()
        self._set_defaults()
        self.initialize_torch_params()

    def _transform_host(self, X: np.ndarray, device: torch.device
                        ) -> Optional[Dict[str, np.ndarray]]:
        """The out-of-core transform (module header) when the rows exceed the
        stream threshold in one process; else None, and they are staged."""
        threshold = _config.stream_threshold_bytes(device)
        if active_partitioner().is_multiprocess or not threshold or X.nbytes <= threshold:
            return None
        labels = streaming_dbscan_fit_predict(
            X, eps=self.getOrDefault("eps"), min_samples=self.getOrDefault("min_samples"),
            device=device, metric=self.getOrDefault("metric"),
        )
        return {self.getOrDefault("predictionCol"): labels}

    def _transform_arrays(self, X: torch.Tensor) -> Dict[str, np.ndarray]:
        part = active_partitioner()
        layout = None
        if part.is_multiprocess:
            layout = part.descriptor(X.shape[0], X.shape[1])
            if X.shape[0] == 0:  # this rank's empty partition, at the group's width
                X = X.reshape(0, layout.n)
        valid = torch.ones((X.shape[0],), dtype=torch.bool, device=X.device)
        labels = dbscan_fit_predict(
            X, valid,
            eps=self.getOrDefault("eps"),
            min_samples=self.getOrDefault("min_samples"),
            metric=self.getOrDefault("metric"),
            part=part, layout=layout,
        )
        return {self.getOrDefault("predictionCol"): labels}
