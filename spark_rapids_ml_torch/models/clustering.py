#
# KMeans estimator/model of the PyTorch port (counterpart of the JAX package's
# models/clustering.py; reference python/src/spark_rapids_ml/clustering.py:84-604):
#   * param mapping incl. tol=0 -> tiny epsilon (reference clustering.py:84-141)
#   * fit returns cluster centers + inertia + n_iter attributes, plus the
#     cluster sizes of the training summary (Spark KMeansSummary)
#

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.backend_params import HasFeaturesCols, _TorchClass
from ..core.dataset import require_finite_rows
from ..core.estimator import FitInputs, _TorchEstimator, _TorchModel
from ..core.params import (
    HasFeaturesCol,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
    HasTol,
    HasWeightCol,
    Param,
    TypeConverters,
)
from ..ops.kmeans import kmeans_fit, kmeans_predict
from ..ops.streaming import streaming_kmeans_fit
from ..parallel.partitioner import resolve_batch_rows_per_process
from ..utils import span


class _KMeansClass(_TorchClass):
    @classmethod
    def _param_mapping(cls):
        # reference clustering.py:84-141
        return {
            "k": "n_clusters",
            "maxIter": "max_iter",
            "tol": "tol",
            "initMode": "init",
            "initSteps": "init_steps",
            "seed": "random_state",
            "distanceMeasure": "metric",
            "featuresCol": "",
            "predictionCol": "",
            "weightCol": "",
            "solver": None,
            "maxBlockSizeInMB": None,
        }

    @classmethod
    def _param_value_mapping(cls):
        # tol=0 would spin max_iter rounds; remap to a tiny epsilon like the reference
        return {
            "tol": lambda x: 1.0e-16 if x == 0 else float(x),
            "init": lambda x: (
                x if x in ("k-means||", "scalable-k-means++", "random") else None
            ),
            "metric": lambda x: x if x in ("euclidean", "cosine") else None,
        }

    @classmethod
    def _get_torch_params_default(cls) -> Dict[str, Any]:
        return {
            "n_clusters": 8,
            "max_iter": 300,
            "tol": 1e-4,
            "init": "k-means||",
            "init_steps": 2,
            "random_state": 1,
            "metric": "euclidean",
        }

    @classmethod
    def _format_params_default(cls) -> Dict[str, Any]:
        return {"n_init": 1}  # the JAX package's key; one init, Spark's

    def _check_supported(self) -> None:
        super()._check_supported()  # type: ignore[misc]
        if not self._float32_inputs:  # type: ignore[attr-defined]
            raise NotImplementedError(
                "KMeans with float32_inputs=False (f64 features) is not ported to the "
                "PyTorch backend yet: its Lloyd and assignment kernels take f32"
            )


class _KMeansParams(
    HasFeaturesCol, HasFeaturesCols, HasPredictionCol, HasMaxIter, HasTol, HasSeed, HasWeightCol
):
    k: Param[int] = Param(
        "undefined", "k", "The number of clusters to create. Must be > 1.", TypeConverters.toInt
    )
    initMode: Param[str] = Param(
        "undefined",
        "initMode",
        "The initialization algorithm. Supported options: 'k-means||' and 'random'.",
        TypeConverters.toString,
    )
    initSteps: Param[int] = Param(
        "undefined",
        "initSteps",
        "The number of steps for k-means|| initialization mode. Must be > 0.",
        TypeConverters.toInt,
    )
    distanceMeasure: Param[str] = Param(
        "undefined",
        "distanceMeasure",
        "the distance measure. Supported options: 'euclidean' and 'cosine'.",
        TypeConverters.toString,
    )
    solver: Param[str] = Param(
        "undefined",
        "solver",
        "The solver algorithm for optimization. Supported options: 'auto', 'row', 'block'.",
        TypeConverters.toString,
    )
    maxBlockSizeInMB: Param[float] = Param(
        "undefined",
        "maxBlockSizeInMB",
        "Maximum memory in MB for stacking input data into blocks.",
        TypeConverters.toFloat,
    )

    def getK(self) -> int:
        return self.getOrDefault("k")

    def setFeaturesCol(self, value: str):
        return self._set(featuresCol=value)

    def setPredictionCol(self, value: str):
        return self._set(predictionCol=value)


class KMeans(_KMeansClass, _TorchEstimator, _KMeansParams):
    """KMeans on one device (the card by default; `device="cpu"` asks for the
    CPU): Lloyd iterations through the fused Lloyd kernel.

    Example
    -------
    >>> from spark_rapids_ml_torch.clustering import KMeans
    >>> model = KMeans(k=4, device="cpu").fit(X)
    >>> model.transform(X)   # a 'prediction' column
    """

    # Spark's KMeans validator requires k > 1 (pyspark ParamValidators.gt(1))
    _PARAM_BOUNDS_EXTRA = {"k": (2, None)}

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(
            featuresCol="features",
            predictionCol="prediction",
            k=2,
            maxIter=20,
            tol=1e-4,
            initMode="k-means||",
            initSteps=2,
            seed=1,
            distanceMeasure="euclidean",
            solver="auto",
            maxBlockSizeInMB=0.0,
        )
        self.initialize_torch_params()
        self._set_params(**kwargs)

    def setK(self, value: int) -> "KMeans":
        return self._set_params(k=value)  # type: ignore[return-value]

    def setMaxIter(self, value: int) -> "KMeans":
        return self._set_params(maxIter=value)  # type: ignore[return-value]

    def _get_torch_fit_func(self):
        p = dict(self._torch_params)

        def _fit(inputs: FitInputs):
            k = int(p["n_clusters"])
            if k > inputs.desc.m:
                raise ValueError(f"k={k} exceeds the number of rows {inputs.desc.m}.")
            # a NaN row would make k-means|| draw from NaN probabilities
            require_finite_rows(inputs.features, "KMeans input")
            metric = str(p["metric"])
            res = kmeans_fit(
                inputs.features,
                inputs.row_weight,
                k=k,
                max_iter=int(p["max_iter"]),
                tol=float(p["tol"]),
                init=str(p["init"]),
                init_steps=int(p["init_steps"]),
                seed=int(p["random_state"]) if p["random_state"] is not None else 1,
                metric=metric,
                unit_weight=inputs.unit_weight,
                part=inputs.partitioner,
                offset=inputs.desc.offset,
                n_global=inputs.desc.m,
            )
            # one assignment pass for the training summary's clusterSizes: all
            # rows, weight-0 rows included (Spark's groupBy(prediction).count())
            with span("summary"):
                centers = torch.as_tensor(res["cluster_centers"], device=inputs.device)
                labels = kmeans_predict(inputs.features, centers, metric)
                sizes = torch.bincount(labels.long(), minlength=k)
                if inputs.partitioner is not None:
                    (sizes,) = inputs.partitioner.all_reduce_sum(sizes)
                res["cluster_sizes"] = sizes.cpu().numpy().astype(np.int64)
            return res

        return _fit

    def _create_pyspark_model(self, attrs: Dict[str, Any]) -> "KMeansModel":
        return KMeansModel(**attrs)

    def _streaming_fit(self, fd, device: torch.device, desc, part) -> Dict[str, Any]:
        """Out-of-core exact Lloyd (ops/streaming.py), taken by
        core/estimator.py when the design matrix exceeds the stream threshold.
        As in the JAX package, the streamed fit returns no cluster sizes: its
        model has no training summary."""
        p = self._torch_params
        k = int(p["n_clusters"])
        if k > desc.m:
            raise ValueError(f"k={k} exceeds the number of rows {desc.m}.")
        return streaming_kmeans_fit(
            fd.features,
            fd.weight,
            k=k,
            max_iter=int(p["max_iter"]),
            tol=float(p["tol"]),
            seed=int(p["random_state"]) if p["random_state"] is not None else 1,
            batch_rows=resolve_batch_rows_per_process(part),
            device=device,
            metric=str(p["metric"]),
            part=part,
            offset=desc.offset,
            n_global=desc.m,
        )


class KMeansSummary:
    """Training summary surface of pyspark.ml.clustering.KMeansSummary."""

    def __init__(
        self, k: int, cluster_sizes: np.ndarray, training_cost: float, num_iter: int
    ) -> None:
        self.k = int(k)
        self.clusterSizes = [int(s) for s in cluster_sizes]
        self.trainingCost = float(training_cost)
        self.numIter = int(num_iter)


class KMeansModel(_KMeansClass, _TorchModel, _KMeansParams):
    """Fitted KMeans model (reference clustering.py:459-604)."""

    def __init__(
        self,
        cluster_centers: np.ndarray,
        inertia: float,
        n_iter: int,
        cluster_sizes: Optional[np.ndarray] = None,
    ) -> None:
        super().__init__(
            cluster_centers=np.asarray(cluster_centers),
            inertia=float(inertia),
            n_iter=int(n_iter),
            cluster_sizes=(
                np.asarray(cluster_sizes) if cluster_sizes is not None else None
            ),
        )
        self._setDefault(
            featuresCol="features",
            predictionCol="prediction",
            distanceMeasure="euclidean",
        )

    def clusterCenters(self) -> List[np.ndarray]:
        """Spark MLlib KMeansModel surface."""
        return list(self._model_attributes["cluster_centers"])

    @property
    def hasSummary(self) -> bool:
        """True on a freshly-fit model."""
        return (
            self._has_training_summary
            and self._model_attributes.get("cluster_sizes") is not None
        )

    @property
    def summary(self) -> KMeansSummary:
        """KMeansSummary (k, clusterSizes, trainingCost, numIter)."""
        if not self.hasSummary:
            raise RuntimeError(
                f"No training summary available for this {self.__class__.__name__}"
            )
        a = self._model_attributes
        return KMeansSummary(
            k=a["cluster_centers"].shape[0],
            cluster_sizes=a["cluster_sizes"],
            training_cost=a["inertia"],
            num_iter=a["n_iter"],
        )

    @property
    def cluster_centers_(self) -> np.ndarray:
        return self._model_attributes["cluster_centers"]

    @property
    def inertia_(self) -> float:
        return self._model_attributes["inertia"]

    def predict(self, value: np.ndarray) -> int:
        """Single-vector prediction (Spark API)."""
        X = torch.as_tensor(np.asarray(value, dtype=np.float32).reshape(1, -1), device=self.device)
        return int(self._transform_arrays(X)[self.getOrDefault("predictionCol")][0])

    def _transform_arrays(self, X: torch.Tensor) -> Dict[str, np.ndarray]:
        centers = torch.tensor(self.cluster_centers_, dtype=X.dtype, device=X.device)
        pred = kmeans_predict(X, centers, self.getOrDefault("distanceMeasure"))
        return {self.getOrDefault("predictionCol"): pred.cpu().numpy()}
