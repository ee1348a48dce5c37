#
# PCA estimator/model of the PyTorch port (counterpart of the JAX package's
# models/feature.py; pyspark.ml.feature.PCA-compatible surface, reference
# python/src/spark_rapids_ml/feature.py):
#   * param mapping {k -> n_components} (reference feature.py:61-65)
#   * fit produces mean/components/explained_variance/singular_values attributes
#     (reference feature.py:260-285)
#   * transform projects raw rows for Spark parity (reference feature.py:438-451)
#

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core.backend_params import _TorchClass
from ..core.estimator import FitInputs, _TorchEstimator, _TorchModel
from ..core.params import HasInputCol, HasInputCols, HasOutputCol, Param, TypeConverters
from ..ops.pca import covariance_for_fit, pca_attrs_from_cov, pca_transform
from ..ops.streaming import streaming_covariance
from ..parallel.partitioner import resolve_batch_rows_per_process
from ..utils import span


class _PCAClass(_TorchClass):
    @classmethod
    def _param_mapping(cls):
        return {"k": "n_components", "inputCol": "", "inputCols": "", "outputCol": ""}

    @classmethod
    def _get_torch_params_default(cls) -> Dict[str, Any]:
        return {"n_components": None}

    @classmethod
    def _format_params_default(cls) -> Dict[str, Any]:
        return {"whiten": False}  # the JAX package's key; the port never whitens


class _PCAParams(HasInputCol, HasInputCols, HasOutputCol):
    k: Param[int] = Param(
        "undefined",
        "k",
        "the number of principal components (> 0).",
        TypeConverters.toInt,
    )

    def getK(self) -> int:
        return self.getOrDefault("k")

    def setInputCol(self, value: str) -> "_PCAParams":
        return self._set(inputCol=value)  # type: ignore[return-value]

    def setInputCols(self, value: List[str]) -> "_PCAParams":
        return self._set(inputCols=value)  # type: ignore[return-value]

    def setOutputCol(self, value: str) -> "_PCAParams":
        return self._set(outputCol=value)  # type: ignore[return-value]


class PCA(_PCAClass, _TorchEstimator, _PCAParams):
    """PCA estimator on one device (the card by default; `device="cpu"` asks for
    the CPU).

    Example
    -------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch.feature import PCA
    >>> X = np.random.rand(100, 8).astype(np.float32)
    >>> model = PCA(k=2, inputCol="features", device="cpu").fit(X)
    >>> out = model.transform(X)   # a 'pca_features' column
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(outputCol="pca_features")
        self.initialize_torch_params()
        self._set_params(**kwargs)

    def setK(self, value: int) -> "PCA":
        return self._set_params(k=value)  # type: ignore[return-value]

    def _get_torch_fit_func(self):
        k = self.getOrDefault("k")

        def _fit(inputs: FitInputs):
            if k > inputs.desc.n:
                raise ValueError(f"k={k} exceeds the number of features {inputs.desc.n}")
            with span("covariance"):
                cov, mean, wsum = covariance_for_fit(
                    inputs.features, inputs.row_weight, unit_weight=inputs.unit_weight,
                    part=inputs.partitioner,
                )
            with span("eigh"):  # and the attributes' copies to the host
                return pca_attrs_from_cov(cov, mean, wsum, k)

        return _fit

    def _create_pyspark_model(self, attrs: Dict[str, Any]) -> "PCAModel":
        return PCAModel(**attrs)

    def _streaming_fit(self, fd, device: torch.device, desc, part) -> Dict[str, Any]:
        """Out-of-core fit (ops/streaming.py), taken by core/estimator.py when
        the design matrix exceeds the stream threshold: the covariance is added
        batch by batch on the device (and across the ranks of `part`)."""
        k = self.getOrDefault("k")
        if k > desc.n:
            raise ValueError(f"k={k} exceeds the number of features {desc.n}")
        cov, mean, wsum = streaming_covariance(
            fd.features, fd.weight, resolve_batch_rows_per_process(part), device,
            float32=self._float32_inputs, part=part,
        )
        with span("eigh"):
            return pca_attrs_from_cov(cov, mean, wsum, k)


class PCAModel(_PCAClass, _TorchModel, _PCAParams):
    """Fitted PCA model (reference feature.py:288-459)."""

    def __init__(
        self,
        mean: np.ndarray,
        components: np.ndarray,
        explained_variance: np.ndarray,
        explained_variance_ratio: np.ndarray,
        singular_values: np.ndarray,
    ) -> None:
        super().__init__(
            mean=np.asarray(mean),
            components=np.asarray(components),
            explained_variance=np.asarray(explained_variance),
            explained_variance_ratio=np.asarray(explained_variance_ratio),
            singular_values=np.asarray(singular_values),
        )
        self._setDefault(outputCol="pca_features")

    @property
    def pc(self) -> np.ndarray:
        """Principal components as a (d, k) matrix, Spark's PCAModel.pc layout."""
        return self._model_attributes["components"].T

    @property
    def explainedVariance(self) -> np.ndarray:
        """Proportion of variance explained per component (Spark semantics)."""
        return self._model_attributes["explained_variance_ratio"]

    @property
    def mean(self) -> np.ndarray:
        return self._model_attributes["mean"]

    @property
    def components_(self) -> np.ndarray:
        return self._model_attributes["components"]

    @property
    def explained_variance_(self) -> np.ndarray:
        return self._model_attributes["explained_variance"]

    @property
    def singular_values_(self) -> np.ndarray:
        return self._model_attributes["singular_values"]

    def _transform_arrays(self, X: torch.Tensor) -> Dict[str, np.ndarray]:
        components = torch.tensor(self._model_attributes["components"], device=X.device)
        out = pca_transform(X, components.to(X.dtype))
        return {self.getOrDefault("outputCol"): out.cpu().numpy()}
