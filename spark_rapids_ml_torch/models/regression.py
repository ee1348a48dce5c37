#
# LinearRegression estimator/model of the PyTorch port (counterpart of the JAX
# package's models/regression.py; pyspark.ml.regression.LinearRegression-
# compatible surface, reference python/src/spark_rapids_ml/regression.py:181-863):
#   * param mapping incl. regParam -> alpha, elasticNetParam -> l1_ratio,
#     standardization -> normalize (reference regression.py:183-215)
#   * solver dispatch by regularization: closed-form L2 or FISTA elastic net
#     (ops/linear.py), from one normal-equation pass over X
#   * 1-feature inputs are supported (no cuML dim == 1 limit here)
#
# Saved and loaded in the JAX package's directory format (core/persistence.py).
#
# Not ported: loss="huber" (raises NotImplementedError at fit), fitMultiple at
# the estimator level (ops/linear.py::solve_from_stats takes extra param sets),
# sparse input and the sklearn twin. The streamed fit
# (ops/streaming.py::streaming_linreg_stats) takes over when the design matrix
# exceeds the stream threshold (core/estimator.py).
#

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.backend_params import HasFeaturesCols, _TorchClass
from ..core.estimator import FitInputs, _TorchEstimatorSupervised, _TorchModel
from ..core.params import (
    HasElasticNetParam,
    HasFeaturesCol,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasRegParam,
    HasSolver,
    HasStandardization,
    HasTol,
    HasWeightCol,
    Param,
    TypeConverters,
)
from ..ops.linear import linreg_fit, linreg_predict, solve_from_stats
from ..ops.streaming import streaming_linreg_stats
from ..parallel.partitioner import resolve_batch_rows_per_process
from ..utils import span


class _LinearRegressionClass(_TorchClass):
    @classmethod
    def _param_mapping(cls):
        # reference regression.py:183-215
        return {
            "regParam": "alpha",
            "elasticNetParam": "l1_ratio",
            "fitIntercept": "fit_intercept",
            "standardization": "normalize",
            "maxIter": "max_iter",
            "tol": "tol",
            "loss": "loss",
            "solver": "solver",
            "epsilon": "epsilon",
            "aggregationDepth": "",
            "maxBlockSizeInMB": "",
            "featuresCol": "",
            "labelCol": "",
            "predictionCol": "",
            "weightCol": "",
        }

    @classmethod
    def _param_value_mapping(cls):
        return {
            "loss": lambda x: {
                "squaredError": "squared_loss",
                "squared_loss": "squared_loss",
                "huber": "huber",
            }.get(x),
            "solver": lambda x: {"auto": "eig", "normal": "eig", "eig": "eig", "l-bfgs": "eig"}.get(x),
        }

    @classmethod
    def _get_torch_params_default(cls) -> Dict[str, Any]:
        return {
            "alpha": 0.0,
            "l1_ratio": 0.0,
            "fit_intercept": True,
            "normalize": True,
            "max_iter": 100,
            "tol": 1e-6,
            "loss": "squared_loss",
            "solver": "eig",
            "epsilon": 1.35,
        }

    def _check_supported(self) -> None:
        super()._check_supported()  # type: ignore[misc]
        if self._torch_params.get("loss") == "huber":  # type: ignore[attr-defined]
            raise NotImplementedError(
                "LinearRegression(loss='huber') is not ported to the PyTorch backend "
                "yet: it needs the L-BFGS solver of the LogisticRegression slice"
            )


class _LinearRegressionParams(
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasMaxIter,
    HasTol,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasSolver,
    HasWeightCol,
):
    loss: Param[str] = Param(
        "undefined",
        "loss",
        "The loss function to be optimized. Supported options: squaredError, huber.",
        TypeConverters.toString,
    )
    epsilon: Param[float] = Param(
        "undefined",
        "epsilon",
        "The shape parameter to control the amount of robustness (huber only).",
        TypeConverters.toFloat,
    )
    maxBlockSizeInMB: Param[float] = Param(
        "undefined",
        "maxBlockSizeInMB",
        "Maximum memory in MB for stacking input data into blocks.",
        TypeConverters.toFloat,
    )
    aggregationDepth: Param[int] = Param(
        "undefined",
        "aggregationDepth",
        "suggested depth for treeAggregate (>= 2).",
        TypeConverters.toInt,
    )

    def _set_defaults(self) -> None:
        self._setDefault(
            featuresCol="features",
            labelCol="label",
            predictionCol="prediction",
            regParam=0.0,
            elasticNetParam=0.0,
            fitIntercept=True,
            standardization=True,
            maxIter=100,
            tol=1e-6,
            loss="squaredError",
            epsilon=1.35,
            solver="auto",
            aggregationDepth=2,
            maxBlockSizeInMB=0.0,
        )

    def setFeaturesCol(self, value: str):
        return self._set(featuresCol=value)

    def setLabelCol(self, value: str):
        return self._set(labelCol=value)

    def setPredictionCol(self, value: str):
        return self._set(predictionCol=value)


class LinearRegression(_LinearRegressionClass, _TorchEstimatorSupervised, _LinearRegressionParams):
    """LinearRegression (OLS / Ridge / Lasso / ElasticNet, squared loss) on one
    device (the card by default; `device="cpu"` asks for the CPU): one
    normal-equation pass over X, then a d x d solve.

    Example
    -------
    >>> import numpy as np, pandas as pd
    >>> from spark_rapids_ml_torch.regression import LinearRegression
    >>> X = np.random.rand(100, 4).astype(np.float32)
    >>> df = pd.DataFrame({"features": list(X), "label": X @ [1.0, 2.0, 0.0, -1.0]})
    >>> model = LinearRegression(device="cpu").fit(df)
    >>> model.transform(df)   # a 'prediction' column
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_defaults()
        self.initialize_torch_params()
        self._set_params(**kwargs)

    def setRegParam(self, value: float) -> "LinearRegression":
        return self._set_params(regParam=value)  # type: ignore[return-value]

    def setElasticNetParam(self, value: float) -> "LinearRegression":
        return self._set_params(elasticNetParam=value)  # type: ignore[return-value]

    def _get_torch_fit_func(self):
        p = dict(self._torch_params)

        def _fit(inputs: FitInputs):
            return linreg_fit(
                inputs.features, inputs.label, inputs.row_weight,
                reg=float(p["alpha"]),
                l1_ratio=float(p["l1_ratio"]),
                fit_intercept=bool(p["fit_intercept"]),
                standardize=bool(p["normalize"]),
                max_iter=int(p["max_iter"]),
                tol=float(p["tol"]),
                unit_weight=inputs.unit_weight,
                part=inputs.partitioner,
            )[0]

        return _fit

    def _create_pyspark_model(self, attrs: Dict[str, Any]) -> "LinearRegressionModel":
        return LinearRegressionModel(**attrs)

    def _streaming_fit(self, fd, device: torch.device, desc, part) -> Dict[str, Any]:
        """Out-of-core fit (ops/streaming.py), taken by core/estimator.py when
        the design matrix exceeds the stream threshold: the normal-equation
        statistics are added batch by batch on the device, then solved as
        in-core."""
        p = self._torch_params
        A, b, xbar, ybar, sw, constant = streaming_linreg_stats(
            fd.features, fd.label, fd.weight, resolve_batch_rows_per_process(part), device,
            float32=self._float32_inputs, part=part,
        )
        with span("solve"):
            return solve_from_stats(
                A, b, xbar, ybar, sw, constant=constant,
                reg=float(p["alpha"]),
                l1_ratio=float(p["l1_ratio"]),
                fit_intercept=bool(p["fit_intercept"]),
                standardize=bool(p["normalize"]),
                max_iter=int(p["max_iter"]),
                tol=float(p["tol"]),
            )[0]


class LinearRegressionModel(_LinearRegressionClass, _TorchModel, _LinearRegressionParams):
    """Fitted linear regression model (reference regression.py:700-863)."""

    def __init__(
        self,
        coefficients: np.ndarray,
        intercept: float,
        n_iter: int,
        scale: float = 1.0,
    ) -> None:
        super().__init__(
            coefficients=np.asarray(coefficients),
            intercept=float(intercept),
            n_iter=int(n_iter),
            scale=float(scale),
        )
        self._set_defaults()

    @property
    def coefficients(self) -> np.ndarray:
        return self._model_attributes["coefficients"]

    @property
    def intercept(self) -> float:
        return self._model_attributes["intercept"]

    @property
    def numFeatures(self) -> int:
        return int(self._model_attributes["coefficients"].shape[0])

    @property
    def scale(self) -> float:
        """Huber scale sigma; 1.0 for the squared-error fits the port runs."""
        return float(self._model_attributes.get("scale", 1.0))

    @property
    def hasSummary(self) -> bool:
        """No training summary is produced (reference regression.py:745-750)."""
        return False

    @property
    def summary(self):
        raise RuntimeError(f"No training summary available for this {self.__class__.__name__}")

    def evaluate(self, dataset: Any) -> "LinearRegressionSummary":
        """The Spark summary surface over a labeled dataset: transform, then the
        regression metrics of its predictions."""
        from ..core.estimator import extract_eval_columns

        out, label, pred, weight = extract_eval_columns(self, dataset)
        return LinearRegressionSummary(
            out, label, pred, weight,
            num_features=self.numFeatures,
            fit_intercept=bool(self.getOrDefault("fitIntercept")),
        )

    def predict(self, value: np.ndarray) -> float:
        """Prediction for one feature vector, on the model's device."""
        dtype = np.float32 if self._float32_inputs else np.float64
        X = torch.from_numpy(np.asarray(value, dtype=dtype).reshape(1, -1)).to(self.device)
        return float(self._predict(X)[0])

    def _predict(self, X: torch.Tensor) -> torch.Tensor:
        coef = torch.tensor(self.coefficients, dtype=X.dtype, device=X.device)
        return linreg_predict(X, coef, self.intercept)

    def _transform_arrays(self, X: torch.Tensor) -> Dict[str, np.ndarray]:
        return {self.getOrDefault("predictionCol"): self._predict(X).cpu().numpy()}


class LinearRegressionSummary:
    """Evaluation summary over a predictions frame: the surface of
    pyspark.ml.regression.LinearRegressionSummary, from the metrics module's
    moment statistics."""

    def __init__(
        self,
        predictions,
        label: np.ndarray,
        pred: np.ndarray,
        weight: "np.ndarray | None" = None,
        num_features: int = 0,
        fit_intercept: bool = True,
    ) -> None:
        from ..metrics.RegressionMetrics import RegressionMetrics

        self.predictions = predictions
        self._m = RegressionMetrics.from_predictions(label, pred, weight)
        self._n = len(np.asarray(label))
        self._dof = max(self._n - num_features - (1 if fit_intercept else 0), 0)

    @property
    def rootMeanSquaredError(self) -> float:
        return self._m.root_mean_squared_error

    @property
    def meanSquaredError(self) -> float:
        return self._m.mean_squared_error

    @property
    def meanAbsoluteError(self) -> float:
        return self._m.mean_absolute_error

    @property
    def r2(self) -> float:
        return self._m.r2

    @property
    def explainedVariance(self) -> float:
        return self._m.explained_variance

    @property
    def numInstances(self) -> int:
        return self._n

    @property
    def degreesOfFreedom(self) -> int:
        return self._dof
