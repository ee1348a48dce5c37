#
# RandomForestClassifier / RandomForestRegressor of the PyTorch port
# (counterpart of the JAX package's models/tree.py; pyspark.ml-compatible
# surface, reference python/src/spark_rapids_ml/tree.py,
# classification.py:285-676 and regression.py:865-1147) over the level-wise
# histogram forest builder of ops/trees.py:
#   * every tree grows on all the rows of one device, its level histograms
#     through the CUDA kernel of csrc/hist.cu on the card; under a process
#     group each rank fits on its own rows and every rank grows the same
#     forest, the level histograms added across the ranks (ops/trees.py);
#     transform stays each rank's own, with no collective;
#   * the label checks (reference tree.py:415-421), across the ranks of a
#     group: integer labels from 0 on any rank, every class of 0..k-1 on some
#     rank; each raises on every rank or on none;
#   * probability and rawPrediction columns for the classifier (reference
#     classification.py:502-515); featureImportances, totalNumNodes,
#     toDebugString and per-tree views from the heap arrays.
#
#   * save/load in the JAX package's directory format (core/persistence.py),
#     and the forest JSON dump and import and the treelite import (toJSON,
#     fromJSON, fromTreeliteJSON; ops/trees.py), which agree with the JAX
#     package's on the same attributes and dumps.
#
#   * out-of-core: when the design matrix exceeds
#     config.stream_threshold_bytes the fit keeps X on the host and bins it on
#     the device batch by batch into resident uint8 bins
#     (ops/trees.py::streaming_forest_fit, edges from a strided row sample),
#     in one process and across the ranks of a group alike; maxBins above 256
#     warns and fits in-core, as in the JAX package.
#
# Not ported: fitMultiple, the classifier's evaluate and serving. A param
# value the JAX package would hand to its sklearn fallback raises here.
#

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.backend_params import HasFeaturesCols, _TorchClass
from ..core.estimator import FitInputs, _TorchEstimatorSupervised, _TorchModel, stage
from ..core.params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasSeed,
    HasWeightCol,
    Param,
    TypeConverters,
)
from ..ops import ingest
from ..ops.trees import (
    forest_fit,
    forest_from_json,
    forest_from_treelite_json,
    forest_to_json,
    predict_forest,
    resolve_feature_subset,
    streaming_forest_fit,
)
from ..parallel.partitioner import resolve_batch_rows_per_process
from ..utils import span


class _RandomForestClass(_TorchClass):
    @classmethod
    def _param_mapping(cls):
        # reference tree.py:103-156
        return {
            "numTrees": "n_estimators",
            "maxDepth": "max_depth",
            "maxBins": "n_bins",
            "minInstancesPerNode": "min_samples_leaf",
            "minInfoGain": "min_impurity_decrease",
            "featureSubsetStrategy": "max_features",
            "subsamplingRate": "max_samples",
            "bootstrap": "bootstrap",
            "impurity": "split_criterion",
            "seed": "random_state",
            "minWeightFractionPerNode": None,
            "maxMemoryInMB": "",
            "cacheNodeIds": "",
            "checkpointInterval": "",
            "leafCol": None,
            "featuresCol": "",
            "labelCol": "",
            "predictionCol": "",
            "probabilityCol": "",
            "rawPredictionCol": "",
            "weightCol": "",
        }

    @classmethod
    def _get_torch_params_default(cls) -> Dict[str, Any]:
        return {
            "n_estimators": 20,
            "max_depth": 5,
            "n_bins": 32,
            "min_samples_leaf": 1,
            "min_impurity_decrease": 0.0,
            "max_features": "auto",
            "max_samples": 1.0,
            "bootstrap": True,
            "split_criterion": "gini",
            "random_state": 0,
        }


class _RandomForestParams(
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasSeed,
    HasWeightCol,
):
    numTrees: Param[int] = Param(
        "undefined", "numTrees", "Number of trees to train (>= 1).", TypeConverters.toInt
    )
    maxDepth: Param[int] = Param(
        "undefined", "maxDepth", "Maximum depth of the tree (>= 0).", TypeConverters.toInt
    )
    maxBins: Param[int] = Param(
        "undefined",
        "maxBins",
        "Max number of bins for discretizing continuous features.",
        TypeConverters.toInt,
    )
    minInstancesPerNode: Param[int] = Param(
        "undefined",
        "minInstancesPerNode",
        "Minimum number of instances each child must have after split.",
        TypeConverters.toInt,
    )
    minInfoGain: Param[float] = Param(
        "undefined",
        "minInfoGain",
        "Minimum information gain for a split to be considered at a tree node.",
        TypeConverters.toFloat,
    )
    featureSubsetStrategy: Param[str] = Param(
        "undefined",
        "featureSubsetStrategy",
        "The number of features to consider for splits at each tree node: "
        "auto|all|onethird|sqrt|log2|(0.0-1.0]|[1-n].",
        TypeConverters.toString,
    )
    subsamplingRate: Param[float] = Param(
        "undefined",
        "subsamplingRate",
        "Fraction of the training data used for learning each decision tree.",
        TypeConverters.toFloat,
    )
    bootstrap: Param[bool] = Param(
        "undefined", "bootstrap", "Whether bootstrap samples are used.", TypeConverters.toBoolean
    )
    impurity: Param[str] = Param(
        "undefined", "impurity", "Criterion used for information gain calculation.",
        TypeConverters.toString,
    )
    minWeightFractionPerNode: Param[float] = Param(
        "undefined",
        "minWeightFractionPerNode",
        "Minimum fraction of the weighted sample count each child must have "
        "(only 0.0 is supported).",
        TypeConverters.toFloat,
    )
    # Spark executor-memory/caching knobs with no meaning on one device;
    # accepted and ignored (reference tree.py:103-156 maps them to "")
    maxMemoryInMB: Param[int] = Param(
        "undefined", "maxMemoryInMB",
        "Maximum memory in MB allocated to histogram aggregation (ignored).",
        TypeConverters.toInt,
    )
    cacheNodeIds: Param[bool] = Param(
        "undefined", "cacheNodeIds",
        "Whether to cache node IDs for each instance (ignored).",
        TypeConverters.toBoolean,
    )
    checkpointInterval: Param[int] = Param(
        "undefined", "checkpointInterval",
        "Checkpoint interval for the node-id cache (ignored).",
        TypeConverters.toInt,
    )
    leafCol: Param[str] = Param(
        "undefined", "leafCol", "Leaf-index output column (not supported).",
        TypeConverters.toString,
    )

    def setFeaturesCol(self, value: str):
        return self._set(featuresCol=value)

    def setLabelCol(self, value: str):
        return self._set(labelCol=value)

    def getNumTrees(self) -> int:
        return self.getOrDefault("numTrees")

    def getMaxDepth(self) -> int:
        return self.getOrDefault("maxDepth")


class _RandomForestEstimator(_RandomForestClass, _TorchEstimatorSupervised, _RandomForestParams):
    _is_classification = False
    # Spark caps tree depth at 30; the heap-layout forest (2^(depth+1) slots)
    # makes an early clear error better than a depth-exponential OOM
    _PARAM_BOUNDS_EXTRA = {"numTrees": (1, None), "maxDepth": (0, 30), "maxBins": (2, None)}

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(
            featuresCol="features",
            labelCol="label",
            predictionCol="prediction",
            numTrees=20,
            maxDepth=5,
            maxBins=32,
            minInstancesPerNode=1,
            minInfoGain=0.0,
            featureSubsetStrategy="auto",
            subsamplingRate=1.0,
            bootstrap=True,
            seed=0,
            minWeightFractionPerNode=0.0,
            maxMemoryInMB=256,
            cacheNodeIds=False,
            checkpointInterval=10,
            leafCol="",
        )
        self.initialize_torch_params()
        self._set_params(**kwargs)

    def _row_stats(self, inputs: FitInputs) -> Tuple[torch.Tensor, int]:
        raise NotImplementedError

    def _impurity_name(self) -> str:
        raise NotImplementedError

    def _forest_params(self, d: int) -> Dict[str, Any]:
        """The keyword arguments of forest_fit / streaming_forest_fit, from the
        backend params, at d features."""
        p = self._torch_params
        return dict(
            n_trees=int(p["n_estimators"]),
            max_depth=int(p["max_depth"]),
            max_bins=int(p["n_bins"]),
            impurity=self._impurity_name(),
            feature_subset=resolve_feature_subset(str(p["max_features"]), d,
                                                  self._is_classification),
            min_instances=int(p["min_samples_leaf"]),
            min_info_gain=float(p["min_impurity_decrease"]),
            subsampling_rate=float(p["max_samples"]),
            bootstrap=bool(p["bootstrap"]),
            seed=int(p["random_state"]) if p["random_state"] is not None else 0,
        )

    def _get_torch_fit_func(self):
        def _fit(inputs: FitInputs):
            stats, n_classes = self._row_stats(inputs)
            attrs = forest_fit(inputs.features, stats, part=inputs.partitioner, layout=inputs.desc,
                               **self._forest_params(inputs.features.shape[1]))
            attrs["num_classes"] = n_classes
            return attrs

        return _fit

    def _streaming_fit(self, fd, device: torch.device, desc, part) -> Dict[str, Any]:
        """Out-of-core fit (module header), taken by core/estimator.py when the
        design matrix exceeds the stream threshold: only the label and the
        weights are staged whole, X goes through binning in batches."""
        if int(self._torch_params["n_bins"]) > 256:
            self.logger.warning(
                "streamed RandomForest bins to uint8 (maxBins <= 256); fitting in-core "
                "despite stream_threshold_bytes.")
            return self._get_torch_fit_func()(self._build_fit_inputs(fd, device, desc, part))
        dtype = np.float32 if self._float32_inputs else np.float64
        w = np.ones((fd.n_rows,), dtype) if fd.weight is None else fd.weight.astype(dtype)
        with span("stage"):
            ring = ingest.PinnedRing(device) if device.type == "cuda" else None
            label = stage(np.asarray(fd.label, dtype), device, ring)
            row_weight = stage(w, device, ring)
        inputs = FitInputs(features=None, row_weight=row_weight, desc=desc, device=device,
                           unit_weight=fd.weight is None, label=label, partitioner=part)
        stats, n_classes = self._row_stats(inputs)
        del inputs, label, row_weight
        attrs = streaming_forest_fit(
            fd.features, stats, batch_rows=resolve_batch_rows_per_process(part), device=device,
            part=part, layout=desc, **self._forest_params(desc.n))
        attrs["num_classes"] = n_classes
        return attrs


class RandomForestRegressor(_RandomForestEstimator):
    """Random forest regression on one device (the card by default;
    `device="cpu"` asks for the CPU), or across the ranks of a process
    group; reference regression.py:865-1147.

    Example
    -------
    >>> import numpy as np, pandas as pd
    >>> from spark_rapids_ml_torch.regression import RandomForestRegressor
    >>> X = np.random.rand(1000, 4).astype(np.float32)
    >>> df = pd.DataFrame({"features": list(X), "label": X @ [1.0, 2.0, 0.0, -1.0]})
    >>> model = RandomForestRegressor(numTrees=5, device="cpu").fit(df)
    >>> model.transform(df)   # a 'prediction' column
    """

    _is_classification = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(impurity="variance")
        self._set_params(**kwargs)

    @classmethod
    def _param_value_mapping(cls):
        return {"split_criterion": lambda x: x if x == "variance" else None}

    @classmethod
    def _get_torch_params_default(cls) -> Dict[str, Any]:
        base = dict(_RandomForestClass._get_torch_params_default())
        base["split_criterion"] = "variance"
        return base

    def _impurity_name(self) -> str:
        return "variance"

    def _row_stats(self, inputs: FitInputs):
        """(n, 3) f32 [w, w y, w y^2], formed in f64."""
        y = inputs.label.double()
        w = inputs.row_weight.double()
        wy = w * y
        return torch.stack([w, wy, wy * y], dim=1).to(torch.float32), 0

    def _create_pyspark_model(self, attrs) -> "RandomForestRegressionModel":
        return RandomForestRegressionModel(**attrs)


class RandomForestClassifier(
    _RandomForestEstimator, HasProbabilityCol, HasRawPredictionCol
):
    """Random forest classification on one device (the card by default;
    `device="cpu"` asks for the CPU), or across the ranks of a process
    group; reference classification.py:285-676. Labels are the integers
    0..k-1, each of which must appear.

    Example
    -------
    >>> import numpy as np, pandas as pd
    >>> from spark_rapids_ml_torch.classification import RandomForestClassifier
    >>> X = np.random.rand(1000, 4).astype(np.float32)
    >>> df = pd.DataFrame({"features": list(X), "label": (X[:, 0] > 0.5) * 1.0})
    >>> model = RandomForestClassifier(numTrees=5, device="cpu").fit(df)
    >>> model.transform(df)   # 'prediction', 'probability', 'rawPrediction'
    """

    _is_classification = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(
            impurity="gini", probabilityCol="probability", rawPredictionCol="rawPrediction"
        )
        self._set_params(**kwargs)

    @classmethod
    def _param_value_mapping(cls):
        return {"split_criterion": lambda x: x if x in ("gini", "entropy") else None}

    def _impurity_name(self) -> str:
        return self._torch_params.get("split_criterion", "gini")

    def _row_stats(self, inputs: FitInputs):
        """(n, n_classes) f32 one-hot rows scaled by the row weight. Under a
        process group the checks are global: one all-reduce MAX of (a bad
        label on this rank, its largest label) and one all-reduce SUM of the
        class counts, so every rank raises, or none."""
        y = inputs.label
        part = inputs.partitioner
        bad = bool(len(y)) and not (bool(torch.equal(y, torch.trunc(y))) and float(y.min()) >= 0)
        top = int(y.max()) if len(y) and not bad else -1
        flags = torch.tensor([int(bad), top], dtype=torch.int64)
        if part is not None:
            flags = part.all_reduce_max(flags)[0]
        if int(flags[0]):
            raise ValueError("Labels must be non-negative integers 0..k-1.")
        n_classes = int(flags[1]) + 1
        counts = torch.bincount(y.to(torch.int64), minlength=n_classes).cpu()
        if part is not None:
            counts = part.all_reduce_sum(counts)[0]
        if bool((counts == 0).any()):
            # reference raises with workaround text (tree.py:415-421)
            missing = (counts == 0).nonzero()[:, 0].tolist()
            raise RuntimeError(
                f"Labels {missing} "
                "are missing from the dataset: every class in 0..k-1 must appear."
            )
        stats = torch.zeros((len(y), n_classes), dtype=torch.float32, device=y.device)
        stats.scatter_(1, y.to(torch.int64)[:, None], inputs.row_weight.to(torch.float32)[:, None])
        return stats, n_classes

    def _create_pyspark_model(self, attrs) -> "RandomForestClassificationModel":
        return RandomForestClassificationModel(**attrs)


class _RandomForestModel(_RandomForestClass, _TorchModel, _RandomForestParams):
    _is_classification = False

    def __init__(
        self,
        feature: np.ndarray,
        threshold: np.ndarray,
        is_leaf: np.ndarray,
        value: np.ndarray,
        bin_edges: np.ndarray,
        num_classes: int,
        gain: "np.ndarray | None" = None,
        node_weight: "np.ndarray | None" = None,
    ) -> None:
        feature = np.asarray(feature)
        # gain/node_weight absent on imported forests (a dump carries
        # structure, not training statistics): importances are all zero there
        super().__init__(
            feature=feature,
            threshold=np.asarray(threshold),
            is_leaf=np.asarray(is_leaf),
            value=np.asarray(value),
            bin_edges=np.asarray(bin_edges),
            num_classes=int(num_classes),
            gain=np.zeros(feature.shape, np.float32) if gain is None else np.asarray(gain),
            node_weight=(
                np.zeros(feature.shape, np.float32)
                if node_weight is None
                else np.asarray(node_weight)
            ),
        )
        self._setDefault(
            featuresCol="features", labelCol="label", predictionCol="prediction",
            numTrees=20, maxDepth=5,
        )

    @property
    def numFeatures(self) -> int:
        return int(self._model_attributes["bin_edges"].shape[0])

    def getNumTrees(self) -> int:
        return int(self._model_attributes["feature"].shape[0])

    @property
    def treeWeights(self) -> List[float]:
        return [1.0] * self.getNumTrees()

    @property
    def max_depth_(self) -> int:
        return int(math.log2(self._model_attributes["feature"].shape[1])) - 1

    def _reachable_slots(self, tree_idx: int) -> List[int]:
        """Heap slots present in tree `tree_idx` (walk from root slot 1; the
        children of leaves are padding)."""
        a = self._model_attributes
        feat = a["feature"][tree_idx]
        leaf = a["is_leaf"][tree_idx]
        n_slots = feat.shape[0]
        out: List[int] = []
        stack = [1]
        while stack:
            p = stack.pop()
            if p >= n_slots:
                continue
            out.append(p)
            if not leaf[p] and feat[p] >= 0:
                stack.extend((2 * p, 2 * p + 1))
        return out

    @property
    def totalNumNodes(self) -> int:
        """Total number of nodes, summed over all trees (Spark
        TreeEnsembleModel.totalNumNodes)."""
        return sum(len(self._reachable_slots(i)) for i in range(self.getNumTrees()))

    @property
    def featureImportances(self) -> np.ndarray:
        """Impurity-based feature importances (Spark TreeEnsembleModel
        semantics: per tree, each internal node adds gain x node weight to its
        split feature; trees are normalized to sum 1, averaged, and
        renormalized)."""
        a = self._model_attributes
        d = self.numFeatures
        total = np.zeros(d, np.float64)
        for i in range(self.getNumTrees()):
            imp = np.zeros(d, np.float64)
            feat = a["feature"][i]
            contrib = a["gain"][i] * a["node_weight"][i]
            for p in self._reachable_slots(i):
                if feat[p] >= 0 and not a["is_leaf"][i][p]:
                    imp[feat[p]] += contrib[p]
            s = imp.sum()
            if s > 0:
                total += imp / s
        s = total.sum()
        return (total / s if s > 0 else total).astype(np.float64)

    def _tree_debug_string(self, tree_idx: int) -> str:
        a = self._model_attributes
        feat = a["feature"][tree_idx]
        thr = a["threshold"][tree_idx]
        leaf = a["is_leaf"][tree_idx]
        value = a["value"][tree_idx]
        lines: List[str] = []

        def walk(p: int, depth: int) -> None:
            pad = "  " * depth
            if leaf[p] or feat[p] < 0:
                v = value[p]
                pred = float(np.argmax(v)) if self._is_classification else float(v[0])
                lines.append(f"{pad}Predict: {pred}")
                return
            lines.append(f"{pad}If (feature {int(feat[p])} <= {float(thr[p])})")
            walk(2 * p, depth + 1)
            lines.append(f"{pad}Else (feature {int(feat[p])} > {float(thr[p])})")
            walk(2 * p + 1, depth + 1)

        walk(1, 1)
        return "\n".join(lines)

    @property
    def toDebugString(self) -> str:
        """Full text description of the forest (Spark toDebugString shape)."""
        n = self.getNumTrees()
        head = (
            f"{self.__class__.__name__} with {n} trees, "
            f"{self.totalNumNodes} total nodes\n"
        )
        parts = []
        for i in range(n):
            n_nodes = len(self._reachable_slots(i))
            parts.append(f"  Tree {i} ({n_nodes} nodes):\n{self._tree_debug_string(i)}")
        return head + "\n".join(parts)

    @property
    def trees(self) -> List["_DecisionTreeView"]:
        """Per-tree views (Spark returns DecisionTreeModels; without a JVM these
        are lightweight standalone equivalents)."""
        return [_DecisionTreeView(self, i) for i in range(self.getNumTrees())]

    def _forest_outputs(self, X: torch.Tensor) -> np.ndarray:
        """(n, v) host array: the forest's mean leaf payload for the rows of X."""
        a = self._model_attributes
        dev = X.device
        with span("predict"):
            out = predict_forest(
                X,
                torch.tensor(a["feature"], dtype=torch.int32, device=dev),
                torch.tensor(a["threshold"], dtype=torch.float32, device=dev),
                torch.tensor(a["is_leaf"], dtype=torch.bool, device=dev),
                torch.tensor(a["value"], dtype=torch.float32, device=dev),
                self.max_depth_,
            )
            return out.cpu().numpy()

    def _one_row(self, value: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(value, dtype=np.float32).reshape(1, -1)).to(
            self.device
        )

    def toJSON(self) -> List[Dict]:
        """Forest dump (the reference's treelite-JSON role, tree.py:534-559)."""
        return forest_to_json(self._model_attributes, self._is_classification)

    @classmethod
    def fromJSON(
        cls, trees_json: List[Dict], n_features: int, num_classes: int = 0
    ) -> "_RandomForestModel":
        """Rebuild a model from a forest JSON dump (the import half of the
        reference's treelite interop, tree.py:439-449): a round trip through
        toJSON()/fromJSON() predicts the same bits, and dumps in the same
        shape from elsewhere import the same way."""
        attrs = forest_from_json(trees_json, n_features, cls._is_classification)
        attrs["num_classes"] = int(num_classes)
        return cls(**attrs)

    @classmethod
    def fromTreeliteJSON(
        cls, model_json: Any, n_features: Optional[int] = None, num_classes: int = 0,
    ) -> "_RandomForestModel":
        """Import a treelite JSON dump, the format cuML forests serialize to
        (reference tree.py:534-559 `dump_as_json`, utils.py:700-809 node
        schema): the full model dict (with `trees` and `num_feature`) or a bare
        list of tree dicts and n_features. Classification leaves are
        `leaf_vector` class probabilities."""
        attrs = forest_from_treelite_json(model_json, cls._is_classification, n_features)
        attrs["num_classes"] = int(num_classes)
        return cls(**attrs)


class _DecisionTreeView:
    """One tree of a fitted forest: the standalone stand-in for Spark's
    DecisionTree{Classification,Regression}Model returned by `model.trees`."""

    def __init__(self, forest: "_RandomForestModel", tree_idx: int) -> None:
        self._forest = forest
        self._idx = int(tree_idx)

    @property
    def numNodes(self) -> int:
        return len(self._forest._reachable_slots(self._idx))

    @property
    def depth(self) -> int:
        # floor(log2(slot)) is the node's level (root slot 1 -> level 0)
        slots = self._forest._reachable_slots(self._idx)
        return max(int(np.floor(np.log2(p))) for p in slots) if slots else 0

    @property
    def toDebugString(self) -> str:
        return (
            f"DecisionTreeModel ({self.numNodes} nodes)\n"
            + self._forest._tree_debug_string(self._idx)
        )

    def predict(self, value: np.ndarray) -> float:
        """Route one sample through this single tree, on the host."""
        a = self._forest._model_attributes
        x = np.asarray(value, np.float32).ravel()
        feat = a["feature"][self._idx]
        thr = a["threshold"][self._idx]
        leaf = a["is_leaf"][self._idx]
        val = a["value"][self._idx]
        p = 1
        while not leaf[p] and feat[p] >= 0:
            p = 2 * p + int(x[feat[p]] > thr[p])
        v = val[p]
        return float(np.argmax(v)) if self._forest._is_classification else float(v[0])


class RandomForestRegressionModel(_RandomForestModel):
    def predict(self, value: np.ndarray) -> float:
        return float(self._forest_outputs(self._one_row(value))[0, 0])

    def _transform_arrays(self, X: torch.Tensor) -> Dict[str, np.ndarray]:
        return {self.getOrDefault("predictionCol"): self._forest_outputs(X)[:, 0]}

    def evaluate(self, dataset: Any):
        """Regression summary on a labeled dataset (Spark model surface; the
        reference exposes no evaluate for forests)."""
        from ..core.estimator import extract_eval_columns
        from .regression import LinearRegressionSummary

        out, label, pred, weight = extract_eval_columns(self, dataset)
        return LinearRegressionSummary(
            out, label, pred, weight, num_features=self.numFeatures, fit_intercept=False,
        )


class RandomForestClassificationModel(
    _RandomForestModel, HasProbabilityCol, HasRawPredictionCol
):
    _is_classification = True

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(probabilityCol="probability", rawPredictionCol="rawPrediction")

    @property
    def numClasses(self) -> int:
        return self._model_attributes["num_classes"]

    def predict(self, value: np.ndarray) -> float:
        return float(np.argmax(self._forest_outputs(self._one_row(value))[0]))

    def predictProbability(self, value: np.ndarray) -> np.ndarray:
        return self._forest_outputs(self._one_row(value))[0]

    def _transform_arrays(self, X: torch.Tensor) -> Dict[str, np.ndarray]:
        prob = self._forest_outputs(X)
        # normalize away any averaging drift
        prob = prob / np.maximum(prob.sum(axis=1, keepdims=True), 1e-12)
        return {
            self.getOrDefault("predictionCol"): prob.argmax(axis=1).astype(np.float64),
            self.getOrDefault("probabilityCol"): prob,
            self.getOrDefault("rawPredictionCol"): prob * self.getNumTrees(),
        }
