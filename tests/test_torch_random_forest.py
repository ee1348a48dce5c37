"""PyTorch port, RandomForestClassifier / RandomForestRegressor
(spark_rapids_ml_torch/models/tree.py) against the JAX package's estimators on
the CPU, on the same pandas frames made from a seed with numpy.

The JAX estimators run with num_workers=1. With featureSubsetStrategy other than
"all", the port's per-level scores are the jax.random scores the JAX package
draws for the same seed, replayed through ops/trees.py::_feature_scores.

Tolerances: the classifier's heap arrays, probabilities and predictions are
exact (integer histogram sums, the same f32 split and averaging arithmetic).
The regressor's predictions are held within rtol 1e-5, atol 1e-5 · max |y|
on real-valued labels: its w y and w y^2 sums are taken in another order, which
moves the last bits of its leaf means (and could flip a split that is a near
tie, which this data does not have); with integer labels its sums are exact
and its forests equal."""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRFC
from spark_rapids_ml_tpu.models.tree import RandomForestClassificationModel as JaxRFCModel
from spark_rapids_ml_tpu.regression import RandomForestRegressor as JaxRFR
from spark_rapids_ml_torch.classification import (
    RandomForestClassificationModel,
    RandomForestClassifier,
)
from spark_rapids_ml_torch.models import from_attributes
from spark_rapids_ml_torch.ops import trees
from spark_rapids_ml_torch.regression import RandomForestRegressionModel, RandomForestRegressor

HEAP = ("feature", "threshold", "is_leaf", "value", "gain", "node_weight", "bin_edges")


def _frame(n=2000, d=8, n_classes=2, seed=0, regression=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1] - 0.25 * X[:, 2] + rng.normal(0, 0.5, n)
    if regression:
        label = (2.0 * X[:, 0] - X[:, 1] + 0.3 * rng.normal(size=n)).astype(np.float32)
    else:
        label = np.digitize(score, np.quantile(score, np.linspace(0, 1, n_classes + 1)[1:-1]))
    return pd.DataFrame({"features": list(X), "label": label.astype(np.float64)}), X


@pytest.fixture
def replay_scores(monkeypatch):
    """Replay the JAX package's per-level feature scores for (seed, trees, depth, d)."""

    def install(seed, n_trees, depth, d):
        draws = []
        for i in range(n_trees):
            key = jax.random.PRNGKey((seed + 7919 * i) & 0x7FFFFFFF)
            for t in range(depth):
                key, sub = jax.random.split(key)
                draws.append(np.array(jax.random.uniform(sub, (2**t, d))))
        it = iter(draws)
        monkeypatch.setattr(
            trees, "_feature_scores", lambda gen, w, dd, dev: torch.from_numpy(next(it)).to(dev)
        )

    return install


def _fit_both(est_cls, jax_cls, df, replay, **params):
    jax_model = jax_cls(num_workers=1, **params).fit(df)
    if params.get("featureSubsetStrategy", "auto") != "all":
        d = len(df["features"].iloc[0])
        replay(params.get("seed", 0), params["numTrees"], params["maxDepth"], d)
    model = est_cls(device="cpu", **params).fit(df)
    return model, jax_model


@pytest.mark.parametrize(
    "params",
    [
        dict(numTrees=3, maxDepth=4, featureSubsetStrategy="all", seed=1),
        dict(numTrees=3, maxDepth=4, seed=2),  # auto: 2 of 8 features per node
        dict(numTrees=2, maxDepth=5, impurity="entropy", featureSubsetStrategy="0.5", seed=3),
        dict(numTrees=3, maxDepth=3, maxBins=8, bootstrap=False, subsamplingRate=0.6, seed=4),
    ],
)
@pytest.mark.parametrize("n_classes", [2, 3])
def test_classifier_fit_and_transform_match_the_jax_estimator(params, n_classes, replay_scores):
    df, X = _frame(n_classes=n_classes, seed=n_classes)
    model, jax_model = _fit_both(RandomForestClassifier, JaxRFC, df, replay_scores, **params)
    got, want = model.get_model_attributes(), jax_model.get_model_attributes()
    for key in HEAP:
        if key == "gain" and params.get("impurity") == "entropy":
            # XLA's CPU log differs from torch's in the last bit (test_torch_trees.py)
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert got["num_classes"] == want["num_classes"] == n_classes
    out, jout = model.transform(df), jax_model.transform(df)
    for col in ("prediction", "probability", "rawPrediction"):
        np.testing.assert_array_equal(
            np.stack(out[col].to_numpy()), np.stack(jout[col].to_numpy()), err_msg=col
        )
    assert model.numClasses == n_classes and model.getNumTrees() == params["numTrees"]
    np.testing.assert_array_equal(model.predictProbability(X[5]), jax_model.predictProbability(X[5]))
    assert model.predict(X[7]) == jax_model.predict(X[7])


@pytest.mark.parametrize(
    "params,integer_labels",
    [(dict(numTrees=3, maxDepth=4, featureSubsetStrategy="all", seed=5), False),
     (dict(numTrees=3, maxDepth=4, seed=6), True)],  # auto: a third of the features
)
def test_regressor_fit_transform_evaluate_match_the_jax_estimator(
    params, integer_labels, replay_scores
):
    """Real-valued labels: predictions within the stated tolerance, on data
    whose splits have no near ties. Integer labels: every stat sum is an
    integer below 2^24, so the forests are equal, near ties or not."""
    df, X = _frame(regression=True, seed=7)
    if integer_labels:
        df["label"] = np.round(df["label"])
    model, jax_model = _fit_both(RandomForestRegressor, JaxRFR, df, replay_scores, **params)
    got = model.transform(df)["prediction"].to_numpy()
    want = jax_model.transform(df)["prediction"].to_numpy()
    a, b = model.get_model_attributes(), jax_model.get_model_attributes()
    if integer_labels:
        np.testing.assert_array_equal(got, want)
        for key in HEAP:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]), err_msg=key)
    else:
        scale = np.abs(df["label"].to_numpy()).max()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_array_equal(a["feature"], b["feature"])
        np.testing.assert_array_equal(a["threshold"], b["threshold"])
    ev, jev = model.evaluate(df), jax_model.evaluate(df)
    np.testing.assert_allclose(ev.rootMeanSquaredError, jev.rootMeanSquaredError, rtol=1e-5)
    np.testing.assert_allclose(ev.r2, jev.r2, rtol=1e-5)
    assert ev.numInstances == len(df)
    np.testing.assert_allclose(model.predict(X[3]), jax_model.predict(X[3]), rtol=1e-5, atol=1e-5)


def test_importances_node_counts_and_debug_strings_match():
    df, _ = _frame(seed=11)
    params = dict(numTrees=3, maxDepth=4, featureSubsetStrategy="all", seed=8)
    model = RandomForestClassifier(device="cpu", **params).fit(df)
    jax_model = JaxRFC(num_workers=1, **params).fit(df)
    np.testing.assert_array_equal(model.featureImportances, jax_model.featureImportances)
    assert abs(model.featureImportances.sum() - 1.0) < 1e-12
    assert model.totalNumNodes == jax_model.totalNumNodes
    assert model.toDebugString.replace("RandomForestClassificationModel", "M") == \
        jax_model.toDebugString.replace("RandomForestClassificationModel", "M")
    views, jviews = model.trees, jax_model.trees
    assert [(t.numNodes, t.depth) for t in views] == [(t.numNodes, t.depth) for t in jviews]
    assert views[0].predict(df["features"].iloc[0]) == jviews[0].predict(df["features"].iloc[0])
    assert model.treeWeights == [1.0] * 3 and model.numFeatures == 8


def test_min_instances_and_weight_column_match_the_jax_estimator():
    df, _ = _frame(seed=12)
    df["w"] = np.random.default_rng(0).integers(0, 4, len(df)).astype(np.float64)
    params = dict(numTrees=2, maxDepth=5, featureSubsetStrategy="all", seed=9,
                  minInstancesPerNode=25, weightCol="w")
    model = RandomForestClassifier(device="cpu", **params).fit(df)
    jax_model = JaxRFC(num_workers=1, **params).fit(df)
    for key in HEAP:
        np.testing.assert_array_equal(
            model.get_model_attributes()[key], np.asarray(jax_model.get_model_attributes()[key]),
            err_msg=key,
        )
    unweighted = RandomForestClassifier(device="cpu", **{**params, "weightCol": None})
    assert not np.array_equal(  # the weights changed the trees
        unweighted.fit(df.drop(columns="w")).get_model_attributes()["node_weight"],
        model.get_model_attributes()["node_weight"],
    )


def test_missing_and_bad_labels_raise():
    df, _ = _frame(n_classes=3, seed=13)
    df.loc[df["label"] == 1, "label"] = 2.0  # class 1 never appears
    with pytest.raises(RuntimeError, match=r"\[1\] are missing"):
        RandomForestClassifier(device="cpu", numTrees=1).fit(df)
    df["label"] = 0.5
    with pytest.raises(ValueError, match="non-negative integers"):
        RandomForestClassifier(device="cpu", numTrees=1).fit(df)
    with pytest.raises(ValueError, match="label column"):
        RandomForestRegressor(device="cpu").fit(df.drop(columns="label"))


def test_params_the_port_cannot_honor_raise():
    df, _ = _frame(n=200, seed=14)
    for kwargs in (dict(impurity="variance"), dict(leafCol="leaf"),
                   dict(minWeightFractionPerNode=0.1)):
        with pytest.raises(ValueError, match="not supported"):
            RandomForestClassifier(device="cpu", **kwargs).fit(df)
    with pytest.raises(ValueError, match="not supported"):
        RandomForestRegressor(device="cpu", impurity="gini").fit(df)
    with pytest.raises(ValueError, match="maxDepth"):
        RandomForestClassifier(device="cpu", maxDepth=31).fit(df)
    with pytest.raises(ValueError, match="numTrees"):
        RandomForestClassifier(device="cpu", numTrees=0).fit(df)
    # Spark's memory and caching knobs are accepted and ignored
    RandomForestClassifier(device="cpu", numTrees=1, maxMemoryInMB=1024, cacheNodeIds=True).fit(df)


@pytest.mark.parametrize("kind", ["random_forest_classifier", "random_forest_regressor"])
def test_jax_fitted_forest_carries_across(kind):
    regression = kind == "random_forest_regressor"
    df, X = _frame(seed=15, regression=regression)
    jax_cls = JaxRFR if regression else JaxRFC
    jax_model = jax_cls(num_workers=1, numTrees=4, maxDepth=4, seed=3).fit(df)
    port = from_attributes(kind, jax_model.get_model_attributes(), device="cpu")
    assert isinstance(port, RandomForestRegressionModel if regression else RandomForestClassificationModel)
    assert not port.hasParam("leaf") and port.getNumTrees() == 4
    cols = ("prediction",) if regression else ("prediction", "probability", "rawPrediction")
    out, jout = port.transform(df), jax_model.transform(df)
    for col in cols:
        np.testing.assert_array_equal(np.stack(out[col].to_numpy()), np.stack(jout[col].to_numpy()))
    back = JaxRFCModel(**port.get_model_attributes()) if not regression else None
    if back is not None:
        np.testing.assert_array_equal(back.transform(df)["prediction"].to_numpy(),
                                      jout["prediction"].to_numpy())
    np.testing.assert_array_equal(port.featureImportances, jax_model.featureImportances)


# The parity rule for real-valued stats (a regressor's w y and w y^2 sums, or
# any forest under a real-valued weightCol): the two packages add the same
# terms in another order, so a node's gains differ in their last bits, and a
# node whose best and second-best gains lie within GAIN_TOL of each other (or
# whose best gain lies within GAIN_TOL of minInfoGain = 0) may split another
# way. So: wherever a node is reached in both trees and its best gain is
# separated from its second best and from 0 by more than GAIN_TOL, the trees
# split it alike (feature, threshold) and hold its value within VALUE_RTOL;
# below a near tie nothing is compared. Predictions agree within VALUE_RTOL on
# every row whose path in every tree passes separated nodes only. Forests under
# integer weights still compare bit for bit (the tests above). GAIN_TOL: some
# 80 f32 ulps of gains below 0.5 (0/1 labels), sums of 600 weighted rows in
# another order.
GAIN_TOL = 1e-5
VALUE_RTOL = 1e-5


def _separated_slots(gains, n_trees, depth):
    """{(tree, heap slot)} of the nodes whose best gain is more than GAIN_TOL
    above both their second best and 0, from the port's per-level gains in
    fit order (tree by tree, level by level)."""
    it = iter(gains)
    out = set()
    for i in range(n_trees):
        for t in range(depth):
            top = torch.topk(next(it).reshape(2**t, -1), 2, dim=1).values
            for w in range(2**t):
                best, second = float(top[w, 0]), float(top[w, 1])
                if best - second > GAIN_TOL and best > GAIN_TOL:
                    out.add((i, 2**t + w))
    return out


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_real_valued_weights_follow_the_parity_rule(kind, monkeypatch):
    """600 x 5, 2 trees of depth 4, all features, weights from uniform(0, 2):
    the rule above, against the JAX estimator."""
    rng = np.random.default_rng(0)
    n, d, n_trees, depth = 600, 5, 2, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(0, 0.5, n) > 0).astype(np.float64)
    df = pd.DataFrame({"features": list(X), "label": y, "w": rng.uniform(0, 2, n)})
    params = dict(numTrees=n_trees, maxDepth=depth, featureSubsetStrategy="all", seed=1,
                  weightCol="w")
    gains = []
    split_gains = trees._split_gains

    def recorded(*args, **kwargs):
        gains.append(split_gains(*args, **kwargs))
        return gains[-1]

    monkeypatch.setattr(trees, "_split_gains", recorded)
    est, jax_est = ((RandomForestClassifier, JaxRFC) if kind == "classifier"
                    else (RandomForestRegressor, JaxRFR))
    model = est(device="cpu", **params).fit(df)
    jax_model = jax_est(num_workers=1, **params).fit(df)
    sep = _separated_slots(gains, n_trees, depth)
    a = model.get_model_attributes()
    b = {key: np.asarray(v) for key, v in jax_model.get_model_attributes().items()}
    compared = 0
    for i in range(n_trees):
        todo = [1]
        while todo:
            s = todo.pop()
            np.testing.assert_allclose(a["value"][i][s], b["value"][i][s], rtol=VALUE_RTOL,
                                       atol=VALUE_RTOL)
            if (i, s) not in sep or a["is_leaf"][i][s]:
                continue  # a leaf, or a near tie: its subtree may differ
            compared += 1
            assert not b["is_leaf"][i][s]
            assert a["feature"][i][s] == b["feature"][i][s], (i, s)
            assert a["threshold"][i][s] == b["threshold"][i][s], (i, s)
            todo += [2 * s, 2 * s + 1]
    assert compared >= 2 * n_trees  # the rule compared real structure
    # rows whose path in every tree passes separated nodes only
    sure = np.ones(n, bool)
    for i in range(n_trees):
        p = np.ones(n, np.int64)
        for _ in range(depth):
            leaf = a["is_leaf"][i][p]
            sure &= leaf | np.array([(i, s) in sep for s in p])
            go = X[np.arange(n), np.maximum(a["feature"][i][p], 0)] > a["threshold"][i][p]
            p = np.where(leaf, p, 2 * p + go)
    assert sure.mean() > 0.25  # a real share of the rows is compared
    got = model.transform(df)["prediction"].to_numpy()
    want = jax_model.transform(df)["prediction"].to_numpy()
    np.testing.assert_allclose(got[sure], want[sure], rtol=VALUE_RTOL, atol=VALUE_RTOL)
