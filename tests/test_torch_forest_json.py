"""PyTorch port, the forest JSON dump and import and the treelite import of
the random forest models (toJSON, fromJSON, fromTreeliteJSON; ops/trees.py's
forest_to_json, forest_from_json, forest_from_treelite_json) against the JAX
package's on the same attributes and dumps.

Data (numpy, seed 0): 400 x 4 f32 normal rows, a 3-class label from the first
two columns and a real label; 3 trees of depth 4. Held: the port's dump of a
forest equals the JAX package's dump of the same attributes; the arrays that
fromJSON and fromTreeliteJSON build equal the JAX package's bit for bit, in
the same dtypes; a toJSON -> fromJSON round trip predicts the same bits; the
treelite dumps of tests/test_random_forest.py (a "<" split routes equality
right, "<" at 0.0 keeps the nudge, leaf_vector class probabilities, scalar
leaves refused for a classifier) route as there."""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_torch import config
from spark_rapids_ml_torch.classification import (
    RandomForestClassificationModel,
    RandomForestClassifier,
)
from spark_rapids_ml_torch.regression import RandomForestRegressionModel, RandomForestRegressor

HEAP = ("feature", "threshold", "is_leaf", "value", "bin_edges")


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set("device", "cpu")
    yield
    config.unset("device")


def _frame():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 4)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1]
    y3 = np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(np.float64)
    return pd.DataFrame({"features": list(X), "label": y3, "y": score + 0.1 * X[:, 2]})


DF = _frame()


def _fit(kind):
    if kind == "classifier":
        return RandomForestClassifier(numTrees=3, maxDepth=4, seed=3).fit(DF)
    return RandomForestRegressor(numTrees=3, maxDepth=4, seed=3, labelCol="y").fit(DF)


def _jax_class(kind):
    from spark_rapids_ml_tpu.classification import RandomForestClassificationModel as J
    from spark_rapids_ml_tpu.regression import RandomForestRegressionModel as R

    return J if kind == "classifier" else R


def assert_heap_equal(got, want):
    for k in HEAP:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w)
    assert got["num_classes"] == want["num_classes"]


def outputs(model):
    out = model.transform(DF)
    cols = [c for c in ("prediction", "probability") if c in out.columns]
    return [np.stack(out[c].to_numpy()) if out[c].dtype == object else out[c].to_numpy()
            for c in cols]


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_the_dump_equals_the_jax_packages(kind):
    model = _fit(kind)
    jax_model = _jax_class(kind)(**model.get_model_attributes())
    dump = model.toJSON()
    assert dump == jax_model.toJSON()
    assert len(dump) == 3 and all(t["tree_id"] == i for i, t in enumerate(dump))


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_a_round_trip_predicts_the_same_bits(kind):
    model = _fit(kind)
    cls = type(model)
    num_classes = 3 if kind == "classifier" else 0
    rebuilt = cls.fromJSON(model.toJSON(), n_features=4, num_classes=num_classes)
    for got, want in zip(outputs(rebuilt), outputs(model)):
        np.testing.assert_array_equal(got, want)
    jax_rebuilt = _jax_class(kind).fromJSON(model.toJSON(), n_features=4,
                                            num_classes=num_classes)
    assert_heap_equal(rebuilt.get_model_attributes(), jax_rebuilt.get_model_attributes())
    assert rebuilt.toJSON() == model.toJSON()
    assert not rebuilt.featureImportances.any()  # a dump carries no gains


def test_import_refuses_a_deep_or_ragged_dump():
    leaf = {"leaf_value": [1.0]}
    node = leaf
    for _ in range(21):
        node = {"split_feature": 0, "threshold": 0.0, "left_child": node, "right_child": leaf}
    with pytest.raises(ValueError, match="depth 21"):
        RandomForestRegressionModel.fromJSON([{"tree_id": 0, "root": node}], n_features=1)
    ragged = {"split_feature": 0, "threshold": 0.0, "left_child": leaf,
              "right_child": {"leaf_value": [1.0, 2.0]}}
    with pytest.raises(ValueError, match="inconsistent"):
        RandomForestRegressionModel.fromJSON([{"tree_id": 0, "root": ragged}], n_features=1)
    with pytest.raises(ValueError, match="out of range"):
        RandomForestRegressionModel.fromJSON(
            [{"tree_id": 0, "root": dict(ragged, split_feature=3, right_child=leaf)}],
            n_features=2)


# the treelite dumps of tests/test_random_forest.py::test_forest_from_treelite_json
REG_TREES = [
    {
        "num_nodes": 5,
        "nodes": [
            {"node_id": 0, "split_feature_id": 0, "default_left": True,
             "node_type": "numerical_test_node", "comparison_op": "<",
             "threshold": 5.0, "left_child": 1, "right_child": 2},
            {"node_id": 1, "split_feature_id": 2, "default_left": False,
             "node_type": "numerical_test_node", "comparison_op": "<",
             "threshold": -3.0, "left_child": 3, "right_child": 4},
            {"node_id": 2, "leaf_value": 0.6},
            {"node_id": 3, "leaf_value": -0.4},
            {"node_id": 4, "leaf_value": 1.2},
        ],
    },
    {
        "num_nodes": 3,
        "nodes": [
            {"node_id": 0, "split_feature_id": 1, "comparison_op": "<=", "threshold": 0.0,
             "left_child": 1, "right_child": 2},
            {"node_id": 1, "leaf_value": -1.0},
            {"node_id": 2, "leaf_value": 2.0},
        ],
    },
]
ZERO_TREE = [
    {
        "num_nodes": 3,
        "nodes": [
            {"node_id": 0, "split_feature_id": 0, "comparison_op": "<", "threshold": 0.0,
             "left_child": 1, "right_child": 2},
            {"node_id": 1, "leaf_value": -1.0},
            {"node_id": 2, "leaf_value": 1.0},
        ],
    }
]
CLS_TREES = [
    {
        "num_nodes": 3,
        "nodes": [
            {"node_id": 0, "split_feature_id": 0, "comparison_op": "<=", "threshold": 1.5,
             "left_child": 1, "right_child": 2},
            {"node_id": 1, "leaf_vector": [0.9, 0.1]},
            {"node_id": 2, "leaf_vector": [0.2, 0.8]},
        ],
    }
]


def test_treelite_regression_import_routes_as_the_jax_package():
    from spark_rapids_ml_tpu.regression import RandomForestRegressionModel as JaxModel

    with pytest.warns(UserWarning, match="default_left=False"):
        model = RandomForestRegressionModel.fromTreeliteJSON({"num_feature": 3, "trees": REG_TREES})
    with pytest.warns(UserWarning, match="default_left=False"):
        want = JaxModel.fromTreeliteJSON({"num_feature": 3, "trees": REG_TREES})
    assert_heap_equal(model.get_model_attributes(), want.get_model_attributes())

    def route(x):
        t0 = 0.6 if x[0] >= 5.0 else (-0.4 if x[2] < -3.0 else 1.2)
        t1 = -1.0 if x[1] <= 0.0 else 2.0
        return (t0 + t1) / 2.0

    probe = np.array([[4.9, 0.0, -3.1], [5.0, 0.1, -3.0], [6.0, -2.0, 0.0], [0.0, 5.0, 7.0]],
                     np.float32)
    got = model.transform(pd.DataFrame({"features": list(probe)}))["prediction"].to_numpy()
    np.testing.assert_allclose(got, [route(p) for p in probe], atol=1e-6)
    np.testing.assert_allclose([model.predict(p) for p in probe], got, atol=0)
    bare = RandomForestRegressionModel.fromTreeliteJSON(REG_TREES[1:], n_features=3)
    assert bare.getNumTrees() == 1
    with pytest.raises(ValueError, match="n_features is required"):
        RandomForestRegressionModel.fromTreeliteJSON(REG_TREES[1:])


def test_treelite_zero_threshold_keeps_its_nudge():
    from spark_rapids_ml_tpu.regression import RandomForestRegressionModel as JaxModel

    model = RandomForestRegressionModel.fromTreeliteJSON({"num_feature": 1, "trees": ZERO_TREE})
    want = JaxModel.fromTreeliteJSON({"num_feature": 1, "trees": ZERO_TREE})
    assert_heap_equal(model.get_model_attributes(), want.get_model_attributes())
    assert model.get_model_attributes()["threshold"][0, 1] == -np.finfo(np.float32).tiny
    frame = pd.DataFrame({"features": list(np.array([[0.0], [-1.0]], np.float32))})
    np.testing.assert_array_equal(model.transform(frame)["prediction"].to_numpy(), [1.0, -1.0])


def test_treelite_classification_import_routes_as_the_jax_package():
    from spark_rapids_ml_tpu.classification import RandomForestClassificationModel as JaxModel

    model = RandomForestClassificationModel.fromTreeliteJSON(
        {"num_feature": 2, "trees": CLS_TREES}, num_classes=2)
    want = JaxModel.fromTreeliteJSON({"num_feature": 2, "trees": CLS_TREES}, num_classes=2)
    assert_heap_equal(model.get_model_attributes(), want.get_model_attributes())
    assert model.predict(np.array([1.0, 0.0])) == 0.0
    assert model.predict(np.array([2.0, 0.0])) == 1.0
    np.testing.assert_allclose(model.predictProbability(np.array([1.0, 0.0])), [0.9, 0.1],
                               atol=1e-7)
    with pytest.raises(ValueError, match="leaf_vector"):
        RandomForestClassificationModel.fromTreeliteJSON(
            {"num_feature": 2, "trees": REG_TREES[1:]}, num_classes=2)
