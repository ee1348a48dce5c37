"""PyTorch port, save/load in the JAX package's directory format
(spark_rapids_ml_torch/core/persistence.py) for PCA, KMeans, LinearRegression,
DBSCAN, RandomForestClassifier and RandomForestRegressor, their estimators
and their models: port -> port, port -> JAX package and JAX package -> port.

Data (numpy, seed 0): 300 x 5 f32, three Gaussian blobs (sd 0.6, centers
N(0, 4²)), label the blob (0, 1, 2) as a float. DBSCAN's eps lies in a gap of
the pair distances, at least 1e-6·(|a| + |b|)² from every pair's d2
(tests/test_torch_dbscan.py's rule), so that both packages' labels are exact.

What is held:
  * the directory: the same files, metadata keys and attribute keys whichever
    package wrote it;
  * what loads: the class of the loading package, the uid, every param both
    classes have (the JAX package's `verbose`, its logging only, has no port
    counterpart), the backend params (the JAX package's key set: the port's
    and `_format_params_default()`), float32_inputs, and every model
    attribute: arrays bit for bit in the same dtypes and shapes, scalars
    equal;
  * transforms: port -> port bit for bit; across the packages, at the
    estimators' parity tolerances (tests/test_torch_*.py): labels equal,
    PCA projections within rtol 1e-5, atol 1e-5 · max |projection|,
    LinearRegression and forest regressor predictions within rtol 1e-5,
    atol 1e-5 · max |y|, forest class probabilities within 1e-6;
  * a port-saved estimator fits in the JAX package, to the model the JAX
    estimator with the same params fits, bit for bit;
  * the overwrite rules; NearestNeighbors and its model refuse to persist; a
    backend value the port cannot honor raises at fit, never reaches an op."""

import json
import os

import numpy as np
import pandas as pd
import pytest

import spark_rapids_ml_torch.classification as t_cls
import spark_rapids_ml_torch.clustering as t_clu
import spark_rapids_ml_torch.feature as t_feat
import spark_rapids_ml_torch.regression as t_reg
from spark_rapids_ml_torch import config

N, D = 300, 5


def _data():
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 4, (3, D))
    blob = rng.integers(0, 3, N)
    X = (centers[blob] + rng.normal(0, 0.6, (N, D))).astype(np.float32)
    return pd.DataFrame({"features": list(X), "label": blob.astype(np.float64)}), X


def _clear_eps(X, target):
    """A radius near target whose square lies in a gap of the pair d2, at
    least 1e-6·(|a| + |b|)² from every pair's."""
    X = X.astype(np.float64)
    sq = (X * X).sum(1)
    d2 = np.maximum(sq[:, None] - 2 * X @ X.T + sq[None, :], 0)
    v = np.unique(d2.ravel())
    i = np.searchsorted(v, target * target)
    j = i - 200 + int(np.argmax(np.diff(v[i - 200 : i + 200])))
    eps2 = 0.5 * (v[j] + v[j + 1])
    norms = np.sqrt(sq)
    assert np.all(np.abs(d2 - eps2) >= 1e-6 * (norms[:, None] + norms[None, :]) ** 2)
    return float(np.sqrt(eps2))


DF, X = _data()
EPS = _clear_eps(X, 1.0)


def _packages():
    """case -> ((port estimator class, JAX estimator class), params, output
    columns and how they compare across the packages)."""
    import spark_rapids_ml_tpu.classification as j_cls
    import spark_rapids_ml_tpu.clustering as j_clu
    import spark_rapids_ml_tpu.feature as j_feat
    import spark_rapids_ml_tpu.regression as j_reg

    forest = dict(numTrees=3, maxDepth=3, seed=1)
    return {
        "pca": ((t_feat.PCA, j_feat.PCA), dict(k=2, inputCol="features"), {"pca_features": "pca"}),
        "kmeans": ((t_clu.KMeans, j_clu.KMeans), dict(k=3, seed=1), {"prediction": "equal"}),
        "linear_regression": ((t_reg.LinearRegression, j_reg.LinearRegression),
                              dict(regParam=0.01, elasticNetParam=0.5), {"prediction": "y"}),
        "dbscan": ((t_clu.DBSCAN, j_clu.DBSCAN), dict(eps=EPS, min_samples=5),
                   {"prediction": "equal"}),
        "rf_classifier": ((t_cls.RandomForestClassifier, j_cls.RandomForestClassifier), forest,
                          {"prediction": "equal", "probability": "prob"}),
        "rf_regressor": ((t_reg.RandomForestRegressor, j_reg.RandomForestRegressor), forest,
                         {"prediction": "y"}),
    }


CASES = ("pca", "kmeans", "linear_regression", "dbscan", "rf_classifier", "rf_regressor")


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set("device", "cpu")
    yield
    config.unset("device")


def fitted(case):
    """(port estimator, its model, JAX estimator, its model)."""
    (t_est, j_est), params, _ = _packages()[case]
    te, je = t_est(**params), j_est(**params)
    return te, te.fit(DF), je, je.fit(DF)


def column(out, name):
    values = out[name].to_numpy()
    return np.stack(values) if values.dtype == object else values


def assert_outputs(case, got, want, exact):
    for name, rule in _packages()[case][2].items():
        a, b = column(got, name), column(want, name)
        assert a.shape == b.shape
        if exact or rule == "equal":
            np.testing.assert_array_equal(a, b)
        elif rule == "pca":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
        elif rule == "y":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * 2.0)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def param_values(obj):
    """(user-set, default) params by name, but the JAX package's verbose."""
    def named(m):
        return {p.name: v for p, v in m.items() if p.name != "verbose"}

    return named(obj._paramMap), named(obj._defaultParamMap)


def backend_params(obj):
    return obj._torch_params if hasattr(obj, "_torch_params") else obj._tpu_params


def saved_backend_params(port_obj):
    return {**port_obj._format_params_default(), **port_obj._torch_params}


def assert_same_attributes(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == v.dtype and g.shape == v.shape, k
            np.testing.assert_array_equal(g, v)
        else:
            assert g == v and type(g) is type(v), k


def assert_loaded(loaded, original, cls, backend):
    assert type(loaded) is cls and loaded.uid == original.uid
    assert param_values(loaded) == param_values(original)
    assert backend_params(loaded) == backend
    assert loaded._float32_inputs == original._float32_inputs
    if hasattr(original, "_model_attributes"):
        assert_same_attributes(loaded.get_model_attributes(), original.get_model_attributes())


@pytest.mark.parametrize("case", CASES)
def test_port_round_trip(tmp_path, case):
    te, tm, _, _ = fitted(case)
    for obj, path in ((te, tmp_path / "est"), (tm, tmp_path / "model")):
        obj.save(str(path))
        loaded = type(obj).load(str(path))
        assert_loaded(loaded, obj, type(obj), obj._torch_params)
        again = type(obj).read().load(str(path))
        assert again.uid == obj.uid
        assert loaded._device is None and not getattr(loaded, "_has_training_summary", False)
    loaded = type(tm).load(str(tmp_path / "model"))
    assert_outputs(case, loaded.transform(DF), tm.transform(DF), exact=True)
    refit = type(te).load(str(tmp_path / "est")).fit(DF)
    assert_same_attributes(refit.get_model_attributes(), tm.get_model_attributes())


@pytest.mark.parametrize("case", CASES)
def test_a_port_directory_loads_in_the_jax_package(tmp_path, case):
    te, tm, je, jm = fitted(case)
    for obj, jcls, path in ((te, type(je), tmp_path / "est"), (tm, type(jm), tmp_path / "model")):
        obj.save(str(path))
        loaded = jcls.load(str(path))
        assert_loaded(loaded, obj, jcls, saved_backend_params(obj))
    loaded = type(jm).load(str(tmp_path / "model"))
    assert_outputs(case, loaded.transform(DF), tm.transform(DF), exact=False)


@pytest.mark.parametrize("case", CASES)
def test_a_jax_directory_loads_in_the_port(tmp_path, case):
    te, tm, je, jm = fitted(case)
    for obj, tcls, path in ((je, type(te), tmp_path / "est"), (jm, type(tm), tmp_path / "model")):
        obj.save(str(path))
        loaded = tcls.load(str(path))
        own = tcls._get_torch_params_default()
        assert_loaded(loaded, obj, tcls, {k: v for k, v in obj._tpu_params.items() if k in own})
        assert loaded._unsupported_params == {}
    loaded = type(tm).load(str(tmp_path / "model"))
    assert_outputs(case, loaded.transform(DF), jm.transform(DF), exact=False)


@pytest.mark.parametrize("case", CASES)
def test_both_packages_write_the_same_files_and_keys(tmp_path, case):
    te, tm, je, jm = fitted(case)
    for tag, port_obj, jax_obj in (("est", te, je), ("model", tm, jm)):
        port_obj.save(str(tmp_path / f"port_{tag}"))
        jax_obj.save(str(tmp_path / f"jax_{tag}"))
        a, b = tmp_path / f"port_{tag}", tmp_path / f"jax_{tag}"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        meta_a, meta_b = (json.load(open(p / "metadata.json")) for p in (a, b))
        assert sorted(meta_a) == sorted(meta_b) and meta_a["class"] == meta_b["class"]
        assert meta_a["tpuParams"] == meta_b["tpuParams"]
        if tag == "model":
            attrs_a, attrs_b = (json.load(open(p / "attributes.json")) for p in (a, b))
            assert sorted(attrs_a) == sorted(attrs_b)
            if case == "dbscan":
                assert attrs_a == {} and not (a / "arrays.npz").exists()
            else:
                with np.load(a / "arrays.npz") as za, np.load(b / "arrays.npz") as zb:
                    assert sorted(za.files) == sorted(zb.files)
                    assert all(za[k].dtype == zb[k].dtype for k in za.files)


@pytest.mark.parametrize("case", CASES)
def test_a_port_saved_estimator_fits_in_the_jax_package(tmp_path, case):
    te, _, je, jm = fitted(case)
    te.save(str(tmp_path / "est"))
    got = type(je).load(str(tmp_path / "est")).fit(DF)
    assert_same_attributes(got.get_model_attributes(), jm.get_model_attributes())
    assert_outputs(case, got.transform(DF), jm.transform(DF), exact=True)


def test_the_overwrite_rules(tmp_path):
    te, tm, _, _ = fitted("kmeans")
    path = str(tmp_path / "m")
    tm.save(path)
    with pytest.raises(IOError, match="already exists"):
        tm.save(path)
    with pytest.raises(IOError, match="already exists"):
        te.write().save(path)
    stale = os.path.join(path, "stale.txt")
    open(stale, "w").close()
    te.write().overwrite().save(path)  # an estimator over a model: no attributes remain
    assert sorted(os.listdir(path)) == ["metadata.json"]
    assert type(t_clu.KMeans.load(path)) is t_clu.KMeans
    with pytest.raises(TypeError, match="not a KMeansModel"):
        t_clu.KMeansModel.load(path)


def test_nearest_neighbors_refuses_to_persist(tmp_path):
    from spark_rapids_ml_torch.knn import NearestNeighbors, NearestNeighborsModel

    est = NearestNeighbors(k=3, inputCol="features")
    model = est.fit(DF)
    for call in (est.write, lambda: est.save(str(tmp_path / "e")), model.write,
                 lambda: model.save(str(tmp_path / "m")), NearestNeighborsModel.read,
                 lambda: NearestNeighborsModel.load(str(tmp_path / "m"))):
        with pytest.raises(NotImplementedError, match="not persistable"):
            call()
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("key, value", [("n_init", 3), ("unknown", 1)])
def test_a_backend_value_the_port_cannot_honor_raises_at_fit(tmp_path, key, value):
    """A JAX-saved KMeans with n_init 3 (the port runs one init) or a key the
    port does not know: the port loads it, and its fit raises before any op."""
    from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans

    je = JaxKMeans(k=3, seed=1)
    je._tpu_params[key] = value
    je.save(str(tmp_path / "est"))
    loaded = t_clu.KMeans.load(str(tmp_path / "est"))
    assert key not in loaded._torch_params and loaded._unsupported_params == {key: value}
    with pytest.raises(ValueError, match="not supported"):
        loaded.fit(DF)


def test_a_loaded_model_runs_where_the_config_says(tmp_path):
    _, tm, _, _ = fitted("linear_regression")
    tm._device = "cpu"
    tm.save(str(tmp_path / "m"))
    loaded = t_reg.LinearRegressionModel.load(str(tmp_path / "m"))
    assert loaded._device is None
    config.set("device", "cuda")
    try:
        import torch

        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                loaded.transform(DF)
    finally:
        config.set("device", "cpu")
    assert_outputs("linear_regression", loaded.transform(DF), tm.transform(DF), exact=True)
