"""One rank of a multi-process job of the PyTorch port on the CPU (gloo), run
by tests/test_torch_multiprocess.py and
tests/test_torch_multiprocess_knn_forest.py and
tests/test_torch_multiprocess_dbscan.py and tests/test_torch_forest_streaming.py:

    python tests/_torch_mp_worker.py <rank> <world> <port> <workdir> [fits | knn_forest | dbscan | forest_streaming]

It joins the group through the SRML_TPU_* environment and takes rows
[cuts[rank], cuts[rank + 1]) of each data set in <workdir>/data.npz (its
`<set>_cuts`). The "fits" job (the default) fits every case of `cases()`
in-core and streamed at each batch size of STREAM_BATCH_ROWS, and writes
<workdir>/rank<rank>.pkl: per (mode, case) the model attributes, the initial
centers of a KMeans fit, and the collectives the fit made
(comm.collective_ops and comm.collective_bytes). The "knn_forest" job (`knn_forest_main`) fits NearestNeighbors and
searches it (`knn_searches()`, both routes, every form) and fits the forests
(`forest_cases()`), and records the same way what each call returned or
raised and the collectives it made. The "dbscan" job (`dbscan_main`)
transforms every case of `dbscan_cases()` and records the labels, the
eps-counts summed over the ring's hops, the propagation rounds and the
collectives, and what each case of `dbscan_errors()` raised. The
"forest_streaming" job (`forest_streaming_main`) fits every case of
`streamed_forest_cases()` out-of-core (stream_threshold_bytes 1) and records
the model attributes and the collectives."""

import datetime
import os
import pickle
import sys

import numpy as np
import pandas as pd

STREAM_BATCH_ROWS = (48, 1024)


def cases():
    """case -> (data set, estimator factory, input: "array" or "frame")."""
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.regression import LinearRegression

    out = {
        "pca": ("blobs", lambda: PCA(k=3, inputCol="features"), "array"),
        "kmeans_random": ("blobs", lambda: KMeans(k=4, seed=1, initMode="random"), "array"),
        "kmeans_parallel": ("blobs", lambda: KMeans(k=4, seed=1), "array"),
        "kmeans_random_weighted": (
            "blobs", lambda: KMeans(k=4, seed=1, initMode="random", weightCol="w"), "frame"),
        "kmeans_parallel_weighted": (
            "blobs", lambda: KMeans(k=4, seed=1, weightCol="w"), "frame"),
        "ols": ("blobs", lambda: LinearRegression(), "frame"),
        "ridge": ("blobs", lambda: LinearRegression(regParam=0.1), "frame"),
        "elastic_net": (
            "blobs", lambda: LinearRegression(regParam=0.01, elasticNetParam=0.5), "frame"),
        "ols_weighted": ("blobs", lambda: LinearRegression(weightCol="w"), "frame"),
    }
    for design in ("constant", "duplicate"):
        out[f"ols_{design}"] = (design, lambda: LinearRegression(), "frame")
        out[f"ols_{design}_weighted"] = (design, lambda: LinearRegression(weightCol="w"), "frame")
    return out


def modes():
    """mode -> stream_batch_rows, None for in-core."""
    return {"in-core": None, **{f"streamed {b}": b for b in STREAM_BATCH_ROWS}}


def _input(data, kind, rank):
    lo, hi = int(data["cuts"][rank]), int(data["cuts"][rank + 1])
    X = data["X"][lo:hi]
    if kind == "array":
        return X
    return pd.DataFrame({"features": list(X), "label": data["y"][lo:hi], "w": data["w"][lo:hi]})


def main(rank: int, world: int, port: int, workdir: str, job: str = "fits") -> None:
    os.environ.update(SRML_TPU_COORDINATOR=f"127.0.0.1:{port}",
                      SRML_TPU_NUM_PROCESSES=str(world), SRML_TPU_PROCESS_ID=str(rank))
    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.ops import kmeans
    from spark_rapids_ml_torch.parallel import bootstrap, partitioner

    config.set("device", "cpu")
    if not bootstrap.init_from_env(timeout=datetime.timedelta(seconds=120)):
        raise RuntimeError("no multi-process group")
    part = partitioner.active_partitioner()
    if job in ("knn_forest", "dbscan", "forest_streaming"):
        run = {"knn_forest": knn_forest_main, "dbscan": dbscan_main,
               "forest_streaming": forest_streaming_main}[job]
        results = run(rank, dict(np.load(os.path.join(workdir, "data.npz"))))
        results.update(process_index=part.process_index, process_count=part.process_count)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        bootstrap.reset_process_group()
        return
    inits = []
    real_init = kmeans.gathered_init

    def recorded_init(*args):
        centers = real_init(*args)
        inits.append(centers.numpy().copy())
        return centers

    kmeans.gathered_init = recorded_init
    sets = np.load(os.path.join(workdir, "data.npz"))
    data = {name: {key: sets[f"{name}_{key}"] for key in ("X", "y", "w", "cuts")}
            for name in ("blobs", "constant", "duplicate")}
    results = {"process_index": part.process_index, "process_count": part.process_count}
    for mode, batch_rows in modes().items():
        config.set("stream_threshold_bytes", 1 if batch_rows else 0)
        config.set("stream_batch_rows", batch_rows or 1 << 20)
        for case, (name, make, kind) in cases().items():
            inits.clear()
            partitioner.reset_counters()
            model = make().fit(_input(data[name], kind, rank))
            results[(mode, case)] = {
                "attrs": model.get_model_attributes(),
                "init": inits[0] if inits else None,
                "comm": dict(partitioner.counters),
            }
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    bootstrap.reset_process_group()


# ------------------------------------------------------------ kNN and forests

KNN_K = 10
KNN_FORMS = ("float32", "bfloat16", "int8")
KNN_ROUTES = ("allgather", "ring")
# the forests' shape: trees, depth, bins and seed of every case
RF_TREES, RF_DEPTH, RF_BINS, RF_SEED = 3, 4, 16, 21


def knn_searches():
    """search -> (item set, query set, k, routes, forms, input kind): the
    searches of the kNN job. "frame": pandas frames with no id column (the
    default ids); "ids": frames with user ids; "array": numpy arrays."""
    both, f32 = KNN_ROUTES, ("float32",)
    return {
        "default": ("items", "queries", KNN_K, both, KNN_FORMS, "frame"),
        "array": ("items", "queries", KNN_K, both, f32, "array"),
        "user_ids": ("items", "queries", KNN_K, both, f32, "ids"),
        "duplicates": ("dups", "dup_queries", KNN_K, both, f32, "frame"),
        "k_above_items": ("tiny", "queries", KNN_K, both, ("float32", "int8"), "frame"),
        "queries_on_rank_0": ("items", "rank0_queries", KNN_K, both, f32, "frame"),
    }


def forest_cases():
    """case -> (estimator kind, label set, params, replay the JAX package's
    feature scores): the forests of the kNN / forest job."""
    base = dict(numTrees=RF_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=RF_SEED)
    return {
        "gini_2": ("classifier", "y2", base, True),
        "gini_3": ("classifier", "y3", base, True),
        "entropy_2_no_bootstrap": (
            "classifier", "y2", dict(base, impurity="entropy", bootstrap=False,
                                     subsamplingRate=0.7), True),
        "entropy_3": ("classifier", "y3", dict(base, impurity="entropy"), True),
        "gini_2_subsample": ("classifier", "y2", dict(base, subsamplingRate=0.7), True),
        "gini_2_weighted": ("classifier", "y2", dict(base, weightCol="w"), True),
        "gini_3_missing_on_rank_0": ("classifier", "y3_late", base, True),
        "gini_2_torch_scores": ("classifier", "y2", base, False),
        "variance": ("regressor", "yreg", base, True),
        "variance_no_bootstrap": (
            "regressor", "yreg", dict(base, bootstrap=False, subsamplingRate=0.7), True),
        "variance_weighted": ("regressor", "yreg", dict(base, weightCol="w"), True),
    }


def label_errors():
    """case -> label set: classifier fits that must raise on every rank."""
    return {"negative_on_last_rank": "y_negative", "class_missing_everywhere": "y_gap"}


def forest_estimator(kind, params):
    from spark_rapids_ml_torch.classification import RandomForestClassifier
    from spark_rapids_ml_torch.regression import RandomForestRegressor

    return (RandomForestClassifier if kind == "classifier" else RandomForestRegressor)(**params)


def replay(trees, scores):
    """Route trees._feature_scores through `scores`, in draw order."""
    import torch

    it = iter(scores)
    trees._feature_scores = lambda gen, width, d, device: torch.from_numpy(next(it)).to(device)


def jax_score_list(flat, n_trees, depth, d):
    """The per-level (2^t, d) score arrays of `flat`, the rows of every
    tree's levels stacked."""
    out, at = [], 0
    for _ in range(n_trees):
        for t in range(depth):
            out.append(flat[at : at + 2**t])
            at += 2**t
    return out


def knn_input(X, lo, hi, kind, ids=None):
    if kind == "array":
        return X[lo:hi]
    frame = pd.DataFrame({"features": list(X[lo:hi])})
    if kind == "ids":
        frame["id"] = ids[lo:hi]
    return frame


def _matrix(column, dtype):
    """A column of per-row arrays as one (rows, k) array; (0, 0) with no rows."""
    return np.stack(column.to_numpy()).astype(dtype) if len(column) else np.zeros((0, 0), dtype)


def _outcome(call, partitioner):
    """(what call() returned, or None, the exception's type name or None, the
    collectives it made)."""
    partitioner.reset_counters()
    try:
        out, raised = call(), None
    except Exception as e:  # recorded, and asserted on by the test
        out, raised = None, type(e).__name__
    return out, raised, dict(partitioner.counters)


def knn_forest_main(rank, sets):
    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.models import from_attributes
    from spark_rapids_ml_torch.models import knn as knn_model
    from spark_rapids_ml_torch.ops import trees
    from spark_rapids_ml_torch.parallel import partitioner

    def rows(name):
        return int(sets[f"{name}_cuts"][rank]), int(sets[f"{name}_cuts"][rank + 1])

    results = {"knn": {}, "forest": {}, "errors": {}}
    threshold = knn_model._RING_QUERY_THRESHOLD
    for search, (items, queries, k, routes, forms, kind) in knn_searches().items():
        X, Q = sets[f"{items}_X"], sets[f"{queries}_X"]
        ilo, ihi = rows(items)
        qlo, qhi = rows(queries)
        est = NearestNeighbors(k=k, inputCol="features", **({"idCol": "id"} if kind == "ids" else {}))
        partitioner.reset_counters()
        model = est.fit(knn_input(X, ilo, ihi, kind, sets[f"{items}_ids"]))
        comm = dict(partitioner.counters)
        results["knn"][(search, "fit")] = {"comm": comm,
                                           "item_ids": model.get_model_attributes()["item_ids"]}
        for route in routes:
            knn_model._RING_QUERY_THRESHOLD = threshold if route == "allgather" else 1
            for form in forms:
                config.set("knn_precision", form)
                q_in = knn_input(Q, qlo, qhi, kind, sets[f"{queries}_ids"])
                partitioner.reset_counters()
                _, q_out, knn_df = model.kneighbors(q_in)
                comm = dict(partitioner.counters)
                joined = model.exactNearestNeighborsJoin(q_in, distCol="dist")
                cols = list(knn_df.columns)
                results["knn"][(search, route, form)] = {
                    "comm": comm, "columns": cols,
                    "query_ids": knn_df[cols[0]].to_numpy(),
                    "ids": _matrix(knn_df["indices"], np.int64),
                    "distances": _matrix(knn_df["distances"], np.float32),
                    "query_frame_ids": (q_out[cols[0][len("query_"):]].to_numpy()
                                        if isinstance(q_out, pd.DataFrame) else None),
                    "join": joined.to_numpy(),
                }
        knn_model._RING_QUERY_THRESHOLD = threshold
        config.unset("knn_precision")
    # a NaN query on the last rank; a model from attributes under the group
    X, Q = sets["items_X"], sets["queries_X"].copy()
    ilo, ihi = rows("items")
    qlo, qhi = rows("queries")
    model = NearestNeighbors(k=KNN_K, inputCol="features").fit(knn_input(X, ilo, ihi, "frame"))
    if rank == len(sets["queries_cuts"]) - 2:
        Q[qhi - 1, 3] = np.nan
    _, raised, comm = _outcome(lambda: model.kneighbors(knn_input(Q, qlo, qhi, "frame")),
                               partitioner)
    results["errors"]["nan_query"] = {"raised": raised, "comm": comm}
    carried = from_attributes("nearest_neighbors", {"item_features": X, "item_ids": np.arange(len(X))},
                              device="cpu")
    _, raised, comm = _outcome(lambda: carried.kneighbors(knn_input(X, 0, 5, "frame")), partitioner)
    results["errors"]["from_attributes"] = {"raised": raised, "comm": comm}

    real_scores = trees._feature_scores
    X = sets["rf_X"]
    lo, hi = rows("rf")
    flat = sets["rf_scores"]
    for case, (kind, label, params, replayed) in forest_cases().items():
        trees._feature_scores = real_scores
        if replayed:
            replay(trees, jax_score_list(flat, RF_TREES, RF_DEPTH, X.shape[1]))
        frame = pd.DataFrame({"features": list(X[lo:hi]), "label": sets[f"rf_{label}"][lo:hi],
                              "w": sets["rf_w"][lo:hi]})
        partitioner.reset_counters()
        model = forest_estimator(kind, params).fit(frame)
        comm = dict(partitioner.counters)
        partitioner.reset_counters()
        out = model.transform(frame) if hi > lo else None
        results["forest"][case] = {
            "attrs": model.get_model_attributes(), "comm": comm,
            "transform_comm": dict(partitioner.counters),
            "prediction": None if out is None else out["prediction"].to_numpy(),
        }
    trees._feature_scores = real_scores
    for case, label in label_errors().items():
        frame = pd.DataFrame({"features": list(X[lo:hi]), "label": sets[f"rf_{label}"][lo:hi]})
        _, raised, comm = _outcome(
            lambda: forest_estimator("classifier", dict(numTrees=1, maxDepth=2)).fit(frame),
            partitioner)
        results["errors"][case] = {"raised": raised, "comm": comm}
    return results


# ------------------------------------------------------------------- DBSCAN


def dbscan_cases():
    """case -> (data set, eps, min_samples, metric): the transforms of the
    DBSCAN job, each rank passing its rows of the set as a pandas frame."""
    return {
        "blobs": ("db_blobs", 1.0, 8, "euclidean"),
        "cosine": ("db_cosine", 0.02, 6, "cosine"),
        "chain": ("db_chain", 1.5, 2, "euclidean"),
        "long_chain": ("db_long_chain", 1.5, 2, "euclidean"),
    }


def dbscan_errors():
    """case -> (data set, float32_inputs, expected exception): transforms that
    must raise on every rank. "zero_row": the last rank's last row is all
    zeros under the cosine metric; "f64": f64 features asked for."""
    return {"zero_row": ("db_cosine", True, "ValueError"),
            "f64": ("db_blobs", False, "NotImplementedError")}


def dbscan_main(rank, sets):
    from spark_rapids_ml_torch.clustering import DBSCAN
    from spark_rapids_ml_torch.ops import dbscan
    from spark_rapids_ml_torch.parallel import partitioner

    def frame(name, last_row_zero=False):
        lo, hi = int(sets[f"{name}_cuts"][rank]), int(sets[f"{name}_cuts"][rank + 1])
        X = sets[f"{name}_X"][lo:hi].copy()
        if last_row_zero and rank == len(sets[f"{name}_cuts"]) - 2:
            X[-1] = 0.0
        return pd.DataFrame({"features": list(X)})

    count, hops = dbscan.fused_count_below, []

    def counted(*args):
        c = count(*args)
        hops.append(c.numpy().astype(np.int64))
        return c

    results = {"dbscan": {}, "errors": {}}
    for case, (name, eps, min_samples, metric) in dbscan_cases().items():
        model = DBSCAN(eps=eps, min_samples=min_samples, metric=metric).fit(frame(name))
        rounds = dbscan._propagate_labels.rounds
        hops.clear()
        dbscan.fused_count_below = counted
        try:
            out, raised, comm = _outcome(lambda: model.transform(frame(name)), partitioner)
        finally:
            dbscan.fused_count_below = count
        n = len(frame(name))
        results["dbscan"][case] = {
            "labels": None if out is None else out["prediction"].to_numpy(), "raised": raised,
            "rounds": dbscan._propagate_labels.rounds - rounds, "comm": comm,
            # the eps-counts summed over the ring's hops (none on an empty rank)
            "counts": np.sum(hops, axis=0, dtype=np.int64) if hops else np.zeros(n, np.int64)}
    for case, (name, f32, _) in dbscan_errors().items():
        est = DBSCAN(eps=0.02, min_samples=6, metric="cosine", float32_inputs=f32)
        _, raised, comm = _outcome(
            lambda: est.fit(frame(name)).transform(frame(name, last_row_zero=True)), partitioner)
        results["errors"][case] = {"raised": raised, "comm": comm}
    return results



# ------------------------------------------------------------ streamed forests

# trees, depth and seed of the streamed forest cases; the batch rows of the
# whole group (each rank streams its share, resolve_batch_rows_per_process)
FS_TREES, FS_DEPTH, FS_SEED, FS_BATCH_ROWS = 3, 4, 5, 1000


def streamed_forest_cases():
    """case -> (estimator kind, data set, label, params): the streamed fits of
    the forest_streaming job; every case replays the JAX package's scores.
    "strided": more than 2 x 200,000 rows, so the edge sample takes every
    second global row and the ranks' first sampled rows differ."""
    base = dict(numTrees=FS_TREES, maxDepth=FS_DEPTH, seed=FS_SEED)
    return {
        "gini_2": ("classifier", "fs", "y2", dict(base, maxBins=16)),
        "entropy_3": ("classifier", "fs", "y3", dict(base, impurity="entropy")),
        "variance_integer": ("regressor", "fs", "yint", dict(base, maxBins=8)),
        "strided": ("classifier", "fsbig", "y2",
                    dict(numTrees=1, maxDepth=2, maxBins=16, seed=FS_SEED)),
    }


def forest_streaming_main(rank, sets):
    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.ops import trees
    from spark_rapids_ml_torch.parallel import partitioner

    results = {"forest": {}}
    real_scores = trees._feature_scores
    config.set("stream_threshold_bytes", 1)
    config.set("stream_batch_rows", FS_BATCH_ROWS)
    for case, (kind, name, label, params) in streamed_forest_cases().items():
        lo, hi = int(sets[f"{name}_cuts"][rank]), int(sets[f"{name}_cuts"][rank + 1])
        replay(trees, jax_score_list(sets[f"{name}_scores_{params['numTrees']}"],
                                     params["numTrees"], params["maxDepth"],
                                     sets[f"{name}_X"].shape[1]))
        frame = pd.DataFrame({"features": list(sets[f"{name}_X"][lo:hi]),
                              "label": sets[f"{name}_{label}"][lo:hi],
                              "w": sets[f"{name}_w"][lo:hi]})
        partitioner.reset_counters()
        model = forest_estimator(kind, params).fit(frame)
        results["forest"][case] = {"attrs": model.get_model_attributes(),
                                   "comm": dict(partitioner.counters)}
    trees._feature_scores = real_scores
    return results


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         *(sys.argv[5:6] or ["fits"]))

