#
# Estimator/model persistence of the PyTorch port: its own copy of the JAX
# package's core/persistence.py (reference core.py:268-355), writing and reading
# the same directory format, so that a directory saved by either package loads
# in the other:
#   metadata.json      class name, uid, user-set + default params, backend params
#   arrays.npz         every ndarray-valued model attribute, in its dtype (a port
#                      model's constructor holds its attributes as numpy arrays
#                      and Python scalars, on the host, as the JAX package's do)
#   attributes.json    every other model attribute; a model with no fitted
#                      state (DBSCAN's) writes {}; an estimator writes neither
#
# The class-name rule. The format names the JAX package's class path
# ("spark_rapids_ml_tpu.models.clustering.KMeansModel"), which the JAX loader
# imports and checks against the class it was asked for. The port's modules
# mirror the JAX package's (models/feature.py, clustering.py, regression.py,
# dbscan.py, tree.py) and its classes carry the same names, so the port writes
# its class's path with the package prefix "spark_rapids_ml_torch." spelled
# "spark_rapids_ml_tpu.", and its loader maps that prefix back by string and
# imports the port's module. The port never imports the JAX package.
#
# Backend params ("tpuParams", the port's `_torch_params`). The JAX loader takes
# the dict whole, so the port writes the JAX package's key set: its own keys
# and those of `_format_params_default()`, the keys the format carries that the
# port has no op for (PCA's "whiten", KMeans's "n_init"), at the one value the
# port computes. Loading, the port keeps the keys it has, drops a format key at
# that value, and records any other key or value as unsupported, so that fit or
# transform raises rather than hand it to an op. The JAX package's `verbose`
# param (its logging only) has no port counterpart: a port load skips it, as the
# JAX loader skips a param its class lacks, and a JAX load of a port directory
# takes its default. The device is not saved: a loaded instance runs where the
# config key `device` (or a later `_device`) says.
#
# Not ported: the ANN-index branch (ops/ann_lifecycle.py) and the CSR branch of
# the JAX package's save_instance, which wait for IVF and UMAP. The port's
# NearestNeighborsModel refuses to write or read.
#

from __future__ import annotations

import importlib
import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Type

import numpy as np

VERSION = "0.1.0"  # the format's version, the JAX package's
FORMAT_PREFIX = "spark_rapids_ml_tpu."
PORT_PREFIX = "spark_rapids_ml_torch."


def _json_default(o: Any) -> Any:
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _format_class_name(cls: Type) -> str:
    """The class path the format names for a port class (module header)."""
    module = cls.__module__
    if not module.startswith(PORT_PREFIX):
        raise ValueError(f"{module}.{cls.__qualname__} is not a class of the port")
    return FORMAT_PREFIX + module[len(PORT_PREFIX):] + "." + cls.__qualname__


def _resolve_class(qualname: str) -> Type:
    """The port's class for a class path of the format (module header)."""
    if not qualname.startswith(FORMAT_PREFIX):
        raise ValueError(f"a saved {qualname} names no class of the format")
    module_name, _, cls_name = (PORT_PREFIX + qualname[len(FORMAT_PREFIX):]).rpartition(".")
    try:
        obj: Any = importlib.import_module(module_name)
        for part in cls_name.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError):
        raise NotImplementedError(f"{qualname} has no counterpart in the port") from None
    return obj


def save_instance(instance: Any, path: str, overwrite: bool = False) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise IOError(f"Path {path} already exists; use write().overwrite().save(path).")
        shutil.rmtree(path)  # stale attribute/array files must not survive an overwrite
    os.makedirs(path, exist_ok=True)

    metadata: Dict[str, Any] = {
        "class": _format_class_name(type(instance)),
        "timestamp": int(time.time() * 1000),
        "version": VERSION,
        "uid": instance.uid,
        "paramMap": {p.name: v for p, v in instance._paramMap.items()},
        "defaultParamMap": {p.name: v for p, v in instance._defaultParamMap.items()},
        "tpuParams": {**instance._format_params_default(), **instance._torch_params},
        "numWorkers": getattr(instance, "_num_workers", None),
        "float32Inputs": instance._float32_inputs,
    }
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata, f, default=_json_default)

    attrs: Optional[Dict[str, Any]] = getattr(instance, "_model_attributes", None)
    if attrs is not None:
        arrays, scalars = {}, {}
        for k, v in attrs.items():
            if isinstance(v, np.ndarray):
                arrays[k] = v
            else:
                scalars[k] = v
        if arrays:
            np.savez(os.path.join(path, "arrays.npz"), **arrays)
        with open(os.path.join(path, "attributes.json"), "w") as f:
            json.dump(scalars, f, default=_json_default)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "metadata.json")) as f:
        return json.load(f)


def _restore_backend_params(instance: Any, saved: Dict[str, Any]) -> None:
    """The saved backend params on a port instance (module header)."""
    own, fixed = instance._get_torch_params_default(), instance._format_params_default()
    for key, value in saved.items():
        if key in own:
            instance._torch_params[key] = value
        elif not (key in fixed and value == fixed[key]):
            instance._unsupported_params[key] = value


def load_instance(path: str, expected_cls: Optional[Type] = None) -> Any:
    metadata = load_metadata(path)
    cls = _resolve_class(metadata["class"])
    if expected_cls is not None and not issubclass(cls, expected_cls):
        raise TypeError(
            f"Path {path} holds a {metadata['class']}, which is not a {expected_cls.__name__}"
        )

    attr_file = os.path.join(path, "attributes.json")
    if os.path.exists(attr_file):
        with open(attr_file) as f:
            attrs: Dict[str, Any] = json.load(f)
        npz_file = os.path.join(path, "arrays.npz")
        if os.path.exists(npz_file):
            with np.load(npz_file) as data:
                attrs.update({k: data[k] for k in data.files})
        instance = cls._from_row(attrs)
    else:
        instance = cls()

    instance._resetUid(metadata["uid"])
    for name, value in metadata.get("defaultParamMap", {}).items():
        if instance.hasParam(name):
            instance._setDefault(**{name: value})
    for name, value in metadata.get("paramMap", {}).items():
        if instance.hasParam(name):
            instance._set(**{name: value})
    _restore_backend_params(instance, metadata.get("tpuParams", {}))
    instance._float32_inputs = metadata.get("float32Inputs", True)
    return instance


class ParamsWriter:
    """`instance.write().overwrite().save(path)` chain, mirroring pyspark's MLWriter."""

    def __init__(self, instance: Any):
        self._instance = instance
        self._overwrite = False

    def overwrite(self) -> "ParamsWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        save_instance(self._instance, path, overwrite=self._overwrite)


class ParamsReader:
    """`Cls.read().load(path)` chain, mirroring pyspark's MLReader."""

    def __init__(self, cls: Type):
        self._cls = cls

    def load(self, path: str) -> Any:
        return load_instance(path, self._cls)


class Persistable:
    """`write`/`save`/`read`/`load` of an estimator or a model (reference
    core.py:268-355), mixed into both of the port's bases."""

    def write(self) -> ParamsWriter:
        return ParamsWriter(self)

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def read(cls) -> ParamsReader:
        return ParamsReader(cls)

    @classmethod
    def load(cls, path: str) -> Any:
        return cls.read().load(path)
