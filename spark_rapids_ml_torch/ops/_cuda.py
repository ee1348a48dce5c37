#
# Build and bind the hand-written CUDA kernels (csrc/*.cu).
#
# Each source is compiled on first use by nvcc, for sm_90a, into a shared library
# with a plain C interface, and loaded with ctypes (no PyTorch headers, so a
# build takes seconds). The build directory is `build/torch_kernels/` beside the
# package, one subdirectory per content hash of the sources and flags, so an
# edited source rebuilds and an unchanged one loads what is there. `build()`
# starts one nvcc per source, all at once. The sources and their entry points:
#   xtx.cu    srml_xtx, srml_xtxy            (ops/xtwx.py)
#   lloyd.cu  srml_lloyd_step                (ops/lloyd.py)
#   assign.cu srml_assign                    (ops/select.py)
#   count.cu  srml_count                     (ops/count.py)
#   topk.cu   srml_topk                      (ops/topk.py, float32)
#   topk_narrow.cu srml_topk_narrow          (ops/topk.py, bfloat16 and int8)
#   probe.cu  srml_probe                     (ops/topk.py::fused_probe)
#   hist.cu   srml_node_bin_hist, srml_segment_hist  (ops/histogram.py)
# Every source may include the headers beside it (nearest.cuh, tf32x3.cuh,
# bf16split.cuh, topk_keys.cuh);
# each library's hash covers them all.
#
# Every pointer and the stream cross as ctypes.c_void_p; each C entry point
# returns cudaGetLastError(), and `check` raises when it is not 0.
#

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
SOURCES = ("xtx", "lloyd", "assign", "count", "topk", "topk_narrow", "probe", "hist")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# entry point -> (source, C symbol, C signature)
ENTRIES = {
    "xtx": ("xtx", "srml_xtx", [_P, _L, _I, _L, _I, _P, _P, _P, _P, _I, _P]),
    "xtxy": ("xtx", "srml_xtxy",
             [_P, _P, _L, _I, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P]),
    "lloyd": ("lloyd", "srml_lloyd_step",
              [_P, _P, _L, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _I, _L, _P, _P, _I, _P]),
    "assign": ("assign", "srml_assign",
               [_P, _L, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _L, _I, _L, _I, _P]),
    "count": ("count", "srml_count", [_P, _P, _L, _I, _P, _P, _I, _F, _P, _P]),
    "topk": ("topk", "srml_topk", [_P, _P, _L, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "topk_narrow": ("topk_narrow", "srml_topk_narrow",
                    [_P, _P, _L, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                     _P, _P, _I, _P, _P]),
    "probe": ("probe", "srml_probe",
              [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "node_bin_hist": ("hist", "srml_node_bin_hist",
                      [_P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _I, _I, _I,
                       _I, _I, _P, _P, _P]),
    "segment_hist": ("hist", "srml_segment_hist",
                     [_P, _P, _L, _I, _I, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _P, _P, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together. Returns each source's ptxas report (empty when it was
    already built). Raises if any compile fails."""
    procs = {}
    for name in names:
        lib = _library_path(name)
        if lib.is_file():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def entry(name: str) -> ctypes._CFuncPtr:
    """The C entry point `name` (a key of ENTRIES), its source built and loaded
    on first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            source, sym, argtypes = ENTRIES[name]
            build([source])
            fn = getattr(ctypes.CDLL(str(_library_path(source))), sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the integer the C side takes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def count_launch(fn, attr: str) -> None:
    """Add one to the launch counter `attr` of the wrapper `fn`."""
    setattr(fn, attr, getattr(fn, attr) + 1)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} (cudaError_t)")


def require(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32) -> None:
    """Raise unless `t` has the dtype, shape and contiguity a kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_kind(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for tensors that all lie on one device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind


def sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count
