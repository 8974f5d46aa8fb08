"""ctypes bindings of the host-side geometry routines of native/nf_native.cc
(port of neurofluid_tpu/native/__init__.py, the same C++ source unchanged).

The shared library is built with g++ at first use into
build/neurofluid_torch/, named by a hash of the source, the flags and the
host's CPU features (`-march=native` code must not run on another CPU: a
copy of the tree on another machine builds its own). When g++ or the build
fails, each wrapper falls back to scipy and to `utils.metrics`, as the JAX
package's loader does: these are host tools, no device path runs through
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from neurofluid_torch.cuda import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "nf_native.cc"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _cpu_features() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(_cpu_features())
    return BUILD_DIR / f"libnf_native-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, out)  # a concurrent loader sees all or nothing


def load():
    """The loaded library (built first if needed), or None when it cannot
    be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError):
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.nf_nearest_neighbors.argtypes = [
            f32p, ctypes.c_int32, f32p, ctypes.c_int32, f32p, i32p]
        lib.nf_nearest_neighbors.restype = None
        lib.nf_chamfer.argtypes = [f32p, ctypes.c_int32, f32p, ctypes.c_int32]
        lib.nf_chamfer.restype = ctypes.c_float
        lib.nf_radius_counts.argtypes = [
            f32p, ctypes.c_int32, f32p, ctypes.c_int32, ctypes.c_float,
            ctypes.c_int32, i32p]
        lib.nf_radius_counts.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _as_f32(x) -> np.ndarray:
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"expected (N, 3) points, got {x.shape}")
    return x


def nearest_neighbor_distances(points, queries):
    """(distance (Q,) float32, index (Q,) int32) of each query's nearest
    point; inf and -1 when there are no points."""
    lib = load()
    points, queries = _as_f32(points), _as_f32(queries)
    if lib is None:
        from scipy.spatial import cKDTree

        d, i = cKDTree(points).query(queries)
        return d.astype(np.float32), i.astype(np.int32)
    out_d = np.empty(len(queries), np.float32)
    out_i = np.empty(len(queries), np.int32)
    lib.nf_nearest_neighbors(points, len(points), queries, len(queries),
                             out_d, out_i)
    return out_d, out_i


def chamfer(x, y) -> float:
    """The symmetric chamfer distance of `utils.metrics.chamfer_distance_np`."""
    lib = load()
    x, y = _as_f32(x), _as_f32(y)
    if lib is None:
        from neurofluid_torch.utils.metrics import chamfer_distance_np

        return chamfer_distance_np(x, y)
    return float(lib.nf_chamfer(x, len(x), y, len(y)))


def radius_counts(points, queries, radius, exclude_self=False):
    """(Q,) int32 points within `radius` of each query (inclusive),
    without the query's own point when `exclude_self`."""
    lib = load()
    points, queries = _as_f32(points), _as_f32(queries)
    if lib is None:
        from scipy.spatial import cKDTree

        tree = cKDTree(points)
        counts = np.asarray(
            [len(tree.query_ball_point(q, radius)) for q in queries], np.int32)
        if exclude_self:
            d, _ = tree.query(queries)
            counts -= (d == 0).astype(np.int32)
        return counts
    out = np.empty(len(queries), np.int32)
    lib.nf_radius_counts(points, len(points), queries, len(queries),
                         float(radius), int(exclude_self), out)
    return out
