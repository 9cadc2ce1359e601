"""ctypes binding of the native C++ SAH builder (accel/native/bvh.cpp).

Port of rtm_tpu/accel/native/bvh_native.py.  The shared library is built
at first use with the system g++ into `rtm_tpu_torch/_build/`, beside the
CUDA kernel libraries (ops/kernels/build.py), under a name that carries a
hash of the source and flags, so an edited source is rebuilt and a stale
library is never loaded.  Concurrent first uses (several test workers)
each compile to a name of their own and `os.replace` it into place.

Unlike rtm_tpu's binding, nothing falls back: a failed compile raises with
g++'s output.  `accel.bvh.build_bvh(mesh, use_native=False)` is the way to
the NumPy builder, and the native build is bitwise the NumPy one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ...ops.kernels.build import BUILD_DIR

SRC = Path(__file__).resolve().with_name("bvh.cpp")
# -ffp-contract=off: no fused multiply-add, so the f32 arithmetic rounds op
# by op as NumPy's does
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}


def library_path(src: Path, build_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return build_dir / f"librtm_bvh_{h.hexdigest()[:16]}.so"


def compile_library(src: Path, build_dir: Path) -> Path:
    """Build the library from `src` unless it exists; returns its path.
    Raises RuntimeError with the compiler's output if g++ fails."""
    out = library_path(src, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native BVH builder is built "
                           "from source at first use; pass use_native=False "
                           "for the NumPy builder") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {src} (rc={proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded builder library (SRC built into BUILD_DIR), compiled
    first if needed."""
    path = library_path(SRC, BUILD_DIR)
    with _lock:
        lib = _loaded.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(compile_library(SRC, BUILD_DIR)))
            fp = ctypes.POINTER(ctypes.c_float)
            up = ctypes.POINTER(ctypes.c_uint32)
            lib.rtm_bvh_build.restype = ctypes.c_int
            lib.rtm_bvh_build.argtypes = [
                fp, ctypes.c_int, fp, fp, fp, up, up, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double)]
            _loaded[path] = lib
    return lib


def build(mesh):
    """Build the BVH of `mesh` natively: an accel.bvh.BVH, bitwise the
    NumPy builder's."""
    from ..bvh import BVH, BvhStats

    lib = load()
    verts = np.ascontiguousarray(mesh.verts, np.float32).reshape(-1, 3, 3)
    t = len(verts)
    vol = np.ascontiguousarray(
        np.concatenate([np.asarray(mesh.volume_min, np.float32),
                        np.asarray(mesh.volume_max, np.float32)]), np.float32)
    cap = max(1, 2 * t)
    box_min = np.empty((cap, 3), np.float32)
    box_max = np.empty((cap, 3), np.float32)
    region = np.empty((cap, 2), np.uint32)
    order = np.empty((max(t, 1),), np.uint32)
    stats10 = np.zeros((10,), np.float64)

    fp = ctypes.POINTER(ctypes.c_float)
    up = ctypes.POINTER(ctypes.c_uint32)
    n = lib.rtm_bvh_build(
        verts.ctypes.data_as(fp), t, vol.ctypes.data_as(fp),
        box_min.ctypes.data_as(fp), box_max.ctypes.data_as(fp),
        region.ctypes.data_as(up), order.ctypes.data_as(up), cap,
        stats10.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if n < 0:
        # a binary tree over t leaves holds at most 2t - 1 nodes
        raise RuntimeError(f"native BVH build overflowed {cap} nodes for "
                           f"{t} triangles")
    stats = BvhStats(
        tri_cnt=int(stats10[0]), node_cnt=int(stats10[1]),
        leaf_cnt=int(stats10[2]),
        leaf_depth_min=int(stats10[3]), leaf_depth_max=int(stats10[4]),
        leaf_depth_sum=float(stats10[5]),
        leaf_tris_min=int(stats10[6]), leaf_tris_max=int(stats10[7]),
        leaf_tris_sum=float(stats10[8]), sah=float(stats10[9]))
    return BVH(box_min=box_min[:n].copy(), box_max=box_max[:n].copy(),
               buffer_region=region[:n].copy(), order=order[:t].copy(),
               stats=stats)
