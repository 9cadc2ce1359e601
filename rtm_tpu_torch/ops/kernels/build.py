"""Build and load the hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface (it may
include the shared `csrc/*.cuh` headers).  At first use it is compiled by
`nvcc` for `sm_90a` into a shared library under `rtm_tpu_torch/_build/`
and loaded with ctypes.  The library's file name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# --fmad=false: the kernels round op by op like their plain versions, so
# the on-card comparison stays tight.  IEEE division and square root are
# nvcc's defaults (no --use_fast_math).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# every csrc/<name>.cu kernel library of the package
KERNELS = ("mxu_trace", "trav_trace", "cluster_sweep", "intersect_sweep",
           "mega_trace", "postpass", "row_grad")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (process or None, target path, temp path, log path)."""
    out = library_path(name)
    if out.exists():
        return None, out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, out, tmp, log


def build_kernels(names) -> dict[str, str]:
    """Build every named kernel library, all nvcc processes started
    together.  Returns each kernel's compiler output (ptxas register and
    shared-memory report); raises with the log if any build fails."""
    jobs = {name: _start_build(name) for name in names}
    reports = {}
    for name, (proc, out, tmp, log) in jobs.items():
        if proc is None:
            reports[name] = f"{out.name}: already built"
            continue
        rc = proc.wait()
        text = log.read_text()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {name} (rc={rc}):\n{text}")
        os.replace(tmp, out)
        reports[name] = text
    return reports


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def ptr(t):
    """A tensor's device address for a ctypes call; None (NULL) for None."""
    return None if t is None else t.data_ptr()


def check_arg(kernel: str, name: str, t, dtype, shape, dev) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of
    `shape` on `dev`: what a kernel's plain C interface takes."""
    if t is None or t.device != dev or t.dtype != dtype \
            or tuple(t.shape) != shape or not t.is_contiguous():
        got = ("None" if t is None else
               f"{t.dtype} {tuple(t.shape)} on {t.device}")
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {dev}; got {got}")
