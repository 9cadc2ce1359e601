"""Intersection-only cluster sweep: the kernel half of the sorted-wavefront
renderer (ops/wavefront2.py).

Port of rtm_tpu/ops/pallas/sweep_kernel.py, whose kernel body is
megakernel.py `_tri_sweep`.  Input: an (8, Np) ray band [ox oy oz dx dy dz
alive 0] (Np a multiple of the ray tile) and the scene's cluster tables
(`MegaPack`: SAH treelet clusters of variable width).  Per ray tile (512
slots) and cluster, the tile sweeps the cluster's rows when any ALIVE ray
of it has its slab entry distance below its running best t.  Outputs: the
ordering distance t, the winning row of the padded table (-1 on miss) and
the cluster passes of each tile.

Two implementations of one contract (`cluster_sweep`):
  * the CUDA kernel (csrc/cluster_sweep.cu over csrc/tri_sweep.cuh), one
    thread block per ray tile, which first finds the tile's candidate
    clusters (`sweep_candidates_plain` states the set) and then walks only
    those;
  * the plain version `cluster_sweep_plain`, vectorised over rays with a
    Python loop over clusters and the same tile-uniform skip.
The wrapper takes the plain version only for CPU tensors.  `sweep_call`
puts the sweep under autograd as rtm_tpu's zero-cotangent `custom_vjp`
does: the sweep is an argmin oracle, the hit topology is detached, and the
distance is recomputed differentiably by the caller.

Ordering differs from rtm_tpu on purpose: the exact tdet / max(det, eps)
where the TPU kernel multiplies by an approximate reciprocal (ROADMAP.md
queue 3).
"""
from __future__ import annotations

import ctypes

import torch

from .build import check_arg, load_kernel_library
from .megakernel import (MegaPack, _slab_near, cluster_argmin, pair_t)
from .vreg_common import BIG, _cross, _safe_inv_dirs

DEFAULT_RAY_TILE = 512
MAX_RAY_TILE = 1024      # threads per block


def cluster_sweep_plain(feats, boxes, offsets: tuple, widths: tuple, state8,
                        ray_tile: int = DEFAULT_RAY_TILE, cull: bool = True,
                        with_passed: bool = False):
    """Plain PyTorch version of the kernel: feats (T', 16), boxes (C, 8),
    the cluster layout as Python tuples, state8 (8, Np).  Returns (t (Np,)
    f32, BIG on miss, i_padded (Np,) i32, passes (Np / ray_tile,) i32), and
    with_passed which clusters each tile swept (Np / ray_tile, C) bool.
    A cluster's pair tests run on the rays of the tiles that sweep it."""
    n = state8.shape[1]
    dev = state8.device
    tiles = n // ray_tile
    ox, oy, oz, dx, dy, dz = ray = [state8[k][:, None] for k in range(6)]
    ray += _cross(ox, oy, oz, dx, dy, dz)                  # w = o x d
    alive = (state8[6] > 0.5)[:, None]
    inv = _safe_inv_dirs(dx, dy, dz)
    best_t = torch.full((n, 1), BIG, device=dev)
    best_i = torch.full((n, 1), -1, dtype=torch.int64, device=dev)
    passed = torch.zeros((tiles, len(offsets)), dtype=torch.bool, device=dev)
    for ci, (off, wdt) in enumerate(zip(offsets, widths)):
        lanes = slice(None)
        if cull:
            near = _slab_near(boxes[ci], ox, oy, oz, *inv)
            go = ((near < best_t) & alive).view(tiles, ray_tile).any(dim=1)
            if not bool(go.any()):
                continue
            passed[:, ci] = go
            lanes = go.repeat_interleave(ray_tile).nonzero()[:, 0]
        else:
            passed[:, ci] = True
        cmin, cand = cluster_argmin(
            pair_t(feats[off:off + wdt].T, *(v[lanes] for v in ray)), off)
        bt = best_t[lanes]
        better = cmin < bt
        best_t[lanes] = torch.where(better, cmin, bt)
        best_i[lanes] = torch.where(better, cand, best_i[lanes])
    out = (best_t[:, 0], best_i[:, 0].to(torch.int32),
           passed.sum(dim=1, dtype=torch.int32))
    return out + (passed,) if with_passed else out


def sweep_candidates_plain(pack: MegaPack, state8,
                           ray_tile: int = DEFAULT_RAY_TILE):
    """The tile's candidate clusters of the kernels' prefilter
    (csrc/tri_sweep.cuh `sweep_clusters`): (Np / ray_tile, C) bool, True
    where some alive ray of the tile enters the cluster's box at all
    (`_slab_near` < BIG).  The best t never exceeds BIG and a miss is BIG,
    so `cluster_sweep_plain`'s pass matrix lies inside this one.  For tests
    and measurement; 64 tiles at a time, to bound the (rays, C)
    intermediates."""
    n = state8.shape[1]
    step = 64 * ray_tile
    boxes_t = pack.boxes.T                          # rows (C,) per bound
    out = []
    for lo in range(0, n, step):
        s = state8[:, lo:lo + step]
        ox, oy, oz, dx, dy, dz = (s[k][:, None] for k in range(6))
        near = _slab_near(boxes_t, ox, oy, oz, *_safe_inv_dirs(dx, dy, dz))
        hit = (near < BIG) & (s[6] > 0.5)[:, None]
        out.append(hit.view(-1, ray_tile, pack.n_clusters).any(dim=1))
    return torch.cat(out)


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _P, ctypes.c_long, _I, _I, _P, _P, _P, _P]


def cluster_sweep(pack: MegaPack, state8, ray_tile: int = DEFAULT_RAY_TILE,
                  cull: bool = True):
    """The sweep of `cluster_sweep_plain`'s contract over `pack`'s tables.
    CPU tensors go to the plain version; CUDA tensors launch the kernel of
    csrc/cluster_sweep.cu (built at first use) and raise on arguments it
    does not take and on any launch error.  `cluster_sweep.launches` counts
    the kernel launches."""
    dev = state8.device
    if dev.type == "cpu":
        return cluster_sweep_plain(pack.tri_feats, pack.boxes,
                                   pack.cluster_offsets, pack.cluster_widths,
                                   state8, ray_tile, cull)
    if dev.type != "cuda":
        raise ValueError(f"cluster_sweep: unsupported device {dev}")
    if not (0 < ray_tile <= MAX_RAY_TILE and ray_tile % 32 == 0):
        raise ValueError("cluster_sweep: ray_tile must be a multiple of 32 "
                         f"in (0, {MAX_RAY_TILE}]; got {ray_tile}")
    n = int(state8.shape[1]) if state8.dim() == 2 else -1
    if n <= 0 or n % ray_tile:
        raise ValueError(f"cluster_sweep: state8 must be (8, Np) with Np a "
                         f"positive multiple of {ray_tile}; got "
                         f"{tuple(state8.shape)}")
    nc = pack.n_clusters
    if nc <= 0:
        raise ValueError("cluster_sweep: the scene has no triangles")
    chk = lambda *a: check_arg("cluster_sweep", *a)  # noqa: E731
    chk("state8", state8, torch.float32, (8, n), dev)
    chk("tri_feats", pack.tri_feats, torch.float32, (pack.n_padded_tris, 16),
        dev)
    chk("boxes", pack.boxes, torch.float32, (nc, 8), dev)
    chk("offsets", pack.offsets_dev, torch.int32, (nc,), dev)
    chk("widths", pack.widths_dev, torch.int32, (nc,), dev)

    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    passes = torch.empty(n // ray_tile, dtype=torch.int32, device=dev)
    fn = load_kernel_library("cluster_sweep").cluster_sweep_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pack.tri_feats.data_ptr(), pack.boxes.data_ptr(),
                 pack.offsets_dev.data_ptr(), pack.widths_dev.data_ptr(), nc,
                 state8.data_ptr(), n, ray_tile, int(bool(cull)),
                 t.data_ptr(), idx.data_ptr(), passes.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cluster_sweep: kernel launch failed with CUDA "
                           f"error {err}")
    cluster_sweep.launches += 1
    return t, idx, passes


cluster_sweep.launches = 0


class _DetachedSweep(torch.autograd.Function):
    """The sweep under autograd with zero cotangents
    (rtm_tpu/ops/pallas/sweep_kernel.py:103-111): the winner index carries
    no gradient, and neither does the ordering distance."""

    @staticmethod
    def forward(ctx, state8, pack, ray_tile, cull):
        t, idx, passes = cluster_sweep(pack, state8.detach(), ray_tile, cull)
        ctx.mark_non_differentiable(t, idx, passes)
        return t, idx, passes

    @staticmethod
    def backward(ctx, *grads):
        return None, None, None, None


def sweep_call(pack: MegaPack, state8, ray_tile: int = DEFAULT_RAY_TILE,
               cull: bool = True):
    """Run the sweep over an (8, Np) ray band (Np % ray_tile == 0).

    Returns (t_approx (Np,) f32, i_padded (Np,) i32, n_passes (Np,) i32:
    each lane carries its tile's cluster-pass count)."""
    t, idx, passes = _DetachedSweep.apply(state8.contiguous(), pack,
                                          ray_tile, cull)
    return t, idx, passes.repeat_interleave(ray_tile)
