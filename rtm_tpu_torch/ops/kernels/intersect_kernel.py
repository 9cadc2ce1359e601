"""Round-1 nearest-triangle sweep: the per-bounce intersection of the
`pallas` backend (`bounce_payload(backend="pallas")`).

Port of rtm_tpu/ops/pallas/intersect_kernel.py.  Triangles are packed into
fixed 128-triangle clusters in buffer order with 16 precomputed features
each (`pack_triangle_features`) and a per-cluster AABB; a ray tile (256
rays) skips a cluster when none of its rays has its slab entry distance
below its running best t.

Two implementations of one contract (`intersect_sweep`):
  * the CUDA kernel (csrc/intersect_sweep.cu over csrc/tri_sweep.cuh), one
    thread per ray, the cull run over the clusters some ray of the tile
    enters at all (a candidate prefilter), a passed cluster's real rows
    staged in shared memory;
  * the plain version `intersect_sweep_plain`, vectorised over rays with a
    Python loop over clusters and the same tile-uniform skip.
The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  The sweep is an argmin oracle: it runs
without autograd, and callers recompute the winner's distance
differentiably (ops/trace_ref.py `_triangle_t_from_idx`).
"""
from __future__ import annotations

import ctypes

import torch

from ..intersect import DET_EPS, FLT_MAX, cross3
from .build import check_arg, load_kernel_library
from .megakernel import _slab_near

CLUSTER = 128            # triangles per cluster
DEFAULT_RAY_TILE = 256   # rays per thread block / skip decision
NUM_FEATURES = 16
MAX_RAY_TILE = 1024      # threads per block


def pack_triangle_features(a, b, c):
    """Precompute the 16 per-triangle features, padded to clusters of 128.

    a/b/c: (T,3) world-space vertices.  Returns (features (16, C*128) f32,
    box_lo (C,3), box_hi (C,3), n_clusters); padding triangles are
    degenerate (zero normal, so det == 0 never passes) and never widen a
    cluster's box."""
    t = a.shape[0]
    c_count = max(1, -(-t // CLUSTER))
    pad = c_count * CLUSTER - t

    def padt(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    a_p, b_p, c_p = padt(a), padt(b), padt(c)
    ab = b_p - a_p
    ac = c_p - a_p
    n = cross3(ab, ac)
    an = (a_p * n).sum(dim=-1)
    g1 = cross3(ac, a_p)
    g2 = cross3(ab, a_p)
    feats = torch.stack([n[:, 0], n[:, 1], n[:, 2], an,
                         ab[:, 0], ab[:, 1], ab[:, 2],
                         ac[:, 0], ac[:, 1], ac[:, 2],
                         g1[:, 0], g1[:, 1], g1[:, 2],
                         g2[:, 0], g2[:, 1], g2[:, 2]], dim=0)
    real = (torch.arange(c_count * CLUSTER, device=a.device) < t)[:, None]
    verts = torch.stack([a_p, b_p, c_p], dim=1)                 # (T',3,3)
    vmin = torch.where(real, verts.amin(dim=1), float("inf"))
    vmax = torch.where(real, verts.amax(dim=1), float("-inf"))
    box_lo = vmin.reshape(c_count, CLUSTER, 3).amin(dim=1)
    box_hi = vmax.reshape(c_count, CLUSTER, 3).amax(dim=1)
    return feats.float().contiguous(), box_lo, box_hi, c_count


def intersect_sweep_plain(rays, feats, boxes, n_clusters: int,
                          ray_tile: int = DEFAULT_RAY_TILE, cull: bool = True,
                          return_passes: bool = False,
                          with_passed: bool = False, n_tris=None):
    """Plain PyTorch version of the kernel: rays (N,16) [o, d, w = o x d,
    0...] with N % ray_tile == 0, feats (16, C*128), boxes (8, C) rows
    lo.xyz, hi.xyz, 0, 0.  Returns (t (N,) f32, FLT_MAX on miss, idx (N,)
    i32, -1 on miss), then the cluster passes per tile (N/ray_tile,) i32
    when return_passes, and which clusters each tile swept (N/ray_tile, C)
    bool when with_passed.  n_tris: the real triangle rows (the rest are
    padding and are not tested; every row when None).  Padding rows never
    pass the gate, so n_tris changes no output."""
    n = rays.shape[0]
    if n_tris is None:
        n_tris = n_clusters * CLUSTER
    dev = rays.device
    tiles = n // ray_tile
    ox, oy, oz, dx, dy, dz, wx, wy, wz = (rays[:, k:k + 1] for k in range(9))
    best_t = torch.full((n, 1), FLT_MAX, device=dev)
    best_i = torch.full((n, 1), -1, dtype=torch.int64, device=dev)
    passes = torch.zeros(tiles, dtype=torch.int32, device=dev)
    passed = torch.zeros((tiles, n_clusters), dtype=torch.bool, device=dev)
    col = torch.arange(CLUSTER, device=dev)[None, :]
    # the raw reciprocal, not the sweep's safe one (intersect_kernel.py:111)
    inv_dx, inv_dy, inv_dz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    for c in range(n_clusters):
        if cull:
            near = _slab_near(boxes[:, c], ox, oy, oz, inv_dx, inv_dy,
                              inv_dz, miss=FLT_MAX)
            go = (near < best_t).reshape(tiles, ray_tile).any(dim=1)
            if not bool(go.any()):
                continue
            passes += go.to(torch.int32)
            passed[:, c] = go
            lane_go = go.repeat_interleave(ray_tile)[:, None]
        else:
            passes += 1
            passed[:, c] = True
            lane_go = None
        width = min(CLUSTER, n_tris - c * CLUSTER)
        if width <= 0:
            continue
        f = feats[:, c * CLUSTER:c * CLUSTER + width]
        nx, ny, nz, an = f[0:1], f[1:2], f[2:3], f[3:4]
        det = -(dx * nx + dy * ny + dz * nz)
        tdet = ox * nx + oy * ny + oz * nz - an
        udet = ((wx * f[7:8] + wy * f[8:9] + wz * f[9:10])
                - (dx * f[10:11] + dy * f[11:12] + dz * f[12:13]))
        vdet = ((dx * f[13:14] + dy * f[14:15] + dz * f[15:16])
                - (wx * f[4:5] + wy * f[5:6] + wz * f[6:7]))
        wdet = det - udet - vdet
        valid = ((det > DET_EPS) & (tdet >= 0.0) & (udet >= 0.0)
                 & (vdet >= 0.0) & (wdet >= 0.0))
        t = torch.where(valid, tdet / torch.where(valid, det, 1.0), FLT_MAX)
        tmin = t.amin(dim=1, keepdim=True)
        in_idx = torch.where(t == tmin, col[:, :width], 2 ** 30).amin(
            dim=1, keepdim=True) + c * CLUSTER
        better = tmin < best_t
        if lane_go is not None:
            better = better & lane_go
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, in_idx, best_i)
    t_out = best_t[:, 0]
    idx = torch.where(t_out < FLT_MAX, best_i[:, 0], -1).to(torch.int32)
    return ((t_out, idx) + ((passes,) if return_passes else ())
            + ((passed,) if with_passed else ()))


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, ctypes.c_long, _I, _I, _P, _P, _P, _P]


def intersect_sweep(rays, feats, boxes, n_clusters: int,
                    ray_tile: int = DEFAULT_RAY_TILE, cull: bool = True,
                    return_passes: bool = False, n_tris=None):
    """The sweep of `intersect_sweep_plain`'s contract.  CPU tensors go to
    the plain version; CUDA tensors launch the kernel of
    csrc/intersect_sweep.cu (built at first use) and raise on arguments it
    does not take and on any launch error.  n_tris (the real triangle rows
    of the table, every row when None) lets the kernel skip the padding.
    `intersect_sweep.launches` counts the kernel launches."""
    dev = rays.device
    if n_tris is None:
        n_tris = n_clusters * CLUSTER
    if dev.type == "cpu":
        return intersect_sweep_plain(rays, feats, boxes, n_clusters,
                                     ray_tile, cull, return_passes,
                                     n_tris=n_tris)
    if dev.type != "cuda":
        raise ValueError(f"intersect_sweep: unsupported device {dev}")
    n = int(rays.shape[0]) if rays.dim() == 2 else -1
    if not (0 < ray_tile <= MAX_RAY_TILE and ray_tile % 32 == 0):
        raise ValueError("intersect_sweep: ray_tile must be a multiple of 32 "
                         f"in (0, {MAX_RAY_TILE}]; got {ray_tile}")
    if n <= 0 or n % ray_tile:
        raise ValueError(f"intersect_sweep: rays must be (N, 16) with N a "
                         f"positive multiple of {ray_tile}; got "
                         f"{tuple(rays.shape)}")
    if n_clusters <= 0:
        raise ValueError("intersect_sweep: need n_clusters > 0")
    if not 0 <= n_tris <= n_clusters * CLUSTER:
        raise ValueError(f"intersect_sweep: n_tris must be in [0, "
                         f"{n_clusters * CLUSTER}]; got {n_tris}")
    chk = lambda *a: check_arg("intersect_sweep", *a)  # noqa: E731
    chk("rays", rays, torch.float32, (n, 16), dev)
    chk("feats", feats, torch.float32, (NUM_FEATURES, n_clusters * CLUSTER),
        dev)
    chk("boxes", boxes, torch.float32, (8, n_clusters), dev)

    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    passes = (torch.empty(n // ray_tile, dtype=torch.int32, device=dev)
              if return_passes else None)
    fn = load_kernel_library("intersect_sweep").intersect_sweep_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rays.data_ptr(), feats.data_ptr(), boxes.data_ptr(),
                 n_clusters, int(n_tris), n, ray_tile, int(bool(cull)), t.data_ptr(),
                 idx.data_ptr(), None if passes is None else passes.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"intersect_sweep: kernel launch failed with CUDA "
                           f"error {err}")
    intersect_sweep.launches += 1
    if return_passes:
        return t, idx, passes
    return t, idx


intersect_sweep.launches = 0


def pack_rays(origin, direction, ray_tile: int = DEFAULT_RAY_TILE):
    """(N,3) origins and directions -> the kernel's (Np, 16) ray rows
    [o, d, o x d, 0...], padded to a multiple of ray_tile with rtm_tpu's
    filler rows (o = 0, d = (1, 1, 1))."""
    n = origin.shape[0]
    w = cross3(origin, direction)
    pad = (-n) % ray_tile
    rays = torch.cat([origin, direction, w,
                      torch.zeros((n, 7), device=origin.device)], dim=1)
    if pad:
        filler = torch.zeros((pad, 16), device=origin.device)
        filler[:, 3:6] = 1.0
        rays = torch.cat([rays, filler], dim=0)
    return rays.contiguous()


def nearest_triangle_pallas(origin, direction, tri_a, tri_b, tri_c,
                            ray_tile: int = DEFAULT_RAY_TILE,
                            cull: bool = True):
    """Nearest triangle per ray through the sweep (kernel on the card, the
    plain version on the CPU).  origin/direction: (N,3) f32; tri_*: (T,3)
    world vertices.  Returns (t (N,), idx (N,) i32, -1 on miss), without
    autograd.  First-min-wins tie order matches buffer order (reference
    `<` semantics)."""
    n = origin.shape[0]
    dev = origin.device
    with torch.no_grad():
        if tri_a.shape[0] == 0:
            return (torch.full((n,), FLT_MAX, device=dev),
                    torch.full((n,), -1, dtype=torch.int32, device=dev))
        feats, box_lo, box_hi, n_clusters = pack_triangle_features(
            tri_a.detach(), tri_b.detach(), tri_c.detach())
        boxes = torch.cat([box_lo.T, box_hi.T,
                           torch.zeros((2, n_clusters), device=dev)],
                          dim=0).contiguous()
        rays = pack_rays(origin.detach(), direction.detach(), ray_tile)
        t, idx = intersect_sweep(rays, feats, boxes, n_clusters, ray_tile,
                                 cull, n_tris=tri_a.shape[0])
    return t[:n], idx[:n]
