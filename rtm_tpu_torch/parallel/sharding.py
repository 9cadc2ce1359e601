"""Multi-GPU execution: pixel-band data parallelism over a process group.

Port of rtm_tpu/parallel/sharding.py on torch.distributed.  rtm_tpu runs
one `jax.shard_map` program over a `jax.sharding.Mesh`; here every rank is
a process of its own on one device, and a 1-D `DeviceMesh` named "dp"
holds the group:

  * the pixel grid is cut into `world` contiguous bands of
    band = ceil(W*H / world) (dispatch slots for the fused routes, the
    padded row-major pixel grid for xla / pallas); rank r traces band r;
  * the scene is replicated (each rank builds or holds its own copy);
  * the forward frame is assembled by one all-reduce(SUM) of a zero-filled
    full buffer into which each rank wrote its band.  NCCL cannot put two
    ranks on one GPU and gloo has no all-gather for CUDA tensors, so this
    one path serves NCCL (one rank per GPU) and gloo (the CPU, or ranks
    sharing a card) alike; the sum of a band with zeros is exact;
  * gradients: each rank differentiates only its own band's partial loss,
    then loss and flattened gradients go through one all-reduce(SUM) —
    never a reduction inside the differentiated function and again
    outside it (rtm_tpu's pinned x n_dev double count);
  * samples-per-pixel sharding: every rank traces the full grid with its
    own seed stream and the radiance is all-reduce averaged.

`render_band` is the band arithmetic with no process group: rank r's share
of a `world`-way split, so it can be held against the full frame in one
process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import RenderConfig
from ..diff.inverse import _bands_of, _check_mxu, _grads, _leaves
from ..diff.params import SceneParams, apply_params
from ..ops.trace_ref import pixel_grid, render_pixels, resolve_route
from .distributed import rank_device

DP_AXIS = "dp"
SP_AXIS = "sp"
# the frame-counter stride between ranks' seed streams (render_sharded_spp)
SPP_SEED_STRIDE = 7919

_FUSED = ("mxu", "trav", "megakernel", "wavefront2")
_BACKENDS = _FUSED + ("xla", "pallas")


def make_mesh(n_devices: int | None = None, device=None) -> DeviceMesh:
    """1-D data-parallel DeviceMesh named "dp" over the initialized world,
    on the card unless device="cpu".

    Stated difference from rtm_tpu: `n_devices` must be None or the world
    size.  rtm_tpu's single controller can take the first n devices of
    one process; torch runs one process per device, so the mesh is the
    whole world and anything else raises ValueError."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the world "
                         f"has {world} ranks (one device per rank)")
    return DeviceMesh(rank_device(device).type, torch.arange(world),
                      mesh_dim_names=(DP_AXIS,))


def _rank_world_group(mesh: DeviceMesh, scene):
    if scene.device.type != mesh.device_type:
        raise ValueError(f"scene on {scene.device} but the mesh is over "
                         f"{mesh.device_type} devices")
    return (mesh.get_local_rank(DP_AXIS), mesh.size(),
            mesh.get_group(DP_AXIS))


def band_size(cfg: RenderConfig, world: int) -> int:
    return -(-cfg.num_pixels // world)


def _padded_band(cfg: RenderConfig, rank: int, band: int, device):
    """Rank `rank`'s band of the row-major pixel grid padded to a multiple
    of the world: (x, y, in-frame mask); padded lanes trace pixel (0, 0)
    with mask 0."""
    p = rank * band + torch.arange(band, dtype=torch.int64, device=device)
    inside = p < cfg.num_pixels
    p = torch.where(inside, p, 0)
    return p % cfg.width, p // cfg.width, inside.float()


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {_BACKENDS}")


def render_band(scene, cam, frame_index: int, cfg: RenderConfig, rank: int,
                world: int, backend: str = "xla", chunk: int = 512):
    """Rank `rank`'s share of a `world`-way split of one dispatch, with no
    process group: (band, 3) radiance, band = ceil(W*H / world).

    The band takes render_dispatch's route (resolve_route).  Fused routes
    (mxu, trav, megakernel, wavefront2) trace dispatch slots
    [rank * band, (rank + 1) * band) through the kernels' band entry
    points, the last band's slots past W*H included; xla and pallas trace
    the same range of the padded row-major pixel grid.  image_of_bands
    turns the ranks' bands, concatenated, into the frame.  Raises
    ValueError on an unknown backend ('auto' included)."""
    _check_backend(backend)
    return _band(scene, cam, frame_index, cfg, rank, world,
                 resolve_route(scene, cfg, backend), chunk)


def _band(scene, cam, frame_index, cfg, rank, world, route, chunk):
    band = band_size(cfg, world)
    if route in _FUSED:
        if route == "mxu":
            from ..ops.kernels.mxu_kernel import render_rays_mxu as rr
        elif route == "trav":
            from ..ops.kernels.trav_kernel import render_rays_trav as rr
        elif route == "megakernel":
            from ..ops.kernels.megakernel import render_rays_megakernel as rr
        else:
            from ..ops.wavefront2 import render_rays_wavefront2 as rr
        return rr(scene, cam, frame_index, cfg, pixel_offset=rank * band,
                  n_rays=band)
    x, y, _ = _padded_band(cfg, rank, band, scene.device)
    return render_pixels(scene, cam, x, y, frame_index, cfg, chunk=chunk,
                         backend=route)


def image_of_bands(flat, cfg: RenderConfig, route: str):
    """The (H, W, 3) frame of every rank's band concatenated in rank order
    ((world * band, 3)): slot order for the fused routes, row-major
    otherwise; the padding past W*H is dropped."""
    from ..ops.kernels.megakernel import slots_to_image, use_block8
    out = flat[:cfg.num_pixels]
    if route in _FUSED and use_block8(cfg.width, cfg.height):
        return slots_to_image(out, cfg.width, cfg.height)
    return out.reshape(cfg.height, cfg.width, 3)


def render_sharded(scene, cam, frame_index: int, cfg: RenderConfig,
                   mesh: DeviceMesh, chunk: int = 512, backend: str = "xla"):
    """One full-frame dispatch with the pixel grid split over the mesh's
    ranks: each renders its band (render_band) and one all-reduce
    assembles the (H, W, 3) frame on every rank, the contract of
    render_dispatch."""
    rank, world, group = _rank_world_group(mesh, scene)
    _check_backend(backend)
    route = resolve_route(scene, cfg, backend)
    band = band_size(cfg, world)
    part = _band(scene, cam, frame_index, cfg, rank, world, route, chunk)
    full = torch.zeros((band * world, 3), device=part.device)
    full[rank * band:(rank + 1) * band] = part
    dist.all_reduce(full, group=group)
    return image_of_bands(full, cfg, route)


def render_sharded_spp(scene, cam, frame_index: int, cfg: RenderConfig,
                       mesh: DeviceMesh, chunk: int = 512,
                       backend: str = "xla"):
    """Sample-axis sharding: every rank traces the full pixel grid (xla or
    pallas) at frame index (frame_index + rank * 7919) mod 2**32, a
    disjoint seed stream, and the radiance is all-reduce averaged: world
    * cfg.max_frames samples per pixel.  For large spp over a small
    grid."""
    rank, world, group = _rank_world_group(mesh, scene)
    x, y = pixel_grid(cfg.width, cfg.height, scene.device)
    fi = (int(frame_index) + rank * SPP_SEED_STRIDE) % 2 ** 32
    local = render_pixels(scene, cam, x, y, fi, cfg, chunk=chunk,
                          backend=backend)
    dist.all_reduce(local, group=group)
    return (local / world).reshape(cfg.height, cfg.width, 3)


def _band_loss(leaves, scene, cam, target, frame_index, cfg, rank, world,
               chunk, backend, remat, rebuild_tri_geometry):
    """Rank `rank`'s partial loss: its band's masked squared error over
    H * W * 3 (the bands' partial losses sum to render_loss)."""
    denom = float(cfg.num_pixels * 3)
    if backend == "mxu":
        _check_mxu(scene, cfg, 0.0)           # loud, never rerouted
    if backend in ("trav", "megakernel"):
        raise ValueError(
            f"sharded_loss_and_grad(backend={backend!r}): a forward-only "
            "kernel with no gradient; use 'mxu', 'wavefront2', 'xla' or "
            "'pallas'")
    _check_backend(backend)
    full = apply_params(scene, leaves, rebuild_tri_geometry)
    if backend in ("mxu", "wavefront2") and cfg.max_bounces > 1:
        band, parts = _bands_of(cfg, world, target)
        off, t, m = parts[rank]
        if backend == "mxu":
            from ..ops.trace_ref import render_rays_mxu_replay
            img = render_rays_mxu_replay(full, cam, frame_index, cfg,
                                         pixel_offset=off, n_rays=band,
                                         remat=remat)
        else:
            from ..ops.wavefront2 import render_rays_wavefront2
            img = render_rays_wavefront2(full, cam, frame_index, cfg,
                                         pixel_offset=off, n_rays=band)
    else:
        route = "pallas" if backend == "pallas" else "xla"
        band = band_size(cfg, world)
        x, y, m = _padded_band(cfg, rank, band, target.device)
        t = target.reshape(-1, 3)[y * cfg.width + x]
        img = render_pixels(full, cam, x, y, frame_index, cfg, chunk=chunk,
                            backend=route, remat=remat)
    return (m[:, None] * (img - t) ** 2).sum() / denom


def sharded_loss_and_grad(params: SceneParams, scene, cam, target,
                          frame_index: int, cfg: RenderConfig,
                          mesh: DeviceMesh, chunk: int = 512,
                          backend: str = "xla", remat: bool = True,
                          rebuild_tri_geometry: bool = True):
    """Distributed loss and gradients: (loss, SceneParams of d loss /
    d params), the value of diff.inverse.loss_and_grad (the mean squared
    pixel error over H * W * 3) up to summation order, on every rank.

    Each rank differentiates only its own band's partial loss
    (torch.autograd.grad): mxu through record replay and wavefront2
    through its sweep, over dispatch-slot bands; xla and pallas over the
    padded pixel grid.  Then one all-reduce(SUM) of the loss and the
    flattened gradients.  The mxu table limits raise, as render_loss's
    do; trav and the megakernel have no gradient and raise."""
    rank, world, group = _rank_world_group(mesh, scene)
    leaves = _leaves(params)
    local = _band_loss(leaves, scene, cam, target, frame_index, cfg, rank,
                       world, chunk, backend, remat, rebuild_tri_geometry)
    grads = _grads(local, leaves)
    flat = torch.cat([local.detach().reshape(1)]
                     + [g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].reshape(g.shape))
        at += g.numel()
    return flat[0], SceneParams(*out)


def make_train_step(scene, cam, target, cfg: RenderConfig, mesh: DeviceMesh,
                    optimizer, chunk: int = 512, backend: str = "xla",
                    remat: bool = True, rebuild_tri_geometry: bool = True):
    """The multi-GPU inverse-rendering step:
    train_step(params, frame_index) -> (params, loss).

    optimizer: a learning rate, for torch.optim.Adam with optax's defaults
    (betas (0.9, 0.999), eps 1e-8, as inverse_render), or a callable that
    takes the list of parameter tensors and returns a torch optimizer.
    Pass each call the params the last one returned: the step updates
    them in place and keeps the optimizer's state.  Other params (the
    first call's) are cloned, broadcast from rank 0 once, and get a fresh
    optimizer, as rtm_tpu's `optimizer.init`.  The all-reduced gradients
    keep every rank's parameters bitwise equal."""
    group = mesh.get_group(DP_AXIS)
    src = dist.get_global_rank(group, 0)
    state = {"params": None, "opt": None}

    def train_step(params: SceneParams, frame_index: int):
        if params is not state["params"]:
            params = params.map(lambda t: t.detach().clone())
            for t in params.tensors():
                dist.broadcast(t, src=src, group=group)
            tensors = [t.requires_grad_(True) for t in params.tensors()]
            if callable(optimizer):
                opt = optimizer(tensors)
            else:
                opt = torch.optim.Adam(tensors, lr=float(optimizer),
                                       betas=(0.9, 0.999), eps=1e-8)
            state.update(params=params, opt=opt)
        loss, grads = sharded_loss_and_grad(
            params, scene, cam, target, frame_index, cfg, mesh, chunk=chunk,
            backend=backend, remat=remat,
            rebuild_tri_geometry=rebuild_tri_geometry)
        for p, g in zip(params.tensors(), grads.tensors()):
            p.grad = g
        state["opt"].step()
        return params, loss

    return train_step
