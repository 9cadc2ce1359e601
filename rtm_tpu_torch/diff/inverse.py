"""Inverse rendering: recover scene parameters from a target image.

Port of rtm_tpu/diff/inverse.py (BASELINE config 5: recover albedo /
position / light emission from a target image by pixel-gradient descent).
The loss is the pixel L2 between one rendered dispatch and the target;
gradients flow through the bounce loop (optionally recomputing each bounce
in the backward pass) and the optimizer is Adam (`torch.optim.Adam` with
optax's defaults: betas (0.9, 0.999), eps 1e-8, no weight decay).

Routes to the gradient, as in rtm_tpu:
  * backend="mxu": record replay, the production route (the mxu kernel
    emits winner records without autograd, the shading is replayed);
  * backend="wavefront2", optionally in `bands` slot bands: the cluster
    sweep kernel per bounce;
  * backend="xla" or "pallas": the per-bounce reference renderer, through
    the chunked sweep or the intersect kernel; with soft_tau > 0, soft
    primary visibility (diff/silhouette.py) on either of them.
The fused forward kernels (trav, megakernel) have no gradient, as
rtm_tpu's `pallas_call`s carry no VJP: `loss_and_grad` raises there.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import RenderConfig
from ..ops.trace_ref import render_dispatch
from ..utils.tracing import span
from .params import SceneParams, apply_params, extract_params


def _check_mxu(scene, cfg: RenderConfig, soft_tau: float):
    """rtm_tpu's loud errors of the mxu grad route: it never reroutes."""
    if soft_tau > 0.0:
        raise ValueError(
            "render_loss(backend='mxu'): soft primary visibility (soft_tau) "
            "is not supported on the record-replay path; use backend='xla'")
    if cfg.max_bounces <= 1:
        raise ValueError(
            "render_loss(backend='mxu'): MaxBounces==1 flat-shade has no "
            "mxu path; use backend='xla'")
    mm = scene.mxu_meta
    if mm is None or not mm.supported:
        raise ValueError(
            "render_loss(backend='mxu'): scene exceeds the mxu table limits "
            "(<=2047 tris / <=128 materials/spheres); use "
            "backend='wavefront2' or 'xla'")


def _bands_of(cfg: RenderConfig, bands: int, target):
    """(band width, [(offset, target band (band,3), mask (band,))]) of a
    banded loss: contiguous dispatch-slot bands, the last one padded and
    masked."""
    from ..ops.kernels.megakernel import image_to_slots, use_block8
    n = cfg.num_pixels
    band = -(-n // bands)
    if use_block8(cfg.width, cfg.height):
        tgt = image_to_slots(target, cfg.width, cfg.height)
    else:
        tgt = target.reshape(-1, 3)
    pad = band * bands - n
    if pad:
        tgt = torch.cat([tgt, torch.zeros((pad, 3), device=tgt.device)])
    mask = (torch.arange(band * bands, device=tgt.device) < n).float()
    return band, [(k * band, tgt[k * band:(k + 1) * band],
                   mask[k * band:(k + 1) * band]) for k in range(bands)]


def _banded(backend: str, bands: int, cfg: RenderConfig,
            soft_tau: float) -> bool:
    return (backend == "wavefront2" and bands > 1 and cfg.max_bounces > 1
            and soft_tau == 0.0)


def _band_sq_sums(params, scene, cam, target, frame_index, cfg, bands,
                  rebuild_tri_geometry):
    """Yield each slot band's masked partial L2 sum, the parameters applied
    anew per band so that a caller may run each band's backward pass before
    the next band's forward; the loss is their sum over H * W * 3."""
    from ..ops.wavefront2 import render_rays_wavefront2
    band, parts = _bands_of(cfg, bands, target)
    for off, t_b, m_b in parts:
        full = apply_params(scene, params, rebuild_tri_geometry)
        img = render_rays_wavefront2(full, cam, frame_index, cfg,
                                     pixel_offset=off, n_rays=band)
        yield (m_b[:, None] * (img - t_b) ** 2).sum()


def render_loss(params: SceneParams, scene, cam, target, frame_index: int,
                cfg: RenderConfig, backend: str = "xla", remat: bool = True,
                rebuild_tri_geometry: bool = True, soft_tau: float = 0.0,
                bands: int = 1):
    """Mean squared pixel error of a single dispatch against `target`
    ((H, W, 3) on the scene's device).

    soft_tau > 0 enables soft primary visibility (diff/silhouette.py):
    geometry gradients pick up the silhouette edge term the detached argmin
    drops, at the cost of a ~tau-wide soft edge band in the loss.  It runs
    on the per-bounce routes ("xla", "pallas"); the fused and wavefront
    routes raise ValueError there, as in rtm_tpu, and `bands` is ignored.

    bands > 1 (wavefront2 only): the loss as a sum over `bands` contiguous
    dispatch-slot bands of masked partial L2 sums (the same value up to
    summation order)."""
    if backend == "mxu":
        _check_mxu(scene, cfg, soft_tau)
        from ..ops.trace_ref import render_mxu_replay
        full = apply_params(scene, params, rebuild_tri_geometry)
        img = render_mxu_replay(full, cam, frame_index, cfg, remat=remat)
        return ((img - target) ** 2).mean()
    if _banded(backend, bands, cfg, soft_tau):
        return sum(_band_sq_sums(params, scene, cam, target, frame_index, cfg,
                                 bands, rebuild_tri_geometry)
                   ) / float(cfg.num_pixels * 3)
    full = apply_params(scene, params, rebuild_tri_geometry)
    if soft_tau > 0.0:
        from ..ops.trace_ref import pixel_grid
        from .silhouette import render_soft_primary
        x, y = pixel_grid(cfg.width, cfg.height, full.device)
        img = render_soft_primary(full, cam, x, y, frame_index, cfg,
                                  tau=soft_tau, backend=backend, remat=remat)
        img = img.reshape(cfg.height, cfg.width, 3)
    else:
        img = render_dispatch(full, cam, frame_index, cfg, backend=backend,
                              remat=remat)
    return ((img - target) ** 2).mean()


def _leaves(params: SceneParams) -> SceneParams:
    return params.map(lambda t: t.detach().requires_grad_(True))


def _grads(loss, leaves: SceneParams):
    gs = torch.autograd.grad(loss, leaves.tensors(), allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(gs, leaves.tensors())]


def loss_and_grad(params: SceneParams, scene, cam, target, frame_index: int,
                  cfg: RenderConfig, backend: str = "xla", remat: bool = True,
                  rebuild_tri_geometry: bool = True, soft_tau: float = 0.0,
                  bands: int = 1):
    """(loss, SceneParams of d loss / d params): rtm_tpu's
    jax.value_and_grad(render_loss), by torch.autograd.grad.

    With wavefront2 and bands > 1, each band's forward and backward run
    before the next band's forward, so only one band's graph is held at a
    time; the band gradients are summed."""
    leaves = _leaves(params)
    if _banded(backend, bands, cfg, soft_tau):
        loss = torch.zeros((), device=target.device)
        total = None
        parts = _band_sq_sums(leaves, scene, cam, target, frame_index, cfg,
                              bands, rebuild_tri_geometry)
        for _ in range(bands):
            with span("rtm.fit.forward"):
                part = next(parts) / float(cfg.num_pixels * 3)
            with span("rtm.fit.backward"):
                gs = _grads(part, leaves)
            total = gs if total is None else [a + b
                                              for a, b in zip(total, gs)]
            loss = loss + part.detach()
        return loss, SceneParams(*total)
    with span("rtm.fit.forward"):
        loss = render_loss(leaves, scene, cam, target, frame_index, cfg,
                           backend, remat, rebuild_tri_geometry, soft_tau,
                           bands)
    if not loss.requires_grad:
        raise ValueError(
            f"loss_and_grad(backend={backend!r}): the route this scene takes "
            "there is a forward-only kernel with no gradient (rtm_tpu's "
            "pallas_call carries no VJP either); use backend='mxu', "
            "'wavefront2', 'xla' or 'pallas'")
    with span("rtm.fit.backward"):
        grads = _grads(loss, leaves)
    return loss.detach(), SceneParams(*grads)


@dataclass(frozen=True)
class InverseRenderConfig:
    steps: int = 100
    learning_rate: float = 2e-2
    remat: bool = True
    backend: str = "xla"
    rebuild_tri_geometry: bool = True
    vary_seed: bool = True   # new RNG stream per step (stochastic gradients)


def inverse_render(scene, cam, target, cfg: RenderConfig,
                   opt_cfg: InverseRenderConfig,
                   init_params: SceneParams | None = None,
                   param_mask: SceneParams | None = None, callback=None):
    """Adam descent on scene parameters toward `target`.

    param_mask: optional SceneParams of 0/1 floats freezing entries (the
    gradients are multiplied by it).  Returns (final SceneParams, list of
    losses)."""
    start = init_params if init_params is not None else extract_params(scene)
    params = start.map(lambda t: t.detach().clone().requires_grad_(True))
    opt = torch.optim.Adam(params.tensors(), lr=opt_cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for i in range(opt_cfg.steps):
        with span("rtm.fit.step"):
            fi = 1 + (i if opt_cfg.vary_seed else 0)
            loss, grads = loss_and_grad(params, scene, cam, target, fi, cfg,
                                        opt_cfg.backend, opt_cfg.remat,
                                        opt_cfg.rebuild_tri_geometry)
            gs = grads.tensors()
            if param_mask is not None:
                gs = [g * m for g, m in zip(gs, param_mask.tensors())]
            for p, g in zip(params.tensors(), gs):
                p.grad = g
            opt.step()
            losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1], params)
    return params.map(lambda t: t.detach()), losses
