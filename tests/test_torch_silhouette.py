"""rtm_tpu_torch's soft primary visibility (diff/silhouette.py) against
rtm_tpu's on the CPU.

The rigs are tests/test_grad.py's silhouette scenes, built by rtm_tpu and
carried into the port as NumPy arrays: a sphere over the sky (every edge
pixel a primary silhouette) and a sphere in front of an emissive triangle
(object over object), at 24x20, 2 bounces, tau = 0.05.  Tolerances:
`primary_soft_alpha` and its exit distances within rtol 1e-5 / atol 1e-6;
`render_soft_primary` images by `images_close` (tests/conftest.py);
gradients (sphere centres and radii, and `loss_and_grad`'s per-field
gradients with soft_tau) within rtm_tpu's own rtol 1e-3 / atol 1e-5, the
bound tests/test_torch_grad.py uses; the port's `pallas` route against
its `xla` route the same way.  Every gradient is finite, sky pixels
included.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.diff import extract_params as j_extract
from rtm_tpu.diff import render_loss as j_render_loss
from rtm_tpu.diff.silhouette import primary_soft_alpha as j_alpha
from rtm_tpu.diff.silhouette import render_soft_primary as j_soft
from rtm_tpu.models import scenes as jscenes
from rtm_tpu.ops.trace_ref import pixel_grid as j_pixel_grid
from rtm_tpu_torch import diff as td
from rtm_tpu_torch.diff.silhouette import (primary_soft_alpha,
                                           render_soft_primary)
from rtm_tpu_torch.ops.trace_ref import camera_ray_basis, pixel_grid
from test_torch_parity import carry

W, H, B, FI, TAU = 24, 20, 2, 1, 0.05
RTOL, ATOL = 1e-3, 1e-5


def _rig(name):
    """tests/test_grad.py's _silhouette_scene ("sky") and its
    occluder-over-object scene ("occluder"), built by rtm_tpu."""
    s = rtm_tpu.Scene(sky=jscenes._procedural_sky())
    s.add_material(rtm_tpu.Material((0.8, 0.3, 0.2), (1, 1, 1), 0.1, 0, 0,
                                    1.0, -1))
    if name == "occluder":
        s.add_material(rtm_tpu.Material((1, 1, 1), (1.0, 0.9, 0.2), 0, 0,
                                        5.0, 1.0, -1))
    s.add_sphere(rtm_tpu.SphereDef((0.0, 1.0, -3.0), 0.7, 0))
    if name == "occluder":
        s.add_mesh(rtm_tpu.Mesh.from_triangles([rtm_tpu.Triangle(
            (-3.0, -1.0, -6.0), (3.0, -1.0, -6.0), (0.0, 4.0, -6.0))]))
        s.add_object(rtm_tpu.MeshInstance(mesh_id=0, material_id=1))
    return rtm_tpu.build_tracer_scene(s)


@pytest.fixture(scope="module", params=["sky", "occluder"])
def rig(request):
    sj = _rig(request.param)
    return request.param, sj, carry(sj)


def _cfgs(w=W, h=H, bounces=B):
    kw = dict(width=w, height=h, max_bounces=bounces, draw_environment=True)
    return rtm_tpu.RenderConfig(**kw), rtm_tpu_torch.RenderConfig(**kw)


def _primary_rays(st, tcfg):
    x, y = pixel_grid(tcfg.width, tcfg.height)
    focus, _, _, pos = camera_ray_basis(
        rtm_tpu_torch.Camera().spec(tcfg.width, tcfg.height), tcfg, x, y)
    d = focus - pos[None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return pos[None, :].expand_as(d), d


def test_primary_soft_alpha_matches_rtm_tpu(rig):
    _, sj, st = rig
    _, tcfg = _cfgs()
    o, d = _primary_rays(st, tcfg)
    alpha, t_exit, hit = primary_soft_alpha(st, o, d, TAU, with_exit=True)
    ja, jt, jh = j_alpha(sj, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                         TAU, with_exit=True)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t_exit.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    # both kinds of lanes: sky (no hit) and silhouette (0 < alpha < 1)
    assert (~hit).any() and hit.any()
    assert ((alpha > 0.05) & (alpha < 0.95)).any()
    assert torch.equal(primary_soft_alpha(st, o, d, TAU), alpha)


def test_render_soft_primary_matches_rtm_tpu(rig, image_compare):
    _, sj, st = rig
    jcfg, tcfg = _cfgs()
    x, y = pixel_grid(W, H)
    got = render_soft_primary(st, rtm_tpu_torch.Camera().spec(W, H), x, y,
                              FI, tcfg, tau=TAU)
    jx, jy = j_pixel_grid(W, H)
    want = j_soft(sj, rtm_tpu.Camera().spec(W, H), jx, jy, jnp.uint32(FI),
                  jcfg, tau=TAU)
    assert got.shape == (W * H, 3) and torch.isfinite(got).all()
    image_compare(got.numpy().reshape(H, W, 3),
                  np.asarray(want).reshape(H, W, 3))


def _port_geometry_grads(st, backend="xla"):
    _, tcfg = _cfgs()
    pos = st.sph_pos.clone().requires_grad_(True)
    rad = st.sph_radius.clone().requires_grad_(True)
    sc = dataclasses.replace(st, sph_pos=pos, sph_radius=rad)
    x, y = pixel_grid(W, H)
    img = render_soft_primary(sc, rtm_tpu_torch.Camera().spec(W, H), x, y,
                              FI, tcfg, tau=TAU, backend=backend)
    loss = (img ** 2).mean()
    grads = torch.autograd.grad(loss, (pos, rad))
    return (float(loss.detach()), *grads)


def _jax_geometry_grads(sj):
    jcfg, _ = _cfgs()
    jx, jy = j_pixel_grid(W, H)

    def loss(pos, rad):
        sc = sj.__class__(**{**sj.__dict__, "sph_pos": pos,
                             "sph_radius": rad})
        img = j_soft(sc, rtm_tpu.Camera().spec(W, H), jx, jy,
                     jnp.uint32(FI), jcfg, tau=TAU)
        return jnp.mean(img ** 2)

    val, grads = jax.value_and_grad(loss, argnums=(0, 1))(sj.sph_pos,
                                                           sj.sph_radius)
    return (float(val), *grads)


def test_sphere_gradients_match_jax(rig):
    """d loss / d (sphere centre, radius) through the soft blend against
    jax.grad of rtm_tpu's render_soft_primary; the silhouette term makes
    them non-zero where the hard render's are ~0."""
    _, sj, st = rig
    loss, g_pos, g_rad = _port_geometry_grads(st)
    j_loss, j_pos, j_rad = _jax_geometry_grads(sj)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    for got, want in ((g_pos, j_pos), (g_rad, j_rad)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert float(g_pos[0, 0].abs()) > 1e-4 and float(g_rad[0].abs()) > 1e-4


def test_pallas_route_matches_xla_route(rig):
    """The intersect kernel's route (its plain version here) gives the
    xla route's image and gradients."""
    _, _, st = rig
    x_loss, x_pos, x_rad = _port_geometry_grads(st, "xla")
    p_loss, p_pos, p_rad = _port_geometry_grads(st, "pallas")
    np.testing.assert_allclose(p_loss, x_loss, rtol=1e-6)
    for got, want in ((p_pos, x_pos), (p_rad, x_rad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_loss_and_grad_soft_tau_matches_jax(rig, backend):
    """render_loss(soft_tau > 0) through apply_params: the loss and every
    parameter's gradient against jax.value_and_grad of rtm_tpu's
    render_loss(soft_tau) on its xla route (rtm_tpu's pallas route has no
    autodiff rule); all finite with sky pixels in the frame.

    rtm_tpu's render_loss runs op by op here (without its jax.jit): the
    occluder rig's centre pixel column meets the triangle exactly where
    its barycentric u == v, and under jit XLA fuses multiply-adds, which
    breaks that tie and moves the triangle's x gradients by up to 0.07
    between jit and op-by-op runs of rtm_tpu itself; the port matches
    the op-by-op run."""
    _, sj, st = rig
    jcfg, tcfg = _cfgs()
    jl, jg = jax.value_and_grad(j_render_loss.__wrapped__)(
        j_extract(sj), sj, rtm_tpu.Camera().spec(W, H),
        jnp.zeros((H, W, 3), jnp.float32), jnp.uint32(FI), jcfg,
        backend="xla", remat=False, soft_tau=TAU)
    loss, g = td.loss_and_grad(td.extract_params(st), st,
                               rtm_tpu_torch.Camera().spec(W, H),
                               torch.zeros((H, W, 3)), FI, tcfg,
                               backend=backend, remat=False, soft_tau=TAU)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for name in g.fields():
        got = getattr(g, name)
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jg, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert float(g.sph_pos.abs().max()) > 0.0


def test_soft_converges_to_hard():
    """tests/test_grad.py: tau -> 0 recovers the hard render away from the
    edge band."""
    from rtm_tpu_torch.ops.trace_ref import render_pixels

    st = carry(_rig("sky"))
    _, tcfg = _cfgs()
    x, y = pixel_grid(W, H)
    cam = rtm_tpu_torch.Camera().spec(W, H)
    hard = render_pixels(st, cam, x, y, FI, tcfg)
    soft = render_soft_primary(st, cam, x, y, FI, tcfg, tau=1e-4)
    frac = float(((hard - soft).abs().amax(dim=-1) > 1e-3).float().mean())
    assert frac < 0.02


@pytest.mark.parametrize("backend", ["megakernel", "wavefront2", "trav",
                                     "auto"])
def test_fused_routes_raise(backend):
    """As in rtm_tpu, the soft route's per-bounce sweep refuses the fused
    and wavefront backends: ValueError from bounce_payload, bands or not."""
    st = carry(_rig("sky"))
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="bounce_payload backend"):
        td.loss_and_grad(td.extract_params(st), st,
                         rtm_tpu_torch.Camera().spec(W, H),
                         torch.zeros((H, W, 3)), FI, tcfg, backend=backend,
                         soft_tau=TAU, bands=2)
