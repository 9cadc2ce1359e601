"""rtm_tpu_torch's gradients against rtm_tpu's on the CPU.

The rig is tests/test_grad.py's `_scene()` (two materials, three spheres,
one triangle) at 24x20, 3 bounces, built by rtm_tpu and carried into the
port as NumPy arrays.  Per-field gradients of `loss_and_grad` match
`jax.value_and_grad(render_loss)` within rtol 1e-3 / atol 1e-5 (rtm_tpu's
own bound, tests/test_grad.py) for every route: `xla`; `mxu` (record
replay) against rtm_tpu's `mxu_interpret`; `wavefront2` against
`wavefront2_interpret`, and bands=2 against bands=1; `pallas` against
rtm_tpu's `xla` (rtm_tpu's `pallas` route has no autodiff rule: its
pallas_call carries no custom_vjp).  Every gradient is finite.
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
from rtm_tpu.diff.params import apply_params as j_apply
from rtm_tpu.models import scenes as jscenes
from rtm_tpu_torch import diff as td
from test_torch_parity import carry, jax_scene

W, H, B = 24, 20, 3
RTOL, ATOL = 1e-3, 1e-5


def _rig(pkg, scenes):
    s = pkg.Scene(sky=scenes._procedural_sky())
    s.add_material(pkg.Material((0.7, 0.4, 0.2), (1, 1, 1), 0.3, 0.2, 0, 1.0,
                                -1))
    s.add_material(pkg.Material((1, 1, 1), (0.9, 0.8, 0.7), 0, 0, 2.0, 1.0,
                                -1))
    s.add_sphere(pkg.SphereDef((0, 0, -2.5), 1.0, 0))
    s.add_sphere(pkg.SphereDef((0, -101, -2), 100.0, 0))
    s.add_sphere(pkg.SphereDef((1.5, 2.0, -2.0), 0.8, 1))
    s.add_mesh(pkg.Mesh.from_triangles([
        pkg.Triangle((-2.5, -0.8, -4), (2.5, -0.8, -4), (0, 2.5, -4))]))
    s.add_object(pkg.MeshInstance(mesh_id=0, material_id=0))
    return s


@pytest.fixture(scope="module")
def rig():
    sj = rtm_tpu.build_tracer_scene(_rig(rtm_tpu, jscenes))
    return sj, carry(sj)


def _cfgs(bounces=B):
    kw = dict(width=W, height=H, max_bounces=bounces, draw_environment=True)
    return rtm_tpu.RenderConfig(**kw), rtm_tpu_torch.RenderConfig(**kw)


def _jax_grads(sj, backend, **kw):
    jcfg, _ = _cfgs()
    return jax.value_and_grad(j_render_loss)(
        j_extract(sj), sj, rtm_tpu.Camera().spec(W, H),
        jnp.zeros((H, W, 3), jnp.float32), jnp.uint32(1), jcfg,
        backend=backend, remat=False, **kw)


def _port_grads(st, backend, **kw):
    _, tcfg = _cfgs()
    return td.loss_and_grad(td.extract_params(st), st,
                            rtm_tpu_torch.Camera().spec(W, H),
                            torch.zeros((H, W, 3)), 1, tcfg, backend=backend,
                            **{"remat": False, **kw})


def _assert_grads_close(tg, jg, rtol=RTOL, atol=ATOL):
    for name in tg.fields():
        got = getattr(tg, name)
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jg, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jax_xla(rig):
    return _jax_grads(rig[0], "xla")


# port route -> (rtm_tpu route it is held against, extra kwargs)
ROUTES = {
    "xla": ("xla", {}),
    "mxu": ("mxu_interpret", {}),
    "wavefront2": ("wavefront2_interpret", {}),
    "pallas": ("xla", {}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_grads_match_jax(rig, jax_xla, route):
    jb, kw = ROUTES[route]
    jl, jg = jax_xla if jb == "xla" else _jax_grads(rig[0], jb, **kw)
    loss, g = _port_grads(rig[1], route, **kw)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_grads_close(g, jg)
    assert float(g.albedo.abs().max()) > 0.0


@pytest.mark.parametrize("route", ["xla", "mxu"])
def test_textured_grads_match_jax(route):
    """Scene 2's textured ground plane: the texture tap carries gradients
    to u, v through its bilinear weights (no integer cast or in-place op
    cuts the graph), so the vertex gradients match rtm_tpu's."""
    sj = jax_scene(2)
    st = carry(sj)
    kw = dict(width=16, height=16, max_bounces=3, draw_environment=True)
    jl, jg = jax.value_and_grad(j_render_loss)(
        j_extract(sj), sj, rtm_tpu.Camera().spec(16, 16),
        jnp.zeros((16, 16, 3), jnp.float32), jnp.uint32(2),
        rtm_tpu.RenderConfig(**kw),
        backend="mxu_interpret" if route == "mxu" else route, remat=False)
    loss, g = td.loss_and_grad(td.extract_params(st), st,
                               rtm_tpu_torch.Camera().spec(16, 16),
                               torch.zeros((16, 16, 3)), 2,
                               rtm_tpu_torch.RenderConfig(**kw),
                               backend=route, remat=False)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_grads_close(g, jg)
    assert float(g.tri_verts.abs().max()) > 0.0


def test_wavefront2_bands_equal_one_band(rig):
    l1, g1 = _port_grads(rig[1], "wavefront2")
    l2, g2 = _port_grads(rig[1], "wavefront2", bands=2)
    l3 = td.render_loss(td.extract_params(rig[1]), rig[1],
                        rtm_tpu_torch.Camera().spec(W, H),
                        torch.zeros((H, W, 3)), 1, _cfgs()[1],
                        backend="wavefront2", bands=3)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    np.testing.assert_allclose(float(l3), float(l1), rtol=1e-6)
    _assert_grads_close(g2, g1, rtol=1e-5, atol=1e-8)


def test_remat_grads_match(rig):
    """torch.utils.checkpoint per bounce must not change gradients, on the
    scan and on the replay route."""
    for route in ("xla", "mxu"):
        _, g0 = _port_grads(rig[1], route, remat=False)
        _, g1 = _port_grads(rig[1], route, remat=True)
        for a, b in zip(g0.tensors(), g1.tensors()):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def _fd(st, field, index, eps):
    """Central finite difference of the xla loss along one coordinate."""
    _, tcfg = _cfgs()
    cam = rtm_tpu_torch.Camera().spec(W, H)
    target = torch.zeros((H, W, 3))
    p = td.extract_params(st)
    vals = []
    for sgn in (1.0, -1.0):
        t = getattr(p, field).clone()
        t[index] += sgn * eps
        q = dataclasses.replace(p, **{field: t})
        with torch.no_grad():
            vals.append(float(td.render_loss(q, st, cam, target, 1, tcfg,
                                              remat=False)))
    return (vals[0] - vals[1]) / (2 * eps)


@pytest.mark.parametrize("field, index, eps, tol", [
    ("albedo", (0, 0), 1e-3, 2e-2),
    ("tri_verts", (0, 2, 1), 2e-3, 0.15),
])
def test_grad_fd(rig, field, index, eps, tol):
    """tests/test_grad.py's finite-difference checks (same eps and tol)."""
    _, g = _port_grads(rig[1], "xla")
    auto = float(getattr(g, field)[index])
    fd = _fd(rig[1], field, index, eps)
    rel = abs(auto - fd) / max(abs(fd), abs(auto), 1e-8)
    assert rel < tol, (auto, fd, rel)
    assert abs(auto) > 0


def test_params_match_jax(rig):
    sj, st = rig
    jp, tp = j_extract(sj), td.extract_params(st)
    for name in tp.fields():
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    carried = td.scene_params_from_numpy(
        {k: np.asarray(v) for k, v in vars(jp).items()}, "cpu")
    for a, b in zip(carried.tensors(), tp.tensors()):
        assert torch.equal(a, b)


def test_apply_params_matches_jax_instanced_scene3():
    """Vertex-parameter rebuild on scene 3's rotated, scaled instance:
    the local-space UV arrays and shader normals agree with rtm_tpu's."""
    sj = jax_scene(3)
    st = carry(sj)
    jp = j_extract(sj)
    verts = (np.asarray(jp.tri_verts) + np.random.default_rng(0).normal(
        0, 1e-2, np.shape(jp.tri_verts))).astype(np.float32)
    jp = dataclasses.replace(jp, tri_verts=jnp.asarray(verts))
    tp = dataclasses.replace(td.extract_params(st),
                             tri_verts=torch.from_numpy(verts))
    js = j_apply(sj, jp)
    ts = td.apply_params(st, tp)
    for name in ("tri_wa", "tri_la", "tri_lab", "tri_lac", "tri_normal"):
        a = np.asarray(getattr(js, name))
        np.testing.assert_allclose(getattr(ts, name).numpy(), a,
                                   rtol=1e-5, atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)
    # round trip of unchanged vertices keeps the build-time arrays
    st2 = td.apply_params(st, td.extract_params(st))
    cos = (st2.tri_normal * st.tri_normal).sum(-1)
    assert float(cos.min()) > 0.99


def test_inverse_render_mxu_replay_recovers_albedo(rig):
    """Twin of tests/test_grad.py's: Adam on the mxu record-replay
    gradients recovers a perturbed albedo."""
    _, st = rig
    _, tcfg = _cfgs()
    cam = rtm_tpu_torch.Camera().spec(W, H)
    true = td.extract_params(st)
    target = rtm_tpu_torch.render_dispatch(st, cam, 1, tcfg, backend="xla")
    alb = true.albedo.clone()
    alb[0] = torch.tensor([0.3, 0.6, 0.6])
    p0 = dataclasses.replace(true, albedo=alb)
    mask = p0.map(torch.zeros_like)
    mask = dataclasses.replace(mask, albedo=torch.ones_like(alb))
    opt = td.InverseRenderConfig(steps=80, learning_rate=4e-2, remat=False,
                                 vary_seed=False, backend="mxu")
    fit, losses = td.inverse_render(st, cam, target, tcfg, opt,
                                    init_params=p0, param_mask=mask)
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
    np.testing.assert_allclose(fit.albedo[0].numpy(),
                               true.albedo[0].numpy(), atol=0.08)
    assert torch.equal(fit.sph_pos, true.sph_pos)


def test_loud_errors(rig):
    """The grad dispatch raises, never reroutes: the mxu route refuses the
    flat-shade preview, soft_tau and scenes beyond its tables; soft
    primary visibility refuses the fused and wavefront routes, as
    rtm_tpu's bounce_payload does (on xla and pallas it is held against
    rtm_tpu: test_soft_tau_grads_match_jax)."""
    _, st = rig
    cam = rtm_tpu_torch.Camera().spec(W, H)
    target = torch.zeros((H, W, 3))
    p = td.extract_params(st)
    _, cfg1 = _cfgs(bounces=1)
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="flat-shade"):
        td.render_loss(p, st, cam, target, 1, cfg1, backend="mxu")
    with pytest.raises(ValueError, match="soft"):
        td.render_loss(p, st, cam, target, 1, cfg, backend="mxu",
                       soft_tau=0.05)
    big = dataclasses.replace(
        st, mxu_meta=st.mxu_meta._replace(supported=False))
    with pytest.raises(ValueError, match="mxu table limits"):
        td.loss_and_grad(p, big, cam, target, 1, cfg, backend="mxu")
    for backend in ("wavefront2", "megakernel"):
        with pytest.raises(ValueError, match="bounce_payload backend"):
            td.loss_and_grad(p, st, cam, target, 1, cfg, backend=backend,
                             soft_tau=0.05)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_soft_tau_grads_match_jax(rig, route):
    """loss_and_grad(soft_tau=0.05) on the rig against jax.value_and_grad
    of rtm_tpu's render_loss(soft_tau=0.05) on its xla route, run op by op
    (without its jax.jit, whose fused multiply-adds break the rig's exact
    barycentric ties on the centre pixel column), at rtm_tpu's tolerance;
    the silhouette term moves the sphere gradients off the hard route's."""
    sj, st = rig
    jcfg, _ = _cfgs()
    jl, jg = jax.value_and_grad(j_render_loss.__wrapped__)(
        j_extract(sj), sj, rtm_tpu.Camera().spec(W, H),
        jnp.zeros((H, W, 3), jnp.float32), jnp.uint32(1), jcfg,
        backend="xla", remat=False, soft_tau=0.05)
    loss, g = _port_grads(st, route, soft_tau=0.05)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_grads_close(g, jg)
    _, hard = _port_grads(st, route)
    assert not torch.allclose(g.sph_pos, hard.sph_pos, rtol=RTOL, atol=ATOL)
