"""rtm_tpu_torch.parallel (torch.distributed) against rtm_tpu.parallel on
the CPU.

In one process, with no process group: `render_band` over a world of 1,
3, 4 and 8 ranks, the bands concatenated, against the port's full-frame
`render_dispatch` for every backend, at 24x20 (row-major slots), 24x19
(uneven: the last band runs past W*H) and 16x16 (8x8-block slots).  xla
and pallas bitwise; mxu and trav within the post-pass's tolerance (rtol
1e-5, atol 5e-6, tests/test_torch_postpass.py): their plain versions are
per slot, but PyTorch's CPU atan2 is not batch-invariant (a SIMD body and
a scalar tail round differently), so a sky or texture tap can move by
ulps with the band's length; on the card every element runs the same code
and chip_smoke.py [shard-band] holds them bitwise.  The megakernel (its
512-ray tiles) and wavefront2 (a sort per band) by images_close.

One spawned gloo world of 4 ranks (rtm_tpu_torch.parallel.smoke
spawn_world + run_cases; one spawn for the module, started first and run
beside the JAX references) against rtm_tpu's sharded functions over
make_mesh(4) on conftest's 8-device CPU mesh, its fused routes in
interpret mode: render_sharded (xla, mxu, trav, megakernel, wavefront2)
and render_sharded_spp by images_close; sharded_loss_and_grad (xla, mxu
replay, wavefront2) within rtol 1e-3 / atol 1e-5, the bound of the port's
one-process gradients against rtm_tpu's (tests/test_torch_grad.py), and
against the port's one-process loss_and_grad within rtm_tpu's own sharding
bound, rtol 3e-4 / atol 2e-6 (tests/test_parallel.py); three make_train_step steps against rtm_tpu's
with optax.adam.  Every rank's frame and parameters bitwise equal, and
the x n double-count pin.  Then initialize_distributed, make_mesh and the
loud errors, on a world of one in this process.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import rtm_tpu
import rtm_tpu_torch
from conftest import images_close
from rtm_tpu.diff import extract_params as j_extract
from rtm_tpu.ops.trace_ref import render_dispatch as j_render_dispatch
from rtm_tpu.parallel import sharding as jsh
from rtm_tpu_torch.ops.kernels import megakernel as tmk
from rtm_tpu_torch.ops.trace_ref import resolve_route
from rtm_tpu_torch.parallel import distributed as tdist
from rtm_tpu_torch.parallel import sharding as tsh
from rtm_tpu_torch.parallel.smoke import _free_port, run_cases, spawn_world
from test_torch_parity import jax_scene

BACKENDS = ("mxu", "trav", "megakernel", "wavefront2", "xla", "pallas")
WORLD = 4
B = 3
# the world's cases: rtm_tpu's own tests' scenes and sizes
# (tests/test_parallel.py): scene 1 at 24x20 for xla, spp and the train
# step, scene 2 at 16x16 for the fused routes and the gradients
S1 = dict(scene=1, width=24, height=20, bounces=B)
S2 = dict(scene=2, width=16, height=16, bounces=B)
CASES = ([dict(name="render-xla", kind="render", backend="xla", **S1),
          dict(name="spp-xla", kind="spp", backend="xla", **S1),
          dict(name="train-xla", kind="train", backend="xla", steps=3,
               lr=5e-2, **S1)]
         + [dict(name=f"render-{be}", kind="render", backend=be, **S2)
            for be in ("mxu", "trav", "megakernel", "wavefront2")]
         + [dict(name=f"grad-{be}", kind="grad", backend=be, **S2)
            for be in ("xla", "mxu", "wavefront2")])
JAX_BACKEND = {"xla": "xla", "mxu": "mxu_interpret",
               "trav": "trav_interpret",
               "megakernel": "megakernel_interpret",
               "wavefront2": "wavefront2_interpret"}
GRAD_RTOL, GRAD_ATOL = 3e-4, 2e-6
JAX_GRAD_RTOL, JAX_GRAD_ATOL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def world():
    """The spawned world's results, rank by rank, as a future: the spawn
    runs in a thread while the tests compute rtm_tpu's references."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn_world, WORLD, run_cases, (CASES,),
                          device="cpu", timeout_s=300)


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def _cfgs(case):
    kw = dict(width=case["width"], height=case["height"],
              max_bounces=case["bounces"], draw_environment=True)
    return rtm_tpu.RenderConfig(**kw), rtm_tpu_torch.RenderConfig(**kw)


def _port_scene(sid):
    return rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(sid),
                                            device="cpu")


# ---------------------------------------------------------------------------
# render_band: the band arithmetic in one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene3():
    return _port_scene(3)


@pytest.mark.parametrize("size", [(24, 20), (24, 19), (16, 16)])
@pytest.mark.parametrize("world_size", [1, 3, 4, 8])
@pytest.mark.parametrize("backend", BACKENDS)
def test_render_band_matches_full_frame(scene3, backend, world_size, size):
    w, h = size
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=B,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(w, h)
    ref = rtm_tpu_torch.render_dispatch(scene3, cam, 1, cfg, backend=backend)
    band = tsh.band_size(cfg, world_size)
    parts = [tsh.render_band(scene3, cam, 1, cfg, r, world_size, backend)
             for r in range(world_size)]
    assert all(p.shape == (band, 3) for p in parts)
    img = tsh.image_of_bands(torch.cat(parts), cfg,
                             resolve_route(scene3, cfg, backend))
    assert img.shape == (h, w, 3) and torch.isfinite(img).all()
    if backend in ("xla", "pallas"):
        assert torch.equal(img, ref)
    elif backend in ("mxu", "trav"):
        torch.testing.assert_close(img, ref, rtol=1e-5, atol=5e-6)
    else:
        images_close(img.numpy(), ref.numpy())


def test_band_route_fallbacks_and_errors(scene3):
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=B)
    assert [resolve_route(scene3, cfg, be) for be in BACKENDS] == list(
        BACKENDS)
    flat = dataclasses.replace(cfg, max_bounces=1)
    assert [resolve_route(scene3, flat, be) for be in BACKENDS] == [
        "xla"] * 5 + ["pallas"]
    beyond = dataclasses.replace(
        scene3, mxu_meta=scene3.mxu_meta._replace(supported=False))
    assert resolve_route(beyond, cfg, "mxu") == "trav"
    beyond = dataclasses.replace(
        beyond, trav_meta=beyond.trav_meta._replace(supported=False))
    assert resolve_route(beyond, cfg, "mxu") == "megakernel"
    with pytest.raises(ValueError, match="backend"):
        resolve_route(scene3, cfg, "bogus")
    with pytest.raises(ValueError, match="backend"):
        tsh.render_band(scene3, rtm_tpu_torch.Camera().spec(16, 16), 1, cfg,
                        0, 2, "auto")
    # a band falls from the megakernel to wavefront2 as loudly as
    # render_dispatch does: one route chain, with its warning
    cam = rtm_tpu_torch.Camera().spec(16, 16)
    with mock.patch.object(tmk, "megakernel_fits", lambda s, c: False):
        with pytest.warns(UserWarning, match="wavefront2"):
            got = tsh.render_band(scene3, cam, 1, cfg, 1, 2, "megakernel")
    want = tsh.render_band(scene3, cam, 1, cfg, 1, 2, "wavefront2")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# A spawned gloo world of 4 against rtm_tpu over make_mesh(4)
# ---------------------------------------------------------------------------

def _jax_render(case, spp=False):
    jcfg, _ = _cfgs(case)
    sj = jax_scene(case["scene"])
    cam = rtm_tpu.Camera().spec(jcfg.width, jcfg.height)
    fn = jsh.render_sharded_spp if spp else jsh.render_sharded
    return np.asarray(fn(sj, cam, jnp.uint32(1), jcfg, jsh.make_mesh(WORLD),
                         backend=JAX_BACKEND[case["backend"]]))


@pytest.mark.parametrize("backend", ["xla", "mxu", "trav", "megakernel",
                                     "wavefront2"])
def test_render_sharded_matches_jax(world, backend):
    case = _case(f"render-{backend}")
    want = _jax_render(case)
    got = world.result()[0][case["name"]]["image"]
    assert got.shape == want.shape and np.isfinite(got).all()
    images_close(got, want)


def test_render_sharded_spp_matches_jax(world):
    case = _case("spp-xla")
    want = _jax_render(case, spp=True)
    got = world.result()[0][case["name"]]["image"]
    images_close(got, want)
    # the average of 4 seed streams differs from the one-stream frame
    one = world.result()[0]["render-xla"]["image"]
    assert not np.array_equal(got, one)


def test_every_rank_holds_the_same_frames_and_params(world):
    ranks = world.result()
    assert len(ranks) == WORLD
    for case in CASES:
        if case["kind"] in ("render", "spp", "train"):
            assert len({r[case["name"]]["digest"] for r in ranks}) == 1, \
                case["name"]
        if case["kind"] == "grad":
            losses = {r[case["name"]]["loss"] for r in ranks}
            assert len(losses) == 1, case["name"]


def _jax_sharded_grads(case):
    jcfg, _ = _cfgs(case)
    sj = jax_scene(case["scene"])
    return jsh.sharded_loss_and_grad(
        j_extract(sj), sj, rtm_tpu.Camera().spec(jcfg.width, jcfg.height),
        jnp.full((jcfg.height, jcfg.width, 3), 0.3, jnp.float32),
        jnp.uint32(1), jcfg, jsh.make_mesh(WORLD),
        backend=JAX_BACKEND[case["backend"]], remat=False,
        rebuild_tri_geometry=False)


def _port_grads(case):
    """One process's loss_and_grad on the case's route (the port)."""
    _, tcfg = _cfgs(case)
    st = _port_scene(case["scene"])
    return rtm_tpu_torch.loss_and_grad(
        rtm_tpu_torch.extract_params(st), st,
        rtm_tpu_torch.Camera().spec(tcfg.width, tcfg.height),
        torch.full((tcfg.height, tcfg.width, 3), 0.3), 1, tcfg,
        case["backend"], False, False)


@pytest.mark.parametrize("backend", ["xla", "mxu", "wavefront2"])
def test_sharded_loss_and_grad_matches_one_process(world, backend):
    """Sharding changes only the summation order: rtm_tpu's own bound for
    its sharded gradients against one device (tests/test_parallel.py)."""
    case = _case(f"grad-{backend}")
    l1, g1 = _port_grads(case)
    got = world.result()[0][case["name"]]
    np.testing.assert_allclose(got["loss"], float(l1), rtol=1e-4)
    for name in g1.fields():
        have = got["grads"][name]
        assert np.isfinite(have).all(), name
        np.testing.assert_allclose(have, getattr(g1, name).numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("backend", ["xla", "mxu", "wavefront2"])
def test_sharded_loss_and_grad_matches_jax(world, backend):
    """Against rtm_tpu's sharded gradients within the bound the port's
    one-process gradients keep to rtm_tpu's (tests/test_torch_grad.py):
    across the two packages sph_radius already differs by up to 3.1e-4
    relative in one process, beyond rtm_tpu's sharding bound."""
    case = _case(f"grad-{backend}")
    jl, jg = _jax_sharded_grads(case)
    got = world.result()[0][case["name"]]
    np.testing.assert_allclose(got["loss"], float(jl), rtol=1e-4)
    for name in dataclasses.fields(jg):
        np.testing.assert_allclose(got["grads"][name.name],
                                   np.asarray(getattr(jg, name.name)),
                                   rtol=JAX_GRAD_RTOL, atol=JAX_GRAD_ATOL,
                                   err_msg=name.name)


@pytest.mark.parametrize("backend", ["mxu", "wavefront2"])
def test_sharded_grads_not_double_counted(world, backend):
    """The port's twin of rtm_tpu's x n_dev pin: the least-squares scale of
    the sharded gradients against one process's xla gradients is 1, and a
    gradient reduced inside and again outside the differentiated function
    (scale 4 on 4 ranks) fails here."""
    case = _case(f"grad-{backend}")
    _, g1 = _port_grads(dict(case, backend="xla"))
    ref = np.concatenate([t.numpy().ravel() for t in g1.tensors()])
    got = world.result()[0][case["name"]]["grads"]
    sh = np.concatenate([got[k].ravel() for k in g1.fields()])
    denom = float(ref @ ref)
    assert denom > 0
    scale = float(sh @ ref) / denom
    assert abs(scale - 1.0) < 0.01, scale
    assert abs(scale - WORLD) > 1.0, scale


def test_train_step_matches_jax(world):
    import optax

    case = _case("train-xla")
    jcfg, _ = _cfgs(case)
    sj = jax_scene(case["scene"])
    cam = rtm_tpu.Camera().spec(jcfg.width, jcfg.height)
    mesh = jsh.make_mesh(WORLD)
    target = j_render_dispatch(sj, cam, jnp.uint32(1), jcfg)
    params = j_extract(sj)
    params.albedo = params.albedo * 0.5
    opt = optax.adam(case["lr"])
    step = jsh.make_train_step(sj, cam, target, jcfg, mesh, opt,
                               rebuild_tri_geometry=False)
    st = opt.init(params)
    losses = []
    for _ in range(case["steps"]):
        params, st, loss = step(params, st, jnp.uint32(1))
        losses.append(float(loss))
    got = world.result()[0][case["name"]]
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    for name in dataclasses.fields(params):
        np.testing.assert_allclose(got["params"][name.name],
                                   np.asarray(getattr(params, name.name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name.name)


# ---------------------------------------------------------------------------
# initialize_distributed, make_mesh and the loud errors (a world of one)
# ---------------------------------------------------------------------------

def test_initialize_distributed_without_a_world_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize_distributed() is False
    assert not dist.is_initialized()
    assert tdist.global_device_count() == 1
    assert tdist.local_device_count() == torch.cuda.device_count()


def test_initialize_distributed_raises_after_its_retries():
    """Rank 1 of 2 against a port nothing listens on: each attempt times
    out, and after the last the error is raised from it."""
    with pytest.raises(RuntimeError, match="after 2 attempts") as e:
        tdist.initialize_distributed(f"127.0.0.1:{_free_port()}", 2, 1,
                                     retries=2, retry_delay_s=0.05,
                                     backend="gloo", timeout_s=0.5)
    assert e.value.__cause__ is not None
    assert not dist.is_initialized()


def test_rank_device_needs_the_card_unless_asked():
    assert tdist.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.rank_device()


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo group of one rank in this process, destroyed after the
    module."""
    assert tdist.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                        backend="gloo")
    try:
        yield tsh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_is_idempotent(world_of_one):
    assert tdist.initialize_distributed() is True
    assert tdist.initialize_distributed("127.0.0.1:1", 3, 2) is True
    assert tdist.global_device_count() == 1


def test_make_mesh_takes_the_whole_world(world_of_one):
    assert world_of_one.size() == 1
    assert world_of_one.mesh_dim_names == (tsh.DP_AXIS,)
    assert world_of_one.device_type == "cpu"
    assert tsh.make_mesh(1, device="cpu").size() == 1
    with pytest.raises(ValueError, match="n_devices"):
        tsh.make_mesh(2, device="cpu")


def test_world_of_one_equals_one_process(world_of_one, scene3):
    """render_sharded over one rank is render_dispatch, and the sharded
    loss and gradients are loss_and_grad's."""
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=B,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(16, 16)
    for be in ("mxu", "xla"):
        got = tsh.render_sharded(scene3, cam, 1, cfg, world_of_one,
                                 backend=be)
        assert torch.equal(got, rtm_tpu_torch.render_dispatch(
            scene3, cam, 1, cfg, backend=be)), be
    params = rtm_tpu_torch.extract_params(scene3)
    target = torch.full((16, 16, 3), 0.3)
    loss, g = tsh.sharded_loss_and_grad(params, scene3, cam, target, 1, cfg,
                                        world_of_one, backend="mxu",
                                        remat=False)
    l1, g1 = rtm_tpu_torch.loss_and_grad(params, scene3, cam, target, 1, cfg,
                                         backend="mxu", remat=False)
    torch.testing.assert_close(loss, l1, rtol=1e-6, atol=0)
    for a, b in zip(g.tensors(), g1.tensors()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_loud_errors(world_of_one, scene3):
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=B)
    cam = rtm_tpu_torch.Camera().spec(16, 16)
    params = rtm_tpu_torch.extract_params(scene3)
    target = torch.zeros((16, 16, 3))
    with pytest.raises(ValueError, match="backend"):
        tsh.render_sharded(scene3, cam, 1, cfg, world_of_one,
                           backend="bogus")
    for be in ("trav", "megakernel", "bogus"):
        with pytest.raises(ValueError, match="backend"):
            tsh.sharded_loss_and_grad(params, scene3, cam, target, 1, cfg,
                                      world_of_one, backend=be)
    beyond = dataclasses.replace(
        scene3, mxu_meta=scene3.mxu_meta._replace(supported=False))
    with pytest.raises(ValueError, match="table limits"):
        tsh.sharded_loss_and_grad(params, beyond, cam, target, 1, cfg,
                                  world_of_one, backend="mxu")
    with pytest.raises(ValueError, match="mxu"):
        tsh.sharded_loss_and_grad(
            params, scene3, cam, target, 1,
            dataclasses.replace(cfg, max_bounces=1), world_of_one,
            backend="mxu")
    elsewhere = dataclasses.replace(scene3, tri_wa=scene3.tri_wa.to("meta"))
    with pytest.raises(ValueError, match="mesh"):
        tsh.render_sharded(elsewhere, cam, 1, cfg, world_of_one)
