"""Spawned worlds of ranks: the harness, its cases, and the smoke run.

    python -m rtm_tpu_torch.parallel.smoke [--world 4] [--device cpu|cuda]

Port of scripts/distributed_smoke.py.  The smoke run spawns `--world`
worker processes; each joins the process group (initialize_distributed),
all-reduces its rank index, renders one render_sharded dispatch (scene 3,
32x32, 2 bounces, mxu) and returns it; the parent checks the sum, that
every rank holds the same finite frame, and that it equals the frame of
one process.  On the card each rank takes cuda:{rank % device_count}:
NCCL when every rank has a GPU of its own, gloo when ranks share one
(NCCL refuses two ranks on one GPU).

`spawn_world` and `run_cases` are the harness the tests and chip_smoke.py
use.  They live in the package because a spawned child imports the module
of its target, and the test modules import jax.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..ops.kernels import kernel_wrappers
from .distributed import initialize_distributed, rank_device
from .sharding import (DP_AXIS, make_mesh, make_train_step, render_sharded,
                       render_sharded_spp, sharded_loss_and_grad)


def pick_backend(world: int, device: str) -> str:
    """NCCL when every rank has a GPU of its own, else gloo."""
    if device == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, backend, target, args, out):
    """One spawned rank: join the group, run target(mesh, device, *args),
    put (rank, ok, result or traceback) on `out`."""
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.cuda.init()       # DeviceMesh then keeps this device
        else:                       # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        initialize_distributed(f"127.0.0.1:{port}", world, rank, retries=1,
                               backend=None if backend == "nccl" else backend)
        mesh = make_mesh(world, device=dev.type)
        out.put((rank, True, target(mesh, dev, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(world: int, target, args=(), device: str = "cuda",
                backend: str | None = None, timeout_s: float = 300.0):
    """Run target(mesh, device, *args) on each rank of a spawned world of
    `world` processes (start method "spawn": safe once CUDA or threads are
    up in the parent) and return the ranks' results in rank order.

    `target` must be a module-level function of a module that imports no
    jax (the children import it).  backend: None picks NCCL or gloo
    (pick_backend).  Raises RuntimeError with the ranks' tracebacks if any
    rank failed, and TimeoutError (after killing every rank) if the world
    did not finish within timeout_s.  Build the kernel libraries in the
    parent first, so that the ranks do not compile them at once."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    backend = backend or pick_backend(world, device)
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, device, backend, target, args,
                               out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        while len(got) < world:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if time.monotonic() >= deadline or dead:
                    raise TimeoutError(
                        f"world of {world} ({backend}): ranks "
                        f"{sorted(set(range(world)) - set(got))} gave no "
                        f"result (exited: {dead}) within {timeout_s} s"
                    ) from None
                continue
            got[rank] = (ok, res)
            if not ok:
                break          # the others may wait on it: kill them below
        else:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    failed = {r: res for r, (ok, res) in got.items() if not ok}
    if failed:
        raise RuntimeError(f"world of {world} ({backend}) failed:\n"
                           + "\n".join(f"rank {r}:\n{tb}"
                                       for r, tb in failed.items()))
    return [got[r][1] for r in range(world)]


def digest(t: torch.Tensor) -> str:
    """A tensor's bytes as a sha256: bitwise equality across ranks."""
    return hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def _timed_ms(fn, dev, reps: int, group) -> float:
    """Host ms per call of fn() over reps calls, every rank starting
    together and the card synchronised at both ends."""
    fn()
    _sync(dev)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def run_cases(mesh, dev, cases):
    """Run the named cases on this rank; returns {name: result}.

    Each case is a dict with "name", "kind" ("render", "spp", "grad" or
    "train"), "scene" (load_scene id), "width", "height", "bounces",
    "backend", and for "train" "steps" and "lr" (and optionally "fit", the
    one SceneParams field the optimizer moves), the albedo scaled by 0.5
    and the target the scene's own frame.  Every result carries each
    kernel's launches in the case's first call ("launches"); "reps" > 0
    then times the case (host ms per call, card synchronised); on the
    card every result carries the rank's peak MiB.  Results are NumPy
    arrays, digests and floats, so they pickle back to the parent."""
    import dataclasses

    from ..config import RenderConfig
    from ..diff.params import extract_params
    from ..models.camera import Camera
    from ..models.scene import build_tracer_scene
    from ..models.scenes import load_scene
    from ..ops.trace_ref import render_dispatch

    group = mesh.get_group(DP_AXIS)
    kernels = kernel_wrappers()
    scenes = {}
    results = {}
    for case in cases:
        sid = case["scene"]
        if sid not in scenes:
            scenes[sid] = build_tracer_scene(load_scene(sid), device=dev)
        scene = scenes[sid]
        cfg = RenderConfig(width=case["width"], height=case["height"],
                           max_bounces=case["bounces"],
                           draw_environment=True)
        cam = Camera().spec(cfg.width, cfg.height)
        be = case["backend"]
        reps = case.get("reps", 0)
        kind = case["kind"]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels.values():
            k.launches = 0
        res = {}
        if kind in ("render", "spp"):
            fn = render_sharded if kind == "render" else render_sharded_spp

            def run():
                return fn(scene, cam, 1, cfg, mesh, backend=be)

            img = run()
            res.update(image=img.cpu().numpy(), digest=digest(img),
                       launches=_launches(kernels))
            if reps:
                res["ms"] = _timed_ms(run, dev, reps, group)
        elif kind == "grad":
            params = extract_params(scene)
            target = torch.full((cfg.height, cfg.width, 3), 0.3, device=dev)
            loss, grads = sharded_loss_and_grad(
                params, scene, cam, target, 1, cfg, mesh, backend=be,
                remat=False, rebuild_tri_geometry=False)
            res.update(loss=float(loss), launches=_launches(kernels), grads={
                k: getattr(grads, k).cpu().numpy() for k in grads.fields()})
            if reps:
                res["ms"] = _timed_ms(lambda: sharded_loss_and_grad(
                    params, scene, cam, target, 1, cfg, mesh, backend=be,
                    remat=False, rebuild_tri_geometry=False), dev, reps,
                    group)
                flat = torch.cat([g.reshape(-1) for g in grads.tensors()])
                res["allreduce_ms"] = _timed_ms(
                    lambda: dist.all_reduce(flat.clone(), group=group), dev,
                    reps, group)
                res["allreduce_floats"] = flat.numel() + 1
        elif kind == "train":
            target = render_dispatch(scene, cam, 1, cfg, backend=be)
            p0 = extract_params(scene)
            params = dataclasses.replace(p0, albedo=p0.albedo * 0.5)
            opt = case["lr"]
            if "fit" in case:
                at, lr = params.fields().index(case["fit"]), case["lr"]

                def opt(tensors):
                    return torch.optim.Adam([tensors[at]], lr=lr,
                                            betas=(0.9, 0.999), eps=1e-8)
            step = make_train_step(scene, cam, target, cfg, mesh, opt,
                                   backend=be, rebuild_tri_geometry=False)
            losses = []
            for _ in range(case["steps"]):
                params, loss = step(params, 1)
                losses.append(float(loss))
            flat = torch.cat([t.detach().reshape(-1)
                              for t in params.tensors()])
            res.update(losses=losses, digest=digest(flat),
                       launches=_launches(kernels), params={
                k: getattr(params, k).detach().cpu().numpy()
                for k in params.fields()})
        else:
            raise ValueError(f"unknown case kind {kind!r}")
        if dev.type == "cuda":
            _sync(dev)
            res["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        results[case["name"]] = res
    return results


SMOKE_CASE = dict(name="smoke", kind="render", scene=3, width=32,
                  height=32, bounces=2, backend="mxu")


def smoke_rank(mesh, dev):
    """The smoke run on one rank: the rank-index all-reduce, then one
    render_sharded dispatch (run_cases)."""
    world = mesh.size()
    t = torch.tensor([float(mesh.get_local_rank(DP_AXIS))], device=dev)
    dist.all_reduce(t, group=mesh.get_group(DP_AXIS))
    total = float(t)
    if total != world * (world - 1) / 2:
        raise AssertionError(f"all-reduce of the rank indices gave {total}")
    out = run_cases(mesh, dev, [SMOKE_CASE])["smoke"]
    out["rank_sum"] = total
    return out


def build_in_parent(device: str) -> None:
    """Build the kernel libraries (on the card) and the native SAH builder
    once, before the ranks spawn and would build them at the same time."""
    from ..accel.native import bvh_native
    bvh_native.load()
    if device == "cuda":
        from ..ops.kernels import build
        build.build_kernels(build.KERNELS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("smoke: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    build_in_parent(args.device)
    backend = pick_backend(args.world, args.device)
    t0 = time.perf_counter()
    outs = spawn_world(args.world, smoke_rank, device=args.device,
                       timeout_s=args.timeout)
    sec = time.perf_counter() - t0
    from ..config import RenderConfig
    from ..models.camera import Camera
    from ..models.scene import build_tracer_scene
    from ..models.scenes import load_scene
    from ..ops.trace_ref import render_dispatch
    c = SMOKE_CASE
    dev = rank_device(args.device)
    cfg = RenderConfig(width=c["width"], height=c["height"],
                       max_bounces=c["bounces"], draw_environment=True)
    ref = render_dispatch(build_tracer_scene(load_scene(c["scene"]),
                                             device=dev),
                          Camera().spec(cfg.width, cfg.height), 1, cfg,
                          backend=c["backend"]).cpu().numpy()
    same = len({o["digest"] for o in outs}) == 1
    img = outs[0]["image"]
    err = float(abs(img - ref).max())
    equal = float((img == ref).all(axis=-1).mean())
    # On the CPU a band's sky and texture taps may move by ulps (PyTorch's
    # CPU atan2 is not batch-invariant): the post-pass tolerance.  On the
    # card bitwise where the band is a multiple of the mxu kernel's
    # 256-slot cull block; off that grid a ray lying in a triangle's plane
    # may differ (ROADMAP Queue 3), so >= 0.999 of the pixels.
    band = -(-cfg.num_pixels // args.world)
    if args.device == "cpu":
        rule = "rtol 1e-5 / atol 5e-6"
        close = bool(np.allclose(img, ref, rtol=1e-5, atol=5e-6))
    elif band % 256 == 0:
        rule, close = "bitwise", equal == 1.0
    else:
        rule, close = ">= 0.999 of pixels", equal >= 0.999
    ok = same and bool(np.isfinite(img).all()) and close
    for r, o in enumerate(outs):
        print(f"[rank {r}] all-reduce of the rank indices {o['rank_sum']} "
              f"render_sharded({c['backend']}) mean {o['image'].mean():.6f}"
              + (f" peak {o['peak_mib']:.1f} MiB" if "peak_mib" in o else ""),
              flush=True)
    print(f"distributed smoke ({args.world} ranks, {backend}, "
          f"{args.device}): frames equal across ranks {same}, pixels "
          f"equal to one process's frame {equal:.6f} (max abs error {err}; "
          f"{rule}), {sec:.1f} s: "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
