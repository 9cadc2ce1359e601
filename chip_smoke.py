#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `rtm_tpu_torch/csrc/` with nvcc
(into `rtm_tpu_torch/_build/`), holds each kernel against its plain
PyTorch version on the card, then drives the port's main path through the
entry points a user calls: scene 3 (Cornell box) at 512x512, 8 bounces,
1 sample per dispatch, progressive accumulation with `backend="auto"`,
which resolves to the mxu kernel.  It also renders the widest scene the
mxu tables take (`dragon_grid`, <= 2047 triangles), the trav path:
`dragon_grid(56)` (62,720 triangles), which auto resolves to the trav
kernel, at the same size, the wavefront2 path (cluster-sweep kernel) on
that scene, the pallas path (intersect kernel) on scene 3, the
differentiable path: `loss_and_grad` through the mxu record replay and
wavefront2, and a few `inverse_render` steps, soft primary visibility on
the pallas route, the megakernel path (scene 3, `dragon_grid(56)` and a
textured `dragon_grid(16)` that auto sends to it), the
`python -m rtm_tpu_torch` command line, the scene editor and the browser
viewer; the native SAH builder and the shader-parity BVH traversal; and
the multi-GPU layer (rtm_tpu_torch/parallel): every kernel per band, and
spawned worlds of one rank over NCCL and of four sharing the card over
gloo (the machine has one card).

Phases (each prints lines starting with its tag, and its seconds):
  [card]    nvidia-smi name and power limit, torch and CUDA versions
  [build]   nvcc build time (all five kernels, built in parallel) and ptxas
            register report; the native SAH builder's g++ build time
  [compare] mxu kernel vs plain version at 64x64, 4 bounces, 1 and 2
            frames: hitrec agreement >= 0.999, max abs error of color /
            miss / rec on the lanes whose hitrec agrees <= 1e-3, and the
            post-passed images within `images_close` (tests/conftest.py)
  [bvh-native] build_tracer_scene(dragon_grid(16)) with the native SAH
            builder and with the NumPy one: the tables bitwise equal, both
            host build seconds
  [bvh-traverse] build_bvh_scene + bounce_ray_bvh on scene 3's primary
            rays at 64x64 against the dense nearest_triangle sweep: hits
            equal, t within 1e-5, indices differing only on t ties
  [trav-build] the [trav] scene's host build (native builder)
  [trav-compare] trav kernel vs plain version, same shapes, on scene 1
            (spheres only), scene 3 forced to trav (textured), and
            dragon_grid(11) and (56): >= 0.999 of lanes agree on color,
            miss and rec within 1e-3, per-1024-slot-tile triangle-test
            counts equal on >= 99% of tiles, images within `images_close`
  [main]    scene 3, 512x512, 8 bounces: 2 warm-up + 32 timed frames of
            render_progressive; ms/frame, cornell_grays_per_s, the kernel's
            and the post-pass's own time, and the launch count
  [profile] torch.profiler over 4 main-path frames: device busy time and
            idle share per frame, device launches, the costliest kernels
            and the PyTorch ops that launched them
  [wide]    dragon_grid at <= 2047 triangles, 512x512, 8 bounces, 8 frames;
            [main] and [wide] print the mxu kernel's time, its bound (the
            largest of the bytes, the tensor-core product and the FP32
            selection and shading terms, from the plain version's alive
            masks and chunk passes) and its dynamic shared memory
  [plain]   the mxu plain version's time for one 512x512 frame of scene 3
  [trav]    dragon_grid(56), 512x512, 8 bounces: 2 warm-up + 16 timed
            frames of render_progressive with backend="auto" (resolves to
            trav); ms/frame, grays_per_s, the host scene build, the
            kernel's time (and at max_bounces=1) and the post-pass's,
            node visits and triangle tests per dispatched ray-bounce, and
            the kernel's bound
  [trav-profile] [profile] for 4 frames of the [trav] path
  [trav-plain] the trav plain version's time for one frame at the [trav]
            shape, and its output held against the kernel's on the same
            inputs by the [trav-compare] criteria; then a [trav] line with
            node visits and triangle tests per live ray-bounce (the rays
            the plain version's descent walks)
  [sweep-compare] the cluster-sweep kernel vs its plain version on the ray
            bands of all 8 bounces (unsorted) of scene 3, dragon_grid(10)
            and dragon_grid(56) at 64x64: the winning row agrees on >= 0.999
            of alive lanes, per-tile cluster passes equal on >= 0.99 of tiles
  [intersect-compare] the intersect kernel vs its plain version on the same
            bands: the winner agrees on >= 0.999 of lanes, per-tile passes
            equal on >= 0.99 of tiles, t within 1e-6 relative where the
            winners agree
  [wf2]     dragon_grid(56), 512x512, 8 bounces, backend="wavefront2": 2
            warm-up + WF2_TIMED frames of render_progressive; ms/frame, sweep
            launches per frame, the sweep kernel's ms per frame by CUDA
            events, its bound and plain time, cluster passes and candidate
            clusters (the prefilter's, `sweep_candidates_plain`) per
            tile-bounce, and the plain version's output on those bands held
            against the kernel's by the [sweep-compare] criteria; per
            bounce, the kernel's ms beside its heaviest tile's alone, and
            the prefilter alone; [wf2-profile] the device idle share; and
            frame 1 at 64x64 against the port's xla path by images_close
  [pallas]  scene 3, 512x512, 8 bounces, backend="pallas": ms/frame, the
            intersect kernel's ms per frame (its 8 launches replayed as a
            CUDA graph: device time; eager through the wrapper beside it),
            launches, bound and plain time,
            and the plain version's output on those rays held against the
            kernel's by the [intersect-compare] criteria; then
            dragon_grid(56) at the size one frame allows in 5 s
  [grad]    loss_and_grad on scene 3 through "mxu" (record replay,
            remat=False) and "wavefront2" (bands=4) at 64x64 against the
            "xla" route (rtol 1e-3, atol 1e-5), then at 512x512, 8 bounces:
            forward-loss ms, fwd+bwd ms, peak device memory, finite grads
  [inverse] inverse_render on scene 3 at 512x512 through "mxu": 5 Adam steps
            from a perturbed wall albedo (albedo only); the loss must fall
  [soft]    render_loss(soft_tau=0.01) through "pallas" (the intersect
            kernel): at 64x64 against "xla" with the same soft_tau by
            [grad]'s tolerances, then loss_and_grad at 512x512, 8
            bounces: forward ms, fwd+bwd ms, peak MiB, finite gradients;
            [soft-profile] one such step under bench/profile.py's trace:
            device busy time, the costliest kernels and ops
  [mega-compare] the megakernel vs its plain version at 64x64, 4 bounces:
            scene 3 (static and nearest-first order), scene 2 (2 frames)
            and dragon_grid(10) (static, nearest-first, cull off): >= 0.999
            of lanes agree on color, miss and rec within 1e-3, the winners
            on >= 0.999 of live lanes, per-tile-bounce cluster passes on
            >= 0.99, images within `images_close`
  [mega]    scene 3, 512x512, 8 bounces, backend="megakernel": 2 warm-up +
            16 timed frames; ms/frame, the kernel's and the post-pass's own
            time, launches, and frame 1 against the mxu path's frame 1 by
            images_close; [mega-profile] the device idle share
  [mega-plain] the plain version at the [mega] shape: its time, its outputs
            held against the kernel's on every lane by the [mega-compare]
            criteria, and the kernel's bound from its work counts
  [mega-big] dragon_grid(56) (768 clusters), backend="megakernel": ms/frame,
            kernel ms, cluster passes and candidates per tile-bounce (as
            [wf2], on the plain version's rays), the heaviest tile's kernel
            ms alone, the plain version's time and agreement and the bound,
            and frame 1 against the trav path's by images_close;
            [mega-big-profile]
  [mega-auto] a textured dragon_grid(16) (5120 textured triangles, beyond
            the mxu and trav tables), backend="auto" resolves to the
            megakernel; ms/frame, kernel ms, cluster passes and candidates
            per tile-bounce, the plain version's time, agreement and bound,
            frame 1 against the wavefront2 path's by images_close;
            [mega-auto-profile]
  [shard-band] render_band in one process, no process group: the bands of
            a 1-, 3- and 4-way split against render_dispatch at 512x512,
            8 bounces: scene 3 on mxu (bitwise at 1 and 4 ranks, whose
            bands are whole 256-slot cull blocks; >= 99.9% of pixels at
            3) and pallas (bitwise), dragon_grid(56) on trav (bitwise),
            the megakernel and wavefront2 (images_close); launches per
            split
  [cli]     `python -m rtm_tpu_torch render --backend megakernel` as a
            subprocess: exit 0 and a PNG
  [editor]  SceneEditor over scene 3 with a ProgressiveRenderer on the card
            (512x512, 8 bounces, auto): 4 frames, then a wall's material,
            a sphere, a 2420-triangle mesh and an instance of it; each
            edit's rebuild seconds, the reset, and the route (mxu, then
            trav)
  [view]    ViewerServer on the card at 512x512 with its render thread
            (auto -> mxu): /frame.png, /state, /input resets, /edit
            changes the frame, the render loop's ms/frame and a PNG
            encode's, a clean stop; then Application + RenderFrame for a
            few iterations
  [shard-nccl] a spawned world of one rank over NCCL (scene 3, 512x512,
            8 bounces): render_sharded(mxu) bitwise render_dispatch,
            sharded_loss_and_grad(mxu) against loss_and_grad(mxu) within
            rtol 3e-4 / atol 2e-6, three make_train_step steps lower the
            loss; ms per sharded frame against render_dispatch, ms per
            gradient all-reduce, peak MiB
  [shard-gloo] the same with four ranks sharing the one card over gloo
            (NCCL refuses two ranks on one GPU), gradients through mxu
            replay and wavefront2, the double-count scale within 0.01 of
            1, the frame and the parameters bitwise equal on every rank
  [total]   the whole run's seconds

The line before the last is the card's `nvidia-smi` name and power limit;
the one before that is the per-kernel JSON record.  The last line is
{"ok": true, "device": {...}} and is printed only when every phase passed.
Exits non-zero, printing no result, without a CUDA device or without the
repository beside this file.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the H100's data-sheet peak rates and the sweeps' operations per pair
# (HBM_BYTES_PER_S, FP32_OPS_PER_S, BF16_TC_FLOP_PER_S, SWEEP_PAIR_OPS,
# STRICT_PAIR_OPS, SLAB_OPS) live in rtm_tpu_torch/bench/profile.py; the
# bound functions import them from there
# one ray-triangle pair of the mxu kernel: on the tensor cores, the
# non-zero products of the table's 16-bit rows (A_hi + A_lo) with the ray's
# three bf16 parts (hi + md + lo) but A_lo . lo, 2 flop each: an edge row
# s1..s3 holds features 0-5 (d, o x d: 6 x 5 products), the tdet row
# features 6-8 (o: 3 x 5) and the constant 1, whose md and lo are 0 (2);
# in FP32 the selection: det's 2 adds, the 3-min chain, the sign test and
# the running min
PAIR_MMA_FLOP = 2 * (3 * 6 * 5 + 3 * 5 + 2)
PAIR_SELECT_OPS = 2 + 3 + 1 + 1
# FP32 operations of one trav node visit (slab test: 6 subtractions, 6
# multiplies, 10 min/max, 3 compares) and one triangle test (edge cross
# product 9, det 6, tdet 5, second cross product 9, u 5, v 6, w 2, the
# ao subtractions 3, the min-chain gate 5, max + division 2, compares 2),
# csrc/trav_trace.cu trav_nearest
NODE_OPS = 25
TRI_OPS = 54
TRAV_GRID = 56               # dragon_grid(56): 62,720 triangles
TRAV_COMPARE_GRIDS = (11, TRAV_GRID)
TRAV_WARM, TRAV_TIMED = 2, 16
TILE = 1024                  # rtm_tpu's ray tile: the stats granule
TILE_AGREE_MIN = 0.99
WF2_TIMED = 8
# FP32 / INT32 operations per alive ray-bounce of the megakernel outside its
# sweep: one sphere test per padded sphere (csrc/bounce_common.cuh
# sphere_nearest: 3 subtractions, a 5, b 6, c 7, delta 4, sqrt, division,
# 3 compares) and the shading tail (csrc/mega_trace.cu: exact t 12, hit
# point 6, material mix 36, sphere normal 10, uv 45, records and
# contribution 20) with the scatter and its PCG draws (scatter_step ~170)
SPHERE_OPS = 30
SHADE_OPS = 300
MEGA_WARM, MEGA_TIMED = 2, 16
MEGA_BIG_TIMED = 8
MEGA_AUTO_GRID = 16          # textured dragon_grid(16): 5120 triangles
MEGA_IMAGE_BOUND = "images_close: mean diff <= 5e-3, <= 1% of pixels off " \
    "by > 2e-2, <= 0.3% by > 0.2"
PALLAS_TIMED = 4
PALLAS_BUDGET_S = 5.0        # one dragon_grid(56) pallas frame at most
GRAD_RES = 64                # route-vs-route gradient check
INVERSE_STEPS = 5
BVH_NATIVE_GRID = 16         # dragon_grid(16): 5120 triangles
BVH_TRAVERSE_RES = 64
SOFT_TAU = 0.01
EDIT_GRID = 11               # dragon_grid(11)'s soup: 2420 triangles
VIEW_WAIT_S = 120.0
APP_ITERATIONS = 3

# the sharded phases: band splits in one process, then spawned worlds
SHARD_WORLDS = (1, 3, 4)
SHARD_GLOO_WORLD = 4
SHARD_REPS = 5
SHARD_TRAIN_STEPS = 3
SHARD_RTOL, SHARD_ATOL = 3e-4, 2e-6   # rtm_tpu's sharded-gradient bound
SHARD_TIMEOUT_S = 240.0

MAIN_RES = 512
MAIN_BOUNCES = 8
COMPARE_RES = 64
COMPARE_BOUNCES = 4
AGREE_MIN = 0.999
MAX_ABS_ERR = 1e-3


def images_close(a, b, tol=2e-2, frac_bad=0.01, outlier_frac=0.003,
                 mean_tol=5e-3):
    """tests/conftest.py images_close, returning a failure message or None:
    mean abs diff <= mean_tol, <= frac_bad pixels beyond tol, <=
    outlier_frac pixels beyond 0.2."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return f"shape {a.shape} != {b.shape}"
    diff = np.abs(a - b).max(axis=-1)
    if diff.mean() > mean_tol:
        return f"mean diff {diff.mean():.5f} > {mean_tol}"
    if np.mean(diff > tol) > frac_bad:
        return f"{np.mean(diff > tol) * 100:.2f}% pixels differ > {tol}"
    if np.mean(diff > 0.2) > outlier_frac:
        return f"{np.mean(diff > 0.2) * 100:.2f}% catastrophic outliers"
    return None


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Smoke:
    def __init__(self):
        self.failures: list[str] = []

    def check(self, ok: bool, what: str):
        if not ok:
            self.failures.append(what)
            print(f"FAIL {what}", flush=True)

    @contextmanager
    def phase(self, tag: str):
        t0 = time.perf_counter()
        yield
        print(f"[{tag}] phase_s={time.perf_counter() - t0:.2f}", flush=True)


def mxu_bound(scene, cfg, n: int):
    """(bound_ms, bound_by, term) of one timed mxu_trace call (no hitrec
    output) on Camera().spec's rays at frame index 1: the largest of each
    input read once and each output written once at the HBM rate, the
    pair products at the bf16 tensor-core rate, and the pair selections,
    sphere tests and shading at the FP32 rate.  A pair is an (alive
    ray-bounce, real triangle of a chunk the ray's BLOCK-slot block
    passed); the alive masks and passes are the plain version's MxuStats
    on the same inputs.  Dead rays feed no output the path reads."""
    from rtm_tpu_torch.bench.profile import (HBM_BYTES_PER_S, FP32_OPS_PER_S,
                                             BF16_TC_FLOP_PER_S)
    import torch
    from rtm_tpu_torch import Camera
    from rtm_tpu_torch.ops.kernels.megakernel import _pack_camera
    from rtm_tpu_torch.ops.kernels.mxu_kernel import (BLOCK, CHUNK,
                                                      mxu_trace_plain,
                                                      side_tables)

    ma, mm = scene.mxu_arrays, scene.mxu_meta
    tabs = side_tables(scene)
    camf = _pack_camera(Camera().spec(cfg.width, cfg.height), scene.device)
    stats = mxu_trace_plain(scene, tabs, camf, 1, 0, n, cfg,
                            with_stats=True)[4]
    in_bytes = 64 * 4 + sum(t.numel() * t.element_size() for t in (
        ma.pair, ma.attr, ma.info, ma.cbox, *tabs) if t is not None)
    out_rows = 3 + 8 * cfg.max_frames + (
        8 * cfg.max_frames * cfg.max_bounces if scene.any_textured else 0)
    t_bytes = (in_bytes + out_rows * n * 4) / HBM_BYTES_PER_S * 1e3
    fb, blocks, nc = stats.passed.shape
    alive = torch.nn.functional.pad(stats.alive.double(),
                                    (0, blocks * BLOCK - n))
    alive_block = alive.view(fb, blocks, BLOCK).sum(dim=2)   # (FB, blocks)
    real = (mm.n_tris - CHUNK * torch.arange(nc, device=alive.device)
            ).clamp(0, CHUNK).double()
    pairs = float((alive_block * (stats.passed.double() @ real)).sum())
    live = float(alive.sum())
    s_pad = tabs.sph.shape[1] if scene.num_spheres else 0
    t_mma = pairs * PAIR_MMA_FLOP / BF16_TC_FLOP_PER_S * 1e3
    t_fp32 = (pairs * PAIR_SELECT_OPS + live * (s_pad * SPHERE_OPS
                                                + SHADE_OPS)) \
        / FP32_OPS_PER_S * 1e3
    terms = {"bytes": t_bytes, "tensor-core product": t_mma,
             "fp32 selection and shading": t_fp32}
    term = max(terms, key=terms.get)
    return terms[term], ("bytes" if term == "bytes" else "operations"), \
        f"{term}; pairs={pairs:.0f} live_ray_bounces={live:.0f} " + \
        " ".join(f"{k.split()[0]}_ms={v:.5f}" for k, v in terms.items())


def mxu_smem_bytes(scene) -> int:
    """The mxu kernel's dynamic shared memory per block on this scene, as
    its launch sets it (csrc/mxu_trace.cu mxu_trace_smem_bytes)."""
    from rtm_tpu_torch.ops.kernels.build import load_kernel_library

    mm = scene.mxu_meta
    return int(load_kernel_library("mxu_trace").mxu_trace_smem_bytes(
        mm.n_tris, mm.nc))


def trav_bound(scene, cfg, stats, n: int):
    """(bound_ms, bound_by) of one timed trav_trace call (no stats
    output): each input read once and each output written once at the HBM
    rate, against the node visits and triangle tests this run's rays
    needed (`stats`, from an untimed call on the same inputs) at the FP32
    rate."""
    from rtm_tpu_torch.bench.profile import HBM_BYTES_PER_S, FP32_OPS_PER_S
    from rtm_tpu_torch.ops.kernels.trav_kernel import trav_side_tables

    ta = scene.trav_arrays
    in_bytes = 64 * 4 + sum(t.numel() * t.element_size() for t in (
        ta.node, ta.tri_feat, ta.tri_info, *trav_side_tables(scene))
        if t is not None)
    out_rows = 3 + 8 * cfg.max_frames + (
        8 * cfg.max_frames * cfg.max_bounces if scene.any_textured else 0)
    t_bytes = (in_bytes + out_rows * n * 4) / HBM_BYTES_PER_S * 1e3
    ops = (int(stats[0].sum()) * NODE_OPS + int(stats[1].sum()) * TRI_OPS)
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_compare(sm: Smoke, scenes):
    """Kernel vs plain version on the card; returns the max abs error."""
    import torch
    from rtm_tpu_torch import Camera, RenderConfig, build_tracer_scene
    from rtm_tpu_torch.ops.kernels.megakernel import (_pack_camera,
                                                      mega_postpass,
                                                      slots_to_image)
    from rtm_tpu_torch.ops.kernels.mxu_kernel import (mxu_trace,
                                                      mxu_trace_plain,
                                                      side_tables)

    res = COMPARE_RES
    n = res * res
    worst = 0.0
    for name, host in scenes:
        scene = build_tracer_scene(host)
        tabs = side_tables(scene)
        for frames, fi in ((1, 1), (2, 3)):
            cfg = RenderConfig(width=res, height=res,
                               max_bounces=COMPARE_BOUNCES,
                               max_frames=frames, draw_environment=True)
            camf = _pack_camera(Camera().spec(res, res), scene.device)
            k = mxu_trace(scene, tabs, camf, fi, 0, n, cfg,
                          return_hitrec=True)
            p = mxu_trace_plain(scene, tabs, camf, fi, 0, n, cfg,
                                return_hitrec=True)
            torch.cuda.synchronize()
            same = k[3] == p[3]
            agree = float(same.float().mean())
            lanes = same.all(dim=0)
            err = 0.0
            for a, b in zip(k[:3], p[:3]):
                if a is not None:
                    err = max(err, float((a - b)[:, lanes].abs().max()))
            imgs = [slots_to_image(mega_postpass(o[0].T, o[1], o[2], scene,
                                                 cfg, n), res, res).cpu()
                    for o in (k, p)]
            msg = images_close(imgs[0].numpy(), imgs[1].numpy())
            finite = bool(torch.isfinite(imgs[0]).all())
            print(f"[compare] {name} tris={scene.num_triangles} "
                  f"frames={frames} hitrec_agree={agree:.6f} "
                  f"lanes_agree={float(lanes.float().mean()):.6f} "
                  f"max_abs_err={err:.3e} images_close="
                  f"{'ok' if msg is None else msg}", flush=True)
            sm.check(agree >= AGREE_MIN, f"{name} f{frames} hitrec agree "
                     f"{agree} < {AGREE_MIN}")
            sm.check(err <= MAX_ABS_ERR, f"{name} f{frames} max abs err "
                     f"{err} > {MAX_ABS_ERR}")
            sm.check(msg is None and finite,
                     f"{name} f{frames} images: {msg}, finite={finite}")
            worst = max(worst, err)
    return worst


def trav_agreement(sm: Smoke, label: str, scene, cfg, k, p) -> float:
    """Check one trav_trace output `k` against trav_trace_plain's `p` (both
    with stats, same inputs): >= AGREE_MIN of lanes agree on color, miss
    and rec within MAX_ABS_ERR, the per-tile sums of triangle tests are
    equal on >= TILE_AGREE_MIN of tiles, and the post-passed images pass
    images_close and are finite.  Returns the max abs error over the lanes
    whose node-visit and triangle-test counts are equal (the lanes that
    took the same traversal in both)."""
    import torch
    from rtm_tpu_torch.ops.kernels.megakernel import (mega_postpass,
                                                      slots_to_image)

    n = cfg.width * cfg.height
    tm = scene.trav_meta
    diff = torch.zeros(n, device=k[0].device)
    for a, b in zip(k[:3], p[:3]):
        if a is not None:
            diff = torch.maximum(diff, (a - b).abs().amax(dim=0))
    lanes = float((diff <= MAX_ABS_ERR).float().mean())
    same_path = (k[3] == p[3]).all(dim=0)
    err = float(diff[same_path].max()) if same_path.any() else 0.0
    tiles = (k[3][1].view(-1, TILE).sum(1) == p[3][1].view(-1, TILE).sum(1))
    tile_agree = float(tiles.float().mean())
    imgs = [slots_to_image(mega_postpass(o[0].T, o[1], o[2], scene, cfg, n),
                           cfg.width, cfg.height).cpu() for o in (k, p)]
    msg = images_close(imgs[0].numpy(), imgs[1].numpy())
    finite = bool(torch.isfinite(imgs[0]).all())
    print(f"{label} tris={scene.num_triangles} nodes={tm.n_nodes} "
          f"leaves={tm.n_leaves} leaf_k={tm.leaf_k} {cfg.width}x"
          f"{cfg.height} bounces={cfg.max_bounces} frames={cfg.max_frames} "
          f"lanes_agree={lanes:.6f} "
          f"same_path={float(same_path.float().mean()):.6f} "
          f"tile_tests_equal={tile_agree:.4f} "
          f"max_abs_err_same_path={err:.3e} images_close="
          f"{'ok' if msg is None else msg}", flush=True)
    what = f"{label} f{cfg.max_frames}"
    sm.check(lanes >= AGREE_MIN, f"{what} lanes agree {lanes} < {AGREE_MIN}")
    sm.check(tile_agree >= TILE_AGREE_MIN,
             f"{what} tile test counts agree {tile_agree}")
    sm.check(msg is None and finite, f"{what} images: {msg}, finite={finite}")
    return err


def phase_trav_compare(sm: Smoke, scenes):
    """trav kernel vs plain version on the card (trav_agreement), on (name,
    host Scene or built TracerScene) pairs.  Returns the max abs error."""
    import torch
    from rtm_tpu_torch import (Camera, RenderConfig, TracerScene,
                               build_tracer_scene)
    from rtm_tpu_torch.ops.kernels.megakernel import _pack_camera
    from rtm_tpu_torch.ops.kernels.trav_kernel import (trav_side_tables,
                                                       trav_trace,
                                                       trav_trace_plain)

    res = COMPARE_RES
    n = res * res
    worst = 0.0
    for name, host in scenes:
        scene = (host if isinstance(host, TracerScene)
                 else build_tracer_scene(host))
        sm.check(scene.trav_meta.supported,
                 f"trav {name} beyond the trav tables")
        tabs = trav_side_tables(scene)
        for frames, fi in ((1, 1), (2, 3)):
            cfg = RenderConfig(width=res, height=res,
                               max_bounces=COMPARE_BOUNCES,
                               max_frames=frames, draw_environment=True)
            camf = _pack_camera(Camera().spec(res, res), scene.device)
            k = trav_trace(scene, tabs, camf, fi, 0, n, cfg,
                           with_stats=True)
            p = trav_trace_plain(scene, tabs, camf, fi, 0, n, cfg,
                                 with_stats=True)
            torch.cuda.synchronize()
            worst = max(worst, trav_agreement(
                sm, f"[trav-compare] {name}", scene, cfg, k, p))
    return worst


def trav_kernel_and_postpass_ms(scene, cfg, reps: int):
    """Device time of one trav_trace launch at the [trav] shape and at one
    bounce, and of one post-pass, plus an untimed launch with stats on the
    same inputs (for the bound and the [trav-plain] comparison).  Returns
    (kernel ms, kernel ms at max_bounces=1, post-pass ms, that launch's
    outputs, its camera row)."""
    from rtm_tpu_torch import Camera
    from rtm_tpu_torch.ops.kernels.megakernel import (_pack_camera,
                                                      mega_postpass)
    from rtm_tpu_torch.ops.kernels.trav_kernel import (trav_side_tables,
                                                       trav_trace)

    n = cfg.width * cfg.height
    camf = _pack_camera(Camera().spec(cfg.width, cfg.height), scene.device)
    tabs = trav_side_tables(scene)
    k_ms = cuda_ms(lambda: trav_trace(scene, tabs, camf, 1, 0, n, cfg), reps)
    one = dataclasses.replace(cfg, max_bounces=1)
    k1_ms = cuda_ms(lambda: trav_trace(scene, tabs, camf, 1, 0, n, one), reps)
    out = trav_trace(scene, tabs, camf, 1, 0, n, cfg, with_stats=True)
    p_ms = cuda_ms(lambda: mega_postpass(out[0].T, out[1], out[2], scene,
                                         cfg, n), reps)
    return k_ms, k1_ms, p_ms, out, camf


def phase_trav_plain(sm: Smoke, scene, cfg, k_out, camf):
    """The trav plain version at the [trav] shape: one frame (frame index
    1, same camera row as `k_out`, the kernel's launch with stats), timed
    by CUDA events, then held against `k_out` by trav_agreement.  Returns
    (plain ms, max abs error, live ray-bounces): the ray-bounces that
    walked the tree, from the alive masks the plain version hands its
    descent (`trav_nearest_plain`'s `active`)."""
    import torch
    from rtm_tpu_torch.ops.kernels import trav_kernel as ttk

    tabs = ttk.trav_side_tables(scene)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with recording(ttk, "trav_nearest_plain") as calls:
        torch.cuda.synchronize()
        start.record()
        p = ttk.trav_trace_plain(scene, tabs, camf, 1, 0,
                                 cfg.width * cfg.height, cfg,
                                 with_stats=True)
        end.record()
        torch.cuda.synchronize()
    live = sum(int(c[9].sum()) for c in calls)
    err = trav_agreement(sm, "[trav-plain]", scene, cfg, k_out, p)
    return start.elapsed_time(end), err, live


def build_scene(host_scene):
    """build_tracer_scene on the card; returns (scene, host seconds)."""
    import torch
    from rtm_tpu_torch import build_tracer_scene

    t0 = time.perf_counter()
    scene = build_tracer_scene(host_scene)
    torch.cuda.synchronize()
    return scene, time.perf_counter() - t0


def drive(sm: Smoke, tag: str, scene, build_s: float, frames_warm: int,
          frames_timed: int, backend_expected: str = "mxu",
          backend: str = "auto"):
    """Drive a path through the user entry points (render_progressive on a
    scene from build_tracer_scene, built in build_s host seconds; `backend`
    must route to `backend_expected`); every launch count is set to 0
    just before the frames and read just after.  The fused kernels
    launch once per frame, the sweep kernels once per bounce.  Returns
    (cfg, image, ms/frame, launches of the expected kernel)."""
    import torch
    from rtm_tpu_torch import Camera, RenderConfig, render_progressive
    from rtm_tpu_torch.ops.kernels import kernel_wrappers
    from rtm_tpu_torch.ops.trace_ref import resolve_route

    kernels = kernel_wrappers()
    cfg = RenderConfig(width=MAIN_RES, height=MAIN_RES,
                       max_bounces=MAIN_BOUNCES, max_frames=1,
                       draw_environment=True, accumulate=True)
    cam = Camera().spec(cfg.width, cfg.height)
    resolved = resolve_route(scene, cfg, backend)
    sm.check(scene.device.type == "cuda", f"{tag} scene not on the card")
    sm.check(resolved == backend_expected,
             f"{tag} {backend} resolved to {resolved}, not "
             f"{backend_expected}")
    per_frame = (1 if backend_expected in ("mxu", "trav", "megakernel")
                 else cfg.max_bounces)

    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    if frames_warm:
        render_progressive(scene, cam, cfg, frames_warm, backend=backend)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    img = render_progressive(scene, cam, cfg, frames_timed, backend=backend)
    end.record()
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in kernels.items()}
    launches = counts[backend_expected]
    ms = start.elapsed_time(end) / frames_timed
    dispatched = (frames_warm + frames_timed) * per_frame
    grays = cfg.width * cfg.height * cfg.max_frames * cfg.max_bounces \
        / (ms * 1e-3) / 1e9
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    metric = ("cornell_grays_per_s" if backend_expected == "mxu"
              else "grays_per_s")
    print(f"[{tag}] backend={resolved} tris={scene.num_triangles} "
          f"{cfg.width}x{cfg.height} bounces={cfg.max_bounces} "
          f"frames={dispatched} ms/frame={ms:.4f} "
          f"{metric}={grays:.6f} launches={counts} "
          f"scene_build_s={build_s:.3f} "
          f"image_mean={mean:.6f} finite={finite}", flush=True)
    sm.check(launches == dispatched, f"{tag} launches {launches} != "
             f"{per_frame} per frame dispatched ({dispatched})")
    sm.check(sum(counts.values()) == launches,
             f"{tag} other kernels launched: {counts}")
    sm.check(finite and mean > 0.0, f"{tag} image finite={finite} "
             f"mean={mean}")
    return cfg, img, ms, launches


def kernel_and_postpass_ms(scene, cfg, reps: int):
    """Device time of one mxu_trace launch (side tables built once, so the
    launches queue back to back) and of one post-pass at the main path's
    shape."""
    from rtm_tpu_torch import Camera
    from rtm_tpu_torch.ops.kernels.megakernel import (_pack_camera,
                                                      mega_postpass)
    from rtm_tpu_torch.ops.kernels.mxu_kernel import mxu_trace, side_tables

    n = cfg.width * cfg.height
    camf = _pack_camera(Camera().spec(cfg.width, cfg.height), scene.device)
    tabs = side_tables(scene)
    k_ms = cuda_ms(lambda: mxu_trace(scene, tabs, camf, 1, 0, n, cfg), reps)
    color, miss, rec, _ = mxu_trace(scene, tabs, camf, 1, 0, n, cfg)
    p_ms = cuda_ms(lambda: mega_postpass(color.T, miss, rec, scene, cfg, n),
                   reps)
    return k_ms, p_ms


def phase_profile(scene, cfg, frames: int, frame_ms: float,
                  tag: str = "profile", backend: str = "auto"):
    """Where a path's frame time goes: torch.profiler over `frames`
    frames of render_progressive, reported by report_profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rtm_tpu_torch import Camera, render_progressive

    cam = Camera().spec(cfg.width, cfg.height)
    render_progressive(scene, cam, cfg, 1, backend=backend)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        render_progressive(scene, cam, cfg, frames, backend=backend)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, tag, frames, wall_ms, frame_ms)


def report_profile(prof, tag: str, n: int, wall_ms: float, ref_ms: float,
                   unit: str = "frame"):
    """Print, per `unit` (n of them in the profiled window): the wall time
    (with the profiler on), the device's busy time (union of the device
    events' intervals), the idle share against the profiled wall time and
    against `ref_ms` (the same work timed without the profiler), the
    device launches, the kernels that take the most device time, and the
    PyTorch ops (with their input shapes) that launched them."""
    from torch.autograd import DeviceType

    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda x: x[0])
    if not dev:
        print(f"[{tag}] device time not measured: the profiler saw no "
              "device events", flush=True)
        return
    busy_us, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name: dict[str, list] = {}
    for s, e, name in dev:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
    busy_ms = busy_us / 1e3 / n
    print(f"[{tag}] {unit}s={n} wall_ms/{unit}={wall_ms / n:.4f} "
          f"device_busy_ms/{unit}={busy_ms:.4f} idle_share="
          f"{1.0 - busy_ms / (wall_ms / n):.4f} "
          f"idle_share_unprofiled={1.0 - busy_ms / ref_ms:.4f} "
          f"device_launches/{unit}={len(dev) / n:.1f}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, cnt) in top:
        print(f"[{tag}]   {us / 1e3 / n:9.4f} ms/{unit}  "
              f"{cnt / n:6.1f}/{unit}  {name[:90]}", flush=True)

    def self_dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and self_dev_us(e) > 0.0]
    for e in sorted(ops, key=lambda e: -self_dev_us(e))[:8]:
        print(f"[{tag}]   op {self_dev_us(e) / 1e3 / n:9.4f} ms/{unit}"
              f"  {e.count / n:6.1f}/{unit}  {e.key}  "
              f"{str(e.input_shapes)[:100]}", flush=True)


@contextmanager
def recording(module, name: str):
    """Replace `module.name` by a wrapper that records each call's
    positional arguments (the inputs a path hands a kernel, for the
    comparisons to replay); the original is restored on exit."""
    orig = getattr(module, name)
    calls = []

    def record(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def record_bands(scene, res: int, bounces: int, sort_from: int = 99):
    """The (8, Np) ray bands the wavefront2 path hands the cluster sweep in
    frame 1 of a res x res dispatch (unsorted by default)."""
    import torch
    from rtm_tpu_torch import Camera, RenderConfig
    from rtm_tpu_torch.ops import wavefront2 as wf2

    cfg = RenderConfig(width=res, height=res, max_bounces=bounces,
                       draw_environment=True)
    with torch.no_grad(), recording(wf2, "sweep_call") as calls:
        wf2.render_rays_wavefront2(scene, Camera().spec(res, res), 1, cfg,
                                   pixel_offset=0, n_rays=res * res,
                                   sort_from=sort_from)
    return [c[1] for c in calls]


def sweep_agreement(state8, k, p):
    """Kernel outputs k = (t, row, passes) against the plain version's p on
    one band: (winning row agreement on alive lanes, share of tiles with
    equal passes, max abs t error on the hit lanes whose rows agree)."""
    t, i, passes = k
    pt, pi, pp = p[:3]
    alive = state8[6] > 0.5
    agree = float((i == pi)[alive].float().mean()) if alive.any() else 1.0
    tiles = float((passes == pp).float().mean())
    same = (i == pi) & (i >= 0)
    err = float((t - pt)[same].abs().max()) if same.any() else 0.0
    return agree, tiles, err


def intersect_agreement(k, p):
    """Kernel outputs k = (t, idx, passes) against the plain version's p:
    (winner agreement on all lanes, share of tiles with equal passes, max
    relative and max abs t error on the hit lanes whose winners agree)."""
    import torch

    t, i, passes = k
    pt, pi, pp = p[:3]
    agree = float((i == pi).float().mean())
    tiles = float((passes == pp).float().mean())
    same = (i == pi) & (i >= 0)
    if not same.any():
        return agree, tiles, 0.0, 0.0
    d = (t - pt)[same].abs()
    rel = torch.where(d > 0, d / pt[same].abs(), 0.0)   # t = 0 hits: 0 / 0
    return agree, tiles, float(rel.max()), float(d.max())


def check_sweep(sm: Smoke, tag: str, what: str, agree, tiles):
    sm.check(agree >= AGREE_MIN, f"{tag} {what} alive-lane agreement {agree}")
    sm.check(tiles >= TILE_AGREE_MIN, f"{tag} {what} tile passes {tiles}")


def check_intersect(sm: Smoke, tag: str, what: str, agree, tiles, rel):
    sm.check(agree >= AGREE_MIN, f"{tag} {what} agreement {agree}")
    sm.check(tiles >= TILE_AGREE_MIN, f"{tag} {what} tile passes {tiles}")
    sm.check(rel <= 1e-6, f"{tag} {what} t rel err {rel}")


def sweep_plain(pack, state8):
    """The cluster sweep's plain version on one band, with the clusters each
    tile passed."""
    from rtm_tpu_torch.ops.kernels.sweep_kernel import cluster_sweep_plain

    return cluster_sweep_plain(pack.tri_feats, pack.boxes,
                               pack.cluster_offsets, pack.cluster_widths,
                               state8, with_passed=True)


def candidates_per_tile(pack, bands) -> float:
    """Mean candidate clusters per tile over `bands` (sweep_kernel.py
    `sweep_candidates_plain`): the clusters the kernels' serial walk still
    visits after the prefilter."""
    from rtm_tpu_torch.ops.kernels.sweep_kernel import sweep_candidates_plain

    cand = [sweep_candidates_plain(pack, b) for b in bands]
    return (sum(int(c.sum()) for c in cand)
            / sum(c.shape[0] for c in cand))


def phase_sweep_compare(sm: Smoke, scenes):
    """Cluster-sweep kernel vs plain version on every band of (name, scene,
    bands); returns the max abs t error on the lanes whose rows agree."""
    import torch
    from rtm_tpu_torch.ops.kernels.megakernel import build_mega_pack
    from rtm_tpu_torch.ops.kernels.sweep_kernel import cluster_sweep

    worst = 0.0
    for name, scene, bands in scenes:
        pack = build_mega_pack(scene)
        agree, tiles, err = 1.0, 1.0, 0.0
        for state8 in bands:
            k = cluster_sweep(pack, state8)
            p = sweep_plain(pack, state8)
            torch.cuda.synchronize()
            a, tl, e = sweep_agreement(state8, k, p)
            agree, tiles, err = min(agree, a), min(tiles, tl), max(err, e)
        print(f"[sweep-compare] {name} tris={scene.num_triangles} "
              f"clusters={pack.n_clusters} bands={len(bands)} "
              f"min_alive_agree={agree:.6f} min_tile_passes_equal="
              f"{tiles:.4f} max_abs_err={err:.3e}", flush=True)
        check_sweep(sm, "sweep-compare", name, agree, tiles)
        worst = max(worst, err)
    return worst


def intersect_tables(scene):
    """(feats, boxes, n_clusters) of the intersect kernel for a scene (its
    real rows: scene.num_triangles)."""
    import torch
    from rtm_tpu_torch.ops.kernels.intersect_kernel import (
        pack_triangle_features)

    feats, lo, hi, nc = pack_triangle_features(scene.tri_wa, scene.tri_wb,
                                               scene.tri_wc)
    boxes = torch.cat([lo.T, hi.T, torch.zeros((2, nc), device=lo.device)])
    return feats, boxes.contiguous(), nc


def intersect_pair(rays, feats, boxes, nc, n_tris):
    """(kernel outputs, plain outputs with the clusters each tile passed) of
    the intersect sweep on one set of ray rows, the kernel given the real
    row count as the pallas path gives it.  The plain version tests every
    row, padding included."""
    from rtm_tpu_torch.ops.kernels.intersect_kernel import (
        intersect_sweep, intersect_sweep_plain)

    return (intersect_sweep(rays, feats, boxes, nc, return_passes=True,
                            n_tris=n_tris),
            intersect_sweep_plain(rays, feats, boxes, nc, return_passes=True,
                                  with_passed=True))


def phase_intersect_compare(sm: Smoke, scenes):
    """Intersect kernel vs plain version on the same bands; returns the max
    abs t error on the lanes whose winners agree."""
    import torch
    from rtm_tpu_torch.ops.kernels.intersect_kernel import pack_rays

    worst = 0.0
    for name, scene, bands in scenes:
        feats, boxes, nc = intersect_tables(scene)
        agree, tiles, rel, err = 1.0, 1.0, 0.0, 0.0
        for state8 in bands:
            rays = pack_rays(state8[0:3].T, state8[3:6].T)
            k, p = intersect_pair(rays, feats, boxes, nc,
                                  scene.num_triangles)
            torch.cuda.synchronize()
            a, tl, r, e = intersect_agreement(k, p)
            agree, tiles = min(agree, a), min(tiles, tl)
            rel, err = max(rel, r), max(err, e)
        print(f"[intersect-compare] {name} tris={scene.num_triangles} "
              f"clusters={nc} bands={len(bands)} min_agree={agree:.6f} "
              f"min_tile_passes_equal={tiles:.4f} max_rel_err={rel:.3e} "
              f"max_abs_err={err:.3e}", flush=True)
        check_intersect(sm, "intersect-compare", name, agree, tiles, rel)
        worst = max(worst, err)
    return worst


def real_rows(pack):
    """(C,) f64: the real (non-padding) triangle rows of each cluster."""
    import torch

    cluster_of_row = torch.repeat_interleave(
        torch.arange(pack.n_clusters, device=pack.boxes.device),
        pack.widths_dev.long())
    return torch.zeros(pack.n_clusters, dtype=torch.float64,
                       device=pack.boxes.device).index_add_(
        0, cluster_of_row, (pack.padded_to_real >= 0).double())


def sweep_bound(pack, bands, passed):
    """(bound_ms, bound_by) of the cluster sweep over `bands` (one frame):
    each launch reads the tables and its band once and writes t, the row
    and the tile counts once, at the HBM rate; against the work this run's
    data needs at the FP32 rate: one slab test per (alive ray, cluster) and
    one pair test per (alive ray, real triangle row) of each cluster its
    tile passed (`passed`: the plain version's (tiles, C) pass matrices).
    Dead rays and padding rows feed no output the path reads."""
    from rtm_tpu_torch.bench.profile import (HBM_BYTES_PER_S, FP32_OPS_PER_S,
                                             SWEEP_PAIR_OPS, SLAB_OPS)
    tab_bytes = sum(x.numel() * x.element_size() for x in (
        pack.tri_feats, pack.boxes, pack.offsets_dev, pack.widths_dev))
    rows = real_rows(pack)
    byts = ops = 0.0
    for state8, pm in zip(bands, passed):
        n, tiles = state8.shape[1], pm.shape[0]
        alive = (state8[6] > 0.5).reshape(tiles, -1).sum(dim=1).double()
        byts += tab_bytes + state8.numel() * 4 + n * 8 + tiles * 4
        ops += (float((alive * (pm.double() @ rows)).sum())
                * SWEEP_PAIR_OPS
                + float(alive.sum()) * pack.n_clusters * SLAB_OPS)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def intersect_bound(feats, boxes, nc, n_tris, rays, passed):
    """(bound_ms, bound_by) of the intersect kernel over one frame's ray
    rows: inputs read once and outputs written once at the HBM rate,
    against one slab test per (ray, cluster) and one pair test per (ray,
    real triangle) of each cluster its tile passed (`passed`: the plain
    version's (tiles, C) pass matrices; a cluster's last rows may be
    padding), at the FP32 rate.  The kernel has no alive mask: every ray's
    winner is an output."""
    from rtm_tpu_torch.bench.profile import (HBM_BYTES_PER_S, FP32_OPS_PER_S,
                                             STRICT_PAIR_OPS, SLAB_OPS)
    import torch

    real = (n_tris - 128 * torch.arange(nc, device=feats.device)).clamp(
        0, 128).double()
    byts = ops = 0.0
    for r, pm in zip(rays, passed):
        n, tiles = r.shape[0], pm.shape[0]
        byts += (r.numel() + feats.numel() + boxes.numel()) * 4 + n * 8
        ops += (float((pm.double() @ real).sum()) * (n // tiles)
                * STRICT_PAIR_OPS + n * nc * SLAB_OPS)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sweep_breakdown(pack, bands, k_outs):
    """Where the cluster sweep's time goes on one frame's bands: each band's
    kernel ms, its heaviest tile's passes and that tile's kernel ms alone
    (its slots as a one-tile band: a tile's passes run one after another in
    one thread block, so the heaviest tile bounds its band), and the
    prefilter alone (band 0's rays, all alive, moved out of the scene
    and heading away: no candidate, no pass)."""
    from rtm_tpu_torch.ops.kernels.megakernel import DEFAULT_RAY_TILE
    from rtm_tpu_torch.ops.kernels.sweep_kernel import cluster_sweep

    r = DEFAULT_RAY_TILE
    band_ms, tile_ms, tile_passes = [], [], []
    for b, k in zip(bands, k_outs):
        heavy = int(k[2].argmax())
        one = b[:, heavy * r:(heavy + 1) * r].contiguous()
        band_ms.append(cuda_ms(lambda: cluster_sweep(pack, b), 3))
        tile_ms.append(cuda_ms(lambda: cluster_sweep(pack, one), 3))
        tile_passes.append(int(k[2][heavy]))
    away = bands[0].clone()
    away[0:3] += 1e4
    away[3:6] = away[3:6].abs()
    away[6] = 1.0
    prefilter_ms = cuda_ms(lambda: cluster_sweep(pack, away), 3)
    return band_ms, tile_ms, tile_passes, prefilter_ms


def phase_wf2(sm: Smoke, scene, build_s: float):
    """The wavefront2 path on the [trav] scene: drive, then the sweep
    kernel alone on one frame's bands (sorted as the path sorts them), its
    plain version on the same bands, held against it by the
    [sweep-compare] criteria, and the bound.  Returns (cfg, ms/frame,
    launches, kernel ms, plain ms, bound ms, bound by, max abs error)."""
    import torch
    from rtm_tpu_torch.ops.kernels.megakernel import build_mega_pack
    from rtm_tpu_torch.ops.kernels.sweep_kernel import cluster_sweep

    cfg, _, ms, launches = drive(sm, "wf2", scene, build_s, 2, WF2_TIMED,
                                 backend_expected="wavefront2",
                                 backend="wavefront2")
    pack = build_mega_pack(scene)
    bands = record_bands(scene, cfg.width, cfg.max_bounces, sort_from=1)
    k_ms = cuda_ms(lambda: [cluster_sweep(pack, b) for b in bands], 5)
    k_outs = [cluster_sweep(pack, b) for b in bands]
    p_outs = []
    plain_ms = cuda_ms(lambda: p_outs.extend(sweep_plain(pack, b)
                                             for b in bands), 1, warm=0)
    agree, tiles, err = 1.0, 1.0, 0.0
    for state8, k, p in zip(bands, k_outs, p_outs):
        a, tl, e = sweep_agreement(state8, k, p)
        agree, tiles, err = min(agree, a), min(tiles, tl), max(err, e)
    bound_ms, bound_by = sweep_bound(pack, bands, [p[3] for p in p_outs])
    passes = torch.stack([k[2] for k in k_outs]).float()
    alive = sum(int((b[6] > 0.5).sum()) for b in bands)
    print(f"[wf2] clusters={pack.n_clusters} sweep_launches/frame="
          f"{len(bands)} sweep_kernel_ms/frame={k_ms:.4f} "
          f"plain_ms/frame={plain_ms:.3f} bound_ms={bound_ms:.5f} "
          f"({bound_by}) cluster_passes/tile-bounce="
          f"{float(passes.mean()):.3f} candidates/tile-bounce="
          f"{candidates_per_tile(pack, bands):.3f} of {pack.n_clusters} "
          f"alive_rays/frame={alive}", flush=True)
    print(f"[wf2] kernel vs plain on these bands: min_alive_agree="
          f"{agree:.6f} min_tile_passes_equal={tiles:.4f} "
          f"max_abs_err={err:.3e}", flush=True)
    band_ms, tile_ms, tile_passes, pre_ms = sweep_breakdown(pack, bands,
                                                            k_outs)
    live = [int((k[2] > 0).sum()) for k in k_outs]
    fmt = lambda v: "[" + ", ".join(f"{x:.4f}" for x in v) + "]"  # noqa: E731
    print(f"[wf2] per bounce: kernel_ms={fmt(band_ms)} "
          f"heaviest_tile_alone_ms={fmt(tile_ms)} "
          f"heaviest_tile_passes={tile_passes} tiles_with_passes={live} "
          f"prefilter_only_bounce0_ms={pre_ms:.4f}", flush=True)
    check_sweep(sm, "wf2", "kernel vs plain", agree, tiles)
    sm.check(len(bands) == cfg.max_bounces, "wf2 bands per frame")
    return cfg, ms, launches, k_ms, plain_ms, bound_ms, bound_by, err


def phase_wf2_vs_xla(sm: Smoke, scene):
    """Frame 1 at 64x64 of the wavefront2 path against the port's xla path
    on the card, with rtm_tpu's outlier allowance (tests/test_wavefront2.py:
    <= 0.3% of pixels off by more than 1e-3, means within 2e-3)."""
    import torch
    from rtm_tpu_torch import Camera, RenderConfig, render_dispatch

    res = COMPARE_RES
    cfg = RenderConfig(width=res, height=res, max_bounces=MAIN_BOUNCES,
                       draw_environment=True)
    cam = Camera().spec(res, res)
    with torch.no_grad():
        wf = render_dispatch(scene, cam, 1, cfg, backend="wavefront2")
        ref = render_dispatch(scene, cam, 1, cfg, backend="xla")
    d = (wf - ref).abs().amax(dim=-1)
    bad = float((d > 1e-3).float().mean())
    mean_rel = abs(float(wf.mean()) / float(ref.mean()) - 1.0)
    print(f"[wf2] vs xla {res}x{res}: frac_off_1e-3={bad:.5f} "
          f"mean_rel={mean_rel:.2e}", flush=True)
    sm.check(bool(torch.isfinite(wf).all()) and bad <= 0.003
             and mean_rel <= 2e-3, f"wf2 vs xla: {bad}, {mean_rel}")


def phase_pallas(sm: Smoke, scene, build_s: float, big):
    """The pallas path on scene 3: drive, then the intersect kernel alone
    on one frame's per-bounce rays, its plain version on the same rays,
    held against it by the [intersect-compare] criteria, and the bound;
    then one dragon_grid(56) frame at the largest of 512/256/128 squared
    that the 128x128 frame's time predicts under PALLAS_BUDGET_S.  Returns
    (ms/frame, launches, kernel ms, plain ms, bound ms, bound by, max abs
    error)."""
    import torch
    from rtm_tpu_torch import Camera, RenderConfig, render_dispatch
    from rtm_tpu_torch.ops.kernels import intersect_kernel as ik
    from rtm_tpu_torch.ops.trace_ref import pixel_grid, render_pixels

    cfg, _, ms, launches = drive(sm, "pallas", scene, build_s, 1,
                                 PALLAS_TIMED, backend_expected="pallas",
                                 backend="pallas")
    x, y = pixel_grid(cfg.width, cfg.height, scene.device)
    with torch.no_grad(), recording(ik, "nearest_triangle_pallas") as calls:
        render_pixels(scene, Camera().spec(cfg.width, cfg.height), x, y, 1,
                      cfg, backend="pallas")
    feats, boxes, nc = intersect_tables(scene)
    packed = [ik.pack_rays(c[0], c[1]) for c in calls]
    n_tris = scene.num_triangles

    def frame():
        return [ik.intersect_sweep(r, feats, boxes, nc, n_tris=n_tris)
                for r in packed]

    # the kernel's device time: one frame's launches replayed as one CUDA
    # graph (through the wrapper one launch costs more host time than the
    # kernel takes, so eager timing reads the host); eager beside it
    eager_ms = cuda_ms(frame, 5)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        frame()
    k_ms = cuda_ms(graph.replay, 5)
    k_outs = [ik.intersect_sweep(r, feats, boxes, nc, return_passes=True,
                                 n_tris=n_tris) for r in packed]
    p_outs = []
    plain_ms = cuda_ms(lambda: p_outs.extend(
        ik.intersect_sweep_plain(r, feats, boxes, nc, return_passes=True,
                                 with_passed=True) for r in packed),
        1, warm=0)
    agree, tiles, rel, err = 1.0, 1.0, 0.0, 0.0
    for k, p in zip(k_outs, p_outs):
        a, tl, r, e = intersect_agreement(k, p)
        agree, tiles = min(agree, a), min(tiles, tl)
        rel, err = max(rel, r), max(err, e)
    bound_ms, bound_by = intersect_bound(feats, boxes, nc,
                                         scene.num_triangles, packed,
                                         [p[3] for p in p_outs])
    print(f"[pallas] clusters={nc} intersect_launches/frame={len(packed)} "
          f"intersect_kernel_ms/frame={k_ms:.4f} (graph replay) "
          f"eager_ms/frame={eager_ms:.4f} plain_ms/frame="
          f"{plain_ms:.3f} bound_ms={bound_ms:.5f} ({bound_by})", flush=True)
    print(f"[pallas] kernel vs plain on these rays: min_agree={agree:.6f} "
          f"min_tile_passes_equal={tiles:.4f} max_rel_err={rel:.3e} "
          f"max_abs_err={err:.3e}", flush=True)
    check_intersect(sm, "pallas", "kernel vs plain", agree, tiles, rel)
    sm.check(len(packed) == cfg.max_bounces, "pallas sweeps per frame")

    est = None
    for res in (128, 256, 512):
        if est is not None and est * (res / 128) ** 2 > PALLAS_BUDGET_S:
            print(f"[pallas] dragon_grid{TRAV_GRID}: stopped at "
                  f"{res // 2}x{res // 2}; a {res}x{res} frame would take "
                  f"~{est * (res / 128) ** 2:.1f} s > {PALLAS_BUDGET_S} s",
                  flush=True)
            break
        bcfg = RenderConfig(width=res, height=res, max_bounces=MAIN_BOUNCES,
                            draw_environment=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            img = render_dispatch(big, Camera().spec(res, res), 1, bcfg,
                                  backend="pallas")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if res == 128:
            est = sec
        print(f"[pallas] dragon_grid{TRAV_GRID} tris={big.num_triangles} "
              f"{res}x{res} {MAIN_BOUNCES} bounces: one frame {sec:.3f} s, "
              f"finite={bool(torch.isfinite(img).all())}", flush=True)
    return ms, launches, k_ms, plain_ms, bound_ms, bound_by, err


def grad_rig():
    """tests/test_grad.py's `_scene()` on the card: two materials, three
    spheres and one triangle (no shared triangle edges)."""
    from rtm_tpu_torch import (Material, Mesh, MeshInstance, Scene,
                               SphereDef, Triangle, build_tracer_scene)
    from rtm_tpu_torch.models import scenes

    s = Scene(sky=scenes._procedural_sky())
    s.add_material(Material((0.7, 0.4, 0.2), (1, 1, 1), 0.3, 0.2, 0, 1.0, -1))
    s.add_material(Material((1, 1, 1), (0.9, 0.8, 0.7), 0, 0, 2.0, 1.0, -1))
    s.add_sphere(SphereDef((0, 0, -2.5), 1.0, 0))
    s.add_sphere(SphereDef((0, -101, -2), 100.0, 0))
    s.add_sphere(SphereDef((1.5, 2.0, -2.0), 0.8, 1))
    s.add_mesh(Mesh.from_triangles([
        Triangle((-2.5, -0.8, -4), (2.5, -0.8, -4), (0, 2.5, -4))]))
    s.add_object(MeshInstance(mesh_id=0, material_id=0))
    return build_tracer_scene(s)


MATERIAL_GRADS = ("albedo", "emission_color", "emission_power")


def grad_parity(sm: Smoke, name: str, scene, checks: dict,
                ref_kw: dict | None = None, tag: str = "grad"):
    """At GRAD_RES x GRAD_RES, 8 bounces: each route's gradients against
    the xla route's (with `ref_kw`, e.g. soft_tau); prints per field the
    largest |diff| / (1e-3 |xla| + 1e-5), the ratio to rtm_tpu's
    tolerance (<= 1 meets it), and checks the fields `checks` names for
    the route (rtol, atol, fields)."""
    import torch
    from rtm_tpu_torch import Camera, RenderConfig
    from rtm_tpu_torch.diff import extract_params, loss_and_grad

    params = extract_params(scene)
    res = GRAD_RES
    cfg = RenderConfig(width=res, height=res, max_bounces=MAIN_BOUNCES,
                       draw_environment=True)
    cam = Camera().spec(res, res)
    target = torch.zeros((res, res, 3), device=scene.device)
    _, g_ref = loss_and_grad(params, scene, cam, target, 1, cfg,
                             backend="xla", remat=False, **(ref_kw or {}))
    for route, (rtol, atol, fields, kw) in checks.items():
        _, g = loss_and_grad(params, scene, cam, target, 1, cfg,
                             backend=route, remat=False, **kw)
        worst = []
        for f in g.fields():
            a, b = getattr(g, f), getattr(g_ref, f)
            if not a.numel():
                continue
            ratio = float(((a - b).abs() / (1e-3 * b.abs() + 1e-5)).max())
            worst.append(f"{f}={ratio:.3f}")
            sm.check(bool(torch.isfinite(a).all()), f"grad {route} {f} "
                     "not finite")
            if fields is None or f in fields:
                sm.check(torch.allclose(a, b, rtol=rtol, atol=atol),
                         f"grad {name} {route} {f} vs xla at {res}x{res}")
        print(f"[{tag}] {name} {route} vs xla {res}x{res} (checked "
              f"{'all' if fields is None else ','.join(fields)} at rtol "
              f"{rtol}, atol {atol}): max |diff| / (1e-3 |xla| + 1e-5) "
              + " ".join(worst), flush=True)


def phase_grad(sm: Smoke, scene, target_full):
    """loss_and_grad through the mxu and wavefront2 routes: at 64x64
    against the xla route, then timed at the main path's shape."""
    import torch
    from rtm_tpu_torch import Camera, RenderConfig
    from rtm_tpu_torch.diff import extract_params, loss_and_grad, render_loss

    tight = (1e-3, 1e-5)
    # the rig (no shared edges): every mxu gradient, and wavefront2's
    # material gradients (tests/test_wavefront2.py compares those)
    grad_parity(sm, "rig", grad_rig(), {
        "mxu": (*tight, None, {}),
        "wavefront2": (*tight, MATERIAL_GRADS, {"bands": 4})})
    # scene 3: material gradients only; roughness moves with the forward
    # t's rounding on every non-xla route (ROADMAP queue 3)
    grad_parity(sm, "scene3", scene, {
        "mxu": (*tight, MATERIAL_GRADS, {}),
        "wavefront2": (*tight, MATERIAL_GRADS, {"bands": 4})})

    params = extract_params(scene)
    routes = (("mxu", {}), ("wavefront2", {"bands": 4}))
    cfg = RenderConfig(width=MAIN_RES, height=MAIN_RES,
                       max_bounces=MAIN_BOUNCES, draw_environment=True)
    cam = Camera().spec(MAIN_RES, MAIN_RES)
    for route, kw in routes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss = render_loss(params, scene, cam, target_full, 1, cfg,
                               backend=route, remat=False, **kw)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, g = loss_and_grad(params, scene, cam, target_full, 1, cfg,
                                backend=route, remat=False, **kw)
        torch.cuda.synchronize()
        fb_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        finite = all(bool(torch.isfinite(t).all()) for t in g.tensors())
        print(f"[grad] {route} {kw} scene3 {MAIN_RES}x{MAIN_RES} "
              f"{MAIN_BOUNCES} bounces: loss={float(loss):.6f} "
              f"forward_loss_ms={fwd_ms:.2f} (peak {fwd_mib:.0f} MiB) "
              f"fwd+bwd_ms={fb_ms:.2f} peak_mib={peak:.0f} "
              f"grads_finite={finite}", flush=True)
        sm.check(finite and bool(torch.isfinite(loss)),
                 f"grad {route} not finite")


def phase_inverse(sm: Smoke, scene):
    """inverse_render through the mxu route at the main path's shape."""
    import dataclasses

    import torch
    from rtm_tpu_torch import Camera, RenderConfig, render_dispatch
    from rtm_tpu_torch.diff import (InverseRenderConfig, extract_params,
                                    inverse_render)

    cfg = RenderConfig(width=MAIN_RES, height=MAIN_RES,
                       max_bounces=MAIN_BOUNCES, draw_environment=True)
    cam = Camera().spec(MAIN_RES, MAIN_RES)
    true = extract_params(scene)
    with torch.no_grad():
        target = render_dispatch(scene, cam, 1, cfg, backend="mxu")
    alb = true.albedo.clone()
    alb[2] = torch.tensor([0.3, 0.6, 0.6], device=alb.device)
    p0 = dataclasses.replace(true, albedo=alb)
    mask = dataclasses.replace(p0.map(torch.zeros_like),
                               albedo=torch.ones_like(alb))
    opt = InverseRenderConfig(steps=INVERSE_STEPS, learning_rate=4e-2,
                              remat=False, vary_seed=False, backend="mxu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit, losses = inverse_render(scene, cam, target, cfg, opt,
                                 init_params=p0, param_mask=mask)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    print(f"[inverse] scene3 {MAIN_RES}x{MAIN_RES} {MAIN_BOUNCES} bounces "
          f"mxu: {INVERSE_STEPS} Adam steps in {sec:.2f} s, losses="
          + ",".join(f"{v:.6e}" for v in losses)
          + f" albedo[2]={[round(float(v), 4) for v in fit.albedo[2]]}",
          flush=True)
    sm.check(all(v == v for v in losses) and losses[-1] < losses[0],
             f"inverse losses did not fall: {losses}")


def mega_bound(scene, pack, cfg, stats, n: int):
    """(bound_ms, bound_by) of one timed mega_trace call: the tables read
    once and the color / miss / rec rows written once at the HBM rate,
    against the work this run's data needs at the FP32 rate: one slab test
    per (alive ray-bounce, cluster), one pair test per (alive ray-bounce,
    real triangle row) of each cluster its tile swept, and the sphere tests
    and shading of each alive ray-bounce (`stats`: the plain version's
    MegaStats on the same inputs).  Dead rays feed no output the path
    reads."""
    from rtm_tpu_torch.bench.profile import (HBM_BYTES_PER_S, FP32_OPS_PER_S,
                                             SWEEP_PAIR_OPS, SLAB_OPS)
    import torch
    from rtm_tpu_torch.ops.kernels.megakernel import DEFAULT_RAY_TILE

    in_bytes = 64 * 4 + sum(t.numel() * t.element_size() for t in (
        pack.tri_feats, pack.tri_attrs, pack.boxes, pack.offsets_dev,
        pack.widths_dev, pack.spheres) if t is not None)
    out_rows = 3 + 8 * cfg.max_frames + (
        8 * cfg.max_frames * cfg.max_bounces if scene.any_textured else 0)
    t_bytes = (in_bytes + out_rows * n * 4) / HBM_BYTES_PER_S * 1e3
    fb, tiles = stats.passes.shape
    alive = torch.nn.functional.pad(stats.alive.double(),
                                    (0, tiles * DEFAULT_RAY_TILE - n))
    alive_tile = alive.view(fb, tiles, -1).sum(dim=2)         # (FB, tiles)
    live = float(alive.sum())
    ops = live * (pack.n_spheres_padded * SPHERE_OPS + SHADE_OPS)
    if pack.n_clusters:
        ops += (float((alive_tile * (stats.passed.double()
                                     @ real_rows(pack))).sum())
                * SWEEP_PAIR_OPS + live * pack.n_clusters * SLAB_OPS)
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def mega_agreement(sm: Smoke, label: str, scene, cfg, k, p) -> float:
    """Check one mega_trace output `k` (with stats) against
    mega_trace_plain's `p` (with stats, same inputs): >= AGREE_MIN of lanes
    agree on color, miss and rec within MAX_ABS_ERR (every lane, dead ones
    too), the winners on >= AGREE_MIN of the live (slot, bounce) records,
    per-tile-bounce cluster passes on >= TILE_AGREE_MIN, and the
    post-passed images pass images_close and are finite.  Returns the max
    abs error over all lanes."""
    import torch
    from rtm_tpu_torch.ops.kernels.megakernel import (mega_postpass,
                                                      slots_to_image)

    n = cfg.width * cfg.height
    diff = torch.zeros(n, device=k[0].device)
    for a, b in zip(k[:3], p[:3]):
        if a is not None:
            diff = torch.maximum(diff, (a - b).abs().amax(dim=0))
    lanes = float((diff <= MAX_ABS_ERR).float().mean())
    live = p[3].alive
    winners = (float((k[3].winners == p[3].winners)[live].float().mean())
               if live.any() else 1.0)
    tiles = float((k[3].passes == p[3].passes).float().mean())
    imgs = [slots_to_image(mega_postpass(o[0].T, o[1], o[2], scene, cfg, n),
                           cfg.width, cfg.height).cpu() for o in (k, p)]
    msg = images_close(imgs[0].numpy(), imgs[1].numpy())
    finite = bool(torch.isfinite(imgs[0]).all())
    err = float(diff.max())
    print(f"{label} tris={scene.num_triangles} clusters="
          f"{p[3].passed.shape[2]} {cfg.width}x"
          f"{cfg.height} bounces={cfg.max_bounces} frames={cfg.max_frames} "
          f"lanes_agree={lanes:.6f} live_winners_agree={winners:.6f} "
          f"tile_passes_equal={tiles:.4f} "
          f"passes/tile-bounce={float(k[3].passes.float().mean()):.3f} "
          f"max_abs_err={err:.3e} images_close="
          f"{'ok' if msg is None else msg}", flush=True)
    what = f"{label} f{cfg.max_frames}"
    sm.check(lanes >= AGREE_MIN, f"{what} lanes agree {lanes} < {AGREE_MIN}")
    sm.check(winners >= AGREE_MIN, f"{what} live winners agree {winners}")
    sm.check(tiles >= TILE_AGREE_MIN, f"{what} tile passes agree {tiles}")
    sm.check(msg is None and finite, f"{what} images: {msg}, finite={finite}")
    return err


def mega_pair(scene, cfg, order: str = "static", cull: bool = True):
    """(kernel outputs, plain outputs, plain ms by CUDA events, pack, camf,
    the (8, N) ray band of each bounce of the plain version's static sweep)
    of one frame-1 dispatch of the whole frame, both with stats."""
    import torch
    from rtm_tpu_torch import Camera
    from rtm_tpu_torch.ops.kernels import sweep_kernel
    from rtm_tpu_torch.ops.kernels.megakernel import (_pack_camera,
                                                      build_mega_pack,
                                                      mega_trace,
                                                      mega_trace_plain)

    n = cfg.width * cfg.height
    pack = build_mega_pack(scene)
    camf = _pack_camera(Camera().spec(cfg.width, cfg.height), scene.device)
    k = mega_trace(scene, pack, camf, 1, 0, n, cfg, cull=cull, order=order,
                   with_stats=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with recording(sweep_kernel, "cluster_sweep_plain") as calls:
        start.record()
        p = mega_trace_plain(scene, pack, camf, 1, 0, n, cfg, cull=cull,
                             order=order, with_stats=True)
        end.record()
        torch.cuda.synchronize()
    return k, p, start.elapsed_time(end), pack, camf, [c[4] for c in calls]


def phase_mega_compare(sm: Smoke, cases):
    """The megakernel vs its plain version on (name, scene, frames, cull,
    order) cases at COMPARE_RES, COMPARE_BOUNCES; returns the max abs
    error."""
    from rtm_tpu_torch import RenderConfig

    worst = 0.0
    for name, scene, frames, cull, order in cases:
        cfg = RenderConfig(width=COMPARE_RES, height=COMPARE_RES,
                           max_bounces=COMPARE_BOUNCES, max_frames=frames,
                           draw_environment=True)
        k, p = mega_pair(scene, cfg, order, cull)[:2]
        worst = max(worst, mega_agreement(
            sm, f"[mega-compare] {name} order={order} cull={cull}", scene,
            cfg, k, p))
    return worst


def frame1_vs(sm: Smoke, tag: str, scene, cfg, other: str):
    """Frame 1 of the megakernel path against frame 1 of `other` on the
    same scene, by images_close."""
    import torch
    from rtm_tpu_torch import Camera, render_dispatch

    cam = Camera().spec(cfg.width, cfg.height)
    with torch.no_grad():
        a = render_dispatch(scene, cam, 1, cfg, backend="megakernel")
        b = render_dispatch(scene, cam, 1, cfg, backend=other)
    msg = images_close(a.cpu().numpy(), b.cpu().numpy())
    d = (a - b).abs().amax(dim=-1)
    print(f"[{tag}] frame 1 vs the {other} path: images_close="
          f"{'ok' if msg is None else msg} (bound: {MEGA_IMAGE_BOUND}); "
          f"frac_off_2e-2={float((d > 2e-2).float().mean()):.5f} "
          f"frac_off_0.2={float((d > 0.2).float().mean()):.5f}", flush=True)
    sm.check(msg is None, f"{tag} frame 1 vs {other}: {msg}")


def mega_kernel_and_postpass_ms(scene, pack, camf, cfg, reps: int):
    """Device time of one mega_trace launch (pack built once, so the
    launches queue back to back) and of one post-pass on its outputs."""
    from rtm_tpu_torch.ops.kernels.megakernel import mega_postpass, mega_trace

    n = cfg.width * cfg.height
    k_ms = cuda_ms(lambda: mega_trace(scene, pack, camf, 1, 0, n, cfg), reps)
    color, miss, rec, _ = mega_trace(scene, pack, camf, 1, 0, n, cfg)
    p_ms = cuda_ms(lambda: mega_postpass(color.T, miss, rec, scene, cfg, n),
                   reps)
    return k_ms, p_ms


def phase_mega(sm: Smoke, scene, build_s: float):
    """The megakernel path on scene 3 at the main shape, then [mega-plain]:
    the plain version on the same inputs, held against the kernel, and the
    bound.  Returns (cfg, ms/frame, launches, kernel ms, plain ms, bound
    ms, bound by, max abs error)."""
    cfg, _, ms, launches = drive(sm, "mega", scene, build_s, MEGA_WARM,
                                 MEGA_TIMED, backend_expected="megakernel",
                                 backend="megakernel")
    k, p, plain_ms, pack, camf, _ = mega_pair(scene, cfg)
    k_ms, p_ms = mega_kernel_and_postpass_ms(scene, pack, camf, cfg, 10)
    n = cfg.width * cfg.height
    bound_ms, bound_by = mega_bound(scene, pack, cfg, p[3], n)
    print(f"[mega] clusters={pack.n_clusters} kernel_ms={k_ms:.4f} "
          f"postpass_ms={p_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
          f"live_ray-bounces={int(p[3].alive.sum())}", flush=True)
    frame1_vs(sm, "mega", scene, cfg, "mxu")
    err = mega_agreement(sm, "[mega-plain] scene3", scene, cfg, k, p)
    print(f"[mega-plain] scene3 {cfg.width}x{cfg.height} {cfg.max_bounces} "
          f"bounces: plain_ms={plain_ms:.3f} kernel_ms={k_ms:.4f}",
          flush=True)
    return cfg, ms, launches, k_ms, plain_ms, bound_ms, bound_by, err


def phase_mega_big(sm: Smoke, scene, build_s: float):
    """The megakernel on the [trav] scene (768 clusters): drive, the kernel
    and post-pass times, the plain version's time, agreement and bound,
    the heaviest tile alone, and frame 1 against the trav path's.  Returns
    (cfg, ms/frame)."""
    from rtm_tpu_torch.ops.kernels.megakernel import (DEFAULT_RAY_TILE,
                                                      mega_trace)

    cfg, _, ms, _ = drive(sm, "mega-big", scene, build_s, 1, MEGA_BIG_TIMED,
                          backend_expected="megakernel",
                          backend="megakernel")
    k, p, plain_ms, pack, camf, bands = mega_pair(scene, cfg)
    k_ms, p_ms = mega_kernel_and_postpass_ms(scene, pack, camf, cfg, 3)
    n = cfg.width * cfg.height
    bound_ms, bound_by = mega_bound(scene, pack, cfg, p[3], n)
    print(f"[mega-big] clusters={pack.n_clusters} kernel_ms={k_ms:.4f} "
          f"postpass_ms={p_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
          f"plain_ms={plain_ms:.3f} "
          f"live_ray-bounces={int(p[3].alive.sum())} "
          f"cluster_passes/tile-bounce={float(k[3].passes.float().mean()):.3f}"
          f" candidates/tile-bounce={candidates_per_tile(pack, bands):.3f}",
          flush=True)
    # a tile's bounces run one after another in one thread block: the tile
    # that sweeps the most clusters, dispatched alone, bounds the kernel
    per_tile = k[3].passes.sum(dim=0)
    heavy = int(per_tile.argmax())
    r = DEFAULT_RAY_TILE
    tile_ms = cuda_ms(lambda: mega_trace(scene, pack, camf, 1, heavy * r, r,
                                         cfg), 3)
    print(f"[mega-big] heaviest tile {heavy}: passes over its bounces="
          f"{int(per_tile[heavy])} (mean {float(per_tile.float().mean()):.2f})"
          f" alone kernel_ms={tile_ms:.4f}", flush=True)
    mega_agreement(sm, f"[mega-big] dragon_grid{TRAV_GRID}", scene, cfg, k, p)
    frame1_vs(sm, "mega-big", scene, cfg, "trav")
    return cfg, ms


def textured_grid(k: int):
    """dragon_grid(k) with material 0 given scene 3's texture: every
    triangle textured, beyond the mxu and trav tables' 128."""
    from rtm_tpu_torch import load_scene
    from rtm_tpu_torch.models.scenes import dragon_grid

    s = dragon_grid(k)
    s.textures = list(load_scene(3).textures)
    s.materials[0].texture_id = 0
    return s


def phase_mega_auto(sm: Smoke):
    """backend="auto" on a textured dragon_grid(MEGA_AUTO_GRID): resolves
    to the megakernel; then the kernel and post-pass times, the plain
    version's time, agreement and bound on the same frame, and frame 1
    against the wavefront2 path's (the port's other route for a textured
    scene beyond the tables).  Returns (scene, cfg, ms/frame)."""
    scene, build_s = build_scene(textured_grid(MEGA_AUTO_GRID))
    sm.check(not scene.mxu_meta.supported and not scene.trav_meta.supported,
             "mega-auto scene fits the mxu or trav tables")
    cfg, _, ms, _ = drive(sm, "mega-auto", scene, build_s, 1, 8,
                          backend_expected="megakernel", backend="auto")
    k, p, plain_ms, pack, camf, bands = mega_pair(scene, cfg)
    k_ms, p_ms = mega_kernel_and_postpass_ms(scene, pack, camf, cfg, 3)
    bound_ms, bound_by = mega_bound(scene, pack, cfg, p[3],
                                    cfg.width * cfg.height)
    print(f"[mega-auto] clusters={pack.n_clusters} kernel_ms={k_ms:.4f} "
          f"postpass_ms={p_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
          f"plain_ms={plain_ms:.3f} "
          f"live_ray-bounces={int(p[3].alive.sum())} "
          f"cluster_passes/tile-bounce={float(k[3].passes.float().mean()):.3f}"
          f" candidates/tile-bounce={candidates_per_tile(pack, bands):.3f}",
          flush=True)
    mega_agreement(sm, f"[mega-auto] textured dragon_grid{MEGA_AUTO_GRID}",
                   scene, cfg, k, p)
    frame1_vs(sm, "mega-auto", scene, cfg, "wavefront2")
    return scene, cfg, ms


def phase_bvh_native(sm: Smoke):
    """build_tracer_scene(dragon_grid(BVH_NATIVE_GRID)) on the card with the
    native SAH builder and with the NumPy one: the tables bitwise equal,
    and both host build times."""
    import torch
    from rtm_tpu_torch import build_tracer_scene
    from rtm_tpu_torch.models.scene import scene_diff
    from rtm_tpu_torch.models.scenes import dragon_grid

    host = dragon_grid(BVH_NATIVE_GRID)
    secs = {}
    scenes = {}
    for name, native in (("native", True), ("numpy", False)):
        t0 = time.perf_counter()
        scenes[name] = build_tracer_scene(host, use_native=native)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    diff = scene_diff(scenes["native"], scenes["numpy"])
    print(f"[bvh-native] dragon_grid{BVH_NATIVE_GRID} "
          f"tris={scenes['native'].num_triangles} "
          f"scene_build_s native={secs['native']:.3f} "
          f"numpy={secs['numpy']:.3f} tables_bitwise_equal={not diff}",
          flush=True)
    sm.check(not diff, f"bvh-native tables differ: {diff}")


def phase_bvh_traverse(sm: Smoke):
    """build_bvh_scene + bounce_ray_bvh (the shader-parity traversal) on
    the card over scene 3's primary rays at BVH_TRAVERSE_RES^2, against the
    dense nearest_triangle sweep of the world-space triangles on the same
    rays, as tests/test_bvh.py holds it: hits equal, t within 1e-5, and
    indices that differ only where t ties."""
    import numpy as np
    import torch
    from rtm_tpu_torch import Camera, RenderConfig, build_tracer_scene
    from rtm_tpu_torch.accel.bvh import build_bvh, build_bvh_scene
    from rtm_tpu_torch.models.scenes import load_scene
    from rtm_tpu_torch.ops.bvh_traverse import BvhArrays, bounce_ray_bvh
    from rtm_tpu_torch.ops.intersect import TriFeatures, nearest_triangle
    from rtm_tpu_torch.ops.trace_ref import camera_rays, pixel_grid

    res = BVH_TRAVERSE_RES
    host = load_scene(3)
    bs = build_bvh_scene(host)
    arrays = BvhArrays.from_scene(bs)
    cfg = RenderConfig(width=res, height=res)
    x, y = pixel_grid(res, res, arrays.box_min.device)
    o, d, _ = camera_rays(Camera().spec(res, res), cfg, x, y, 1, 1)
    k = max(st.leaf_tris_max for st in bs.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t, tri, inst = bounce_ray_bvh(arrays, o, d, max_leaf_tris=k)
    torch.cuda.synchronize()
    trav_ms = (time.perf_counter() - t0) * 1e3
    world = build_tracer_scene(host, order="buffer")
    with torch.no_grad():
        t_d, i_d = nearest_triangle(o, d, TriFeatures.build(
            world.tri_wa, world.tri_wb, world.tri_wc))
    # the BVH's (reordered triangle, instance) as a world buffer index
    orders = [build_bvh(m).order.astype(np.int64) for m in host.meshes]
    roots = bs.mesh_model_root.astype(np.int64)
    offs = np.cumsum([0] + [host.meshes[ob.mesh_id].num_triangles
                            for ob in host.objects])
    tri_n = tri.cpu().numpy().astype(np.int64)
    inst_n = inst.cpu().numpy()
    wid = np.full(len(tri_n), -1)
    for r in np.nonzero(tri_n >= 0)[0]:
        m = host.objects[inst_n[r]].mesh_id
        wid[r] = offs[inst_n[r]] + orders[m][tri_n[r] - roots[m]]
    t_b, t_dn, i_dn = t.cpu().numpy(), t_d.cpu().numpy(), i_d.cpu().numpy()
    hit = tri_n >= 0
    hits_equal = bool(np.array_equal(hit, i_dn >= 0))
    t_close = bool(np.allclose(t_b[hit], t_dn[hit], rtol=1e-5, atol=1e-5))
    differ = hit & (wid != i_dn)
    ties = bool(np.allclose(t_b[differ], t_dn[differ]))
    print(f"[bvh-traverse] scene3 {res}x{res} primary rays: "
          f"instances={len(host.objects)} nodes={len(bs.box_min)} "
          f"max_leaf_tris={k} traverse_ms={trav_ms:.2f} hits={int(hit.sum())}"
          f" hits_equal={hits_equal} t_within_1e-5={t_close} "
          f"index_differs={int(differ.sum())} (t ties: {ties})", flush=True)
    sm.check(hits_equal and hit.any(), "bvh-traverse hits differ from the "
             "dense sweep")
    sm.check(t_close, "bvh-traverse t beyond 1e-5 of the dense sweep")
    sm.check(ties, "bvh-traverse indices differ off a t tie")


def phase_soft(sm: Smoke, scene, target_full):
    """Soft primary visibility (render_loss(soft_tau=SOFT_TAU)) through the
    pallas route: at GRAD_RES^2 against the xla route with the same
    soft_tau by [grad]'s tolerances (the rig: every field; scene 3: the
    material fields), then one loss_and_grad at the main path's shape:
    forward ms, fwd+bwd ms, peak MiB, every gradient finite."""
    import torch
    from rtm_tpu_torch import Camera, RenderConfig
    from rtm_tpu_torch.diff import extract_params, loss_and_grad, render_loss
    from rtm_tpu_torch.ops.kernels.intersect_kernel import intersect_sweep

    tight = (1e-3, 1e-5)
    soft = {"soft_tau": SOFT_TAU}
    grad_parity(sm, "rig", grad_rig(), {"pallas": (*tight, None, soft)},
                ref_kw=soft, tag="soft")
    grad_parity(sm, "scene3", scene,
                {"pallas": (*tight, MATERIAL_GRADS, soft)}, ref_kw=soft,
                tag="soft")

    params = extract_params(scene)
    cfg = RenderConfig(width=MAIN_RES, height=MAIN_RES,
                       max_bounces=MAIN_BOUNCES, draw_environment=True)
    cam = Camera().spec(MAIN_RES, MAIN_RES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        render_loss(params, scene, cam, target_full, 1, cfg,
                    backend="pallas", remat=False, **soft)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    intersect_sweep.launches = 0
    t0 = time.perf_counter()
    loss, g = loss_and_grad(params, scene, cam, target_full, 1, cfg,
                            backend="pallas", remat=False, **soft)
    torch.cuda.synchronize()
    fb_ms = (time.perf_counter() - t0) * 1e3
    launches = intersect_sweep.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    finite = all(bool(torch.isfinite(t).all()) for t in g.tensors())
    geo = float(g.tri_verts.abs().max())
    print(f"[soft] pallas soft_tau={SOFT_TAU} scene3 {MAIN_RES}x{MAIN_RES} "
          f"{MAIN_BOUNCES} bounces: loss={float(loss):.6f} "
          f"forward_loss_ms={fwd_ms:.2f} (peak {fwd_mib:.0f} MiB) "
          f"fwd+bwd_ms={fb_ms:.2f} peak_mib={peak:.0f} "
          f"intersect_launches={launches} grads_finite={finite} "
          f"max|d/d tri_verts|={geo:.6e}", flush=True)
    sm.check(finite and bool(torch.isfinite(loss)), "soft grads not finite")
    sm.check(launches == MAIN_BOUNCES, f"soft: {launches} intersect "
             f"launches, not one per bounce ({MAIN_BOUNCES})")
    # where the fwd+bwd goes: one profiled step (bench/profile.py trace,
    # a Chrome trace beside the kernel libraries)
    from rtm_tpu_torch.bench.profile import trace
    from rtm_tpu_torch.ops.kernels import build

    with trace(build.BUILD_DIR / "soft_trace") as prof:
        t0 = time.perf_counter()
        loss_and_grad(params, scene, cam, target_full, 1, cfg,
                      backend="pallas", remat=False, **soft)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, "soft-profile", 1, prof_ms, fb_ms, unit="step")


def path_launches():
    from rtm_tpu_torch.ops.kernels import kernel_wrappers

    return {name: k.launches for name, k in kernel_wrappers().items()}


def zero_launches():
    from rtm_tpu_torch.ops.kernels import kernel_wrappers

    for k in kernel_wrappers().values():
        k.launches = 0


def phase_editor(sm: Smoke):
    """A SceneEditor over scene 3's host scene with a ProgressiveRenderer on
    the card (auto -> mxu): 4 frames, then a wall's material (the
    accumulation resets, frame 1 changes), a sphere (the count grows), and
    a mesh beyond the mxu tables with an instance of it (the route moves
    from the mxu kernel to trav).  Prints each edit's rebuild seconds and
    the route."""
    import torch
    from rtm_tpu_torch import RenderConfig, load_scene
    from rtm_tpu_torch.models.scenes import dragon_grid
    from rtm_tpu_torch.ops.trace_ref import resolve_route
    from rtm_tpu_torch.runtime.editor import SceneEditor
    from rtm_tpu_torch.runtime.renderer import ProgressiveRenderer

    cfg = RenderConfig(width=MAIN_RES, height=MAIN_RES,
                       max_bounces=MAIN_BOUNCES, draw_environment=True,
                       accumulate=True)
    host = load_scene(3)
    t0 = time.perf_counter()
    r = ProgressiveRenderer(host, cfg=cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ed = SceneEditor(host, r)
    zero_launches()
    frame1 = r.step().clone()
    for _ in range(3):
        r.step()
    ms = r.last_ms
    counts = path_launches()
    print(f"[editor] scene3 {MAIN_RES}x{MAIN_RES} {MAIN_BOUNCES} bounces on "
          f"{r.scene.device}: build_s={first_s:.3f} frames={r.frame_index} "
          f"last_frame_ms={ms:.2f} "
          f"route={resolve_route(r.scene, cfg, 'auto')} launches={counts}",
          flush=True)
    sm.check(r.frame_index == 4 and counts["mxu"] == 4,
             f"editor: 4 frames through mxu, got {r.frame_index} / {counts}")

    soup = build_tracer_scene_soup(dragon_grid(EDIT_GRID))
    edits = (
        ("set_material (red wall -> green)",
         lambda: ed.apply({"op": "set_material", "index": 3,
                           "albedo": [0.0, 1.0, 0.0]})),
        ("add_sphere",
         lambda: ed.apply({"op": "add_sphere", "position": [0.0, 1.0, -1.0],
                           "radius": 0.5, "material_id": 2})),
        (f"add_mesh dragon_grid{EDIT_GRID} soup ({len(soup)} tris)",
         lambda: ed.add_mesh(soup)),
        ("add_instance of it",
         lambda: ed.apply({"op": "add_instance", "mesh_id":
                           len(host.meshes) - 1, "material_id": 0,
                           "position": [0.0, 0.0, -40.0]})),
    )
    for name, edit in edits:
        spheres = r.scene.num_spheres
        edit()
        zero_launches()
        img = r.step()
        counts = path_launches()
        route = resolve_route(r.scene, cfg, "auto")
        print(f"[editor] {name}: rebuild_s={ed.last_rebuild_s:.4f} "
              f"tris={r.scene.num_triangles} spheres={r.scene.num_spheres} "
              f"route={route} frame_index={r.frame_index} "
              f"frame_ms={r.last_ms:.2f} launches={counts}", flush=True)
        sm.check(r.frame_index == 1 and bool(torch.isfinite(img).all()),
                 f"editor {name}: accumulation not reset or image not finite")
        sm.check(counts[route] == 1 and sum(counts.values()) == 1,
                 f"editor {name}: launches {counts} for route {route}")
        if name.startswith("set_material"):
            sm.check(not torch.equal(img, frame1),
                     "editor set_material: frame 1 unchanged")
        if name == "add_sphere":
            sm.check(r.scene.num_spheres == spheres + 1,
                     "editor add_sphere: sphere count unchanged")
    sm.check(route == "trav" and r.scene.num_triangles > 2047,
             f"editor: route {route} after the big mesh, not trav")


def build_tracer_scene_soup(host):
    """The world-space triangle soup (T,3,3) of a host scene."""
    import torch
    from rtm_tpu_torch import build_tracer_scene

    st = build_tracer_scene(host, order="buffer", device="cpu")
    return torch.stack([st.tri_wa, st.tri_wb, st.tri_wc], 1).numpy()


def phase_view(sm: Smoke):
    """The browser viewer on the card at the main path's shape: a
    ViewerServer(port=0) with its render thread (auto -> mxu) and the
    scene editor; GET /frame.png decodes to 512x512x3, /state's frame
    index grows, POST /input with a key resets the accumulation, POST
    /edit changes the frame; the render loop's ms/frame; then the server
    stops and its threads end.  Then Application + RenderFrame for a few
    iterations."""
    import json
    import urllib.request

    import numpy as np
    import torch
    from rtm_tpu_torch import RenderConfig, load_scene
    from rtm_tpu_torch.io.image import decode_png, encode_png
    from rtm_tpu_torch.runtime.events import KeyPressed
    from rtm_tpu_torch.runtime.frame import Application, RenderFrame
    from rtm_tpu_torch.runtime.renderer import ProgressiveRenderer
    from rtm_tpu_torch.viewer import ViewerServer

    cfg = RenderConfig(width=MAIN_RES, height=MAIN_RES,
                       max_bounces=MAIN_BOUNCES, draw_environment=True,
                       accumulate=True)
    host = load_scene(3)
    srv = ViewerServer(ProgressiveRenderer(host, cfg=cfg), port=0,
                       host_scene=host, scene_id=3)
    base = f"http://127.0.0.1:{srv.port}"

    def get(path):
        return urllib.request.urlopen(base + path, timeout=60).read()

    def post(path, payload):
        req = urllib.request.Request(base + path, method="POST",
                                     data=json.dumps(payload).encode())
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def wait(cond, what, timeout=VIEW_WAIT_S):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                sm.check(False, f"view: timed out waiting for {what}")
                return False
            time.sleep(0.02)
        return True

    def state():
        return json.loads(get("/state"))

    after_key = []
    srv.bus.register(KeyPressed,
                     lambda e: after_key.append(srv.renderer.frame_index))
    zero_launches()
    srv.start()
    try:
        wait(lambda: srv.frames_encoded >= 3, "3 frames")
        img = decode_png(get("/frame.png"))
        s0 = state()
        wait(lambda: state()["frame_index"] > s0["frame_index"],
             "the frame index to grow")
        s1 = state()
        sm.check(img.shape == (MAIN_RES, MAIN_RES, 3) and img.std() > 0,
                 f"view: /frame.png shape {img.shape}")
        post("/input", {"keys": ["w"]})
        wait(lambda: bool(after_key), "the key event")
        sm.check(after_key[:1] == [0], f"view: /input did not reset the "
                 f"accumulation (frame index {after_key[:1]} after it)")
        n0 = srv.frames_encoded
        wait(lambda: srv.frames_encoded >= n0 + 3, "frames after the key")
        before = decode_png(get("/frame.png")).astype(np.float64).mean()
        resp = post("/edit", {"op": "set_material", "index": 3,
                              "emission_color": [1.0, 1.0, 1.0],
                              "emission_power": 4.0})
        n1 = srv.frames_encoded
        wait(lambda: srv.frames_encoded >= n1 + 3, "frames after the edit")
        after = decode_png(get("/frame.png")).astype(np.float64).mean()
        sm.check(bool(resp.get("ok")) and after > before * 1.05,
                 f"view: /edit (an emissive wall) moved the mean from "
                 f"{before:.2f} to {after:.2f}")
        sf = state()
    finally:
        srv.stop()
    counts = path_launches()
    alive = [t.name for t in srv._threads if t.is_alive()]
    print(f"[view] scene3 {MAIN_RES}x{MAIN_RES} {MAIN_BOUNCES} bounces "
          f"backend={sf['backend']} device={sf['device']}: png "
          f"{img.shape[1]}x{img.shape[0]}, frame_index {s0['frame_index']} "
          f"-> {s1['frame_index']}, reset by /input to {after_key[:1]}, "
          f"/edit mean {before:.2f} -> {after:.2f}, render_loop_ms/frame="
          f"{sf['frame_ms']:.2f} fps={sf['fps']:.2f} frames_encoded="
          f"{srv.frames_encoded} launches={counts} threads_alive={alive}",
          flush=True)
    host = srv.renderer.accum.cpu().numpy() / max(srv.renderer.frame_index, 1)
    t0 = time.perf_counter()
    for _ in range(3):
        encode_png(host[::-1])
    print(f"[view] one {MAIN_RES}x{MAIN_RES} /frame.png encode on the host "
          f"(render thread): {(time.perf_counter() - t0) / 3 * 1e3:.2f} ms",
          flush=True)
    sm.check(not alive, f"view: threads still alive after stop: {alive}")
    sm.check(counts["mxu"] > 0 and sum(counts.values()) == counts["mxu"],
             f"view: launches {counts}, not the mxu kernel's")

    small = RenderConfig(width=MAIN_RES, height=MAIN_RES,
                         max_bounces=MAIN_BOUNCES, accumulate=True)
    app = Application(lambda: RenderFrame(scene_id=3, cfg=small),
                      max_iterations=APP_ITERATIONS)
    t0 = time.perf_counter()
    n = app.run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out = app.frame.image
    print(f"[view] Application + RenderFrame: {n} iterations in {sec:.2f} s "
          f"(last {app.last_ms:.2f} ms), image {tuple(out.shape)} on "
          f"{out.device}, finite={bool(torch.isfinite(out).all())}",
          flush=True)
    sm.check(n == APP_ITERATIONS and out.is_cuda
             and bool(torch.isfinite(out).all()),
             "view: Application/RenderFrame did not render on the card")


def phase_cli(sm: Smoke):
    """`python -m rtm_tpu_torch render --backend megakernel` as a user runs
    it, in a subprocess: it must exit 0 and write a PNG."""
    from rtm_tpu_torch.ops.kernels import build

    out = build.BUILD_DIR / "chip_smoke_cli.png"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "rtm_tpu_torch", "render", "--scene", "3",
           "--backend", "megakernel", "--width", str(MAIN_RES), "--height",
           str(MAIN_RES), "--bounces", str(MAIN_BOUNCES), "--frames", "4",
           "--check-nans", "--out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    sec = time.perf_counter() - t0
    ok = (proc.returncode == 0 and out.exists()
          and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n")
    print(f"[cli] {' '.join(cmd[1:6])} ... rc={proc.returncode} "
          f"seconds={sec:.2f} png={'ok' if ok else 'missing'}: "
          f"{proc.stdout.strip()} {proc.stderr.strip()[-300:]}", flush=True)
    sm.check(ok, f"cli render rc={proc.returncode}")


def shard_cfg():
    from rtm_tpu_torch import RenderConfig

    return RenderConfig(width=MAIN_RES, height=MAIN_RES,
                        max_bounces=MAIN_BOUNCES, draw_environment=True)


def phase_shard_band(sm: Smoke, scene, tscene):
    """render_band in this process, no process group: every rank's band of
    a 1-, 3- and 4-way split concatenated into the frame and held against
    the full-frame render_dispatch; each band is one kernel launch (the
    sweeps: one per bounce), counted from 0 around each split.  mxu on
    scene 3 bitwise where the band is a multiple of the kernel's 256-slot
    cull block (world 1 and 4), else >= AGREE_MIN of the pixels; trav and
    pallas bitwise; the megakernel (512-ray tiles) and wavefront2 (a sort
    per band) by images_close.  World 3 leaves 2 slots past W*H in the
    last band."""
    import torch
    from rtm_tpu_torch import Camera, render_dispatch
    from rtm_tpu_torch.ops.kernels.mxu_kernel import BLOCK
    from rtm_tpu_torch.ops.trace_ref import resolve_route
    from rtm_tpu_torch.parallel.sharding import (band_size, image_of_bands,
                                                 render_band)

    cfg = shard_cfg()
    cam = Camera().spec(cfg.width, cfg.height)
    grid = f"dragon_grid{TRAV_GRID}"
    for name, sc, be in (("scene3", scene, "mxu"), (grid, tscene, "trav"),
                         (grid, tscene, "megakernel"),
                         (grid, tscene, "wavefront2"),
                         ("scene3", scene, "pallas")):
        full = render_dispatch(sc, cam, 1, cfg, backend=be)
        per_band = 1 if be in ("mxu", "trav", "megakernel") \
            else cfg.max_bounces
        for world in SHARD_WORLDS:
            band = band_size(cfg, world)
            torch.cuda.synchronize()
            zero_launches()
            parts = [render_band(sc, cam, 1, cfg, r, world, be)
                     for r in range(world)]
            torch.cuda.synchronize()
            counts = path_launches()
            img = image_of_bands(torch.cat(parts), cfg,
                                 resolve_route(sc, cfg, be))
            equal = float((img == full).all(dim=-1).float().mean())
            if be in ("megakernel", "wavefront2"):
                msg = images_close(img.cpu().numpy(), full.cpu().numpy())
                rule, ok = "images_close", msg is None
            elif be == "mxu" and band % BLOCK:
                rule, ok = f">= {AGREE_MIN} of pixels", equal >= AGREE_MIN
            else:
                rule, ok = "bitwise", torch.equal(img, full)
            print(f"[shard-band] {name} {be} world={world} band={band} "
                  f"tail_slots={band * world - cfg.num_pixels} "
                  f"pixels_equal={equal:.6f} max_abs_err="
                  f"{float((img - full).abs().max()):.3e} ({rule}: "
                  f"{'ok' if ok else 'FAIL'}) launches={counts}", flush=True)
            sm.check(ok, f"shard-band {name} {be} world {world}: {rule}")
            sm.check(counts[be] == world * per_band
                     and sum(counts.values()) == counts[be],
                     f"shard-band {name} {be} world {world}: launches "
                     f"{counts}, expected {world * per_band} of {be}")


def shard_refs(scene):
    """One process's references for the spawned worlds, on the parent's
    card: the mxu frame and its host ms, and loss_and_grad through mxu
    replay and wavefront2 (bands=4) against a constant 0.3 target, as
    run_cases differentiates."""
    import torch
    from rtm_tpu_torch import Camera, render_dispatch
    from rtm_tpu_torch.diff import extract_params, loss_and_grad

    cfg = shard_cfg()
    cam = Camera().spec(cfg.width, cfg.height)
    frame = render_dispatch(scene, cam, 1, cfg, backend="mxu")

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    frame_ms = host_ms(lambda: render_dispatch(scene, cam, 1, cfg,
                                               backend="mxu"), SHARD_REPS)
    target = torch.full((cfg.height, cfg.width, 3), 0.3, device=scene.device)
    grads = {}
    for route, kw in (("mxu", {}), ("wavefront2", {"bands": 4})):
        grads[route] = loss_and_grad(extract_params(scene), scene, cam,
                                     target, 1, cfg, route, False, False,
                                     **kw)
    return {"frame": frame, "frame_ms": frame_ms, "grads": grads}


def shard_cases(grad_routes):
    common = dict(scene=3, width=MAIN_RES, height=MAIN_RES,
                  bounces=MAIN_BOUNCES)
    return ([dict(name="render", kind="render", backend="mxu",
                  reps=SHARD_REPS, **common)]
            + [dict(name=f"grad-{be}", kind="grad", backend=be,
                    reps=SHARD_REPS if be == "mxu" else 0, **common)
               for be in grad_routes]
            + [dict(name="train", kind="train", backend="mxu",
                    steps=SHARD_TRAIN_STEPS, lr=5e-2, fit="albedo",
                    **common)])


def phase_shard_world(sm: Smoke, tag: str, world: int, backend: str, refs,
                      grad_routes, card: str):
    """A spawned world of `world` ranks on the card over `backend` running
    render_sharded (mxu), sharded_loss_and_grad and make_train_step at the
    main shape: the frame bitwise the full frame and the same on every
    rank; the gradients within rtm_tpu's sharding bound of one process's
    loss_and_grad on the same route, and their least-squares scale
    within 0.01 of 1 (a double-counted reduction reads `world`); the
    train steps lower the loss and leave every rank's parameters bitwise
    equal; each route's kernel launched on every rank."""
    import numpy as np
    import torch
    from rtm_tpu_torch.parallel.smoke import run_cases, spawn_world

    t0 = time.perf_counter()
    outs = spawn_world(world, run_cases, (shard_cases(grad_routes),),
                       device="cuda", backend=backend,
                       timeout_s=SHARD_TIMEOUT_S)
    print(f"[{tag}] {world} rank(s) over {backend} on one card "
          f"({card}): spawn to results {time.perf_counter() - t0:.2f} s",
          flush=True)
    r0 = outs[0]
    full = refs["frame"].cpu().numpy()
    img = r0["render"]["image"]
    same = len({o["render"]["digest"] for o in outs}) == 1
    bitwise = bool(np.array_equal(img, full))
    print(f"[{tag}] render_sharded(mxu) scene3 {MAIN_RES}x{MAIN_RES} "
          f"{MAIN_BOUNCES} bounces: bitwise the full frame {bitwise}, the "
          f"same on every rank {same}; ms per sharded frame "
          f"{[round(o['render']['ms'], 4) for o in outs]} against "
          f"render_dispatch {refs['frame_ms']:.4f} ({card})", flush=True)
    sm.check(bitwise and same, f"{tag} frame bitwise {bitwise} same {same}")
    for route in grad_routes:
        case = f"grad-{route}"
        l1, g1 = refs["grads"][route]
        got = r0[case]
        worst, ref_v, sh_v = [], [], []
        for f in g1.fields():
            b = getattr(g1, f).cpu().numpy()
            a = got["grads"][f]
            if not b.size:
                continue
            ratio = float((np.abs(a - b) / (SHARD_RTOL * np.abs(b)
                                             + SHARD_ATOL)).max())
            worst.append(f"{f}={ratio:.3f}")
            sm.check(bool(np.isfinite(a).all()) and ratio <= 1.0,
                     f"{tag} {route} grad {f}: ratio {ratio:.3f}")
            ref_v.append(b.ravel())
            sh_v.append(a.ravel())
        ref_v, sh_v = np.concatenate(ref_v), np.concatenate(sh_v)
        scale = float(sh_v @ ref_v) / float(ref_v @ ref_v)
        losses = {o[case]["loss"] for o in outs}
        rel = abs(got["loss"] - float(l1)) / abs(float(l1))
        print(f"[{tag}] sharded_loss_and_grad({route}): loss "
              f"{got['loss']:.8f} against {float(l1):.8f} (rel {rel:.2e}; "
              f"one value on every rank {len(losses) == 1}); max |diff| / "
              f"({SHARD_RTOL} |one process| + {SHARD_ATOL}): "
              + " ".join(worst) + f"; scale {scale:.6f}; launches "
              f"{got['launches']}", flush=True)
        sm.check(rel <= 1e-4 and len(losses) == 1,
                 f"{tag} {route} loss {got['loss']} vs {float(l1)}")
        sm.check(abs(scale - 1.0) < 0.01, f"{tag} {route} scale {scale}")
        sm.check(all(o[case]["launches"][route] >= 1 for o in outs),
                 f"{tag} {route}: the kernel did not launch on every rank")
        if got.get("allreduce_ms") is not None:
            print(f"[{tag}] gradient all-reduce: "
                  f"{got['allreduce_floats']} floats in "
                  f"{[round(o[case]['allreduce_ms'], 4) for o in outs]} ms "
                  f"per rank; sharded fwd+bwd "
                  f"{[round(o[case]['ms'], 2) for o in outs]} ms ({card})",
                  flush=True)
    tr = r0["train"]["losses"]
    same_p = len({o["train"]["digest"] for o in outs}) == 1
    print(f"[{tag}] make_train_step(mxu, Adam on the albedo) "
          f"x{SHARD_TRAIN_STEPS}: losses "
          f"{[round(v, 8) for v in tr]}; parameters bitwise equal on every "
          f"rank {same_p}", flush=True)
    sm.check(tr[-1] < tr[0] and same_p,
             f"{tag} train losses {tr} params equal {same_p}")
    sm.check(all(o["render"]["launches"]["mxu"] == 1 for o in outs),
             f"{tag} render launches "
             f"{[o['render']['launches'] for o in outs]}")
    peaks = [round(max(v["peak_mib"] for v in o.values()), 1) for o in outs]
    print(f"[{tag}] peak MiB per rank {peaks} ({card})", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "rtm_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no rtm_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rtm_tpu_torch import Camera, load_scene, render_dispatch
    from rtm_tpu_torch.accel.native import bvh_native
    from rtm_tpu_torch.io.image import save_png
    from rtm_tpu_torch.models.scenes import dragon_grid
    from rtm_tpu_torch.ops.kernels import build
    from rtm_tpu_torch.ops.kernels.megakernel import (_pack_camera,
                                                      mega_postpass,
                                                      slots_to_image)
    from rtm_tpu_torch.ops.kernels.mxu_kernel import (MAX_TRIS,
                                                      mxu_trace_plain,
                                                      side_tables)

    run_t0 = time.perf_counter()
    sm = Smoke()
    card = nvidia_smi_line()
    print(f"[card] {card}", flush=True)
    print(f"[card] torch={torch.__version__} cuda={torch.version.cuda} "
          f"device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()}", flush=True)

    with sm.phase("build"):
        t0 = time.perf_counter()
        reports = build.build_kernels(build.KERNELS)
        print(f"[build] {', '.join(build.KERNELS)} built in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for name, text in reports.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    print(f"[build] {name}: {line.strip()}", flush=True)
        t0 = time.perf_counter()
        bvh_native.load()
        print(f"[build] native SAH builder (accel/native/bvh.cpp, g++) "
              f"built in {time.perf_counter() - t0:.2f} s", flush=True)

    # widest dragon grid the mxu tables take (k=10 with the stand-in mesh)
    per_dragon = dragon_grid(1).meshes[0].num_triangles
    grid_k = max(1, int((MAX_TRIS / per_dragon) ** 0.5))

    with sm.phase("compare"):
        err = phase_compare(sm, [("scene1", load_scene(1)),
                                 ("scene2", load_scene(2)),
                                 ("scene3", load_scene(3)),
                                 (f"dragon_grid{grid_k}",
                                  dragon_grid(grid_k))])
    with sm.phase("bvh-native"):
        phase_bvh_native(sm)
    with sm.phase("bvh-traverse"):
        phase_bvh_traverse(sm)
    with sm.phase("trav-build"):
        # the [trav] scene, built once for [trav-compare] and [trav]
        tscene, tbuild_s = build_scene(dragon_grid(TRAV_GRID))
        print(f"[trav-build] dragon_grid{TRAV_GRID} "
              f"tris={tscene.num_triangles} scene_build_s={tbuild_s:.3f} "
              f"(native SAH builder)", flush=True)
    with sm.phase("trav-compare"):
        trav_err = phase_trav_compare(
            sm, [("scene1", load_scene(1)), ("scene3", load_scene(3))]
            + [(f"dragon_grid{k}",
                tscene if k == TRAV_GRID else dragon_grid(k))
               for k in TRAV_COMPARE_GRIDS])

    with sm.phase("main"):
        scene, build_s = build_scene(load_scene(3))
        cfg, img, frame_ms, launches = drive(sm, "main", scene, build_s,
                                             2, 32)
        k_ms, p_ms = kernel_and_postpass_ms(scene, cfg, 20)
        n = cfg.width * cfg.height
        bound_ms, bound_by, term = mxu_bound(scene, cfg, n)
        print(f"[main] kernel_ms={k_ms:.4f} postpass_ms={p_ms:.4f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}: {term}) "
              f"dynamic_smem_bytes={mxu_smem_bytes(scene)}", flush=True)
        out_png = build.BUILD_DIR / "chip_smoke_scene3.png"
        out_png.parent.mkdir(parents=True, exist_ok=True)
        save_png(out_png, img.cpu().numpy()[::-1])
        print(f"[main] image written to {out_png.relative_to(ROOT)}",
              flush=True)
    with sm.phase("profile"):
        phase_profile(scene, cfg, 4, frame_ms)

    with sm.phase("wide"):
        wide, wbuild_s = build_scene(dragon_grid(grid_k))
        wcfg, _, wide_ms, _ = drive(sm, "wide", wide, wbuild_s, 0, 8)
        wk_ms, wp_ms = kernel_and_postpass_ms(wide, wcfg, 5)
        wb_ms, wb_by, wterm = mxu_bound(wide, wcfg, n)
        print(f"[wide] kernel_ms={wk_ms:.4f} postpass_ms={wp_ms:.4f} "
              f"bound_ms={wb_ms:.5f} ({wb_by}: {wterm}) "
              f"dynamic_smem_bytes={mxu_smem_bytes(wide)}", flush=True)
        del wide

    with sm.phase("plain"):
        # the plain version at the main path's shape, and its image
        # against the kernel's (frame 1, same rays)
        camf = _pack_camera(Camera().spec(cfg.width, cfg.height),
                            scene.device)
        tabs = side_tables(scene)
        plain_ms = cuda_ms(
            lambda: mxu_trace_plain(scene, tabs, camf, 1, 0, n, cfg), 3)
        p_out = mxu_trace_plain(scene, tabs, camf, 1, 0, n, cfg)
        k_img = render_dispatch(scene, Camera().spec(cfg.width, cfg.height),
                                1, cfg)
        p_img = slots_to_image(mega_postpass(p_out[0].T, p_out[1], p_out[2],
                                             scene, cfg, n), cfg.width,
                               cfg.height)
        msg = images_close(k_img.cpu().numpy(), p_img.cpu().numpy())
        print(f"[plain] scene3 {cfg.width}x{cfg.height} {cfg.max_bounces} "
              f"bounces: plain_ms={plain_ms:.3f} "
              f"kernel_ms={k_ms:.4f} frame-1 images_close="
              f"{'ok' if msg is None else msg}", flush=True)
        sm.check(msg is None, f"main-path frame vs plain version: {msg}")

    with sm.phase("trav"):
        tcfg, timg, trav_ms, trav_launches = drive(
            sm, "trav", tscene, tbuild_s, TRAV_WARM, TRAV_TIMED,
            backend_expected="trav")
        tk_ms, tk1_ms, tp_ms, tout, tcamf = trav_kernel_and_postpass_ms(
            tscene, tcfg, 5)
        tstats = tout[3]
        tb_ms, tb_by = trav_bound(tscene, tcfg, tstats, n)
        ray_bounces = n * tcfg.max_frames * tcfg.max_bounces
        tm = tscene.trav_meta
        print(f"[trav] nodes={tm.n_nodes} leaves={tm.n_leaves} "
              f"leaf_k={tm.leaf_k} kernel_ms={tk_ms:.4f} "
              f"kernel_ms_1_bounce={tk1_ms:.4f} "
              f"postpass_ms={tp_ms:.4f} bound_ms={tb_ms:.5f} ({tb_by}) "
              f"node_visits/ray-bounce="
              f"{int(tstats[0].sum()) / ray_bounces:.4f} "
              f"tri_tests/ray-bounce={int(tstats[1].sum()) / ray_bounces:.4f}"
              f" (per dispatched ray-bounce, W*H*spp*bounces)", flush=True)
        out_png = build.BUILD_DIR / f"chip_smoke_dragon_grid{TRAV_GRID}.png"
        save_png(out_png, timg.cpu().numpy()[::-1])
        print(f"[trav] image written to {out_png.relative_to(ROOT)}",
              flush=True)
    with sm.phase("trav-profile"):
        phase_profile(tscene, tcfg, 4, trav_ms, tag="trav-profile")
    with sm.phase("trav-plain"):
        trav_plain_ms, plain_err, live = phase_trav_plain(
            sm, tscene, tcfg, tout, tcamf)
        trav_err = max(trav_err, plain_err)
        print(f"[trav-plain] dragon_grid{TRAV_GRID} {tcfg.width}x"
              f"{tcfg.height} {tcfg.max_bounces} bounces: plain_ms="
              f"{trav_plain_ms:.3f} kernel_ms={tk_ms:.4f}", flush=True)
        print(f"[trav] per live ray-bounce (rays alive at the bounce's "
              f"start, from [trav-plain]'s alive masks): live_ray_bounces="
              f"{live} of {ray_bounces} node_visits/live="
              f"{int(tstats[0].sum()) / max(live, 1):.4f} tri_tests/live="
              f"{int(tstats[1].sum()) / max(live, 1):.4f}", flush=True)
        sm.check(0 < live <= ray_bounces, f"trav live ray-bounces {live}")

    with sm.phase("sweep-compare"):
        wide, _ = build_scene(dragon_grid(grid_k))
        bands = [(name, sc, record_bands(sc, COMPARE_RES, MAIN_BOUNCES))
                 for name, sc in (("scene3", scene),
                                  (f"dragon_grid{grid_k}", wide),
                                  (f"dragon_grid{TRAV_GRID}", tscene))]
        sweep_err = phase_sweep_compare(sm, bands)
    with sm.phase("intersect-compare"):
        isect_err = phase_intersect_compare(sm, bands)
        del wide, bands
    with sm.phase("wf2"):
        (wcfg, wf2_ms, wf2_launches, wk_ms, wplain_ms, wb_ms, wb_by,
         wf2_err) = phase_wf2(sm, tscene, tbuild_s)
        sweep_err = max(sweep_err, wf2_err)
        phase_wf2_vs_xla(sm, tscene)
    with sm.phase("wf2-profile"):
        phase_profile(tscene, wcfg, 2, wf2_ms, tag="wf2-profile",
                      backend="wavefront2")
    with sm.phase("pallas"):
        (pal_ms, pal_launches, pk_ms, pplain_ms, pb_ms, pb_by,
         pal_err) = phase_pallas(sm, scene, build_s, tscene)
        isect_err = max(isect_err, pal_err)
    with sm.phase("grad"):
        phase_grad(sm, scene, img)
    with sm.phase("inverse"):
        phase_inverse(sm, scene)
    with sm.phase("soft"):
        phase_soft(sm, scene, img)

    with sm.phase("mega-compare"):
        wide, _ = build_scene(dragon_grid(grid_k))
        scene2, _ = build_scene(load_scene(2))
        mega_err = phase_mega_compare(sm, [
            ("scene3", scene, 1, True, "static"),
            ("scene3", scene, 1, True, "near"),
            ("scene2", scene2, 2, True, "static"),
            (f"dragon_grid{grid_k}", wide, 1, True, "static"),
            (f"dragon_grid{grid_k}", wide, 1, True, "near"),
            (f"dragon_grid{grid_k}", wide, 1, False, "static")])
        del wide, scene2
    with sm.phase("mega"):
        (mcfg, mega_ms, mega_launches, mk_ms, mplain_ms, mb_ms, mb_by,
         err_m) = phase_mega(sm, scene, build_s)
        mega_err = max(mega_err, err_m)
    with sm.phase("mega-profile"):
        phase_profile(scene, mcfg, 4, mega_ms, tag="mega-profile",
                      backend="megakernel")
    with sm.phase("mega-big"):
        bcfg, big_ms = phase_mega_big(sm, tscene, tbuild_s)
    with sm.phase("mega-big-profile"):
        phase_profile(tscene, bcfg, 2, big_ms, tag="mega-big-profile",
                      backend="megakernel")
    with sm.phase("shard-band"):
        phase_shard_band(sm, scene, tscene)
        del tscene
    with sm.phase("mega-auto"):
        ascene, acfg, auto_ms = phase_mega_auto(sm)
    with sm.phase("mega-auto-profile"):
        phase_profile(ascene, acfg, 2, auto_ms, tag="mega-auto-profile")
        del ascene
    with sm.phase("cli"):
        phase_cli(sm)
    with sm.phase("editor"):
        phase_editor(sm)
    with sm.phase("view"):
        phase_view(sm)
    with sm.phase("shard-nccl"):
        refs = shard_refs(scene)
        phase_shard_world(sm, "shard-nccl", 1, "nccl", refs, ("mxu",), card)
    with sm.phase("shard-gloo"):
        phase_shard_world(sm, "shard-gloo", SHARD_GLOO_WORLD, "gloo", refs,
                          ("mxu", "wavefront2"), card)

    record = {"kernels": [{
        "name": "mxu_trace",
        "route": "cuda",
        "source": "rtm_tpu_torch/csrc/mxu_trace.cu",
        "replaces": "rtm_tpu/ops/pallas/mxu_kernel.py:248",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "trav_trace",
        "route": "cuda",
        "source": "rtm_tpu_torch/csrc/trav_trace.cu",
        "replaces": "rtm_tpu/ops/pallas/trav_kernel.py:429",
        "launches": trav_launches,
        "max_abs_err": trav_err,
        "ms": tk_ms,
        "plain_ms": trav_plain_ms,
        "bound_ms": tb_ms,
        "bound_by": tb_by,
        "library_ms": None,
    }, {
        "name": "cluster_sweep",
        "route": "cuda",
        "source": "rtm_tpu_torch/csrc/cluster_sweep.cu",
        "replaces": "rtm_tpu/ops/pallas/sweep_kernel.py:43",
        "launches": wf2_launches,
        "max_abs_err": sweep_err,
        "ms": wk_ms,
        "plain_ms": wplain_ms,
        "bound_ms": wb_ms,
        "bound_by": wb_by,
        "library_ms": None,
    }, {
        "name": "intersect_sweep",
        "route": "cuda",
        "source": "rtm_tpu_torch/csrc/intersect_sweep.cu",
        "replaces": "rtm_tpu/ops/pallas/intersect_kernel.py:92",
        "launches": pal_launches,
        "max_abs_err": isect_err,
        "ms": pk_ms,
        "plain_ms": pplain_ms,
        "bound_ms": pb_ms,
        "bound_by": pb_by,
        "library_ms": None,
    }, {
        "name": "mega_trace",
        "route": "cuda",
        "source": "rtm_tpu_torch/csrc/mega_trace.cu",
        "replaces": "rtm_tpu/ops/pallas/megakernel.py:598",
        "launches": mega_launches,
        "max_abs_err": mega_err,
        "ms": mk_ms,
        "plain_ms": mplain_ms,
        "bound_ms": mb_ms,
        "bound_by": mb_by,
        "library_ms": None,
    }]}
    print(f"[total] run_s={time.perf_counter() - run_t0:.2f}", flush=True)
    print(json.dumps(record), flush=True)
    if sm.failures:
        print(f"chip_smoke: {len(sm.failures)} check(s) failed: "
              + "; ".join(sm.failures), file=sys.stderr)
        return 1
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
