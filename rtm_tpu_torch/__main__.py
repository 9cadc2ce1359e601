"""CLI entry — `python -m rtm_tpu_torch <command>`.

Port of rtm_tpu/__main__.py.  The reference's startup chain
(EntryPoint.h:6-9 -> Startup.cpp:18-52) launches a windowed app; this
framework is headless-first, so the entry point is a CLI (SURVEY C1):

  render      render a scene to PNG (progressive accumulation)
  measure     orbit-camera perf sweep -> Measure.txt (C29 parity)
  viewperf    summarize/plot a Measure.txt (viewPerf.py parity)
  scenes      list built-in scenes
  save-scene  export a built-in scene to the .rtm.json format
  optimize    inverse-rendering demo (Adam on scene params vs a target)
  view        browser viewer: progressive render + scene editor over HTTP
  bench       headline throughput, one JSON line (bench/headline.py)

Commands run on the card; `--device cpu` asks for the CPU, where the
kernels' plain versions run.  Without a CUDA device and without
`--device cpu` a command exits non-zero with a message.
"""
from __future__ import annotations

import argparse
import sys


def _add_render_args(p):
    p.add_argument("--scene", type=int, default=3, help="built-in scene 1-5")
    p.add_argument("--scene-file", default=None,
                   help="load a saved .rtm.json scene instead of --scene")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--bounces", type=int, default=8,
                   help="MaxBounces (reference UI range 1-15)")
    p.add_argument("--spp", type=int, default=1,
                   help="samples per dispatch (reference MaxFrames, 1-5)")
    p.add_argument("--frames", type=int, default=16,
                   help="progressive accumulation dispatches")
    p.add_argument("--no-environment", action="store_true",
                   help="disable sky lighting (DrawEnvironment=0)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "pallas", "mxu", "trav",
                            "megakernel", "wavefront2"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to render: the card (default), or the CPU "
                        "(the kernels' plain versions) when asked")
    p.add_argument("--debug", type=int, default=0,
                   help="debug visualization (ref Debug uniform, "
                        "RayTracing.cpp:130-133): 1 = cluster-passes "
                        "heatmap (cull effectiveness, the analog of the "
                        "shader's BVH-depth views)")
    p.add_argument("--env", default="map", choices=("map", "sun"),
                   help="environment model: equirect sky map, or the "
                        "legacy kernel's procedural sun/sky "
                        "(OldRayTracing.shader:119-136)")
    p.add_argument("--check-nans", action="store_true",
                   help="numeric validation layer (SURVEY §5.2): per-bounce "
                        "finiteness checks in the reference renderer + "
                        "finite output assertion")


class DeviceUnavailable(RuntimeError):
    pass


def _device(args):
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; pass --device cpu to run on the "
            "CPU (the kernels' plain versions)")
    return torch.device(args.device)


def _setup(args, want_host_scene: bool = False):
    from rtm_tpu_torch import (Camera, RenderConfig, build_tracer_scene,
                               load_scene)
    from rtm_tpu_torch.ops.trace_ref import auto_backend

    dev = _device(args)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_bounces=args.bounces, max_frames=args.spp,
                       draw_environment=not args.no_environment)
    cam = Camera()
    if getattr(args, "scene_file", None):
        from rtm_tpu_torch.io.scene_io import load_scene_file
        host, file_cam, _ = load_scene_file(args.scene_file)
        if file_cam is not None:
            cam = file_cam
    else:
        host = load_scene(args.scene)
    scene = build_tracer_scene(host, env_model=getattr(args, "env", "map"),
                               device=dev)
    backend = args.backend
    if backend == "auto":
        backend = auto_backend(scene, dev.type)
    if want_host_scene:
        return scene, cam, cfg, backend, host
    return scene, cam, cfg, backend


def _debug_heatmap(args, scene, cam, cfg) -> int:
    """Mode 1: the cluster-passes-per-ray heatmap of the wavefront2 sweep,
    the direct measure of tile-uniform cull effectiveness (reference Debug
    uniform feeding BVH-depth / box heatmaps, RayTracing.cpp:130-133,
    RayTracing.shader:345-374)."""
    import numpy as np
    import torch

    from rtm_tpu_torch.io.image import save_png
    from rtm_tpu_torch.ops.kernels.megakernel import pixel_to_slot, use_block8
    from rtm_tpu_torch.ops.wavefront2 import render_rays_wavefront2

    with torch.no_grad():
        _, passes = render_rays_wavefront2(
            scene, cam.spec(cfg.width, cfg.height, device=scene.device), 1,
            cfg, pixel_offset=0, n_rays=cfg.num_pixels, debug_passes=True)
    passes = passes.cpu().numpy().astype(np.float32)
    if use_block8(cfg.width, cfg.height):
        p = np.arange(cfg.num_pixels, dtype=np.int64)
        passes = passes[pixel_to_slot(p, cfg.width)]
    hm = passes.reshape(cfg.height, cfg.width)
    t = hm / max(hm.max(), 1.0)
    # blue (cheap) -> red (expensive) ramp
    img = np.stack([t, 0.25 + 0.5 * np.abs(t - 0.5), 1.0 - t], axis=-1)
    save_png(args.out, img[::-1])
    print(f"wrote {args.out}  (debug={args.debug}: cluster-pass heatmap, "
          f"max {int(hm.max())} passes over {cfg.max_bounces} bounces, "
          f"mean {hm.mean():.1f})")
    return 0


def cmd_render(args) -> int:
    import torch

    from rtm_tpu_torch.io.image import save_png
    from rtm_tpu_torch.runtime.renderer import render_progressive

    scene, cam, cfg, backend = _setup(args)
    if args.debug:
        return _debug_heatmap(args, scene, cam, cfg)
    spec = cam.spec(cfg.width, cfg.height, device=scene.device)
    if args.check_nans and backend == "xla":
        from rtm_tpu_torch.utils.guards import checked_render_dispatch
        # instrumented first frame: names the first bad bounce and tensor
        with torch.no_grad():
            checked_render_dispatch(scene, spec, 1, cfg)
    with torch.no_grad():
        img = render_progressive(scene, spec, cfg, args.frames,
                                 backend=backend)
    if args.check_nans:
        from rtm_tpu_torch.utils.guards import assert_image_finite
        assert_image_finite(img)
    save_png(args.out, img.cpu().numpy()[::-1])  # row 0 looks down
    print(f"wrote {args.out}  ({cfg.width}x{cfg.height}, {args.frames} "
          f"frames, backend={backend}, device={scene.device.type})")
    return 0


def cmd_measure(args) -> int:
    import torch

    from rtm_tpu_torch.bench.measure import run_measure, summarize

    scene, cam, cfg, backend = _setup(args)
    with torch.no_grad():
        arr = run_measure(scene, cfg, out_path=args.out, radius=args.radius,
                          backend=backend, camera=cam)
    stats = summarize(arr)
    print(f"Mean: {stats['mean_fps']}")
    print(f"Max: {stats['max_fps']}")
    print(f"Min: {stats['min_fps']}")
    return 0


def cmd_viewperf(args) -> int:
    from rtm_tpu_torch.bench.view_perf import main as vp
    vp(args.file, plot=not args.no_plot, save=args.save)
    return 0


def cmd_scenes(args) -> int:
    from rtm_tpu_torch.models.scenes import SCENES
    for sid, fn in sorted(SCENES.items()):
        doc = (fn.__doc__ or "").splitlines()[0]
        print(f"{sid}: {doc}")
    return 0


def cmd_view(args) -> int:
    """Serve the browser viewer until Ctrl-C: a progressive renderer on the
    chosen device and backend (auto re-resolves after every edit) with the
    scene editor attached."""
    import dataclasses

    from rtm_tpu_torch.runtime.renderer import ProgressiveRenderer
    from rtm_tpu_torch.viewer import ViewerServer

    scene, cam, cfg, _, host = _setup(args, want_host_scene=True)
    cfg = dataclasses.replace(cfg, accumulate=True)   # progressive viewer
    renderer = ProgressiveRenderer(scene, cam, cfg, backend=args.backend)
    server = ViewerServer(renderer, port=args.port, host_scene=host,
                          scene_id=args.scene)
    print(f"viewer: http://127.0.0.1:{server.port}  (device="
          f"{scene.device.type}, backend={args.backend}; Ctrl-C to stop)",
          flush=True)
    server.start(block=True)
    return 0


def cmd_save_scene(args) -> int:
    """Export a built-in scene to the .rtm.json format (editable, reloadable
    via --scene-file on any command)."""
    from rtm_tpu_torch import Camera, load_scene
    from rtm_tpu_torch.io.scene_io import save_scene

    path = save_scene(args.out, load_scene(args.scene), camera=Camera())
    print(f"wrote {path}")
    return 0


def cmd_optimize(args) -> int:
    """Self-demo of BASELINE config 5: render a target with the true scene,
    perturb the float parameters, recover them by Adam descent."""
    import torch

    from rtm_tpu_torch.diff.inverse import InverseRenderConfig, inverse_render
    from rtm_tpu_torch.diff.params import apply_params, extract_params
    from rtm_tpu_torch.io.image import save_png
    from rtm_tpu_torch.ops.trace_ref import render_dispatch

    scene, cam, cfg, _ = _setup(args)
    spec = cam.spec(cfg.width, cfg.height, device=scene.device)
    with torch.no_grad():
        target = render_dispatch(scene, spec, 1, cfg, backend="xla")
    init = extract_params(scene).map(
        lambda t: t * 0.7 + 0.1 if t.dtype == torch.float32 else t)
    opt_cfg = InverseRenderConfig(steps=args.steps, learning_rate=args.lr)
    params, losses = inverse_render(scene, spec, target, cfg, opt_cfg,
                                    init_params=init)
    print(f"optimize: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({args.steps} steps)")
    if args.out:
        with torch.no_grad():
            img = render_dispatch(apply_params(scene, params), spec, 1, cfg,
                                  backend="xla")
        save_png(args.out, img.cpu().numpy()[::-1])
    return 0


def cmd_bench(args) -> int:
    """bench.py's headline on the port: one JSON line on stdout, its
    knobs in RTM_BENCH_* environment variables (bench/headline.py)."""
    import json

    from rtm_tpu_torch.bench.headline import run

    print(json.dumps(run(_device(args))), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rtm_tpu_torch",
        description="differentiable progressive path tracer on NVIDIA GPUs")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(p)
    p.add_argument("--out", default="render.png")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="headline throughput (one JSON line)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default), or the CPU when asked")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("measure", help="orbit perf sweep -> Measure.txt")
    _add_render_args(p)
    p.add_argument("--out", default="Measure.txt")
    p.add_argument("--radius", type=float, default=2.0)
    p.set_defaults(fn=cmd_measure)

    p = sub.add_parser("viewperf", help="summarize/plot Measure.txt")
    p.add_argument("file", nargs="?", default="Measure.txt")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--save", default=None, help="save plot PNG")
    p.set_defaults(fn=cmd_viewperf)

    p = sub.add_parser("scenes", help="list built-in scenes")
    p.set_defaults(fn=cmd_scenes)

    p = sub.add_parser("save-scene", help="export a scene to .rtm.json")
    p.add_argument("--scene", type=int, default=3)
    p.add_argument("--out", default="scene.rtm.json")
    p.set_defaults(fn=cmd_save_scene)

    p = sub.add_parser("view", help="browser viewer with scene editor")
    _add_render_args(p)
    p.add_argument("--port", type=int, default=8654)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("optimize", help="inverse-rendering demo")
    _add_render_args(p)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_optimize)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except DeviceUnavailable as e:
        print(f"rtm_tpu_torch {args.command}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
