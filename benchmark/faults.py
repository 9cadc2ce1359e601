"""The control and the planted faults that the check must catch.

Each entry patches the program for the length of a `with` block:
  * control: the plain reference computed in bfloat16 (the precision
    below the configurations' float32) put in the program's place: every
    dispatch (spp4, interactive) or every loss and gradient (fit);
  * unchanged: a step that leaves its state as it was (the accumulation
    is not written; Adam does not move the parameters);
  * half: half of the work left out and the mean taken over the rest
    (half the samples of a dispatch, or of a 1-sample frame half the
    rows; the loss over half the rows);
  * altered: an answer altered where it is produced (one row in 16 of
    each dispatch, or of the fit's rendered image, scaled by 1.05);
  * stale (fit alone): the window's steps reuse the RNG stream of the
    last set-up step, which the reference follows, where each step should
    draw a new one; a fault in the window alone.
There is one card in each cell, so no exchange between chips to leave out.

`python3 benchmark/faults.py --workload W --seeds a,b,c --seconds S
--mode M` runs the harness once per seed with mode M planted and prints
each run's numbers and `correct`: the readings the limits are set from.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import types
from pathlib import Path

MODES = ("none", "control", "unchanged", "half", "altered", "stale")


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _reference_dispatch(ctx, dtype):
    """render_dispatch computed by the reference in `dtype`."""
    import torch

    from benchmark.reference import render as R

    sc = R.Scene(ctx.tables, ctx.device, dtype)

    def dispatch(scene, cam, frame_index, cfg, backend="auto", **kw):
        pos = cam.position.detach().float().cpu().numpy()
        camd = dict(ctx.desc.camera, position=[float(v) for v in pos])
        x = torch.arange(cfg.width * cfg.height, device=ctx.device)
        out = R.trace(sc, camd, cfg.width, cfg.height, x % cfg.width,
                      x // cfg.width, torch.full_like(x, frame_index),
                      cfg.max_frames, cfg.max_bounces, cfg.draw_environment)
        return out.float().reshape(cfg.height, cfg.width, 3)
    return dispatch


def _reference_loss_and_grad(ctx, dtype):
    """loss_and_grad computed by the reference in `dtype`."""
    import torch

    from benchmark.loops.fit import MAT_COLS
    from benchmark.reference import render as R

    sc = R.Scene(ctx.tables, ctx.device, dtype)
    leaves = ctx.traffic["leaves"]

    def loss_and_grad(params, scene, cam, target, frame_index, cfg,
                      *a, **kw):
        from rtm_tpu_torch import SceneParams

        vals = {f: getattr(params, f).detach().to(dtype).requires_grad_()
                for f in leaves}
        cols = list(sc.mat.unbind(1))
        for f, p in vals.items():
            s = MAT_COLS[f]
            if isinstance(s, int):
                cols[s] = p
            else:
                for j in range(s.stop - s.start):
                    cols[s.start + j] = p[:, j]
        x = torch.arange(cfg.width * cfg.height, device=ctx.device)
        img = R.trace(sc, ctx.desc.camera, cfg.width, cfg.height,
                      x % cfg.width, x // cfg.width,
                      torch.full_like(x, frame_index), cfg.max_frames,
                      cfg.max_bounces, cfg.draw_environment,
                      mat=torch.stack(cols, 1))
        loss = ((img - target.reshape(-1, 3).to(dtype)) ** 2).mean()
        gs = dict(zip(leaves, torch.autograd.grad(loss, list(vals.values()))))
        out = {f.name: (gs[f.name].float() if f.name in gs else
                        torch.zeros_like(getattr(params, f.name)))
               for f in dataclasses.fields(SceneParams)}
        return loss.detach().float(), SceneParams(**out)
    return loss_and_grad


@contextlib.contextmanager
def planted(mode: str, ctx_holder: dict):
    """Plant `mode` in the program.  ctx_holder["ctx"] is the run's
    Context, which the harness hands to `on_context` before the loop runs
    (the control needs its scene description)."""
    if mode == "none":
        yield
        return
    import torch

    import rtm_tpu_torch.diff.inverse as inv
    import rtm_tpu_torch.ops.trace_ref as tref
    import rtm_tpu_torch.runtime.renderer as rend

    orig_dispatch = rend.render_dispatch
    with contextlib.ExitStack() as stack:
        if mode == "control":
            made = {}

            def lazy(make):
                def call(*a, **kw):
                    if make not in made:
                        made[make] = make(ctx_holder["ctx"], torch.bfloat16)
                    return made[make](*a, **kw)
                return call
            lazy_dispatch = lazy(_reference_dispatch)
            lazy_lag = lazy(_reference_loss_and_grad)
            stack.enter_context(patched(rend, "render_dispatch",
                                        lazy_dispatch))
            stack.enter_context(patched(inv, "loss_and_grad", lazy_lag))
        elif mode == "unchanged":
            def still(scene, cam, accum, frame_index, cfg, backend="auto"):
                return accum, accum / float(frame_index)
            stack.enter_context(patched(rend, "accumulate_step", still))
            stack.enter_context(patched(torch.optim.Adam, "step",
                                        lambda self, closure=None: None))
        elif mode == "half":
            def half(scene, cam, frame_index, cfg, backend="auto", **kw):
                if cfg.max_frames > 1:
                    cfg = dataclasses.replace(cfg,
                                              max_frames=cfg.max_frames // 2)
                    return orig_dispatch(scene, cam, frame_index, cfg,
                                         backend=backend)
                img = orig_dispatch(scene, cam, frame_index, cfg,
                                    backend=backend)
                img[1::2] = img[0::2][:img[1::2].shape[0]]
                return img
            stack.enter_context(patched(rend, "render_dispatch", half))
            stack.enter_context(patched(inv, "render_loss", _half_rows(
                inv.render_loss)))
        elif mode == "altered":
            def altered(*a, **kw):
                img = orig_dispatch(*a, **kw)
                img[::16] = img[::16] * 1.05
                return img
            orig_replay = tref.render_mxu_replay

            def altered_replay(*a, **kw):
                img = orig_replay(*a, **kw)
                scale = torch.ones_like(img)
                scale[::16] = 1.05
                return img * scale
            stack.enter_context(patched(rend, "render_dispatch", altered))
            stack.enter_context(patched(tref, "render_mxu_replay",
                                        altered_replay))
        elif mode == "stale":
            orig_lag = inv.loss_and_grad

            def stale(params, scene, cam, target, frame_index, *a, **kw):
                last = ctx_holder["ctx"].traffic["warm_steps"]
                return orig_lag(params, scene, cam, target,
                                min(frame_index, last), *a, **kw)
            stack.enter_context(patched(inv, "loss_and_grad", stale))
        else:
            raise ValueError(f"unknown mode {mode!r}")
        yield


def _half_rows(render_loss):
    """render_loss over the even rows of the image alone: the mean of
    the squared error taken over half the pixels."""
    import rtm_tpu_torch.ops.trace_ref as tref

    def loss(params, scene, cam, target, frame_index, cfg, backend="xla",
             *a, **kw):
        orig = tref.render_mxu_replay

        def even_rows(*ra, **rk):
            img = orig(*ra, **rk)
            return img[0::2]
        with patched(tref, "render_mxu_replay", even_rows):
            return render_loss(params, scene, cam, target[0::2],
                               frame_index, cfg, backend, *a, **kw)
    return loss


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=3)
    ap.add_argument("--mode", choices=MODES, default="control")
    args = ap.parse_args()
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from benchmark import harness

    holder = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        a = types.SimpleNamespace(workload=args.workload, seed=seed,
                                  seconds=args.seconds, trace=0)
        with planted(args.mode, holder):
            res = harness.run(a, time.perf_counter(), root,
                              on_context=lambda c: holder.update(ctx=c))
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
