"""Fitting materials and lights to a target image with Adam: one user,
closed loop, one `inverse_render` call.

Traffic keys: `backend`, `remat`, `spp`, `leaves` (the material fields
fitted; everything else is frozen through `param_mask`), `perturb`
(each fitted entry starts at value * u + offset, u drawn from the seed in
`scale`), `target_spp` and `learning_rate`, `check_steps`,
`warm_steps`, `trace_seconds`.

Set-up renders the target with the plain reference (the unperturbed
scene, `target_spp` samples, an accumulation counter drawn from the
seed), builds the scene, and starts `inverse_render` (a new RNG stream per
step); its first `warm_steps` steps run in set-up, and the window is the
same call's following steps until `--seconds` have passed, stopped through
its callback.  fit_step_ms = window seconds / steps completed in it.

The check: the reference follows the first `check_steps` steps from the
same start (its own renderer, autograd and Adam): the first step's
gradient as the optimizer got it, and the change of the fitted parameters
after the last checked step, both per leaf (a leaf whose reference
gradient is under a thousandth of the median leaf's is left out).  Each
of those steps' losses, and that of one step of the window drawn from
the seed (a reservoir sample over the window's steps), is held to the
loss the reference works out from the fitted parameters that the step
started from, at the step's own frame index: loss_gap.  Losses along the
reference's own trajectory are not compared: from the second step on
they carry Adam's first moves of entries whose gradients are all but
zero, which one path that the kernel and the reference trace apart can
flip (PERF.md gives the readings); change_gap holds the trajectory.  The
window step's gradient is not compared either, for the same cause.
"""
from __future__ import annotations

import numpy as np

from benchmark import program
from benchmark.loops import Outcome

# columns of the reference's material rows (reference/scene.py Tables.mat)
MAT_COLS = {"albedo": slice(0, 3), "emission_color": slice(3, 6),
            "roughness": 6, "metallic": 7, "emission_power": 8}


class Stop(Exception):
    """Raised from the callback when the window's time is up."""


def start_values(ctx) -> dict:
    """The fitted leaves' starting values (NumPy f32), drawn from the
    seed."""
    tr = ctx.traffic
    rng = ctx.rng(1)
    lo, hi = tr["perturb"]["scale"]
    out = {}
    for leaf in tr["leaves"]:
        v = ctx.tables.mat[:, MAT_COLS[leaf]]
        u = rng.uniform(lo, hi, v.shape).astype(np.float32)
        out[leaf] = (v * u + np.float32(tr["perturb"]["offset"])).astype(
            np.float32)
    return out


def target_frame_index(ctx) -> int:
    return 1_000_000 + int(ctx.rng(2).integers(1_000_000))


def make_target(ctx, sc):
    """The reference's render of the unperturbed scene, (H, W, 3)."""
    from benchmark.loops import reference_image

    r = ctx.desc.render
    img = reference_image(ctx, sc, ctx.desc.camera, ctx.traffic["target_spp"],
                          target_frame_index(ctx))
    return img.reshape(r["height"], r["width"], 3)


def run(ctx) -> Outcome:
    import torch
    from rtm_tpu_torch import (InverseRenderConfig, build_tracer_scene,
                               extract_params, inverse_render)

    from benchmark.reference import render as R

    tr, r = ctx.traffic, ctx.desc.render
    with ctx.span("reference_target"):
        sc = R.Scene(ctx.tables, ctx.device)
        target_np = make_target(ctx, sc)
        del sc
    if ctx.on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with ctx.span("scene_build"):
        ts = build_tracer_scene(program.port_scene(ctx.desc),
                                device=ctx.device)
        ctx.sync()
    cfg = program.render_config(r, tr["spp"])
    cam = program.port_camera(ctx.desc.camera).spec(
        cfg.width, cfg.height, device=ctx.device)
    target = torch.from_numpy(target_np).to(ctx.device)
    start = start_values(ctx)
    p0 = extract_params(ts)
    fields = {f: getattr(p0, f) for f in p0.fields()}
    for leaf, v in start.items():
        fields[leaf] = torch.tensor(v, device=ctx.device)
    p0 = type(p0)(**fields)
    mask = type(p0)(**{f: (torch.ones_like(t) if f in start else
                           torch.zeros_like(t)) for f, t in fields.items()})
    opt = InverseRenderConfig(steps=10 ** 9,
                              learning_rate=tr["learning_rate"],
                              remat=tr["remat"], backend=tr["backend"],
                              rebuild_tri_geometry=False, vary_seed=True)

    seen = {"losses": [], "befores": [start], "grad": None, "after": None,
            "next": None, "window": None}
    clock = {"t0": None, "window_steps": 0, "t_end": None, "prof": None,
             "t2": None, "traced": 0}
    warm, n_check = tr["warm_steps"], tr["check_steps"]
    pick = ctx.rng(5)
    t_first = ctx.clock()

    def draw(i, params):
        """Whether step i + 1, the window's n-th, becomes the window step
        checked (probability 1/n); if so, keep the fitted parameters it
        starts from (device copies, no wait)."""
        if pick.integers(clock["window_steps"] + 1) == 0:
            seen["next"] = (i + 1, {f: getattr(params, f).detach().clone()
                                    for f in start})

    def callback(i, loss, params):
        now = ctx.clock()
        if i == 0:
            ctx.split["first_step_s"] = now - t_first
            seen["grad"] = {f: getattr(params, f).grad.detach().cpu().numpy()
                            .copy() for f in start}
        if i < n_check:
            seen["losses"].append(loss)
        if i < n_check - 1:
            seen["befores"].append({f: getattr(params, f).detach().cpu()
                                    .numpy().copy() for f in start})
        if i == n_check - 1:
            seen["after"] = {f: getattr(params, f).detach().cpu().numpy()
                             .copy() for f in start}
        if seen["next"] is not None and seen["next"][0] == i:
            seen["window"] = (i, seen["next"][1], loss)
            seen["next"] = None
        if i == warm - 1:
            clock["t0"] = ctx.open_window()
            draw(i, params)
            return
        if clock["t0"] is None:
            return
        if clock["t_end"] is None:
            clock["window_steps"] += 1
            if now - clock["t0"] < ctx.seconds:
                draw(i, params)
            else:
                clock["t_end"] = now
                if not ctx.trace:
                    raise Stop
                from benchmark.devtrace import Profiler

                clock["prof"] = Profiler()
                clock["prof"].start()
                clock["t2"] = ctx.clock()
            return
        clock["traced"] += 1
        if now - clock["t2"] >= tr["trace_seconds"]:
            ctx.sync()
            ctx.trace_data = clock["prof"].stop(units=clock["traced"])
            ctx.work.update(traced=clock["traced"],
                            trace_events=clock["prof"].events)
            raise Stop

    try:
        inverse_render(ts, cam, target, cfg, opt, init_params=p0,
                       param_mask=mask, callback=callback)
    except Stop:
        pass
    steps = clock["window_steps"]
    j, before, loss = seen["window"]
    seen["window"] = (j, {f: v.cpu().numpy() for f, v in before.items()},
                      loss)
    ctx.work.update(steps=steps, window_s=clock["t_end"] - clock["t0"],
                    checked_window_step=j)
    e2e = {"fit_step_ms": (clock["t_end"] - clock["t0"]) / steps * 1e3}
    state = {"ts": ts, "target": target}

    def release():
        state.clear()

    def check():
        return fit_check(ctx, target_np, start, seen)

    return Outcome(e2e=e2e, attempted=steps, check=check, release=release)


class Reference:
    """The reference's fitting arithmetic on the cell's scene: its own
    renderer and autograd over the fitted material columns."""

    def __init__(self, ctx, target_np, dtype=None):
        import torch

        from benchmark.reference import render as R

        self.ctx, self.dtype = ctx, dtype or torch.float32
        r = ctx.desc.render
        self.w, self.h = r["width"], r["height"]
        self.sc = R.Scene(ctx.tables, ctx.device, self.dtype)
        self.target = torch.from_numpy(target_np).to(
            ctx.device, self.dtype).reshape(-1, 3)
        lin = torch.arange(self.w * self.h, device=ctx.device)
        self.x, self.y = lin % self.w, lin // self.w

    def leaves(self, values: dict) -> dict:
        import torch

        return {f: torch.tensor(v, device=self.ctx.device,
                                dtype=self.dtype).requires_grad_()
                for f, v in values.items()}

    def loss_of(self, leaves: dict, frame_index: int):
        """One step's loss at `frame_index` from the fitted `leaves`."""
        import torch

        from benchmark.reference import render as R

        tr, r = self.ctx.traffic, self.ctx.desc.render
        cols = list(self.sc.mat.unbind(1))
        for f, p in leaves.items():
            s = MAT_COLS[f]
            if isinstance(s, int):
                cols[s] = p
            else:
                for j in range(s.stop - s.start):
                    cols[s.start + j] = p[:, j]
        img = R.trace(self.sc, self.ctx.desc.camera, self.w, self.h, self.x,
                      self.y, torch.full_like(self.x, frame_index),
                      tr["spp"], r["max_bounces"], r["draw_environment"],
                      mat=torch.stack(cols, 1))
        return ((img - self.target) ** 2).mean()

    def steps(self, start: dict, steps: int):
        """The first `steps` Adam steps from `start`: (losses, first
        gradients, fitted values after the last step), NumPy."""
        import torch

        leaves = self.leaves(start)
        adam = {f: [torch.zeros_like(v), torch.zeros_like(v)]
                for f, v in leaves.items()}
        lr, b1, b2, eps = self.ctx.traffic["learning_rate"], 0.9, 0.999, 1e-8
        losses, first = [], None
        for i in range(steps):
            loss = self.loss_of(leaves, 1 + i)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
            if i == 0:
                first = {f: g.detach().float().cpu().numpy()
                         for f, g in zip(leaves, grads)}
            with torch.no_grad():
                for (f, p), g in zip(leaves.items(), grads):
                    m, v = adam[f]
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    bc1, bc2 = 1 - b1 ** (i + 1), 1 - b2 ** (i + 1)
                    p.sub_(lr / bc1 * m / (v.sqrt() / bc2 ** 0.5 + eps))
        return losses, first, {f: p.detach().float().cpu().numpy()
                               for f, p in leaves.items()}

    def loss(self, values: dict, step: int) -> float:
        """Step `step`'s loss from the fitted `values` it started from, at
        its frame index (1 + step: a new RNG stream per step)."""
        import torch

        with torch.no_grad():
            return float(self.loss_of(self.leaves(values), 1 + step))


def fit_numbers(start, prog, ref, forced) -> dict:
    """loss_gap, grad_gap and change_gap: `forced` pairs each checked
    step's loss with the reference's from the parameters that step
    started from; `prog` and `ref` are (first gradients, values after the
    checked steps) of the program and of the reference's own
    trajectory."""
    from benchmark.reference import compare

    (pg, pa), (rg, ra) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in forced)
    rn = {f: float(np.linalg.norm(rg[f])) for f in rg}
    pn = {f: float(np.linalg.norm(pg[f])) for f in pg}
    med = float(np.median(list(rn.values())))
    keep = {f for f in rn if rn[f] >= 1e-3 * med}
    rc = {f: float(np.linalg.norm(ra[f] - start[f])) for f in ra}
    pc = {f: float(np.linalg.norm(pa[f] - start[f])) for f in pa}
    return {"loss_gap": loss_gap,
            "grad_gap": compare.leaf_gap(pn, rn, keep),
            "change_gap": compare.leaf_gap(pc, rc, keep)}


def fit_check(ctx, target_np, start, seen) -> dict:
    ref = Reference(ctx, target_np)
    losses, first, after = ref.steps(start, ctx.traffic["check_steps"])
    j, before, loss = seen["window"]
    forced = [(a, ref.loss(v, k)) for k, (a, v) in
              enumerate(zip(seen["losses"], seen["befores"]))]
    forced.append((loss, ref.loss(before, j)))
    gaps = [abs(a - b) / abs(b) for a, b in forced]
    ctx.work["window_step_loss_gap"] = gaps[-1]
    ctx.work["step_loss_gaps"] = gaps[:-1]
    ctx.work["trajectory_loss_gaps"] = [
        abs(a - b) / abs(b) for a, b in zip(seen["losses"], losses)]
    return fit_numbers(start, (seen["grad"], seen["after"]), (first, after),
                       forced)
