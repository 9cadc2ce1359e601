"""The general drivers a traffic file names by its `loop` key, and what
they share: the Outcome of a run and the check of rendered images
against the plain reference."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass
class Outcome:
    """e2e: the loop's end-to-end values by metric name; attempted and
    failed: units of work of the window; check(): the numbers compared;
    release(): drop the program's state before the check runs."""

    e2e: dict
    attempted: int
    check: Callable[[], dict]
    release: Callable[[], None]
    failed: int = 0


def pixel_grid(width: int, height: int, device):
    import torch

    lin = torch.arange(width * height, device=device)
    return lin % width, lin // width


def reference_image(ctx, sc, cam: dict, spp: int, frame_index: int,
                    pix=None):
    """The reference's (H*W, 3) radiance of one dispatch, or (len(pix),
    3) at the pixel indices `pix` alone."""
    import torch

    from benchmark.reference import render as R

    r = ctx.desc.render
    x, y = pixel_grid(r["width"], r["height"], ctx.device)
    if pix is not None:
        sel = torch.from_numpy(pix).to(ctx.device)
        x, y = x[sel], y[sel]
    fi = torch.full_like(x, frame_index)
    return R.trace_blocked(sc, cam, r["width"], r["height"], x, y, fi, spp,
                           r["max_bounces"], r["draw_environment"]
                           ).cpu().numpy()


def render_check(ctx, cam: dict, spp: int, accum, k_total: int,
                 kept) -> dict:
    """bad_pixel_share over the kept dispatches (k, display after k-1 or
    None for k = 1, display after k), at every pixel or at the limits
    file's `dispatch_pixels` drawn from the seed, and accum_rel_gap of the
    accumulation over all k_total dispatches at its `check_pixels` pixels
    drawn from the seed."""
    import torch

    from benchmark.reference import compare
    from benchmark.reference import render as R

    r = ctx.desc.render
    w, h = r["width"], r["height"]
    sc = R.Scene(ctx.tables, ctx.device)
    n_disp = min(ctx.limits.get("dispatch_pixels", w * h), w * h)
    some = np.sort(ctx.rng(4).choice(w * h, n_disp, replace=False))
    bad = 0
    for k, before, after in kept:
        ref = reference_image(ctx, sc, cam, spp, k, some)
        after = after.reshape(-1, 3)[some]
        if before is None:
            bad += compare.bad_pixels(after, ref)
        else:
            got, slack = compare.recover_dispatch(
                k, before.reshape(-1, 3)[some], after)
            bad += compare.bad_pixels(got, ref, slack)
    numbers = {"bad_pixel_share": bad / (len(kept) * n_disp)}
    pix = ctx.rng(3).choice(w * h, ctx.limits["check_pixels"], replace=False)
    pix_t = torch.from_numpy(pix).to(ctx.device)
    x = (pix_t % w).repeat_interleave(k_total)
    y = (pix_t // w).repeat_interleave(k_total)
    fi = torch.arange(1, k_total + 1, device=ctx.device).repeat(len(pix))
    ref = R.trace_blocked(sc, cam, w, h, x, y, fi, spp, r["max_bounces"],
                          r["draw_environment"])
    ref_sum = ref.reshape(len(pix), k_total, 3).double().sum(1).cpu().numpy()
    numbers["accum_rel_gap"] = compare.rel_gap(
        np.asarray(accum).reshape(-1, 3)[pix], ref_sum)
    return numbers
