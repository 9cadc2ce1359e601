"""The numbers that decide `correct`, from the program's outputs and the
reference's.  Each number reads 0 for an exact match and grows with the
disagreement; the cell's limits file holds the limit of each.
"""
from __future__ import annotations

import numpy as np

# a pixel is off where its largest channel gap passes TOL times the larger
# of 1 and the reference's brightest channel, plus the rounding slack of
# recovering one dispatch from two accumulated display images
TOL = 1e-3
EPS32 = float(np.finfo(np.float32).eps)


def bad_pixels(prog, ref, slack=None) -> int:
    """How many pixels of (N, 3) `prog` are off from `ref`."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    gap = np.abs(prog - ref)
    lim = TOL * np.maximum(1.0, np.abs(ref).max(-1, keepdims=True))
    if slack is not None:
        lim = lim + slack
    return int((gap > lim).any(-1).sum())


def recover_dispatch(k: int, before, after):
    """Dispatch k's radiance from the display images after dispatches k-1
    and k (each the accumulation over the dispatch count), and the bound
    on the rounding of that recovery."""
    a = np.asarray(before, np.float64) * (k - 1)
    b = np.asarray(after, np.float64) * k
    return b - a, 8 * EPS32 * (np.abs(a) + np.abs(b))


def rel_gap(prog, ref) -> float:
    """Sum |prog - ref| / sum |ref|."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(prog - ref).sum() / max(np.abs(ref).sum(), 1e-30))


def leaf_gap(prog_norms: dict, ref_norms: dict, keep: set) -> float:
    """The worst leaf's |prog norm - ref norm| over the larger of the
    reference's norm of that leaf and of the median leaf, over `keep`."""
    if not keep:
        return float("nan")
    med = float(np.median([ref_norms[k] for k in keep]))
    return max(abs(prog_norms[k] - ref_norms[k]) / max(ref_norms[k], med)
               for k in keep)
