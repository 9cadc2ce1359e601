"""The check catches the control and every fault a cell can have.

Each test drives a whole run on the CPU (the harness's look for a card
skipped, the scenes cut to 24x16) with the timed path broken underneath
(benchmark/faults.py), against the cells' own limits files, and sees
`correct` come out false; sound runs of the render cells come out true.
The same control runs on the card at the cells' own size through
`python3 benchmark/faults.py` (PERF.md gives its readings)."""
from __future__ import annotations

import pytest

from bench_helpers import run_cell, small_root  # noqa: F401 (a fixture)

RENDER = ["cornell720.spp4", "cornell512.interactive"]
ALL = RENDER + ["cornell512.fit"]


@pytest.mark.parametrize("workload", RENDER)
def test_sound_render_runs_are_correct(small_root, workload):
    res, _ = run_cell(small_root, workload, seconds=0.5)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("mode", ["control", "unchanged", "half",
                                  "altered"])
@pytest.mark.parametrize("workload", ALL)
def test_the_check_fails_the_broken_path(small_root, workload, mode):
    res, _ = run_cell(small_root, workload, seconds=0.5, mode=mode)
    assert not res["correct"], res["checks"]


def test_the_check_sees_a_fault_in_the_window_alone(small_root):
    """The fit's window steps reuse the RNG stream of the last set-up
    step: no step the reference follows from the start is touched, and
    the run still fails, since one window step drawn from the seed is
    held to the reference."""
    res, ctx = run_cell(small_root, "cornell512.fit", seconds=0.5,
                        mode="stale")
    assert ctx.work["checked_window_step"] >= ctx.traffic["warm_steps"]
    assert not res["correct"], res["checks"]
    assert res["checks"]["loss_gap"]["value"] > \
        ctx.limits["limits"]["loss_gap"]
