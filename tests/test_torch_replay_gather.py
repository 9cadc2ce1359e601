"""The replay's wide-row gather (`ReplayRowGather`, ops/kernels/row_grad.py)
on the CPU, where its backward is the plain version `row_grad_plain`.

The forward is `table[idx]` bitwise.  The backward sums the same terms as
an index_add_ in float64, in `row_grad_plan`'s order in float32: each
entry's sum is a chain of at most lanes_per_chunk + chunks additions, so it
lies within (lanes_per_chunk + chunks) * 2**-24 * (the sum of its terms'
magnitudes) of the float64 sum (the bound of recursive summation).  The
kernel on the card is held to the plain version bitwise
(tests/test_torch_cuda.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import rtm_tpu_torch
from rtm_tpu_torch import diff as td
from rtm_tpu_torch.ops.kernels import row_grad as rg

WIDTH = 40

# name: (lanes, rows, how the lanes' rows are drawn)
CASES = {
    "fit_35": (512 * 512, 35, "clustered"),
    "mxu_limit_2176": (40_000, 2176, "uniform"),
    "tail_not_a_chunk_multiple": (5003, 41, "clustered"),
    "rows_no_lane_hits": (3000, 41, "low_half"),
    "every_lane_one_row": (4099, 41, "one_row"),
    "one_lane": (1, 3, "uniform"),
}


def _inputs(n, rows, draw, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if draw == "clustered":      # most lanes on a few rows, as hits fall
        idx = np.where(rng.random(n) < 0.8,
                       rng.integers(0, min(rows, 6), n),
                       rng.integers(0, rows, n))
    elif draw == "uniform":
        idx = rng.integers(0, rows, n)
    elif draw == "low_half":
        idx = rng.integers(0, rows // 2, n)
    else:
        idx = np.full(n, 7)
    g = rng.standard_normal((n, WIDTH)).astype(dtype)
    return torch.from_numpy(g), torch.from_numpy(idx.astype(np.int64))


def _f64_sums(g, idx, rows):
    """(the float64 sums, the sums of the terms' magnitudes), per entry."""
    z = torch.zeros((rows, g.shape[1]), dtype=torch.float64)
    return (z.index_add(0, idx, g.double()),
            z.index_add(0, idx, g.double().abs()))


def test_forward_is_the_gather_bitwise():
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((41, WIDTH))
                             .astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 41, 1000))
    assert torch.equal(rg.ReplayRowGather.apply(table, idx), table[idx])


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_float64_index_add(case):
    n, rows, draw = CASES[case]
    g, idx = _inputs(n, rows, draw)
    table = torch.zeros((rows, WIDTH), requires_grad=True)
    rg.ReplayRowGather.apply(table, idx).backward(g)
    got = table.grad
    want, mag = _f64_sums(g, idx, rows)
    _, chunks, lanes = rg.row_grad_plan(n, rows, WIDTH)
    err = (got.double() - want).abs()
    assert bool((err <= (lanes + chunks) * 2.0 ** -24 * mag).all()), \
        float(err.max())
    hit = torch.zeros(rows, dtype=torch.bool)
    hit[idx] = True
    assert bool((got[~hit] == 0).all())        # rows no lane hits
    assert torch.equal(got, rg.row_grad(g, idx, rows))   # deterministic


def test_plan_covers_every_lane_once():
    for n, rows in ((512 * 512, 35), (512 * 512, 2176), (5003, 41), (1, 1),
                    (64, 65536)):
        tile_rows, chunks, lanes = rg.row_grad_plan(n, rows, WIDTH)
        assert (chunks - 1) * lanes < n <= chunks * lanes
        assert tile_rows * WIDTH * 4 <= rg.TILE_BYTES
    # the fit cell's shape (the Cornell box: 34 triangles and the miss
    # row): one tile, four blocks per SM, 3.0 MB of partials
    assert rg.row_grad_plan(512 * 512, 35, WIDTH) == (35, 528, 497)
    # the mxu tables' limit: several row tiles
    tile_rows, chunks, _ = rg.row_grad_plan(512 * 512, 2176, WIDTH)
    assert -(-2176 // tile_rows) > 1


def test_indices_outside_the_rows_add_nothing():
    g, idx = _inputs(700, 41, "uniform")
    idx[::7] = 41
    idx[3::7] = -1
    keep = (idx >= 0) & (idx < 41)
    want, mag = _f64_sums(g[keep], idx[keep], 41)
    _, chunks, lanes = rg.row_grad_plan(700, 41, WIDTH)
    err = (rg.row_grad(g, idx, 41).double() - want).abs()
    assert bool((err <= (lanes + chunks) * 2.0 ** -24 * mag).all())


def test_gradcheck_float64():
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((7, 5))).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 7, 150))
    assert torch.autograd.gradcheck(
        lambda t: rg.ReplayRowGather.apply(t, idx), (table,))


def test_wrapper_rejects_what_it_does_not_take():
    g, idx = _inputs(100, 41, "uniform")
    for args in ((g.half(), idx, 41), (g.T.contiguous().T, idx, 41),
                 (g, idx.int(), 41), (g, idx[:99], 41), (g, idx, 0),
                 (g, idx, rg.MAX_ROWS + 1), (g[:, :0], idx, 41),
                 (g[0], idx, 41)):
        with pytest.raises(ValueError, match="row_grad"):
            rg.row_grad(*args)


def test_replay_fit_step_grads_as_before(monkeypatch):
    """loss_and_grad through mxu replay on the CPU: the gradients with
    the plain backward and with PyTorch's own backward of `table[idx]`
    (what the replay took before) agree within the reordering's rounding,
    and the loss is bitwise the same."""
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(3),
                                        device="cpu")
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=3,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(16, 16)
    target = torch.full((16, 16, 3), 0.3)

    def step():
        return td.loss_and_grad(td.extract_params(st), st, cam, target, 2,
                                cfg, backend="mxu", remat=False)

    loss, g = step()
    monkeypatch.setattr(rg.ReplayRowGather, "apply",
                        staticmethod(lambda table, idx: table[idx]))
    loss0, g0 = step()
    assert torch.equal(loss, loss0)
    assert float(g.albedo.abs().max()) > 0.0
    for name in g.fields():
        torch.testing.assert_close(getattr(g, name), getattr(g0, name),
                                   rtol=1e-5, atol=1e-7, msg=name)
