"""The replay's wide-row gather, `table[idx]`, with a deterministic
backward: the table's gradient summed per row in a fixed order by
csrc/row_grad.cu on the card (`row_grad`), by its plain version
`row_grad_plain` on the CPU.

The record replay (ops/trace_ref.py `replay_payload`) gathers one (N, 40)
row a lane from the (T + S + 1, 40) primitive and material table every
bounce.  PyTorch's backward of that gather, index_put_(accumulate=True),
sorts the indices and sums each distinct row's lanes in one sequential
loop; with a few dozen rows it keeps a few dozen warps busy, ~35 ms a
bounce at 512x512 on the H100 and most of a fit step.  rtm_tpu gathers
with jnp.take and leaves the backward to XLA's scatter-add, so the kernel
replaces no TPU kernel.  Bytes bound it: each lane's gradient row and
index read once, 44 MB at 512x512, 13 us at 3.35 TB/s (csrc/row_grad.cu
says what the design does about it).

The order of every sum is `row_grad_plan`'s, worked out from the shapes
alone (not from the device), so the kernel and the plain version sum the
same terms in the same order: chunk by chunk in lane order, then the
chunks in order.  On the card the two are bitwise equal, and two runs of
the kernel are too.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .build import check_arg, load_kernel_library

SMS = 132                     # the H100's SMs
BLOCKS_PER_SM = 4             # pass 1's blocks the plan aims at, per SM
TILE_BYTES = 48 * 1024        # one block's table tile in shared memory
SCRATCH_FLOATS = 8 << 20      # the partial tables' cap (32 MiB) ...
MIN_CHUNK_LANES = 64          # ... and the shortest chunk
MAX_ROWS = 1 << 16
MAX_WIDTH = 256               # one thread per column: pass 1's block

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]
_LAUNCH = {}                  # csrc/row_grad.cu's launch function


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def row_grad_plan(n: int, rows: int, width: int) -> tuple:
    """(tile_rows, chunks, lanes_per_chunk) of the sum over n > 0 lanes:
    a table tile fills at most TILE_BYTES of shared memory; chunks *
    tiles comes near BLOCKS_PER_SM blocks per SM, with at most
    SCRATCH_FLOATS of partial tables (unless one chunk's table is more)
    and chunks of at least MIN_CHUNK_LANES lanes; every chunk but the
    last holds lanes_per_chunk lanes, the last at least one."""
    tile_rows = min(rows, TILE_BYTES // (4 * width))
    tiles = _ceil(rows, tile_rows)
    chunks = max(1, min(_ceil(SMS * BLOCKS_PER_SM, tiles),
                        SCRATCH_FLOATS // (rows * width),
                        _ceil(n, MIN_CHUNK_LANES)))
    lanes = _ceil(n, chunks)
    return tile_rows, _ceil(n, lanes), lanes


def _check(grad, idx, rows: int) -> None:
    """Raise ValueError unless grad is a contiguous (N, W) float tensor,
    idx a contiguous (N,) int64 tensor on its device, 1 <= W <=
    MAX_WIDTH and 1 <= rows <= MAX_ROWS; on the card grad is float32."""
    if not isinstance(grad, torch.Tensor) or grad.dim() != 2:
        raise ValueError("row_grad: grad must be a 2-D tensor")
    n, width = grad.shape
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"row_grad: need 1 <= width <= {MAX_WIDTH}; got "
                         f"{width}")
    if not 1 <= int(rows) <= MAX_ROWS:
        raise ValueError(f"row_grad: need 1 <= rows <= {MAX_ROWS}; got "
                         f"{rows}")
    dtypes = ((torch.float32,) if grad.device.type == "cuda"
              else (torch.float32, torch.float64))
    if grad.dtype not in dtypes or not grad.is_contiguous():
        raise ValueError(f"row_grad: grad must be a contiguous tensor of "
                         f"{' or '.join(map(str, dtypes))} on "
                         f"{grad.device}; got {grad.dtype}")
    check_arg("row_grad", "idx", idx, torch.int64, (n,), grad.device)


def row_grad_plain(grad, idx, rows: int):
    """The plain version of `row_grad`, in its order: per chunk a table
    that starts at 0 and takes its lanes' rows one lane at a time in lane
    order (one index_add_ a lane position, over every chunk at once: no
    two of its additions meet in one entry), then the chunks' tables added
    in order to a table of zeros.  Indices outside [0, rows) add
    nothing."""
    n, width = grad.shape
    out = torch.zeros((rows, width), dtype=grad.dtype, device=grad.device)
    if n == 0:
        return out
    _, chunks, lanes = row_grad_plan(n, rows, width)
    # per chunk rows + 1 rows: the last takes the indices outside [0, rows)
    part = torch.zeros((chunks * (rows + 1), width), dtype=grad.dtype,
                       device=grad.device)
    ok = (idx >= 0) & (idx < rows)
    dest = torch.where(ok, idx, rows)
    first = torch.arange(chunks, device=grad.device) * lanes
    base = torch.arange(chunks, device=grad.device) * (rows + 1)
    last = n - (chunks - 1) * lanes            # lanes of the last chunk
    for j in range(lanes):
        k = chunks if j < last else chunks - 1
        lane = first[:k] + j
        part.index_add_(0, base[:k] + dest[lane], grad[lane])
    part = part.view(chunks, rows + 1, width)
    for k in range(chunks):
        out += part[k, :rows]
    return out


def _launch_fn():
    """csrc/row_grad.cu's launch function with its argument types; bound
    once."""
    if not _LAUNCH:
        fn = load_kernel_library("row_grad").row_grad_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LAUNCH["fn"] = fn
    return _LAUNCH["fn"]


def row_grad(grad, idx, rows: int):
    """The gradient of a (rows, W) table from the gradient `grad` (N, W)
    of `table[idx]`: out[r] = the sum of grad[i] over the lanes i with
    idx[i] == r, in `row_grad_plan`'s order; indices outside [0, rows)
    add nothing.

    CPU tensors go to `row_grad_plain` (float32 or float64).  CUDA
    tensors (float32) launch csrc/row_grad.cu's two passes (built at
    first use) and raise on arguments they do not take and on any launch
    error; `row_grad.launches` counts those launches, one per call with N
    > 0 (N == 0 gives zeros and launches nothing)."""
    _check(grad, idx, rows)
    dev = grad.device
    if dev.type == "cpu":
        return row_grad_plain(grad, idx, rows)
    if dev.type != "cuda":
        raise ValueError(f"row_grad: unsupported device {dev}")
    n, width = grad.shape
    out = torch.empty((rows, width), dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    tile_rows, chunks, lanes = row_grad_plan(n, rows, width)
    part = torch.empty((chunks, rows, width), dtype=torch.float32,
                       device=dev)
    fn = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(grad.data_ptr(), idx.data_ptr(), n, width, rows, tile_rows,
                 chunks, lanes, part.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"row_grad: kernel launch failed with CUDA error "
                           f"{err}")
    row_grad.launches += 1
    return out


row_grad.launches = 0


class ReplayRowGather(torch.autograd.Function):
    """`ReplayRowGather.apply(table, idx)` is `table[idx]` for a (R, W)
    table and (N,) int64 indices, bitwise; its backward is `row_grad`,
    deterministic on every device.  Not twice differentiable."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return row_grad(grad.contiguous(), idx, ctx.rows), None
