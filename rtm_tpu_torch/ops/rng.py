"""PCG-hash per-pixel RNG, bit-exact with the reference device kernel.

Reference semantics (RayTracing/assets/shaders/RayTracing.shader:123-151):

  uint PCGhash(uint s)   { state = s*747796405u + 2891336453u;
                           word = ((state >> ((state>>28)+4)) ^ state) * 277803737u;
                           return (word >> 22) ^ word; }
  float fastRandom(seed) { seed = PCGhash(seed); return float(seed)/4294967295.0; }
  vec3  fastRandom3      -> three sequential draws (x, y, z)
  vec2  randomCirclePoint-> angle = draw*2*PI; (cos,sin) * sqrt(draw)   [2 draws]
  vec3  randomUnitSpehere-> 2*fastRandom3 - 1  (NOT normalized!)        [3 draws]

Per-pixel seed init is
  seed = uint(y * Resolution.x + x) + frame * FrameIndex * 735529   (shader:697)
with uint32 wraparound, and `seed += bounce` at each bounce (shader:659).

PyTorch's CPU build has no `+` or `>>` on uint32 tensors, so the plain
versions carry u32 values in int64 tensors and mask with 0xFFFFFFFF after
every operation that can leave 32 bits.  The CUDA kernels use `uint32_t`.

The functions below are the XLA-style path's (ops/trace_ref.py): they take
an int64 seed tensor and return (value, new_seed).  `fast_random` converts
the full u32 to f32 (int64 -> f32 rounds to nearest, as JAX's u32 -> f32
cast does); the kernels keep the top 24 bits instead
(ops/kernels/vreg_common.py `_rand`).
"""
from __future__ import annotations

import numpy as np
import torch

SEED_STRIDE = 735529             # shader:697 magic
U32_MASK = 0xFFFFFFFF
UINT_MAX_F = float(np.float32(4294967295.0))
TWO_PI = float(np.float32(2.0) * np.float32(np.pi))


def pcg_hash(seed: torch.Tensor) -> torch.Tensor:
    """u32 -> u32 PCG output hash (shader:123-128), on int64 tensors
    holding values in [0, 2^32)."""
    state = (seed * 747796405 + 2891336453) & U32_MASK
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * 277803737) & U32_MASK
    return (word >> 22) ^ word


def fast_random(seed):
    """(value in [0,1] f32, new_seed). shader:130-134."""
    seed = pcg_hash(seed)
    return seed.to(torch.float32) / UINT_MAX_F, seed


def fast_random3(seed):
    """((...,3) f32, new_seed): three sequential draws. shader:136-139."""
    x, seed = fast_random(seed)
    y, seed = fast_random(seed)
    z, seed = fast_random(seed)
    return torch.stack([x, y, z], dim=-1), seed


def random_circle_point(seed):
    """((...,2) f32 point in unit disk, new_seed). shader:141-146."""
    r1, seed = fast_random(seed)
    angle = r1 * TWO_PI
    r2, seed = fast_random(seed)
    radius = torch.sqrt(r2)
    return torch.stack([torch.cos(angle) * radius,
                        torch.sin(angle) * radius], dim=-1), seed


def random_unit_sphere(seed):
    """((...,3) f32 in [-1,1]^3, intentionally NOT normalized
    (shader:148-151))."""
    v, seed = fast_random3(seed)
    return 2.0 * v - 1.0, seed


def pixel_seed(x, y, width: int, frame: int, frame_index: int):
    """Initial per-pixel seed (shader:697) as an int64 tensor of u32
    values.  `frame` is the 1-based sample index within the dispatch,
    `frame_index` the 1-based accumulation frame counter (Python ints)."""
    lin = (y.to(torch.int64) * width + x.to(torch.int64)) & U32_MASK
    step = (frame * (int(frame_index) & U32_MASK) * SEED_STRIDE) & U32_MASK
    return (lin + step) & U32_MASK


# ---------------------------------------------------------------------------
# NumPy scalar mirror (host-side golden values for tests)
# ---------------------------------------------------------------------------

def pcg_hash_np(seed: int) -> int:
    """pcg_hash of one u32 in Python integers."""
    state = (seed * 747796405 + 2891336453) & U32_MASK
    shift = ((state >> 28) + 4) & U32_MASK
    word = (((state >> shift) ^ state) * 277803737) & U32_MASK
    return ((word >> 22) ^ word) & U32_MASK


def fast_random_np(seed: int):
    """fast_random of one u32: (np.float32 value, new seed)."""
    seed = pcg_hash_np(seed)
    return np.float32(np.float32(seed) / np.float32(UINT_MAX_F)), seed
