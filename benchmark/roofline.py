"""The roofline of a tracing kernel, counted from the cell and not from
any implementation of it.

The least work a dispatch needs, whatever kernel does it:
  * bytes: each byte of the scene description read once (world triangle
    vertices and material ids, spheres, materials, texture and sky texels,
    all f32, and the camera row) and the dispatch's radiance written once;
  * operations: every dispatched ray-bounce (W * H * spp * bounces) times
    the FP32 operations of one ray-triangle test.
The bound is the larger of bytes / HBM bandwidth and operations / FP32
rate; a kernel's share is bound / its device time, so it cannot pass 100%
and rises only when the kernel gets faster.  Culling, a BVH or any other
cut of the pairs tested leaves the count as it is.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12

# FP32 operations of one ray-triangle test in the scalar-triple-product
# form: det 6, t*det 6, u*det 11, v*det 11, w*det 2, the five sign gates
# and the det > eps gate 6, the division 1, the nearest-t compare 2
RAY_TRIANGLE_OPS = 45
CAMERA_ROW_BYTES = 64 * 4


def description_bytes(tables) -> int:
    """Bytes of the scene description at f32 (reference.scene.Tables)."""
    n_tri = len(tables.wa)
    texels = sum(t.shape[0] * t.shape[1] for t in tables.textures)
    texels += tables.sky.shape[0] * tables.sky.shape[1]
    return (n_tri * (9 + 1) * 4 + len(tables.sph_radius) * 5 * 4
            + tables.mat.size * 4 + texels * 3 * 4 + CAMERA_ROW_BYTES)


def dispatch_bound(tables, width: int, height: int, spp: int,
                   bounces: int) -> dict:
    """The least seconds one dispatch can take on the card, and which
    term binds."""
    nbytes = description_bytes(tables) + width * height * 3 * 4
    ops = width * height * spp * bounces * RAY_TRIANGLE_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "bytes_s": t_bytes, "ops_s": t_ops,
            "bound_s": max(t_bytes, t_ops),
            "binds": "bytes" if t_bytes >= t_ops else "operations"}
