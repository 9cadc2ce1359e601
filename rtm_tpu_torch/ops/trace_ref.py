"""Backend resolution and the full-frame dispatch.

Port of rtm_tpu/ops/trace_ref.py `auto_backend` and `render_dispatch`,
the mxu and trav branches.  Everything the port does not have yet raises
NotImplementedError naming the ROADMAP.md item (queue 1) that will port it;
nothing falls back silently to another path.
"""
from __future__ import annotations

from ..config import RenderConfig

# backend -> the ROADMAP.md queue 1 item that ports it
_NOT_PORTED = {
    "xla": "item 3 (torch reference renderer)",
    "pallas": "item 9 (per-bounce sweep through the intersect kernel)",
    "megakernel": "item 8 (megakernel)",
    "wavefront2": "item 9 (wavefront2 + sweep kernel)",
}


def auto_backend(scene, platform: str) -> str:
    """Resolve backend='auto' for this scene on this platform.

    'cuda' resolves to the mxu kernel inside its table limits and to the
    trav kernel beyond them (as on the TPU).  'cpu' resolves the same way:
    the port's CPU path is the kernels' plain versions, since the XLA-style
    reference renderer is not ported yet.  Any other platform gets 'xla'."""
    if platform not in ("tpu", "cuda", "cpu"):
        return "xla"
    mm = scene.mxu_meta
    if mm is not None and mm.supported:
        return "mxu"
    return "trav"


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to rtm_tpu_torch yet: ROADMAP.md queue 1 "
        f"{item}")


def render_dispatch(scene, cam, frame_index: int, cfg: RenderConfig,
                    backend: str = "auto"):
    """One full-frame dispatch (shader main :675-722, minus the
    accumulation-image I/O which lives in runtime/renderer.py).

    frame_index: the 1-based accumulation counter (python int).
    backend: 'auto' (see auto_backend, on the scene's device), 'mxu' (falls
    to trav beyond the mxu tables, as in rtm_tpu) or 'trav'.
    Returns (H, W, 3) f32 radiance averaged over cfg.max_frames samples,
    on the scene's device."""
    if backend == "auto":
        backend = auto_backend(scene, scene.device.type)
    if cfg.max_bounces <= 1:
        _not_ported("the max_bounces == 1 flat-shade preview",
                    _NOT_PORTED["xla"])
    if backend == "mxu":
        mm = scene.mxu_meta
        if mm is not None and mm.supported:
            from .kernels.mxu_kernel import render_mxu
            return render_mxu(scene, cam, frame_index, cfg)
        backend = "trav"                          # table-limit fallback
    if backend == "trav":
        tm = scene.trav_meta
        if tm is not None and tm.supported:
            from .kernels.trav_kernel import render_trav
            return render_trav(scene, cam, frame_index, cfg)
        _not_ported("a scene beyond the trav table limits (< 1024 BVH "
                    "nodes, <= 512 leaves, <= 128 materials / textured "
                    "triangles / spheres), which rtm_tpu sends to the "
                    "megakernel", _NOT_PORTED["megakernel"])
    if backend in _NOT_PORTED:
        _not_ported(f"backend {backend!r}", _NOT_PORTED[backend])
    raise ValueError(f"unknown backend {backend!r}")
