"""Numeric guards: the analog of the reference's Vulkan validation layers
(SURVEY.md §5.2: Debug.h:16-21 VK_LAYER_KHRONOS_validation + CHECK_VK on
every call).

Port of rtm_tpu/utils/guards.py.  The runtime hazard class that remains
on a dataflow device is numeric: NaN/Inf escaping a kernel.  Two opt-in
oracles:

  * assert_image_finite: post-hoc output validation (any backend, one
    reduction per frame);
  * checked_render_dispatch: rtm_tpu instruments the whole XLA render
    graph with checkify float_checks; here the reference renderer checks
    every bounce's hit payload and path state explicitly
    (`render_pixels(check_finite=True)`) and raises at the first bounce
    whose tensors hold NaN/Inf, naming the frame, the bounce and the
    tensor.  The `xla` backend only, as in rtm_tpu: the kernels are
    covered by the output check and by their plain versions.

Wire-up: `python -m rtm_tpu_torch render --check-nans`, or call directly.
"""
from __future__ import annotations

import numpy as np
import torch


def assert_image_finite(img, what: str = "render output") -> None:
    """Raise FloatingPointError if the image (a tensor on any device, or an
    array) holds NaN/Inf."""
    t = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor)
                        else img)
    bad = int((~torch.isfinite(t)).sum())
    if bad:
        finite = t[torch.isfinite(t)]
        lo = float(finite.min()) if finite.numel() else float("nan")
        hi = float(finite.max()) if finite.numel() else float("nan")
        raise FloatingPointError(
            f"{what}: {bad}/{t.numel()} non-finite values "
            f"(finite min {lo}, max {hi})")


def checked_render_dispatch(scene, cam, frame_index: int, cfg, **kw):
    """render_dispatch(backend='xla') with a finiteness check after every
    bounce: raises FloatingPointError on the first bounce whose payload or
    path state holds NaN/Inf.  Returns the (H, W, 3) image."""
    from ..ops.trace_ref import pixel_grid, render_pixels

    backend = kw.pop("backend", "xla")
    if backend != "xla":
        raise ValueError(
            "checked_render_dispatch instruments the reference renderer; "
            f"the kernel backends ({backend!r}) are covered by "
            "assert_image_finite and their plain versions")
    x, y = pixel_grid(cfg.width, cfg.height, scene.device)
    out = render_pixels(scene, cam, x, y, frame_index, cfg, backend="xla",
                        check_finite=True, **kw)
    return out.reshape(cfg.height, cfg.width, 3)
