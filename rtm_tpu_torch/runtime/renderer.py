"""Progressive renderer: the per-frame driver loop.

Analog of the reference's Application::run + RayTracingClient::update
(Application.cpp:44-68, RayTracing.cpp:501-519) and the accumulation logic in
the kernel epilogue (shader:711-721):

    incoming  = dispatch() / MaxFrames
    if frameIndex != 1: incoming += accumulation
    accumulation = incoming
    out = incoming / frameIndex           (stored RGBA8; no gamma)

frameIndex advances only while accumulation is enabled, and resets to 1 on
camera moves / resizes / scene edits (RayTracing.cpp:81,91-95,625) — here via
`reset()`.  Everything runs on the scene's device; the accumulation buffer
is updated in place.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.scene import TracerScene, build_tracer_scene
from ..ops.trace_ref import render_dispatch
from ..utils.tracing import span


def accumulate_step(scene: TracerScene, cam, accum: torch.Tensor,
                    frame_index: int, cfg: RenderConfig,
                    backend: str = "auto"):
    """One progressive frame.  Accumulates into `accum` IN PLACE (frame 1
    overwrites it) and returns (accum, display_image)."""
    incoming = render_dispatch(scene, cam, frame_index, cfg, backend=backend)
    if frame_index != 1:
        accum.add_(incoming)
    else:
        accum.copy_(incoming)
    return accum, accum / float(frame_index)


def render_progressive(scene: TracerScene, cam, cfg: RenderConfig,
                       frames: int, backend: str = "auto") -> torch.Tensor:
    """`frames` accumulation dispatches (frame_index 1..frames), returning
    the converged display image.  A Python loop over frames; each frame's
    radiance is added IN PLACE (`add_`) into one accumulation buffer on the
    scene's device.  On the fused routes (mxu, trav, megakernel) a frame
    makes no host wait: the camera row reaches the card by a copy the host
    does not wait for, the post-pass reads no count on the host, and the
    scene's index tables are uploaded once (chip_smoke.py [host-waits]).
    Give `cam` on the scene's device (`Camera.spec(..., device=)`); a spec
    on the CPU works too."""
    accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                        device=scene.device)
    for fi in range(1, frames + 1):
        accum.add_(render_dispatch(scene, cam, fi, cfg, backend=backend))
    return accum / float(frames)


class ProgressiveRenderer:
    """Host-side session state (scene + camera + accumulation).  `backend`
    is handed to every `accumulate_step`: "auto" (the kernels) by default,
    while rtm_tpu's renderer always takes its default, "xla"."""

    def __init__(self, scene, camera: Camera | None = None,
                 cfg: RenderConfig | None = None, device=None,
                 backend: str = "auto"):
        self.cfg = cfg or RenderConfig()
        self.camera = camera or Camera()
        self.backend = backend
        self.scene = (scene if isinstance(scene, TracerScene)
                      else build_tracer_scene(scene, device=device))
        self.frame_index = 0
        self.accum = self._zeros()
        self.last_ms = 0.0        # "GPU time" analog (RayTracing.cpp:77)
        self.fps = 0.0            # rolling average (ImGui Framerate parity)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((self.cfg.height, self.cfg.width, 3),
                           dtype=torch.float32, device=self.scene.device)

    def reset(self) -> None:
        """Reset accumulation (camera move / resize / scene edit parity)."""
        self.frame_index = 0
        self.accum = self._zeros()

    def set_config(self, **kw) -> None:
        """Apply settings-panel edits (RayTracing.cpp:83-101 semantics):
        only a resize reallocates and resets the accumulation image."""
        old = self.cfg
        self.cfg = dataclasses.replace(old, **kw)
        if (self.cfg.width, self.cfg.height) != (old.width, old.height):
            self.reset()

    def set_scene(self, scene) -> None:
        self.scene = (scene if isinstance(scene, TracerScene)
                      else build_tracer_scene(scene,
                                              device=self.scene.device))
        self.reset()

    def move_camera(self, **kw) -> None:
        self.camera.move(**kw)
        self.reset()

    def step(self) -> torch.Tensor:
        """Render one frame; returns the display image (H,W,3) f32."""
        t0 = time.perf_counter()
        out = self.step_async()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.last_ms = (time.perf_counter() - t0) * 1e3
        inst = 1e3 / max(self.last_ms, 1e-3)
        self.fps = inst if self.fps == 0.0 else 0.9 * self.fps + 0.1 * inst
        return out

    @span("rtm.step_async")
    def step_async(self) -> torch.Tensor:
        """Queue one frame without waiting for the device: returns the
        display image tensor immediately.  The camera's spec is rebuilt
        every frame (it may have moved) with one copy to the scene's device
        that the host does not wait for, so on the fused routes the host
        can queue frames ahead of the card."""
        self.frame_index = self.frame_index + 1 if self.cfg.accumulate else 1
        cam_spec = self.camera.spec(self.cfg.width, self.cfg.height,
                                    device=self.scene.device)
        self.accum, out = accumulate_step(self.scene, cam_spec, self.accum,
                                          self.frame_index, self.cfg,
                                          backend=self.backend)
        return out

    def render(self, frames: int = 1) -> torch.Tensor:
        out = None
        for _ in range(frames):
            out = self.step()
        return out
