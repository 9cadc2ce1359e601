"""The client extension point + application loop — C1-C3 parity.

Port of rtm_tpu/runtime/frame.py.  The reference exposes `RT::Frame` as
the virtual interface a client app implements
(Engine/src/Engine/Frame/Frame.h:6-16: onInit / onShutdown /
layout / update) and `RT::Application` as the singleton main loop that
owns the window and drives the frame per iteration with timing
(Engine/src/Engine/Core/Application.h:17-45, Application.cpp:44-68:
beginUI -> frame->layout() -> endUI -> frame->update(dt) ->
window->update, with AppClose handling).  This module is that
protocol:

  * `Frame` — subclass and override the four hooks; `layout` is the
    settings/UI phase (runs before the render step; the viewer's
    settings panel plays the ImGui role), `update(dt)` the render phase;
  * `Application` — owns an EventBus and a Frame, `run()` loops
    layout/update with ms timing (Core/Time.h:12-30 Timer parity) until
    an AppClose event or `max_iterations`;
  * `RenderFrame` — the built-in frame: a ProgressiveRenderer stepped
    once per update (exactly what the CLI/viewer do), provided both as
    the default client and as the reference implementation of the
    protocol.  Its backend defaults to "auto" (the kernels), where
    rtm_tpu's RenderFrame defaults to "xla", and it renders on the card
    unless given `device="cpu"`.

Registration mirrors `RegisterStartupFrame` (Application.h:47-52):
pass a Frame factory to Application, or use rtm_tpu_torch.__main__'s CLI
for the stock client.
"""
from __future__ import annotations

import time

from .events import AppClose, EventBus


class Frame:
    """Client extension point (ref Frame.h:6-16).  All hooks optional."""

    def on_init(self, app: "Application") -> None:
        """Called once before the loop (ref onInit)."""

    def on_shutdown(self) -> None:
        """Called once after the loop (ref onShutdown)."""

    def layout(self, app: "Application") -> None:
        """Settings/UI phase, before update (ref layout; the reference
        draws ImGui panels and flushes uniform edits here)."""

    def update(self, dt_ms: float) -> None:
        """Render phase (ref update(dt)); dt_ms = last frame time."""


class Application:
    """The main loop (ref Application.cpp:44-68), headless: owns the
    event bus + client frame; no window — the browser viewer or the CLI
    is the display."""

    def __init__(self, frame_factory, name: str = "rtm_tpu_torch",
                 max_iterations: int | None = None):
        self.name = name
        self.bus = EventBus()
        self.frame: Frame = frame_factory()
        self.max_iterations = max_iterations
        self.is_running = False
        self.frame_count = 0
        self.last_ms = 0.0
        self.bus.register(AppClose, self._on_close)

    def _on_close(self, _event) -> None:
        self.is_running = False

    def close(self) -> None:
        """Request shutdown (the reference emits AppClose on window X)."""
        self.bus.emit(AppClose())

    def run(self) -> int:
        """layout -> update(dt) per iteration with ms timing
        (Application.cpp:44-68 + Core/Time.h Timer semantics).  Returns
        the number of iterations executed."""
        self.is_running = True
        self.frame.on_init(self)
        try:
            while self.is_running:
                t0 = time.perf_counter()
                self.bus.process()
                if not self.is_running:        # AppClose drained
                    break
                self.frame.layout(self)
                self.frame.update(self.last_ms)
                self.frame_count += 1
                self.last_ms = (time.perf_counter() - t0) * 1e3
                if (self.max_iterations is not None
                        and self.frame_count >= self.max_iterations):
                    self.is_running = False
        finally:
            self.frame.on_shutdown()
        return self.frame_count


class RenderFrame(Frame):
    """The stock client: one progressive-accumulation step per update
    (what RayTracingClient::update does, RayTracing.cpp:501-519)."""

    def __init__(self, scene_id: int = 3, cfg=None, backend: str = "auto",
                 device=None):
        self.scene_id = scene_id
        self.cfg = cfg
        self.backend = backend
        self.device = device
        self.renderer = None
        self.image = None

    def on_init(self, app: Application) -> None:
        from ..config import RenderConfig
        from ..models.scenes import load_scene
        from .renderer import ProgressiveRenderer
        self.renderer = ProgressiveRenderer(
            load_scene(self.scene_id),
            cfg=self.cfg or RenderConfig(width=128, height=128,
                                         max_bounces=3, accumulate=True),
            device=self.device, backend=self.backend)

    def update(self, dt_ms: float) -> None:
        self.image = self.renderer.step()
