"""Typed event bus — reference event-system parity (SURVEY C4).

Port of rtm_tpu/runtime/events.py (pure Python, unchanged).

The reference registers static per-type callback lists and drains queued
events each frame (Engine/src/Engine/Event/Event.h:7-33, Dispatcher.h:13-25)
with event structs AppClose/WindowResize/KeyPressed/MousePressed/MouseMove/
ScrollMoved (AppEvents.h:7-40).  Same model here: callbacks registered per
event *type*, events queued from any thread (the viewer's HTTP handlers),
drained on the render thread with `process()`.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class AppClose:
    pass


@dataclass
class WindowResize:
    width: int
    height: int


@dataclass
class KeyPressed:
    key: str
    pressed: bool = True


@dataclass
class MousePressed:
    button: int
    pressed: bool = True


@dataclass
class MouseMove:
    x: float
    y: float
    dx: float = 0.0
    dy: float = 0.0


@dataclass
class ScrollMoved:
    offset: float


class EventBus:
    """Per-type callbacks + thread-safe queue (fill/process parity)."""

    def __init__(self) -> None:
        self._callbacks = defaultdict(list)
        self._queue: list = []
        self._lock = threading.Lock()

    def register(self, event_type: type, fn) -> None:
        self._callbacks[event_type].append(fn)

    def emit(self, event) -> None:
        """Queue an event (Event<T>::fill parity) — any thread."""
        with self._lock:
            self._queue.append(event)

    def process(self) -> int:
        """Drain the queue, invoking callbacks in registration order
        (Event<T>::process parity).  Returns number processed."""
        with self._lock:
            batch, self._queue = self._queue, []
        for ev in batch:
            for fn in self._callbacks[type(ev)]:
                fn(ev)
        return len(batch)
