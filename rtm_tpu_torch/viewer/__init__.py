"""Interactive browser viewer (SURVEY C5/C26 analog)."""

from .server import CameraController, ViewerServer  # noqa: F401
