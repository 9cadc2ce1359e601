"""Camera model.

Parity with ``RT::Camera`` (ref: Engine/src/Engine/Render/Camera.{h,cpp}):
  * perspective from glm::perspectiveFov(radians(fov), W, H, near, far),
    right-handed, clip z in [-1,1] (no GLM_FORCE defines in the reference);
    the *inverse* matrix is what ships to the kernel (Camera.cpp:25-30).
  * view from glm::lookAt(position, position+direction, (0,1,0)); inverse
    shipped (Camera.cpp:32-36).
  * defaults: fov 45, near 0.1, far 1.0 (RayTracing.cpp:27), position (0,1,5),
    direction (0,0,-1), focusDistance 1, defocusStrength 0, blurStrength 0
    (Camera.cpp:8-22).

The device-side consumption (ray generation, shader:684-706) reads
invView column 0/1 as the right/up vectors, so CameraSpec stores logical
(row-major numpy) matrices where column extraction matches GLSL `m[0].xyz`.

The matrices are built in float64 NumPy and cast to f32 at the end
(`Camera.row`, `Camera.spec`).  `Camera.spec` puts the whole spec on the
device it is given (the CPU by default) with one copy that the host does
not wait for: the kernels' 64-float camera row and the row-major matrices
are packed in NumPy into one pinned buffer, copied without blocking, and
every field of the spec is a view of that one device buffer.  So a frame
that rebuilds its spec (a moving camera) makes no host wait.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch


CAMERA_ROW = 64          # floats in the kernels' camera row


@dataclass
class CameraSpec:
    """Device-ready camera uniform (ref Camera::Spec, Camera.h:11-21).

    A spec is a value: build a new one (`Camera.spec`, or
    `dataclasses.replace`) rather than writing into its tensors.  `row` is
    the kernels' camera row of the same values (ops/kernels/megakernel.py
    `_pack_camera`), set by `Camera.spec`; it is not an argument, so a spec
    built by hand or by `dataclasses.replace` has none and the row is
    packed from its fields."""

    inv_projection: torch.Tensor    # (4,4) f32
    inv_view: torch.Tensor          # (4,4) f32
    position: torch.Tensor          # (3,) f32
    focus_distance: torch.Tensor    # () f32
    defocus_strength: torch.Tensor  # () f32
    blur_strength: torch.Tensor     # () f32
    row: torch.Tensor | None = field(default=None, init=False, repr=False,
                                     compare=False)


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`: from the host to a CUDA device by a copy the host
    does not wait for, through a pinned block (PyTorch's caching host
    allocator keeps it until the copy has run); otherwise `t.to(device)`."""
    device = torch.device(device)
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        out = torch.empty(t.shape, dtype=t.dtype, device=device)
        return out.copy_(t.pin_memory(), non_blocking=True)
    return t.to(device)


def perspective_fov(fov_rad: float, width: float, height: float,
                    near: float, far: float) -> np.ndarray:
    """glm::perspectiveFov (RH, negative-one clip). Returns (4,4) row-major."""
    h = np.cos(0.5 * fov_rad) / np.sin(0.5 * fov_rad)
    w = h * height / width
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAt (RH). Returns (4,4) row-major view matrix."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def inv_look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Closed-form inverse of look_at: columns = (right, up, -forward, eye)."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = s
    m[:3, 1] = u
    m[:3, 2] = -f
    m[:3, 3] = eye
    return m


@dataclass
class Camera:
    """Host-side camera state (mutable, like the reference's RT::Camera)."""

    fov: float = 45.0
    near: float = 0.1
    far: float = 1.0
    position: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 5.0]))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    focus_distance: float = 1.0
    defocus_strength: float = 0.0
    blur_strength: float = 0.0

    UP = np.array([0.0, 1.0, 0.0])

    def inv_projection(self, width: int, height: int) -> np.ndarray:
        proj = perspective_fov(np.radians(self.fov), float(width), float(height),
                               self.near, self.far)
        return np.linalg.inv(proj)

    def inv_view(self) -> np.ndarray:
        return inv_look_at(np.asarray(self.position, np.float64),
                           np.asarray(self.position, np.float64) + np.asarray(self.direction, np.float64),
                           self.UP)

    def row(self, width: int, height: int) -> np.ndarray:
        """The kernels' (64,) f32 camera row, packed in NumPy: the inverse
        projection and inverse view column-major (the kernels read m[i,j]
        at j*4+i), position, focus distance, defocus and blur strength,
        zeros."""
        r = np.zeros(CAMERA_ROW, np.float32)
        r[0:16] = np.asarray(self.inv_projection(width, height),
                             np.float32).T.reshape(-1)
        r[16:32] = np.asarray(self.inv_view(), np.float32).T.reshape(-1)
        r[32:35] = np.asarray(self.position, np.float32)
        r[35:38] = np.asarray([self.focus_distance, self.defocus_strength,
                               self.blur_strength], np.float32)
        return r

    def spec(self, width: int, height: int, device="cpu") -> CameraSpec:
        """The spec on `device`, with one copy the host does not wait for:
        one buffer holds the kernels' row and then the row-major inverse
        projection and inverse view, and every field is a view of it."""
        row = self.row(width, height)
        host = np.concatenate([row, row[0:16].reshape(4, 4).T.reshape(-1),
                               row[16:32].reshape(4, 4).T.reshape(-1)])
        buf = host_to_device(torch.from_numpy(host), device)
        spec = CameraSpec(
            inv_projection=buf[CAMERA_ROW:CAMERA_ROW + 16].view(4, 4),
            inv_view=buf[CAMERA_ROW + 16:CAMERA_ROW + 32].view(4, 4),
            position=buf[32:35],
            focus_distance=buf[35],
            defocus_strength=buf[36],
            blur_strength=buf[37],
        )
        spec.row = buf[:CAMERA_ROW]
        return spec

    # -- interactive-controller parity helpers (RayTracing.cpp:522-595) -----
    def move(self, forward: float = 0.0, right: float = 0.0, up: float = 0.0,
             dt: float = 1.0, speed: float = 1.0) -> None:
        fwd = np.asarray(self.direction, np.float64)
        r = np.cross(fwd, self.UP)
        self.position = (np.asarray(self.position, np.float64)
                         + (forward * fwd + right * r + up * self.UP) * speed * dt)

    def orbit(self, angle_deg: float, radius: float = 2.0) -> None:
        """Perf-harness orbit (ref RayTracing.cpp:608-612): pos on r-circle in
        the XZ plane, looking at the origin."""
        a = np.radians(angle_deg)
        self.position = radius * np.array([np.cos(a), 0.0, np.sin(a)])
        self.direction = -self.position

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)
