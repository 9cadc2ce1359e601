"""rtm_tpu_torch — the PyTorch/CUDA port of rtm_tpu, a differentiable,
progressive path tracer, for NVIDIA Hopper GPUs.

The package mirrors rtm_tpu's module layout.  Host code (scenes, meshes,
BVH builder, loaders) is NumPy; device code is PyTorch, and each of
rtm_tpu's Pallas TPU kernels becomes a hand-written CUDA kernel under
`csrc/` with a plain PyTorch version beside it.  It never imports JAX or
rtm_tpu.  Entry points run on the card unless the caller asks for the CPU
(`build_tracer_scene(..., device="cpu")`), where the kernels' plain
versions run.  Every Pallas kernel of rtm_tpu has its CUDA counterpart:
the mxu forward path, the trav path and the megakernel for scenes beyond
the mxu tables, and the differentiable path (the XLA-style reference
renderer, the wavefront2 and per-bounce `pallas` backends, mxu record
replay, `loss_and_grad` / `inverse_render`).  `python -m rtm_tpu_torch`
is the command-line entry point; see ROADMAP.md for what is left.
"""

from .config import RenderConfig
from .diff import (InverseRenderConfig, SceneParams, apply_params,
                   extract_params, inverse_render, loss_and_grad, render_loss)
from .models.camera import Camera, CameraSpec
from .models.material import Material, Materials
from .models.mesh import Mesh, MeshInstance, Triangle
from .models.scene import (Scene, SphereDef, TracerScene, build_tracer_scene,
                           tracer_scene_from_numpy)
from .models.scenes import load_scene
from .ops.trace_ref import render_dispatch
from .runtime.renderer import (ProgressiveRenderer, accumulate_step,
                               render_progressive)

__version__ = "0.1.0"
