"""Multi-GPU execution on torch.distributed (port of rtm_tpu/parallel).

Pixel-band data parallelism over a 1-D DeviceMesh, sample-axis sharding,
all-reduced scene-parameter gradients and the distributed train step
(sharding.py), and process-group bring-up (distributed.py): NCCL between
GPUs, gloo on the CPU and for several ranks sharing one card.
`python -m rtm_tpu_torch.parallel.smoke` spawns a world and checks it.
"""
from .distributed import initialize_distributed
from .sharding import (DP_AXIS, make_mesh, make_train_step, render_sharded,
                       render_sharded_spp, sharded_loss_and_grad)

__all__ = [
    "DP_AXIS", "make_mesh", "make_train_step", "render_sharded",
    "render_sharded_spp", "sharded_loss_and_grad", "initialize_distributed",
]
