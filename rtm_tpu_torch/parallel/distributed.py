"""Multi-process runtime bring-up on torch.distributed.

Port of rtm_tpu/parallel/distributed.py.  rtm_tpu brings up
`jax.distributed` (one controller per host, every local chip in one
process); PyTorch runs one process per rank, each on one device, joined
by a process group: NCCL between GPUs, gloo on the CPU.  The sharding
layer (parallel/sharding.py) sees the group through a 1-D DeviceMesh and
does not care which backend carries it.
"""
from __future__ import annotations

import datetime
import logging
import os
import time

import torch
import torch.distributed as dist

log = logging.getLogger("rtm.parallel")

# the variables torchrun sets for each rank it starts
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def rank_device(device=None) -> torch.device:
    """This rank's device: `cuda:{LOCAL_RANK % device_count}`, or the CPU
    only when the caller asks (device="cpu").  Raises without a card
    unless asked for the CPU: the entry points never drop to the CPU by
    themselves.  On a one-card machine every rank is cuda:0."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "rtm_tpu_torch.parallel: no CUDA device; pass device='cpu' "
            "(and backend='gloo') to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           retries: int = 3, retry_delay_s: float = 5.0,
                           backend: str | None = None,
                           timeout_s: float = 300.0) -> bool:
    """Join the process group (idempotent, with retry).

    Returns True at once when the group is already up.  With no
    coordinator, no process count and no torchrun environment
    (RANK / WORLD_SIZE / MASTER_ADDR) this is a single-process run: it
    does nothing and returns False, as rtm_tpu's does.  Otherwise it calls
    `init_process_group(init_method="tcp://<coordinator_address>",
    world_size=num_processes, rank=process_id)`, the torchrun variables
    filling what the arguments leave out, up to `retries` times, and
    raises RuntimeError from the last error.

    backend: None picks NCCL on this rank's CUDA device (rank_device, made
    current first); "gloo" is what the CPU, or several ranks sharing one
    card, take.  A failed NCCL start raises: it never falls to gloo.
    timeout_s bounds each attempt's rendezvous and every later
    collective."""
    if dist.is_initialized():
        return True
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and not all(k in env for k in _TORCHRUN_ENV)):
        return False
    if coordinator_address is None:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if backend is None:
        torch.cuda.set_device(rank_device())
        backend = "nccl"
    last = None
    for attempt in range(retries):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(seconds=timeout_s))
            log.info("process group up (%s): rank %d/%d", backend,
                     dist.get_rank(), dist.get_world_size())
            return True
        except Exception as e:  # noqa: BLE001 - retry then surface
            last = e
            log.warning("process group attempt %d failed: %s", attempt, e)
            if attempt + 1 < retries:
                time.sleep(retry_delay_s)
    raise RuntimeError(f"torch.distributed.init_process_group ({backend}) "
                       f"failed after {retries} attempts") from last


def local_device_count() -> int:
    return torch.cuda.device_count()


def global_device_count() -> int:
    """The world size: one device per rank (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1
