"""Process-group bring-up and the host barrier.

The counterpart of llama_pipeline_parallel_tpu/parallel/distributed.py over
`torch.distributed`: `initialize_distributed` joins the process group that a
launcher describes in the environment (`python -m torch.distributed.run`
sets `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`), with `gloo` on
the CPU and `nccl` on cards; a lone process initialises nothing. `barrier`
waits for every process, and raises BarrierTimeoutError when a peer does not
arrive within its deadline.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_DEFAULT_BARRIER_TIMEOUT_S = 1800.0


class BarrierTimeoutError(RuntimeError):
    """The barrier's deadline expired: a peer is dead or hung. Never
    retried: peers that already passed will not re-enter it."""


def _env_int(name: str) -> int | None:
    # `or None`: launchers that export unset shell variables give ""
    value = os.environ.get(name) or None
    return None if value is None else int(value)


def initialize_distributed(device: str | torch.device = "cuda") -> None:
    """Join the launcher's process group, once: `gloo` for a CPU run,
    `nccl` on cards (each rank on card `LOCAL_RANK`). Nothing happens for a
    lone process (no `WORLD_SIZE`, or 1). A rank without a world size, or a
    world size without `MASTER_ADDR`, is refused: running N independent
    copies of one training run is the worst outcome of a half-configured
    launcher."""
    if dist.is_initialized():
        return
    world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    if world is None or world == 1:
        if rank:
            raise ValueError(f"RANK={rank} but WORLD_SIZE is {world}; set both, or neither "
                             f"for a one-process run")
        return
    if rank is None or not os.environ.get("MASTER_ADDR"):
        raise ValueError(f"WORLD_SIZE={world} needs RANK and MASTER_ADDR/MASTER_PORT too "
                         f"(python -m torch.distributed.run sets all of them)")
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    dist.init_process_group(backend=backend, rank=rank, world_size=world)
    logger.info("torch.distributed initialised: process %d/%d (%s)", rank, world, backend)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier(tag: str = "sync", timeout_s: float = _DEFAULT_BARRIER_TIMEOUT_S) -> None:
    """Wait for every process of the group (a no-op alone). A peer that has
    not arrived within `timeout_s` raises BarrierTimeoutError naming `tag`."""
    if process_count() == 1:
        return
    timeout = float(timeout_s)
    work = dist.barrier(async_op=True)
    try:
        done = work.wait(timeout=datetime.timedelta(seconds=timeout))
    except RuntimeError as e:
        raise BarrierTimeoutError(f"barrier {tag!r}: a peer did not arrive within "
                                  f"{timeout:.0f} s ({e})") from e
    if done is False:
        raise BarrierTimeoutError(f"barrier {tag!r}: a peer did not arrive within "
                                  f"{timeout:.0f} s")
