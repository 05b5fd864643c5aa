"""The parallel layout: axis degrees, and which stages and replica this process runs.

The counterpart of llama_pipeline_parallel_tpu/parallel/mesh.py. There the
layout is a `jax.sharding.Mesh` over four named axes in the row-major
`(pp, dp, sp, tp)` device order; here it is a `MeshConfig` (the same degrees,
validation and `describe()`) and a `Mesh` that knows the pipeline's size,
the stages this process runs, its data-parallel replica and the process
groups it talks over:

- one process (dp = 1): every stage in this process, handing tensors over
  in memory (parallel/pipeline.LocalTransport), on one device;
- `world == pp * dp`: one stage per process. Rank r runs stage `r // dp` of
  replica `r % dp` (the reference's device order), its stages talk over
  `torch.distributed` point-to-point (parallel/pipeline.DistTransport);
- `world == dp` with pp > 1: every stage in each process over the local
  transport, one replica a process.

The groups are built once, on every process in the same order: this
replica's pp group (the stage handoffs, the gradient norm's stage sums, the
loss from the last stage), this stage's dp group (the gradient and ZeRO-1
collectives, the valid-target count) and, for the stop vote, the whole world
(parallel/distributed.py). A group of one process is None: nothing to
reduce. tp and sp > 1, and any other process count, are refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch.distributed as dist

AXIS_PP = "pp"
AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Degrees of each parallelism axis (the reference's MeshConfig; its
    reserved `ep` axis is refused above 1 there and absent here)."""

    pp: int = 1
    dp: int = 1
    tp: int = 1
    sp: int = 1

    def __post_init__(self) -> None:
        for axis in ("pp", "dp", "tp", "sp"):
            if getattr(self, axis) < 1:
                raise ValueError(f"axis {axis} must be >= 1, got {getattr(self, axis)}")

    def axis_sizes(self) -> dict[str, int]:
        return {AXIS_PP: self.pp, AXIS_DP: self.dp, AXIS_SP: self.sp, AXIS_TP: self.tp}

    def describe(self) -> str:
        """Compact layout label ("pp2xdp4xtp1xsp1") for logs and the
        checkpoint's topology record."""
        return f"pp{self.pp}xdp{self.dp}xtp{self.tp}xsp{self.sp}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The layout as this process sees it: `stages` are the pipeline stages
    it runs, `replica` its data-parallel replica, `rank` and
    `process_count` its place in the process group (0 and 1 alone).
    `pp_ranks[s]` is the global rank that runs stage s of this replica
    (under one stage a process); `pp_group` / `dp_group` are the process
    groups of this replica's stages and of this stage's replicas, None
    where the group is this process alone."""

    config: MeshConfig
    stages: tuple[int, ...]
    rank: int = 0
    process_count: int = 1
    replica: int = 0
    pp_ranks: tuple[int, ...] = ()
    pp_group: Any = None
    dp_group: Any = None

    @property
    def pp(self) -> int:
        return self.config.pp

    @property
    def dp(self) -> int:
        return self.config.dp

    @property
    def in_process(self) -> bool:
        """Whether every stage runs in this process."""
        return len(self.stages) == self.pp

    def rank_of(self, stage: int, replica: int) -> int:
        """The process that runs `stage` of `replica`."""
        if self.process_count == 1:
            return 0
        return replica if self.in_process else stage * self.dp + replica


def layout_for(config: MeshConfig, world: int) -> str:
    """Which layout `world` processes run `config` in: "in_process" (one
    process, dp = 1), "stage_per_process" (world = pp * dp, pp > 1),
    "replica_per_process" (world = dp > 1); refuses tp / sp > 1 and any
    other process count by name."""
    other = {ax: n for ax, n in config.axis_sizes().items() if ax in (AXIS_TP, AXIS_SP) and n != 1}
    if other:
        raise NotImplementedError(
            f"not ported yet: {other} of {config.describe()} (tensor and sequence parallelism "
            f"come with later slices; this package runs pp x dp)")
    if world == 1 and config.dp == 1:
        return "in_process"
    if config.pp > 1 and world == config.pp * config.dp:
        return "stage_per_process"
    if world == config.dp:
        return "replica_per_process"
    raise ValueError(
        f"{world} processes for mesh {config.describe()}: run it in pp*dp={config.pp * config.dp} "
        f"processes (one stage each)"
        + (f" or dp={config.dp} processes (every stage in each)" if config.pp > 1 else "")
        + (" under python -m torch.distributed.run" if world == 1 else "")
        + ("; dp=1 also runs in one process" if config.dp == 1 else ""))


def make_mesh(config: MeshConfig) -> Mesh:
    """The layout for this process (layout_for), with its process groups.
    Every process of the group must call it at the same point: the groups
    are created collectively."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    layout = layout_for(config, world)
    if layout == "in_process":
        return Mesh(config=config, stages=tuple(range(config.pp)))
    rank = dist.get_rank()
    pp, dp = config.pp, config.dp
    if layout == "replica_per_process":
        return Mesh(config=config, stages=tuple(range(pp)), rank=rank, process_count=world,
                    replica=rank, dp_group=dist.group.WORLD)
    stage, replica = divmod(rank, dp)
    pp_groups = [dist.new_group([s * dp + j for s in range(pp)]) for j in range(dp)]
    dp_groups = [dist.new_group([stage_ * dp + j for j in range(dp)]) if dp > 1 else None
                 for stage_ in range(pp)]
    return Mesh(config=config, stages=(stage,), rank=rank, process_count=world,
                replica=replica, pp_ranks=tuple(s * dp + replica for s in range(pp)),
                pp_group=pp_groups[replica], dp_group=dp_groups[stage])


def host_dp_shard(mesh: Mesh) -> tuple[int, int]:
    """(first_dp_index, count) of the dp replicas THIS process loads data
    for (the reference's `host_dp_shard`): its own replica under several
    processes, every replica alone. The loader's `dp_range`."""
    if mesh.process_count == 1:
        return 0, mesh.dp
    return mesh.replica, 1
