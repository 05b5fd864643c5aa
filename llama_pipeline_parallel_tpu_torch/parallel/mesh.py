"""The parallel layout: axis degrees, and which stages and replica this process runs.

The counterpart of llama_pipeline_parallel_tpu/parallel/mesh.py. There the
layout is a `jax.sharding.Mesh` over four named axes in the row-major
`(pp, dp, sp, tp)` device order; here it is a `MeshConfig` (the same degrees,
validation and `describe()`) and a `Mesh` that knows the pipeline's size,
the stages this process runs, its data-parallel replica and the process
groups it talks over:

- one process (dp = tp = sp = 1): every stage in this process, handing
  tensors over in memory (parallel/pipeline.LocalTransport), on one device;
- `world == pp * dp * sp * tp` with pp > 1: one (stage, replica, sp rank, tp
  rank) per process, in the reference's row-major `(pp, dp, sp, tp)` device
  order: rank `((stage * dp + replica) * sp + s) * tp + t`; stages talk over
  `torch.distributed` point-to-point (parallel/pipeline.DistTransport);
- `world == dp * sp * tp` (pp = 1, or pp > 1 with sp = tp = 1): every stage
  in each process over the local transport, one (replica, sp rank, tp rank)
  a process, rank `(replica * sp + s) * tp + t`.

The groups are built once, on every process in the same order: this
replica's pp group of its sp and tp ranks (the stage handoffs, the gradient
norm's stage sums, the loss from the last stage), this stage's dp group of
its sp and tp ranks (the gradient and ZeRO-1 collectives, the valid-target
count), this stage's tp group of its replica and sp rank (parallel/tp.py's
collectives), this stage's sp group of its replica and tp rank (the ring,
Ulysses, the label shift and the sums over the sequence slabs:
parallel/sp.py) and, for the stop vote, the whole world
(parallel/distributed.py). A group of one process is None: nothing to
reduce. Every stage in one process at sp > 1, and any other process count,
are refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch.distributed as dist

from llama_pipeline_parallel_tpu_torch.parallel import distributed

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
    `pp_ranks[s]` is the global rank that runs stage s of this replica at
    this tp rank (under one stage a process); `pp_group` / `dp_group` /
    `tp_group` / `sp_group` are the process groups of this replica's
    stages, of this stage's replicas, of this stage's tp ranks and of its
    sequence slabs, None where the group is this process alone; `tp_rank`
    and `sp_rank` are this process's places among its tp ranks and among
    its slabs."""

    config: MeshConfig
    stages: tuple[int, ...]
    rank: int = 0
    process_count: int = 1
    replica: int = 0
    pp_ranks: tuple[int, ...] = ()
    pp_group: Any = None
    dp_group: Any = None
    tp_rank: int = 0
    tp_group: Any = None
    sp_rank: int = 0
    sp_group: Any = None

    @property
    def pp(self) -> int:
        return self.config.pp

    @property
    def dp(self) -> int:
        return self.config.dp

    @property
    def tp(self) -> int:
        return self.config.tp

    @property
    def sp(self) -> int:
        return self.config.sp

    @property
    def in_process(self) -> bool:
        """Whether every stage runs in this process."""
        return len(self.stages) == self.pp

    def rank_of(self, stage: int, replica: int, tp_rank: int = 0, sp_rank: int = 0) -> int:
        """The process that runs `stage` of `replica` at `tp_rank` and
        `sp_rank`."""
        if self.process_count == 1:
            return 0
        stage = 0 if self.in_process else stage
        return ((stage * self.dp + replica) * self.sp + sp_rank) * self.tp + tp_rank


def layout_for(config: MeshConfig, world: int) -> str:
    """Which layout `world` processes run `config` in: "in_process" (one
    process, dp = tp = sp = 1), "stage_per_process" (world = pp * dp * sp *
    tp, pp > 1), "replica_per_process" (world = dp * sp * tp, every stage in
    each process; pp = 1 under tp or sp > 1); refuses every stage in one
    process at sp > 1, and any other process count, by name."""
    pp, dp, tp, sp = config.pp, config.dp, config.tp, config.sp
    if world == 1 and dp == 1 and tp == 1 and sp == 1:
        return "in_process"
    if pp > 1 and world == pp * dp * sp * tp:
        return "stage_per_process"
    if world == dp * sp * tp and (pp == 1 or (tp == 1 and sp == 1)):
        return "replica_per_process"
    if pp > 1 and sp > 1 and world == dp * sp * tp:
        raise ValueError(
            f"{world} processes for mesh {config.describe()}: every stage in one process "
            f"is not run at sp={sp} (a slab's collectives would interleave across the "
            f"process's stages); run it in pp*dp*sp*tp={pp * dp * sp * tp} processes, one "
            f"stage each")
    axes = "*".join(ax for ax, n in (("dp", dp), ("sp", sp), ("tp", tp))
                    if n > 1 or ax == "dp")
    ways = [f"pp*{axes}={pp * dp * sp * tp} processes (one stage each)"]
    if pp == 1 and (tp > 1 or sp > 1):
        ways = [f"{axes}={dp * sp * tp} processes"]
    elif pp > 1 and tp == 1 and sp == 1:
        ways.append(f"dp={dp} processes (every stage in each)")
    raise ValueError(
        f"{world} processes for mesh {config.describe()}: run it in " + " or ".join(ways)
        + (" under python -m torch.distributed.run" if world == 1 else "")
        + ("; dp=1 also runs in one process" if dp == 1 and tp == 1 and sp == 1 else ""))


def make_mesh(config: MeshConfig) -> Mesh:
    """The layout for this process (layout_for), with its process groups.
    Every process of the group must call it at the same point: the groups
    are created collectively, all of them on every process in one order."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    layout = layout_for(config, world)
    if layout == "in_process":
        return Mesh(config=config, stages=tuple(range(config.pp)))
    rank = dist.get_rank()
    pp, dp, tp, sp = config.pp, config.dp, config.tp, config.sp
    per_stage = layout == "stage_per_process"
    n_stages = pp if per_stage else 1

    def rank_at(s, j, q, t):
        return ((s * dp + j) * sp + q) * tp + t

    cell, t = divmod(rank, tp)
    cell, q = divmod(cell, sp)
    stage, replica = divmod(cell, dp)

    def groups(size, members):
        """Every such group (created on every process, in one order) and
        this process's: None where the groups are single processes."""
        if size == 1:
            return None
        mine = None
        for ranks in members:
            group = dist.new_group(ranks) if len(ranks) < world else dist.group.WORLD
            if rank in ranks:
                mine = group
        return mine

    cells = [(s, j, c, u) for s in range(n_stages) for j in range(dp) for c in range(sp)
             for u in range(tp)]
    pp_group = groups(n_stages, [[rank_at(s, j, c, u) for s in range(n_stages)]
                                 for (s0, j, c, u) in cells if s0 == 0])
    dp_group = groups(dp, [[rank_at(s, j, c, u) for j in range(dp)]
                           for (s, j0, c, u) in cells if j0 == 0])
    tp_group = groups(tp, [[rank_at(s, j, c, u) for u in range(tp)]
                           for (s, j, c, u0) in cells if u0 == 0])
    sp_group = groups(sp, [[rank_at(s, j, c, u) for c in range(sp)]
                           for (s, j, c0, u) in cells if c0 == 0])
    for group, label in ((pp_group, "pp"), (dp_group, "dp"), (tp_group, "tp"),
                         (sp_group, "sp")):
        distributed.label_group(group, label)
    stages = (stage,) if per_stage else tuple(range(pp))
    return Mesh(config=config, stages=stages, rank=rank, process_count=world,
                replica=replica, pp_ranks=tuple(rank_at(s, replica, q, t) for s in range(pp))
                if per_stage else (), pp_group=pp_group, dp_group=dp_group, tp_rank=t,
                tp_group=tp_group, sp_rank=q, sp_group=sp_group)


def host_dp_shard(mesh: Mesh) -> tuple[int, int]:
    """(first_dp_index, count) of the dp replicas THIS process loads data
    for (the reference's `host_dp_shard`): its own replica under several
    processes (the same rows for its tp ranks), every replica alone. The
    loader's `dp_range`."""
    if mesh.process_count == 1:
        return 0, mesh.dp
    return mesh.replica, 1


def sp_slab(batch: dict, mesh: Mesh) -> dict:
    """This process's column slab of every [rows, seq] field of `batch` (the
    reference's batch spec shards the sequence dim over sp): columns
    [sp_rank * seq / sp, (sp_rank + 1) * seq / sp); the batch itself at sp
    = 1."""
    if mesh.sp == 1:
        return batch
    out = {}
    for key, x in batch.items():
        n = x.shape[1] // mesh.sp
        out[key] = x[:, mesh.sp_rank * n:(mesh.sp_rank + 1) * n]
    return out
