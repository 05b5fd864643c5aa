"""The parallel layout: axis degrees, and which pipeline stages this process runs.

The counterpart of llama_pipeline_parallel_tpu/parallel/mesh.py. There the
layout is a `jax.sharding.Mesh` over four named axes; here it is a
`MeshConfig` (the same degrees, validation and `describe()`) and a `Mesh`
that knows the pipeline's size, the stages this process runs and the
process group they talk over:

- one process and `pp > 1`: every stage in this process, handing tensors
  over in memory (parallel/pipeline.LocalTransport), on one device;
- `world_size == pp`: one stage per process, rank r running stage r over
  `torch.distributed` point-to-point (parallel/pipeline.DistTransport).

Any other process count is refused by name: dp, tp and sp are not ported.
"""

from __future__ import annotations

import dataclasses

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
    it runs (all of them in one process, else its rank's), `rank` and
    `process_count` its place in the process group (0 and 1 alone). With dp
    = tp = sp = 1 the pp group is the whole default group, so the stages
    talk over it."""

    config: MeshConfig
    stages: tuple[int, ...]
    rank: int = 0
    process_count: int = 1

    @property
    def pp(self) -> int:
        return self.config.pp

    @property
    def in_process(self) -> bool:
        """Whether every stage runs in this process."""
        return self.process_count == 1


def make_mesh(config: MeshConfig) -> Mesh:
    """The layout for this process: alone, every stage here; under an
    initialised process group of `pp` processes, rank r runs stage r. dp,
    tp or sp > 1, and any other process count, are refused by name."""
    other = {ax: n for ax, n in config.axis_sizes().items() if ax != AXIS_PP and n != 1}
    if other:
        raise NotImplementedError(
            f"not ported yet: {other} (data, tensor and sequence parallelism come with "
            f"later slices; this package runs pp > 1 with dp = tp = sp = 1)")
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world == 1:
        return Mesh(config=config, stages=tuple(range(config.pp)))
    if world != config.pp:
        raise ValueError(
            f"{world} processes for mesh {config.describe()}: a pipeline runs either in one "
            f"process (every stage on one device) or in exactly pp={config.pp} processes "
            f"(one stage each)")
    rank = dist.get_rank()
    return Mesh(config=config, stages=(rank,), rank=rank, process_count=world)
