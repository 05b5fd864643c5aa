"""The canonical checkpoint tree of a train state spread over processes,
written by process 0 one leaf at a time.

A run holds its state in pieces: each stage's chunk leaves of the params
(every replica of a stage holds the same; replica 0's are saved) and of the
optimizer's state, which under ZeRO-1 (the moments) or the host optimizer's
ZeRO-2 layout (its masters and moments) are split further, replica j
holding slice j of a leaf on its `zero1_dim` (optim/optimizer.zero1_dims);
under tensor parallelism every piece of a split leaf is one tp rank's slice
(parallel/tp.py), and tp rank 0 holds the replicated ones; under sequence
parallelism every sp peer holds the same pieces, and sp rank 0's are
catalogued (`rank_of` names it), each piece once. `ShardedState`
names every piece the same way on every process (a catalogue built from the
manifest and the leaf shapes) and knows which process holds it. Process 0
writes the canonical tree as tensor_io.Lazy leaves: writing a leaf fetches
its pieces (its own, or asked for by catalogue index from the process that
holds them, over the commit's gloo group), joins them on the host (the dp
slices, then the tp slices) and lets them go before the next leaf. The
other processes `serve` those requests until process 0 says it is done. So
process 0 holds one canonical leaf at a time besides its own pieces, nothing
is gathered on a card, and a write that the storage retry policy repeats
simply asks again. Under an async save each process first copies the pieces
it holds to host memory (`owned`).

Two layouts of files: the device optimizer's (`params`, and `opt`: `mu.`,
`nu.` and `count`) and the host optimizer's `offload_parts` (`params` from
its fp32 masters, `opt_m`, `opt_v`; `count` is its step count).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.distributed as dist

from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.optim.optimizer import zero1_dims
from llama_pipeline_parallel_tpu_torch.parallel.tp import tp_dim

# what process 0 sends in place of a catalogue index when its writes end
_DONE, _FAILED = -1, -2

# (kind, flat name, tp rank or None where tp does not split the leaf, dp
# slice or None where the kind is not split over dp)
Key = tuple[str, str, "int | None", "int | None"]


@dataclasses.dataclass
class ShardedState:
    """A run's params and optimizer state, as this process holds them.

    `local[kind][flat]` for each kind (`kinds`: "params", then the
    optimizer's two moments) are this process's tensors under the
    optimizer's naming: its tp rank's slice of a split leaf, and of that its
    replica's slice where `dims[kind][flat]` is not None. `cells[name]`
    lists, for each canonical leaf, (first layer, stage, flat name, the
    chunk's shape on one tp rank) of the chunks that hold its rows.
    `rank_of(stage, replica, tp_rank)` is the process that holds that piece;
    `dp` and `tp` the replica and tp rank counts. `offload`: the host
    optimizer's file layout, `count` its step count (else AdamW's)."""

    local: dict[str, dict[str, torch.Tensor]]
    cells: dict[str, list[tuple[int, int, str, tuple[int, ...]]]]
    dims: dict[str, dict[str, int | None]]
    dp: int
    rank: int
    rank_of: Callable[..., int]
    count: int
    group: Any = None
    tp: int = 1
    offload: bool = False

    def __post_init__(self) -> None:
        # the catalogue: every piece, in one order on every process
        self._keys: list[Key] = []
        self._owner: dict[Key, int] = {}
        self._shape: dict[Key, tuple[int, ...]] = {}
        for name in sorted(self.cells):
            for _, stage, flat, shape in self.cells[name]:
                tps = range(self.tp) if self._tp_dim(flat, shape) is not None else [None]
                for kind in self.kinds:
                    dim = self.dims[kind][flat]
                    part = list(shape)
                    if dim is not None:
                        part[dim] //= self.dp
                    for t in tps:
                        for j in ([None] if dim is None else range(self.dp)):
                            key = (kind, flat, t, j)
                            self._keys.append(key)
                            self._owner[key] = self.rank_of(stage, j or 0, t or 0)
                            self._shape[key] = tuple(part)
        self._index = {key: i for i, key in enumerate(self._keys)}

    @property
    def kinds(self) -> tuple[str, ...]:
        return ("params", "m", "v") if self.offload else ("params", "mu", "nu")

    def _tp_dim(self, flat: str, shape: tuple[int, ...]) -> int | None:
        return tp_dim(flat, len(shape)) if self.tp > 1 else None

    @classmethod
    def of_run(cls, local: dict[str, dict[str, torch.Tensor]],
               dims: dict[str, dict[str, int | None]] | None, count: int,
               manifest: StageManifest, structure: dict[int, list[dict[str, torch.Tensor]]],
               pipelined: bool, dp: int, rank: int, rank_of: Callable[..., int],
               group: Any = None, tp: int = 1, offload: bool = False) -> "ShardedState":
        """A trainer's state: `local` (params and the optimizer's state,
        named `s{stage}c{chunk}/{name}` when `pipelined`, else canonically:
        one stage), with `dims` the dp split of each of this process's
        leaves by kind (None: nothing split). `structure` is every stage's
        chunk trees on one tp rank (parallel/pipeline.chunk_views of the
        canonical shapes: only their shapes are read). Every process places
        every leaf's dp slices by the optimizer's own rule
        (optim/optimizer.zero1_dims), which the local `dims` must follow."""
        cells: dict[str, list] = {}
        for s, chunks in structure.items():
            for c, tree in enumerate(chunks):
                first = manifest.layers_of_chunk(s, c).start
                for name, leaf in tree.items():
                    flat = f"s{s}c{c}/{name}" if pipelined else name
                    cells.setdefault(name, []).append((first, s, flat, tuple(leaf.shape)))
        shapes = {flat: shape for cs in cells.values() for _, _, flat, shape in cs}
        rule = zero1_dims(shapes, dp, tp)
        full = {}
        for kind, mine in (dims or {}).items():
            for flat, dim in mine.items():
                if dim != rule[flat]:
                    raise ValueError(f"{flat}: the optimizer splits its {kind} on dim {dim}, "
                                     f"zero1_dim on {rule[flat]}")
            full[kind] = rule
        nothing = dict.fromkeys(shapes)
        return cls(local=local, cells=cells,
                   dims={kind: full.get(kind, nothing) for kind in local}, dp=dp, rank=rank,
                   rank_of=rank_of, count=int(count), group=group, tp=tp, offload=offload)

    def owned(self) -> dict[str, torch.Tensor]:
        """The pieces this process holds, {"kind/flat/tp/slice": tensor}: what
        an async save copies to host memory (`with_local`)."""
        return {_tag(key): self.local[key[0]][key[1]] for key in self._keys
                if self._owner[key] == self.rank}

    def with_local(self, owned: dict[str, torch.Tensor]) -> "ShardedState":
        """This state reading its own pieces from `owned` (owned()'s keys)."""
        local: dict[str, dict[str, torch.Tensor]] = {kind: {} for kind in self.local}
        for key in self._keys:
            if self._owner[key] == self.rank:
                local[key[0]][key[1]] = owned[_tag(key)]
        return dataclasses.replace(self, local=local)

    # -- process 0 ------------------------------------------------------------

    def files(self) -> dict[str, dict[str, Any]]:
        """The tensors of each canonical file by its role ("params" and
        "opt", or under `offload` "params", "opt_m" and "opt_v"), each leaf
        a tensor_io.Lazy that fetches and joins its pieces when written."""
        files: dict[str, dict[str, Any]] = {role: {} for role in (
            ("params", "opt_m", "opt_v") if self.offload else ("params", "opt"))}
        for name, cells in self.cells.items():
            shape = self._canonical_shape(cells)
            for kind in self.kinds:
                lazy = tensor_io.Lazy(shape, self._dtype(kind), functools.partial(
                    self._canonical, kind, name))
                if kind == "params":
                    files["params"][name] = lazy
                elif self.offload:
                    files[f"opt_{kind}"][name] = lazy
                else:
                    files["opt"][f"{kind}.{name}"] = lazy
        if not self.offload:
            files["opt"]["count"] = torch.tensor(self.count, dtype=torch.int64)
        return files

    def _canonical_shape(self, cells) -> tuple[int, ...]:
        _, _, flat, shape = cells[0]
        shape = list(shape)
        dim = self._tp_dim(flat, tuple(shape))
        if dim is not None:
            shape[dim] *= self.tp
        if len(cells) > 1:
            shape[0] = sum(c[3][0] for c in cells)
        return tuple(shape)

    def _canonical(self, kind: str, name: str) -> torch.Tensor:
        cells = sorted(self.cells[name])
        leaves = [self._leaf(kind, flat, shape) for _, _, flat, shape in cells]
        return torch.cat(leaves) if name.startswith("layers.") else leaves[0]

    def _leaf(self, kind: str, flat: str, shape: tuple[int, ...]) -> torch.Tensor:
        """A chunk's whole leaf: each tp rank's slice joined from its dp
        slices, then the tp slices joined."""
        dim = self.dims[kind][flat]
        tp_d = self._tp_dim(flat, shape)
        slices = []
        for t in (range(self.tp) if tp_d is not None else [None]):
            if dim is None:
                slices.append(self._piece((kind, flat, t, None)))
            else:
                slices.append(torch.cat([self._piece((kind, flat, t, j))
                                         for j in range(self.dp)], dim))
        return slices[0] if tp_d is None else torch.cat(slices, tp_d)

    def _piece(self, key: Key) -> torch.Tensor:
        owner = self._owner[key]
        if owner == self.rank:
            return self.local[key[0]][key[1]].detach().to("cpu")
        dist.send(torch.tensor([self._index[key]], dtype=torch.int64), dst=owner,
                  group=self.group)
        buf = torch.empty(self._shape[key], dtype=self._dtype(key[0]))
        dist.recv(buf, src=owner, group=self.group)
        return buf

    def _dtype(self, kind: str) -> torch.dtype:
        return next(iter(self.local[kind].values())).dtype

    def done(self, ok: bool) -> None:
        """Release every serving process: the writes ended (`ok`) or failed.
        Alone: nothing to release."""
        if not dist.is_initialized():
            return
        for rank in range(dist.get_world_size()):
            if rank != self.rank:
                dist.send(torch.tensor([_DONE if ok else _FAILED], dtype=torch.int64),
                          dst=rank, group=self.group)

    # -- every other process ----------------------------------------------------

    def serve(self) -> None:
        """Send process 0 each piece it asks for (one at a time, from this
        process's tensors through host memory) until it is done; raises if
        its writes failed."""
        req = torch.empty(1, dtype=torch.int64)
        while True:
            dist.recv(req, src=0, group=self.group)
            i = int(req)
            if i == _DONE:
                return
            if i == _FAILED:
                raise RuntimeError("process 0 failed to write the checkpoint's tensors")
            kind, flat, _, _ = self._keys[i]
            dist.send(self.local[kind][flat].detach().to("cpu").contiguous(), dst=0,
                      group=self.group)


def _tag(key: Key) -> str:
    return "/".join(str(k) for k in key)
