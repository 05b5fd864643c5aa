"""The canonical checkpoint tree of a train state spread over processes,
written by process 0 one leaf at a time.

A run holds its state in pieces: each stage's chunk leaves of the params
(every replica of a stage holds the same; replica 0's are saved) and of the
Adam moments, which under ZeRO-1 are split further, replica j holding slice
j of a leaf on its `zero1_dim` (optim/optimizer.Zero1AdamW). `ShardedState`
names every piece the same way on every process (a catalogue built from the
manifest and the leaf shapes) and knows which process holds it. Process 0
writes the canonical tree as tensor_io.Lazy leaves: writing a leaf fetches
its pieces (its own, or asked for by catalogue index from the process that
holds them, over the commit's gloo group), joins them on the host and lets
them go before the next leaf. The other processes `serve` those requests
until process 0 says it is done. So process 0 holds one canonical leaf at a
time besides its own pieces, no moment is gathered on a card, and a write
that the storage retry policy repeats simply asks again. Under an async save
each process first copies the pieces it holds to host memory (`owned`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.distributed as dist

from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.optim.optimizer import zero1_dim

MOMENTS = ("mu", "nu")
# what process 0 sends in place of a catalogue index when its writes end
_DONE, _FAILED = -1, -2

Key = tuple[str, str, "int | None"]  # (kind, flat name, ZeRO-1 slice or None)


@dataclasses.dataclass
class ShardedState:
    """The params and Adam state of a run, as this process holds them.

    `local[kind][flat]` for kind in ("params", "mu", "nu") are this
    process's tensors under the optimizer's naming (a moment is this
    replica's slice where `dims[flat]` is not None). `cells[name]` lists,
    for each canonical leaf, (first layer, stage, flat name, chunk shape) of
    the chunks that hold its rows. `rank_of(stage, replica)` is the process
    that holds that stage of that replica; `dp` the replica count."""

    local: dict[str, dict[str, torch.Tensor]]
    cells: dict[str, list[tuple[int, int, str, tuple[int, ...]]]]
    dims: dict[str, int | None]
    dp: int
    rank: int
    rank_of: Callable[[int, int], int]
    count: int
    group: Any = None

    def __post_init__(self) -> None:
        # the catalogue: every piece, in one order on every process
        self._keys: list[Key] = []
        self._owner: dict[Key, int] = {}
        self._shape: dict[Key, tuple[int, ...]] = {}
        for name in sorted(self.cells):
            for _, stage, flat, shape in self.cells[name]:
                key = ("params", flat, None)
                self._add(key, self.rank_of(stage, 0), shape)
                dim = self.dims[flat]
                for kind in MOMENTS:
                    if dim is None:
                        self._add((kind, flat, None), self.rank_of(stage, 0), shape)
                        continue
                    part = list(shape)
                    part[dim] //= self.dp
                    for j in range(self.dp):
                        self._add((kind, flat, j), self.rank_of(stage, j), tuple(part))
        self._index = {key: i for i, key in enumerate(self._keys)}

    def _add(self, key: Key, owner: int, shape: tuple[int, ...]) -> None:
        self._keys.append(key)
        self._owner[key], self._shape[key] = owner, shape

    @classmethod
    def of_run(cls, params: dict[str, torch.Tensor], optimizer: Any, manifest: StageManifest,
               structure: dict[int, list[dict[str, torch.Tensor]]], pipelined: bool, dp: int,
               rank: int, rank_of: Callable[[int, int], int], group: Any = None
               ) -> "ShardedState":
        """A trainer's state: `params` and `optimizer` (AdamW or Zero1AdamW)
        under the chunk naming `s{stage}c{chunk}/{name}` when `pipelined`,
        else the canonical names (one stage). `structure` is every stage's
        chunk trees (parallel/pipeline.chunk_views of the canonical shapes:
        only their shapes are read). Every process places every leaf's
        moment slices by zero1_dim, the optimizer's own rule."""
        cells: dict[str, list] = {}
        for s, chunks in structure.items():
            for c, tree in enumerate(chunks):
                first = manifest.layers_of_chunk(s, c).start
                for name, leaf in tree.items():
                    flat = f"s{s}c{c}/{name}" if pipelined else name
                    cells.setdefault(name, []).append((first, s, flat, tuple(leaf.shape)))
        split = getattr(optimizer, "dims", None)  # Zero1AdamW's, of this process's leaves
        dims = {flat: zero1_dim(shape, dp) if split is not None else None
                for cs in cells.values() for _, _, flat, shape in cs}
        for flat, dim in (split or {}).items():
            if dims[flat] != dim:
                raise ValueError(f"{flat}: the optimizer splits its moments on dim {dim}, "
                                 f"zero1_dim on {dims[flat]}")
        return cls(local={"params": params, "mu": optimizer.mu, "nu": optimizer.nu},
                   cells=cells, dims=dims, dp=dp, rank=rank, rank_of=rank_of,
                   count=int(optimizer.count), group=group)

    def owned(self) -> dict[str, torch.Tensor]:
        """The pieces this process holds, {"kind/flat/slice": tensor}: what
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

    def files(self) -> tuple[dict[str, tensor_io.Lazy], dict[str, Any]]:
        """(params, optimizer) tensors of the canonical files, each leaf a
        tensor_io.Lazy that fetches and joins its pieces when written."""
        params, opt = {}, {}
        for name, cells in self.cells.items():
            shape = _canonical_shape(cells)
            params[name] = tensor_io.Lazy(shape, self._dtype("params"), functools.partial(
                self._canonical, "params", name))
            for kind in MOMENTS:
                opt[f"{kind}.{name}"] = tensor_io.Lazy(shape, self._dtype(kind),
                                                       functools.partial(self._canonical, kind,
                                                                         name))
        opt["count"] = torch.tensor(self.count, dtype=torch.int64)
        return params, opt

    def _canonical(self, kind: str, name: str) -> torch.Tensor:
        cells = sorted(self.cells[name])
        leaves = [self._leaf(kind, flat) for _, _, flat, _ in cells]
        return torch.cat(leaves) if name.startswith("layers.") else leaves[0]

    def _leaf(self, kind: str, flat: str) -> torch.Tensor:
        dim = None if kind == "params" else self.dims[flat]
        if dim is None:
            return self._piece((kind, flat, None))
        return torch.cat([self._piece((kind, flat, j)) for j in range(self.dp)], dim)

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
            kind, flat, _ = self._keys[i]
            dist.send(self.local[kind][flat].detach().to("cpu").contiguous(), dst=0,
                      group=self.group)


def _tag(key: Key) -> str:
    return f"{key[0]}/{key[1]}/{key[2]}"


def _canonical_shape(cells: list[tuple[int, int, str, tuple[int, ...]]]) -> tuple[int, ...]:
    shape = cells[0][3]
    if len(cells) == 1:
        return shape
    return (sum(c[3][0] for c in cells),) + tuple(shape[1:])

