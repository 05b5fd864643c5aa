"""DP-sharded sampling and the training data loader.

A copy of llama_pipeline_parallel_tpu/data/loader.py's sampling rules, so the
two packages emit the same batches for the same seed: per-epoch shuffling by
`RandomState(seed * 131071 + epoch)`, dp shard d takes every dp-th index, and
drop_last. Batches are numpy dicts; the trainer moves them to the device.

Resume is O(1): `iter_batches(start_batch)` / `RepeatingLoader(start_epoch,
start_batch)` open the stream at a position by index arithmetic alone, without
reading a skipped record.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Sequence

import numpy as np


@dataclasses.dataclass
class ShardedSampler:
    """Deterministic per-epoch shuffling + dp sharding + drop_last."""

    dataset_len: int
    num_replicas: int
    rank: int
    seed: int = 0

    def __post_init__(self) -> None:
        if not 0 <= self.rank < self.num_replicas:
            raise ValueError(f"rank {self.rank} out of range for {self.num_replicas} replicas")
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    @property
    def num_samples_per_replica(self) -> int:
        return self.dataset_len // self.num_replicas

    def indices(self) -> np.ndarray:
        order = np.random.RandomState(self.seed * 131071 + self._epoch).permutation(
            self.dataset_len)
        return order[self.rank::self.num_replicas][:self.num_samples_per_replica]

    def __len__(self) -> int:
        return self.num_samples_per_replica


@dataclasses.dataclass
class DataLoader:
    """Batched, collated iteration over a dataset with dp-aware ordering:
    GLOBAL batch dicts of shape [dp * per_replica_batch, ...] where rows
    [d*b:(d+1)*b] belong to dp replica d."""

    dataset: Any
    collate_fn: Callable[[Sequence[Any]], dict[str, np.ndarray]]
    per_replica_batch: int
    dp_size: int = 1
    seed: int = 0

    def __post_init__(self) -> None:
        self._samplers = [
            ShardedSampler(len(self.dataset), self.dp_size, rank=d, seed=self.seed)
            for d in range(self.dp_size)
        ]

    def set_epoch(self, epoch: int) -> None:
        for s in self._samplers:
            s.set_epoch(epoch)

    def __len__(self) -> int:
        """Batches per epoch."""
        return self._samplers[0].num_samples_per_replica // self.per_replica_batch

    @property
    def global_batch_examples(self) -> int:
        return self.dp_size * self.per_replica_batch

    def iter_batches(self, start_batch: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """One epoch of batches from `start_batch` on; the skipped prefix
        costs no record reads."""
        if not 0 <= start_batch <= len(self):
            raise ValueError(f"start_batch {start_batch} outside [0, {len(self)}]")
        per_replica = [s.indices() for s in self._samplers]
        b_rows = self.per_replica_batch
        for b in range(start_batch, len(self)):
            rows = [self.dataset[int(i)] for order in per_replica
                    for i in order[b * b_rows:(b + 1) * b_rows]]
            yield self.collate_fn(rows)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.iter_batches(0)


class RepeatingLoader:
    """Infinite wrapper advancing epochs (sampler.set_epoch each epoch);
    `start_epoch` / `start_batch` open the stream mid-run."""

    def __init__(self, loader: DataLoader, start_epoch: int = 0, start_batch: int = 0):
        if start_epoch < 0 or start_batch < 0:
            raise ValueError(f"start position ({start_epoch}, {start_batch}) "
                             f"must be non-negative")
        if start_batch >= max(len(loader), 1):
            raise ValueError(f"start_batch {start_batch} outside the epoch "
                             f"({len(loader)} batches); fold it into start_epoch")
        self.loader = loader
        self.epoch = start_epoch
        self._start_batch = start_batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            self.loader.set_epoch(self.epoch)
            skip, self._start_batch = self._start_batch, 0
            got_any = False
            for batch in self.loader.iter_batches(skip):
                got_any = True
                yield batch
            if not got_any and skip == 0:
                raise ValueError("underlying loader is empty; cannot repeat")
            self.epoch += 1
