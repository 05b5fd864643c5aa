"""DP-sharded sampling and the training data loader.

A copy of llama_pipeline_parallel_tpu/data/loader.py's sampling rules, so the
two packages emit the same batches for the same seed: per-epoch shuffling by
`RandomState(seed * 131071 + epoch)`, dp shard d takes every dp-th index, and
drop_last. Batches are numpy dicts; the trainer moves them to the device.

Resume is O(1): `iter_batches(start_batch)` / `RepeatingLoader(start_epoch,
start_batch)` open the stream at a position by index arithmetic alone, without
reading a skipped record.

Every record read fires the `data_read` fault site and runs under the shared
transient-retry policy (utils/faults.py, utils/retry.py). With
`quarantine_bad_records` a record that stays unreadable is replaced by the
next healthy index instead of ending the run; `sample_ledger` appends each
batch's indices to a JSONL file; `PrefetchIterator` collates the next batches
on a background thread.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from llama_pipeline_parallel_tpu_torch.utils import faults, retry, trace
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class CorruptRecordError(OSError):
    """A dataset read produced an unusable record (None, or a fault-injected
    corruption). An OSError, so it is retried like any transient read."""


@dataclasses.dataclass
class ShardedSampler:
    """Deterministic per-epoch shuffling + dp sharding + drop_last."""

    dataset_len: int
    num_replicas: int
    rank: int
    shuffle: bool = True
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
        order = np.arange(self.dataset_len)
        if self.shuffle:
            order = np.random.RandomState(self.seed * 131071 + self._epoch).permutation(order)
        return order[self.rank::self.num_replicas][:self.num_samples_per_replica]

    def __len__(self) -> int:
        return self.num_samples_per_replica


@dataclasses.dataclass
class DataLoader:
    """Batched, collated iteration over a dataset with dp-aware ordering:
    GLOBAL batch dicts of shape [dp * per_replica_batch, ...] where rows
    [d*b:(d+1)*b] belong to dp replica d. `dp_range` = (first, count) names
    the replicas this process reads (None: all of them)."""

    dataset: Any
    collate_fn: Callable[[Sequence[Any]], dict[str, np.ndarray]]
    per_replica_batch: int
    dp_size: int = 1
    shuffle: bool = True  # False: dataset order (the evaluator's loader)
    seed: int = 0
    dp_range: tuple[int, int] | None = None
    # a record still unreadable after the retry budget is quarantined (skipped,
    # counted, a deterministic substitute trains in its place) instead of
    # ending the run; off by default: losing data must be asked for
    quarantine_bad_records: bool = False
    # append one {"epoch", "batch", "indices"} JSONL row per emitted batch
    sample_ledger: str | None = None

    def __post_init__(self) -> None:
        first, count = self.dp_range if self.dp_range is not None else (0, self.dp_size)
        if not (0 <= first and first + count <= self.dp_size):
            raise ValueError(f"dp_range {self.dp_range} outside dp_size {self.dp_size}")
        self._local_dp = range(first, first + count)
        self._retry_policy = retry.RetryPolicy.from_env()  # once, not per record
        self._samplers = [
            ShardedSampler(len(self.dataset), self.dp_size, rank=d, shuffle=self.shuffle,
                           seed=self.seed)
            for d in self._local_dp
        ]
        self.records_read = 0       # successful dataset fetches
        self.quarantine_count = 0   # records skipped as persistently bad
        self._quarantined: set[int] = set()
        self._ledger_f = (open(self.sample_ledger, "a", buffering=1)
                          if self.sample_ledger else None)

    def close_ledger(self) -> None:
        """Close the sample ledger (a no-op without one). A prefetch thread
        caught mid-write sees the None'd handle or a ValueError it ignores."""
        f, self._ledger_f = self._ledger_f, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def set_epoch(self, epoch: int) -> None:
        for s in self._samplers:
            s.set_epoch(epoch)

    def __len__(self) -> int:
        """Batches per epoch."""
        return self._samplers[0].num_samples_per_replica // self.per_replica_batch

    @property
    def global_batch_examples(self) -> int:
        """Examples the whole run consumes per step (every dp replica): step
        b consumes global-order positions [b*G, (b+1)*G) of the epoch
        permutation, for any dp width."""
        return self.dp_size * self.per_replica_batch

    def _fetch(self, index: int) -> Any:
        """One dataset read under the transient-retry policy; IndexError
        stays fatal (a sampler bug, not a blip)."""

        def read():
            action = faults.fire("data_read", tag=str(index))
            row = self.dataset[int(index)]
            if action == "corrupt" or row is None:
                raise CorruptRecordError(f"dataset[{index}] returned a corrupt/empty record")
            return row

        row = retry.retry_call(read, policy=self._retry_policy, describe=f"dataset[{index}]")
        self.records_read += 1
        return row

    def _quarantine(self, index: int, err: BaseException | None) -> None:
        self._quarantined.add(int(index))
        self.quarantine_count += 1
        logger.warning("quarantined persistently bad record %d (%d quarantined so far; a "
                       "deterministic substitute record trains in its place): %r",
                       index, self.quarantine_count, err)

    def _read_record(self, index: int) -> Any:
        """_fetch, plus the opt-in quarantine: a record unreadable past the
        retry budget is marked bad and replaced by the next healthy index
        (a deterministic walk, so every restart substitutes the same way).
        Quarantined indices are never fetched again."""
        index = int(index)
        last: BaseException | None = None
        if index not in self._quarantined:
            try:
                return self._fetch(index)
            except OSError as e:
                if not self.quarantine_bad_records:
                    raise
                self._quarantine(index, e)
                last = e
        n = len(self.dataset)
        for offset in range(1, n):
            idx = (index + offset) % n
            if idx in self._quarantined:
                continue
            try:
                return self._fetch(idx)
            except OSError as e:
                self._quarantine(idx, e)
                last = e
        raise CorruptRecordError(f"every record is quarantined ({n} total); the data "
                                 f"source is gone, not degraded") from last

    def iter_batches(self, start_batch: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """One epoch of batches from `start_batch` on; the skipped prefix
        costs no record reads."""
        if not 0 <= start_batch <= len(self):
            raise ValueError(f"start_batch {start_batch} outside [0, {len(self)}]")
        per_replica = [s.indices() for s in self._samplers]
        epoch = self._samplers[0]._epoch
        b_rows = self.per_replica_batch
        for b in range(start_batch, len(self)):
            ids = [int(i) for order in per_replica for i in order[b * b_rows:(b + 1) * b_rows]]
            rows = [self._read_record(i) for i in ids]
            ledger = self._ledger_f
            if ledger is not None:
                try:
                    ledger.write(json.dumps({"epoch": epoch, "batch": b, "indices": ids}) + "\n")
                except ValueError:
                    pass  # closed by the trainer's teardown mid-prefetch
            yield self.collate_fn(rows)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.iter_batches(0)


class PrefetchIterator:
    """Background-thread prefetch of the next batches, so host-side
    collation overlaps device compute. `depth` bounds the buffered batches;
    an exception in the producer re-raises on the consumer's side. A get
    that finds the buffer empty is a `prefetch_stall` span (utils/trace.py)."""

    _DONE = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth} (Queue(0) would be "
                             f"UNBOUNDED buffering of an infinite loader)")
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._err: list[BaseException] = []

        def produce():
            try:
                for item in iterator:
                    self._queue.put(item)
            except BaseException as e:  # surfaced on the consumer thread
                self._err.append(e)
            finally:
                self._queue.put(self._DONE)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()
        self._finished = False

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._finished:  # the end is sticky: never block again
            if self._err:
                raise self._err[0]
            raise StopIteration
        if self._queue.empty():  # producer behind: the blocked get is a stall
            with trace.span("prefetch_stall"):
                item = self._queue.get()
        else:
            item = self._queue.get()
        if item is self._DONE:
            self._finished = True
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item


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
