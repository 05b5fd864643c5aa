"""Datasets (copies of the JAX package's, so both yield the same items in the
same order):

- `JsonSeq2SeqDataset`: {"inputs", "targets"} records of a .json or .jsonl
  file, held in memory, empty targets filtered out.
- `LazyJsonlDataset`: the same records of a .jsonl file read on demand
  through an int64 byte-offset index (8 bytes of RAM per record), with one
  file handle per thread.
- `ConcatDataset`, `MixtureDataset`: concatenation and a deterministic
  weighted interleave of datasets.
- `SyntheticDataset`: deterministic random token rows in the batch protocol.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from fractions import Fraction
from math import lcm
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from llama_pipeline_parallel_tpu_torch.data.collator import IGNORE_INDEX
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def load_seq2seq_records(path: str, input_field: str = "inputs",
                         target_field: str = "targets",
                         filter_fn: Callable[[Mapping[str, Any]], bool] | None = None
                         ) -> list[dict[str, str]]:
    """{"inputs": ..., "targets": ...} records of a .json or .jsonl file, the
    rows `filter_fn` rejects left out."""
    records: list[dict[str, str]] = []
    with open(path) as f:
        if path.endswith(".jsonl"):
            rows = (json.loads(line) for line in f if line.strip())
        else:
            rows = json.load(f)
        for row in rows:
            if filter_fn is not None and not filter_fn(row):
                continue
            records.append({"inputs": str(row[input_field]),
                            "targets": str(row[target_field])})
    logger.info("loaded %d records from %s", len(records), path)
    return records


def drop_empty_targets(row: Mapping[str, Any], target_field: str = "targets") -> bool:
    return bool(str(row.get(target_field, "")).strip())


@dataclasses.dataclass
class JsonSeq2SeqDataset:
    """Sequence protocol over seq2seq records held in memory."""

    path: str
    input_field: str = "inputs"
    target_field: str = "targets"
    filter_empty: bool = True

    def __post_init__(self) -> None:
        self._records = load_seq2seq_records(
            self.path, self.input_field, self.target_field,
            (lambda row: drop_empty_targets(row, self.target_field))
            if self.filter_empty else None)

    def __len__(self) -> int:
        return len(self._records)

    def __getitem__(self, idx: int) -> dict[str, str]:
        return self._records[idx]


@dataclasses.dataclass
class LazyJsonlDataset:
    """Constant-RAM random access over a .jsonl corpus: one pass at start
    builds the byte offset of each kept line (empty targets are filtered
    during the scan), and `__getitem__` seeks to one line and parses it.
    File handles are per thread (`threading.local`), so the prefetch thread
    and another reader never race on a seek."""

    path: str
    input_field: str = "inputs"
    target_field: str = "targets"
    filter_empty: bool = True

    def __post_init__(self) -> None:
        offsets = []
        pos = 0
        with open(self.path, "rb") as f:
            for line in f:
                if line.strip() and (not self.filter_empty or drop_empty_targets(
                        json.loads(line), self.target_field)):
                    offsets.append(pos)
                pos += len(line)
        self._offsets = np.asarray(offsets, np.int64)
        self._local = threading.local()
        logger.info("indexed %d records from %s (lazy)", len(offsets), self.path)

    def _handle(self):
        f = getattr(self._local, "f", None)
        if f is None or f.closed:
            f = self._local.f = open(self.path, "rb")
        return f

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, idx: int) -> dict[str, str]:
        f = self._handle()
        f.seek(int(self._offsets[idx]))
        row = json.loads(f.readline())
        return {"inputs": str(row[self.input_field]),
                "targets": str(row[self.target_field])}


@dataclasses.dataclass
class ConcatDataset:
    """Concatenation of datasets."""

    datasets: Sequence[Any]

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        for d in self.datasets:
            if idx < len(d):
                return d[idx]
            idx -= len(d)
        raise IndexError(idx)


@dataclasses.dataclass
class MixtureDataset:
    """Deterministic weighted interleaving of datasets: items come from each
    source in proportion to `weights`, in a fixed block pattern, so every
    epoch sees the same order (the sampler shuffles by index).

    The epoch ends when the first source runs out of full blocks; the other
    sources' tails are left out that epoch, and `len(self)` counts only what
    is yielded."""

    datasets: Sequence[Any]
    weights: Sequence[float] | None = None

    def __post_init__(self) -> None:
        if not self.datasets:
            raise ValueError("MixtureDataset needs at least one dataset")
        w = self.weights or [1.0] * len(self.datasets)
        if len(w) != len(self.datasets) or min(w) <= 0:
            raise ValueError(f"bad weights {w} for {len(self.datasets)} datasets")
        # one block of the interleave, proportional to the weights (a
        # small-integer ratio so short datasets still yield >= 1 block)
        total = sum(w)
        fracs = [Fraction(x / total).limit_denominator(1024) for x in w]
        denom = lcm(*(f.denominator for f in fracs))
        counts = [int(f * denom) for f in fracs]
        if min(counts) < 1:
            raise ValueError(
                f"weight ratio {w} too extreme to interleave exactly "
                f"(a source rounds to zero draws per block); cap ratios ~1000:1")
        pattern: list[int] = []
        drawn = [0.0] * len(counts)
        for _ in range(sum(counts)):
            j = int(np.argmax([c - i for c, i in zip(counts, drawn)]))
            pattern.append(j)
            drawn[j] += 1
        self._pattern = pattern
        self._per_block = [pattern.count(j) for j in range(len(self.datasets))]
        self._blocks = min(len(d) // c for d, c in zip(self.datasets, self._per_block))

    def __len__(self) -> int:
        return self._blocks * len(self._pattern)

    def __getitem__(self, idx: int):
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        block, offset = divmod(idx, len(self._pattern))
        src = self._pattern[offset]
        nth = self._pattern[:offset].count(src)  # src's earlier draws in this block
        return self.datasets[src][block * self._per_block[src] + nth]


@dataclasses.dataclass
class SyntheticDataset:
    """Deterministic random-token dataset that emits the full batch protocol."""

    vocab_size: int
    seq_length: int
    pseudo_dataset_len: int = 1024
    seed: int = 0
    pad_fraction: float = 0.0  # trailing fraction of each row marked padding

    def __len__(self) -> int:
        return self.pseudo_dataset_len

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        if not 0 <= idx < self.pseudo_dataset_len:
            raise IndexError(idx)
        rng = np.random.RandomState((self.seed * 1_000_003 + idx) % (2**31))
        ids = rng.randint(3, self.vocab_size, size=(self.seq_length,)).astype(np.int32)
        mask = np.ones((self.seq_length,), np.int32)
        n_pad = int(self.seq_length * self.pad_fraction)
        if n_pad:
            mask[-n_pad:] = 0
        labels = np.where(mask == 1, ids, IGNORE_INDEX).astype(np.int32)
        return {
            "input_ids": ids,
            "attention_mask": mask,
            "position_ids": np.arange(self.seq_length, dtype=np.int32),
            "labels": labels,
        }
