"""Datasets: the synthetic one (a copy of the JAX package's, so both emit the
same rows for the same seed)."""

from __future__ import annotations

import dataclasses

import numpy as np

from llama_pipeline_parallel_tpu_torch.data.collator import IGNORE_INDEX


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
