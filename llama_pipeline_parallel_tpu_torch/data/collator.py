"""Batch protocol and collation (copies of the JAX package's, numpy only).

Batch protocol: {"input_ids", "attention_mask", "position_ids", "labels"},
all int32 [batch, seq]. `attention_mask` carries SEGMENT IDS: 0 = pad,
nonzero = real (packed examples numbered 1..k).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

IGNORE_INDEX = -100


def get_lm_labels(input_ids: np.ndarray, attention_mask: np.ndarray,
                  prompt_lens: np.ndarray) -> np.ndarray:
    """Labels with prompt tokens and padding masked to IGNORE_INDEX."""
    labels = input_ids.astype(np.int32).copy()
    positions = np.arange(input_ids.shape[1])[None, :]
    labels[positions < prompt_lens[:, None]] = IGNORE_INDEX
    labels[attention_mask == 0] = IGNORE_INDEX
    return labels


@dataclasses.dataclass
class PretokenizedCollator:
    """Pass-through collator for datasets that already emit token arrays."""

    def __call__(self, examples: Sequence[Mapping[str, np.ndarray]]) -> dict[str, np.ndarray]:
        keys = ("input_ids", "attention_mask", "position_ids", "labels")
        return {k: np.stack([np.asarray(ex[k]) for ex in examples]).astype(np.int32)
                for k in keys}
