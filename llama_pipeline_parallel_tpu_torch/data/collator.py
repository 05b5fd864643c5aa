"""Batch protocol and collation (copies of the JAX package's, numpy only).

Batch protocol: {"input_ids", "attention_mask", "position_ids", "labels"},
all int32 [batch, seq]. `attention_mask` carries SEGMENT IDS: 0 = pad,
nonzero = real (packed examples numbered 1..k). The collators stay on the
host; the trainer moves their arrays to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

IGNORE_INDEX = -100


def causal_texts(inputs: Sequence[str], targets: Sequence[str], eos: str) -> list[str]:
    """The one place the `input + " " + target + eos` join lives: packed and
    unpacked collators must tokenize identically or their labels drift."""
    return [f"{inp} {tgt}{eos}" for inp, tgt in zip(inputs, targets)]


def prompt_lengths(tokenizer: Any, inputs: Sequence[str], max_seq_length: int) -> np.ndarray:
    """Token count of each bare prompt: tokenizing the prompt alone tells how
    many tokens of the combined text to mask (the only method that holds
    across subword tokenizers)."""
    enc = tokenizer(list(inputs), max_length=max_seq_length, truncation=True,
                    return_length=True)
    return np.asarray([len(x) for x in enc["input_ids"]], np.int32)


def seq2seq_to_causal(inputs: Sequence[str], targets: Sequence[str], tokenizer: Any,
                      max_seq_length: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize seq2seq pairs for decoder-only training. Returns (input_ids,
    attention_mask, prompt_lens), right-padded."""
    texts = causal_texts(inputs, targets, tokenizer.eos_token)
    enc = tokenizer(texts, max_length=max_seq_length, truncation=True,
                    padding="max_length", return_tensors="np")
    return (enc["input_ids"].astype(np.int32),
            enc["attention_mask"].astype(np.int32),
            prompt_lengths(tokenizer, inputs, max_seq_length))


def get_lm_labels(input_ids: np.ndarray, attention_mask: np.ndarray,
                  prompt_lens: np.ndarray) -> np.ndarray:
    """Labels with prompt tokens and padding masked to IGNORE_INDEX."""
    labels = input_ids.astype(np.int32).copy()
    positions = np.arange(input_ids.shape[1])[None, :]
    labels[positions < prompt_lens[:, None]] = IGNORE_INDEX
    labels[attention_mask == 0] = IGNORE_INDEX
    return labels


@dataclasses.dataclass
class CausalLMCollator:
    """(inputs, targets) string pairs -> one right-padded row per example."""

    tokenizer: Any
    max_seq_length: int

    def __post_init__(self) -> None:
        # the attention stack assumes RIGHT padding; some published tokenizer
        # configs ship padding_side="left" for generation
        if getattr(self.tokenizer, "padding_side", "right") != "right":
            self.tokenizer.padding_side = "right"

    def __call__(self, examples: Sequence[Mapping[str, str]]) -> dict[str, np.ndarray]:
        inputs = [ex["inputs"] for ex in examples]
        targets = [ex["targets"] for ex in examples]
        input_ids, attention_mask, prompt_lens = seq2seq_to_causal(
            inputs, targets, self.tokenizer, self.max_seq_length)
        labels = get_lm_labels(input_ids, attention_mask, prompt_lens)
        position_ids = np.broadcast_to(
            np.arange(input_ids.shape[1], dtype=np.int32), input_ids.shape).copy()
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "position_ids": position_ids, "labels": labels}


@dataclasses.dataclass
class PackedCausalLMCollator:
    """Sequence packing: several (inputs, targets) examples share one
    max_seq_length row.

    - `attention_mask` carries SEGMENT IDS (1..k within a row, 0 = pad): the
      attention op masks cross-segment pairs, so packed examples never see
      each other.
    - `position_ids` restart at 0 for each segment (RoPE stays per example).
    - The first token of every segment is always IGNORE_INDEX: the previous
      segment's last position takes its shifted target from that slot and
      must contribute no loss.

    Called with N examples it emits N // pack_factor rows (a fixed shape),
    placed first-fit-decreasing (longest first, a stable sort for ties).
    Examples that fit no row are dropped and counted in `dropped_total`,
    beside `packed_total`; `drop_rate()` is the cumulative share dropped.
    """

    tokenizer: Any
    max_seq_length: int
    pack_factor: int = 4

    def __post_init__(self) -> None:
        if self.pack_factor < 1:
            raise ValueError(f"pack_factor must be >= 1, got {self.pack_factor}")
        self.dropped_total = 0
        self.packed_total = 0

    def drop_rate(self) -> float:
        """Cumulative fraction of examples dropped since construction."""
        seen = self.dropped_total + self.packed_total
        return self.dropped_total / seen if seen else 0.0

    def __call__(self, examples: Sequence[Mapping[str, str]]) -> dict[str, np.ndarray]:
        inputs = [ex["inputs"] for ex in examples]
        texts = causal_texts(inputs, [ex["targets"] for ex in examples],
                             self.tokenizer.eos_token)
        enc = self.tokenizer(texts, max_length=self.max_seq_length, truncation=True)
        prompt_lens = prompt_lengths(self.tokenizer, inputs, self.max_seq_length)

        rows = max(len(examples) // self.pack_factor, 1)
        L = self.max_seq_length
        input_ids = np.zeros((rows, L), np.int32)
        segment_ids = np.zeros((rows, L), np.int32)
        position_ids = np.zeros((rows, L), np.int32)
        labels = np.full((rows, L), IGNORE_INDEX, np.int32)
        cursor = np.zeros(rows, np.int32)
        seg_count = np.zeros(rows, np.int32)

        # first-fit-decreasing; the stable sort keeps arrival order within a
        # length, so placement is deterministic
        order = np.argsort([-len(ids) for ids in enc["input_ids"]], kind="stable")
        dropped = 0
        for i in order:
            ids, prompt_len = enc["input_ids"][i], prompt_lens[i]
            n = len(ids)
            row = next((r for r in range(rows) if cursor[r] + n <= L), None)
            if row is None:
                dropped += 1
                continue
            at = int(cursor[row])
            seg_count[row] += 1
            input_ids[row, at:at + n] = ids
            segment_ids[row, at:at + n] = seg_count[row]
            position_ids[row, at:at + n] = np.arange(n)
            # mask the prompt span, and always the segment's first token
            start = max(min(int(prompt_len), n), 1)
            labels[row, at + start:at + n] = ids[start:]
            cursor[row] += n
        self.packed_total += len(examples) - dropped
        if dropped:
            self.dropped_total += dropped
            if self.dropped_total == dropped:  # the first drop: say so once
                logger.warning(
                    "packing dropped %d example(s) that fit no row; lower pack_factor or "
                    "raise max_seq_length if this persists (the cumulative rate is in the "
                    "metrics stream as packing_drop_rate)", dropped)
        return {"input_ids": input_ids, "attention_mask": segment_ids,
                "position_ids": position_ids, "labels": labels}


@dataclasses.dataclass
class PretokenizedCollator:
    """Pass-through collator for datasets that already emit token arrays."""

    def __call__(self, examples: Sequence[Mapping[str, np.ndarray]]) -> dict[str, np.ndarray]:
        keys = ("input_ids", "attention_mask", "position_ids", "labels")
        return {k: np.stack([np.asarray(ex[k]) for ex in examples]).astype(np.int32)
                for k in keys}
