"""`fixed`: one document of `tokens` ids filling a row (continued pre-training,
long-document fine-tuning).

Ids are uniform over the vocabulary, a function of (seed, index). The record
is already a row ({input_ids, attention_mask, position_ids, labels}), which
the port's `PretokenizedCollator` stacks and the reference takes as it is.
"""

from __future__ import annotations

import numpy as np

from bench_port.generator import Stream, examples_per_step
from bench_port.reference import packing

SEGMENTED = False
PORT_COLLATOR = "llama_pipeline_parallel_tpu_torch.data.collator.PretokenizedCollator"


class FixedDocuments(Stream):
    def __init__(self, seed: int, vocab_size: int, tokens: int, count: int, per_step: int):
        super().__init__(per_step)
        self.seed, self.vocab_size, self.tokens, self.count = seed, vocab_size, tokens, count

    def __len__(self) -> int:
        return self.count

    def record(self, i: int, position: int) -> dict:
        ids = np.random.default_rng([self.seed, 1, i]).integers(
            0, self.vocab_size, self.tokens, dtype=np.int64).astype(np.int32)
        return {"input_ids": ids, "attention_mask": np.ones(self.tokens, np.int32),
                "position_ids": np.arange(self.tokens, dtype=np.int32), "labels": ids.copy()}


def make_dataset(traffic: dict, seed: int, vocab_size: int) -> FixedDocuments:
    docs = traffic["documents"]
    if docs["tokens"] != traffic["seq_length"]:
        raise ValueError("a fixed document fills its row: tokens must equal seq_length")
    return FixedDocuments(seed, vocab_size, docs["tokens"], traffic["dataset_documents"],
                          examples_per_step(traffic))


def port_data(traffic: dict) -> dict:
    return {"collator": {"_target_": PORT_COLLATOR}}


def reference_rows(records: list[dict], traffic: dict, tokenizer) -> dict:
    return packing.fixed_rows(records)
