"""The step's rows, rebuilt from its documents.

Packed traffic: every pair is tokenized as `<s> prompt response</s>` (capped
at the row length) and placed first-fit-decreasing (longest first, ties in
arrival order) into `len(pairs) // packing_factor` rows; a pair that fits no
row is left out. Segment ids number a row's documents 1..k (0 = pad),
positions restart at each document, and a label is kept only on a document's
response tokens (never its first token). A fixed document is its row.
"""

from __future__ import annotations

import numpy as np

IGNORE_INDEX = -100


def fixed_rows(records: list[dict]) -> dict[str, np.ndarray]:
    ids = np.stack([r["input_ids"] for r in records]).astype(np.int64)
    n, s = ids.shape
    return {"input_ids": ids, "segments": np.ones((n, s), np.int64),
            "positions": np.broadcast_to(np.arange(s), (n, s)).copy(), "labels": ids.copy()}


def packed_rows(records: list[dict], tokenizer, seq: int, packing_factor: int
                ) -> dict[str, np.ndarray]:
    texts = [f"{r['inputs']} {r['targets']}{tokenizer.eos_token}" for r in records]
    docs = [tokenizer.encode(t)[:seq] for t in texts]
    prompts = [min(len(tokenizer.encode(r["inputs"])), seq) for r in records]
    rows = max(len(records) // packing_factor, 1)
    out = {"input_ids": np.zeros((rows, seq), np.int64),
           "segments": np.zeros((rows, seq), np.int64),
           "positions": np.zeros((rows, seq), np.int64),
           "labels": np.full((rows, seq), IGNORE_INDEX, np.int64)}
    used, count = [0] * rows, [0] * rows
    for i in sorted(range(len(docs)), key=lambda j: -len(docs[j])):
        doc, n = docs[i], len(docs[i])
        row = next((r for r in range(rows) if used[r] + n <= seq), None)
        if row is None:
            continue
        at = used[row]
        count[row] += 1
        out["input_ids"][row, at:at + n] = doc
        out["segments"][row, at:at + n] = count[row]
        out["positions"][row, at:at + n] = np.arange(n)
        first = max(min(prompts[i], n), 1)
        out["labels"][row, at + first:at + n] = doc[first:]
        used[row] += n
    return out


def shift_targets(labels: np.ndarray) -> np.ndarray:
    """Next-token targets: position t learns labels[t + 1]; the last learns nothing."""
    out = np.full_like(labels, IGNORE_INDEX)
    out[:, :-1] = labels[:, 1:]
    return out
