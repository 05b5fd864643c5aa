"""`packed_pairs`: SFT pairs (prompt, response) of seeded words, packed by the port's
`PackedCausalLMCollator` (`packing_factor` pairs a row, first-fit-decreasing,
segment ids, positions restarting per pair, prompts unlabelled).

Lengths: each step's pairs draw their prompt and response shapes from a
lognormal of `sigma`, by (seed, step), scaled so that the step's prompts sum
to `prompt_mean` tokens a pair and its responses to `response_mean`, to the
token (largest remainders; each at least 1, a pair with its `<s>` and `</s>`
at most `cap`). So every step of every seed holds the same tokens and the
same number of response tokens, while its lengths, and with them the rows'
segment layout, change with the seed and the step. Words are Zipf-distributed
(exponent `word_zipf`), one token each.

The text of `plan_steps` steps is made when the dataset is built (set-up);
a read only looks it up: the loader's k-th read takes the plan's k-th pair
(cycling), so a step is the loader's next `per_step` reads whatever indices
it asks for. The port's collator tokenizes and packs on the timed path.
"""

from __future__ import annotations

import numpy as np

from bench_port.generator import Stream, examples_per_step
from bench_port.reference import packing
from bench_port.tokenizer import WordTokenizer

SEGMENTED = True


def apportion(weights: np.ndarray, total: int, lo, hi) -> np.ndarray:
    """Integers in proportion to `weights`, each within [lo, hi], summing to `total`."""
    w = np.asarray(weights, np.float64)
    lo = np.broadcast_to(np.asarray(lo, np.float64), w.shape)
    hi = np.broadcast_to(np.asarray(hi, np.float64), w.shape)
    if not lo.sum() <= total <= hi.sum():
        raise ValueError(f"{total} cannot be split within [{lo.sum()}, {hi.sum()}]")
    # the scale at which the clipped shares sum to `total`, by bisection
    below, above = 0.0, float((hi / w).max())
    for _ in range(100):
        mid = 0.5 * (below + above)
        if np.clip(mid * w, lo, hi).sum() < total:
            below = mid
        else:
            above = mid
    x = np.clip(above * w, lo, hi)
    out = np.floor(x).astype(np.int64)
    order = np.argsort(out - x, kind="stable")  # largest remainder first
    room = order[out[order] < hi[order]]
    out[room[:total - int(out.sum())]] += 1
    return out


def step_lengths(docs: dict, seed: int, step: int, pairs: int) -> np.ndarray:
    """[pairs, 2] (prompt, response) tokens of step `step`'s pairs."""
    shape = np.random.default_rng([seed, 2, step]).lognormal(0.0, docs["sigma"], (2, pairs))
    cap = docs["cap"]
    response = apportion(shape[1], round(pairs * docs["response_mean"]), 1, cap - 3)
    prompt = apportion(shape[0], round(pairs * docs["prompt_mean"]), 1, cap - 2 - response)
    return np.stack([prompt, response], axis=1)


class PairDocuments(Stream):
    """{"inputs", "targets"} text pairs, made for `plan_steps` steps at once."""

    def __init__(self, seed: int, vocab_size: int, docs: dict, count: int, per_step: int):
        super().__init__(per_step)
        self.count = count
        tokenizer = WordTokenizer(vocab_size)
        rank = np.arange(1, tokenizer.num_words + 1, dtype=np.float64)
        cdf = np.cumsum(rank ** -float(docs["word_zipf"]))
        cdf /= cdf[-1]
        text = tokenizer.words
        self.lengths = np.stack([step_lengths(docs, seed, s, per_step)
                                 for s in range(docs["plan_steps"])])
        self.plan = []
        for s, lengths in enumerate(self.lengths):
            u = np.random.default_rng([seed, 3, s]).random(int(lengths.sum()))
            words = [text[k] for k in np.minimum(np.searchsorted(cdf, u),
                                                 tokenizer.num_words - 1).tolist()]
            at = 0
            for p, r in lengths.tolist():
                self.plan.append({"inputs": " ".join(words[at:at + p]),
                                  "targets": " ".join(words[at + p:at + p + r])})
                at += p + r

    def __len__(self) -> int:
        return self.count

    def record(self, i: int, position: int) -> dict:
        return self.plan[max(position, 0) % len(self.plan)]


def make_dataset(traffic: dict, seed: int, vocab_size: int) -> PairDocuments:
    return PairDocuments(seed, vocab_size, traffic["documents"], traffic["dataset_documents"],
                         examples_per_step(traffic))


def port_data(traffic: dict) -> dict:
    if traffic.get("packing_factor", 1) < 2:
        raise ValueError("packed_pairs needs a packing_factor of 2 or more")
    return {"packing_factor": traffic["packing_factor"]}


def reference_rows(records: list[dict], traffic: dict, tokenizer) -> dict:
    return packing.packed_rows(records, tokenizer, traffic["seq_length"],
                               traffic["packing_factor"])
