"""Tiny stand-ins of the benchmark's cells, for runs on the CPU."""

from __future__ import annotations

import copy

from bench_port import cells

TINY_MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2)
TINY_TRAFFIC = {
    "full-4k": {"seq_length": 64, "dataset_documents": 64,
                "documents": {"kind": "fixed", "tokens": 64}},
    "long-32k": {"seq_length": 128, "dataset_documents": 16,
                 "documents": {"kind": "fixed", "tokens": 128}},
    "sft-packed-4k": {"seq_length": 128, "dataset_documents": 256,
                      "documents": {"kind": "packed_pairs", "prompt_mean": 5.5,
                                    "response_mean": 3.5, "sigma": 1.0, "cap": 128,
                                    "word_zipf": 1.0, "plan_steps": 4}},
}


def tiny_cell(name: str, dtype: str = "float32") -> cells.Cell:
    """Cell `name` of BENCHMARK.json at tiny widths and lengths, its layout,
    trainer and limits kept; `dtype` the compute dtype."""
    cell = cells.load(name)
    traffic_name = next(w["traffic"] for w in cells.benchmark()["workloads"]
                        if w["name"] == name)
    config = copy.deepcopy(cell.config)
    config.update(TINY_MODEL)
    config["trainer"].update(compute_dtype=dtype, loss_vocab_chunks=4)
    cell.config = config
    cell.traffic = dict(copy.deepcopy(cell.traffic), **TINY_TRAFFIC[traffic_name])
    return cell
