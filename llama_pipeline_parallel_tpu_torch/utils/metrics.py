"""Throughput / MFU accounting and the metrics writer (the keys of the JAX
trainer's metrics line, where they apply)."""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Dense bf16 tensor-core peak per card, by a substring of the device name
# (NVIDIA's data sheet, H100 SXM at its 700 W limit). A card set below its
# maximum power limit runs slower, so MFU against this peak is a lower bound.
GPU_PEAK_FLOPS = {"H100": 989e12}


def param_count(cfg: LlamaConfig) -> int:
    d, f, L, V = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_hidden_layers, cfg.vocab_size)
    kv_dim = cfg.kv_heads * cfg.head_dim
    per_layer = d * d * 2 + d * kv_dim * 2 + 3 * d * f + 2 * d
    return V * d * 2 + L * per_layer + d


def train_flops_per_token(cfg: LlamaConfig, seq_length: int) -> float:
    """PaLM-style accounting: 6*N + 12*L*d*S per trained token (fwd+bwd,
    attention quadratic term included)."""
    return 6.0 * param_count(cfg) + 12.0 * cfg.num_hidden_layers * cfg.hidden_size * seq_length


def peak_flops(device: torch.device) -> float | None:
    """Peak bf16 FLOP/s of the device, or None (MFU off: a CPU or an
    unlisted card)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in GPU_PEAK_FLOPS.items() if k in name), None)


class MetricsWriter:
    """Scalars -> `metrics.jsonl` in the output dir + one log line each."""

    def __init__(self, output_dir: str, config_snapshot: dict | None = None):
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1)
        if config_snapshot is not None:
            with open(os.path.join(output_dir, "training_config.json"), "w") as f:
                json.dump(config_snapshot, f, indent=2, default=str)

    def log(self, step: int, scalars: dict[str, Any]) -> None:
        record = {"step": step, **scalars}
        self._f.write(json.dumps(record) + "\n")
        logger.info(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in record.items()))

    def close(self) -> None:
        self._f.close()
