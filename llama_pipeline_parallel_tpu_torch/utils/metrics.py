"""Throughput / MFU accounting and the metrics writer (the keys of the JAX
trainer's metrics line, where they apply).

The meter and the writers are llama_pipeline_parallel_tpu/utils/metrics.py's
`Throughput`, `NullMetricsWriter` and `MetricsWriter` for one process: the
card's peak (`peak_flops`) in place of the TPU table, and no scale from this
process's batch rows to a global batch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import torch

from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Dense bf16 tensor-core peak per card, by a substring of the device name
# (NVIDIA's data sheet, H100 SXM at its 700 W limit). A card set below its
# maximum power limit runs slower, so MFU against this peak is a lower bound.
GPU_PEAK_FLOPS = {"H100": 989e12}
# the wandb project, and the metrics whose best value (not the last) its run
# summary shows
WANDB_PROJECT = "llama-pipeline-tpu"
SUMMARY_METRICS = {"loss": "min", "eval_loss": "min"}


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


@dataclasses.dataclass
class Throughput:
    """Rolling tokens/sec + MFU meter over the wall time since its last read
    (data wait, eval and checkpoint seconds included).

    `update(tokens, real_tokens)`: `tokens` are the batch's row positions, pad
    included (the compute spent, what MFU is against); `real_tokens` the
    non-pad ones, where packing's win shows. `real_tokens_per_sec` is on the
    line only when the two differ. `peak_flops_per_chip` defaults to
    `peak_flops(device)`; without a peak the line has no `mfu`."""

    cfg: LlamaConfig
    seq_length: int
    n_chips: int = 1
    peak_flops_per_chip: float | None = None
    device: torch.device | None = None

    def __post_init__(self) -> None:
        self._t0 = time.perf_counter()
        self._tokens = 0
        self._real_tokens = 0
        if self.peak_flops_per_chip is None and self.device is not None:
            self.peak_flops_per_chip = peak_flops(self.device)

    def update(self, tokens: int, real_tokens: int | None = None) -> None:
        self._tokens += tokens
        self._real_tokens += tokens if real_tokens is None else real_tokens

    def read_and_reset(self) -> dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        tps = self._tokens / dt
        out = {"tokens_per_sec": tps, "tokens_per_sec_per_chip": tps / self.n_chips}
        if self._real_tokens != self._tokens:
            out["real_tokens_per_sec"] = self._real_tokens / dt
        if self.peak_flops_per_chip:
            flops = train_flops_per_token(self.cfg, self.seq_length) * tps
            out["mfu"] = flops / (self.peak_flops_per_chip * self.n_chips)
        self._t0 = time.perf_counter()
        self._tokens = 0
        self._real_tokens = 0
        return out


class NullMetricsWriter:
    """A writer that writes nothing (the JAX trainer's sink for pod
    processes other than process 0)."""

    def log(self, step: int, scalars: dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class MetricsWriter:
    """Scalars -> `metrics.jsonl` in the output dir + one log line each, plus
    wandb (`use_wandb`) and tensorboard (`use_tensorboard`) sinks when their
    packages import; a sink that cannot start is logged and left out. wandb's
    run summary shows the best value of each of SUMMARY_METRICS, not the
    last."""

    def __init__(self, output_dir: str, config_snapshot: dict | None = None,
                 use_wandb: bool = False, use_tensorboard: bool = False):
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1)
        self._wandb = None
        self._tb = None
        if config_snapshot is not None:
            with open(os.path.join(output_dir, "training_config.json"), "w") as f:
                json.dump(config_snapshot, f, indent=2, default=str)
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=WANDB_PROJECT, config=config_snapshot)
            except Exception as e:  # wandb not installed / offline
                logger.warning("wandb unavailable (%r); falling back to jsonl only", e)
            if self._wandb is not None:
                try:
                    for name, direction in SUMMARY_METRICS.items():
                        wandb.define_metric(name, summary=direction)
                except Exception as e:  # run stays live; only best-so-far lost
                    logger.warning("wandb.define_metric failed (%r); summary "
                                   "shows last value, not best", e)
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "tensorboard"))
            except Exception as e:
                logger.warning("tensorboard unavailable (%r); falling back to "
                               "jsonl only", e)

    def log(self, step: int, scalars: dict[str, Any]) -> None:
        record = {"step": step, **{k: _to_py(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(record) + "\n")
        logger.info(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in record.items()))
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if self._tb is not None:
            for k, v in record.items():
                if k != "step" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, global_step=step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()


def _to_py(v: Any) -> Any:
    """A tensor or numpy scalar as a Python number (JSON-serialisable)."""
    if hasattr(v, "item"):
        return v.item()
    return v
