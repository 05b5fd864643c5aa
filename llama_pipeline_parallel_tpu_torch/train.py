"""The trainer: config -> model -> data -> step loop, on one device.

The counterpart of llama_pipeline_parallel_tpu/train.py for a single device
(pp = dp = tp = sp = 1): the same config keys, the same synthetic data for
the same seed, the same schedule-total rules and the same metrics line keys
where they apply. Checkpointing, resume, evaluation, the observatories,
fault injection and preemption handling are not ported yet; a config that
asks for a layout or feature this trainer does not have is refused, naming
its key, and keys that mean nothing on one device (the pipeline schedule)
are logged once.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any, Iterator

import numpy as np
import torch

from llama_pipeline_parallel_tpu_torch.data.collator import PretokenizedCollator
from llama_pipeline_parallel_tpu_torch.data.datasets import SyntheticDataset
from llama_pipeline_parallel_tpu_torch.data.loader import DataLoader, RepeatingLoader
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.model import (
    LlamaForCausalLM,
    init_params,
)
from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
)
from llama_pipeline_parallel_tpu_torch.optim.optimizer import AdamW, OptimizerConfig
from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
    LossHead,
    TrainState,
    train_step,
)
from llama_pipeline_parallel_tpu_torch.utils.config import instantiate
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger
from llama_pipeline_parallel_tpu_torch.utils.metrics import (
    MetricsWriter,
    peak_flops,
    train_flops_per_token,
)

logger = get_logger(__name__)

_PRESETS = {
    "tiny": LlamaConfig.tiny,
    "llama_7b": LlamaConfig.llama_7b,
    "llama_13b": LlamaConfig.llama_13b,
    "llama_33b": LlamaConfig.llama_33b,
    "llama_65b": LlamaConfig.llama_65b,
    "llama2_7b": LlamaConfig.llama2_7b,
    "llama2_13b": LlamaConfig.llama2_13b,
    "llama2_70b": LlamaConfig.llama2_70b,
    "codellama_34b_16k": LlamaConfig.codellama_34b_16k,
}

# config keys that name features of the JAX trainer this one does not have yet
_NOT_PORTED = ("optimizer_offload", "optimizer_offload_zero2", "model_name_or_path",
               "eval_dataset", "fault_plan", "profile_steps")
# keys of the JAX trainer whose value, other than the default given here,
# asks for something this trainer does not do
_NOT_PORTED_UNLESS_DEFAULT = {"gradient_accumulation_chunks": 1, "eval_steps": 0,
                              "async_save": False, "save_total_limit": None}
# blocks of the JAX trainer (host offload tiers, the observatories) that ask
# for their feature when any of their values is set
_NOT_PORTED_BLOCKS = ("offload", "numerics", "timeline", "profiler", "memory")
# keys that order the pipeline's stages, with their defaults: with one stage
# (pp = 1) the microbatches run in order whatever they say
_ONE_STAGE_KEYS = {"pipeline_schedule": "1f1b", "virtual_stages": 1, "schedule_file": None}
PIPELINE_SCHEDULES = ("1f1b", "interleaved_1f1b", "zb1", "solver", "gpipe")
# the JAX trainer's activation-checkpointing policies (jax.checkpoint policy
# names); torch.utils.checkpoint here keeps nothing, which is nothing_saveable
REMAT_POLICIES = ("nothing_saveable", "everything_saveable", "dots_saveable", "checkpoint_dots",
                  "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims")
_CHECKPOINT_DIR = re.compile(r"^checkpoint-(\d+)$")


def build_model_config(node: dict) -> LlamaConfig:
    node = dict(node)
    if "_target_" in node:
        return instantiate(node)
    preset = node.pop("preset", None)
    for key in ("dtype", "param_dtype"):
        if isinstance(node.get(key), str):
            node[key] = getattr(torch, node[key])
    if preset is not None:
        return _PRESETS[preset](**node)
    return LlamaConfig(**node)


def build_dataset_and_collator(cfg: dict, model_cfg: LlamaConfig) -> tuple[Any, Any]:
    data_cfg = cfg.get("dataset")
    if data_cfg is not None and not data_cfg.get("synthetic"):
        raise NotImplementedError(
            "only the synthetic dataset is ported; tokenizer-backed datasets "
            "and their collators come with a later slice")
    if int(cfg.get("packing_factor", 1) or 1) > 1:
        raise ValueError("packing_factor requires a tokenizer-backed dataset (the "
                         "synthetic dataset emits fixed full-length rows)")
    seq = (data_cfg or {}).get("seq_length", cfg.get("max_seq_length", 512))
    ds = SyntheticDataset(
        vocab_size=model_cfg.vocab_size, seq_length=seq,
        pseudo_dataset_len=(data_cfg or {}).get("pseudo_dataset_len", 4096),
        seed=cfg.get("seed", 42),
        pad_fraction=(data_cfg or {}).get("pad_fraction", 0.0))
    return ds, PretokenizedCollator()


def _flash_without_mask(q, k, v, padding_mask=None, *, causal=True):
    """flash_attention minus the segment-id stream: for unpacked right-padded
    batches the segment test is a documented no-op."""
    return flash_attention(q, k, v, None, causal=causal)


def _measure_attention(model_cfg: LlamaConfig, seq_len: int, micro_batch: int,
                       device: torch.device) -> Any:
    """Time exact vs flash (fwd+bwd, bf16, device-synchronised) at the run's
    (microbatch, seq) shape on the card and return the faster."""
    rng = np.random.RandomState(0)
    h, hkv, hd = model_cfg.num_attention_heads, model_cfg.kv_heads, model_cfg.head_dim
    b = max(int(micro_batch), 1)

    def rand(heads):
        return torch.from_numpy(rng.randn(b, seq_len, heads, hd).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16).requires_grad_()

    q, k, v = rand(h), rand(hkv), rand(hkv)

    def time_one(fn):
        def run():
            out = fn(q, k, v, None, causal=True)
            out.float().square().sum().backward()
        run()  # warm-up (and the kernels' build on first use)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / 3

    t_exact, t_flash = time_one(attention), time_one(flash_attention)
    logger.info("attention=auto @ batch %d seq %d: exact %.2fms, flash %.2fms",
                b, seq_len, 1e3 * t_exact, 1e3 * t_flash)
    return _flash_without_mask if t_flash < t_exact else attention


def select_attention(impl: str, seq_length: int, device: torch.device,
                     model_cfg: LlamaConfig | None = None, micro_batch: int = 1) -> Any:
    """'exact' | 'flash' | 'auto'. `auto` (needs `model_cfg`) measures both
    paths on the card at the run's (microbatch, seq) shape and keeps the
    faster; off the card it takes the exact path (the flash kernels' plain
    version is slower there). Flash runs drop the segment-id stream
    (`_flash_without_mask`): batches are unpacked and right-padded."""
    if impl == "exact":
        return attention
    if impl == "flash":
        return _flash_without_mask
    if impl == "auto":
        if device.type != "cuda":
            return attention
        if model_cfg is None:
            raise ValueError("attention=auto measures at the model's shape: pass model_cfg")
        if model_cfg.head_dim not in KERNEL_HEAD_DIMS:
            logger.warning("attention=auto: head_dim %d has no flash kernel; using "
                           "the exact path", model_cfg.head_dim)
            return attention
        return _measure_attention(model_cfg, seq_length, micro_batch, device)
    raise ValueError(f"unknown attention impl {impl!r} (use exact|flash|auto)")


def _kernel_flags(cfg: dict) -> tuple[bool, bool]:
    """The `kernels.*` block, as the reference's `_kernel_flags` parses it:
    `ce` selects the loss head's backend, `prologue` the decoder layers'
    rms_norm -> QKV -> RoPE prologue; values `xla` (default) or `pallas`,
    unknown keys and values rejected. Here `pallas` selects the hand-written
    CUDA kernels. Returns (kernel_ce, kernel_prologue)."""
    node = cfg.get("kernels") or {}
    if not isinstance(node, dict):
        raise ValueError(f"kernels must be a mapping of op backends, e.g. "
                         f"kernels: {{ce: pallas}} -- got {node!r}")
    unknown = set(node) - {"ce", "prologue"}
    if unknown:
        raise ValueError(f"unknown kernels.* key(s) {sorted(unknown)}; "
                         f"known: ['ce', 'prologue']")
    flags = []
    for key in ("ce", "prologue"):
        val = node.get(key, "xla")
        if val not in ("xla", "pallas"):
            raise ValueError(f"kernels.{key} must be 'xla' or 'pallas', got {val!r}")
        flags.append(val == "pallas")
    return flags[0], flags[1]


def _loss_head(cfg: dict, model_cfg: LlamaConfig) -> LossHead:
    """`loss_vocab_chunks` and `kernels.ce`, checked as the reference's
    pipeline build checks them."""
    chunks = int(cfg.get("loss_vocab_chunks", 1))
    if chunks < 1:
        raise ValueError("loss_vocab_chunks must be >= 1")
    if model_cfg.vocab_size % chunks:
        raise ValueError(f"loss_vocab_chunks={chunks} must divide "
                         f"vocab_size={model_cfg.vocab_size}")
    return LossHead(loss_chunks=chunks, kernel_ce=_kernel_flags(cfg)[0])


def _remat(cfg: dict) -> bool:
    """`activation_checkpointing` with its `remat_policy`: a name outside the
    JAX trainer's policies is refused, and so is a policy that saves
    something while checkpointing is on (torch.utils.checkpoint keeps
    nothing here)."""
    remat = bool(cfg.get("activation_checkpointing", True))
    policy = cfg.get("remat_policy", "nothing_saveable")
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; choose one of {REMAT_POLICIES}")
    if policy != "nothing_saveable":
        if remat:
            raise NotImplementedError(
                f"remat_policy={policy!r} is not ported yet: activation checkpointing here "
                f"saves nothing ('nothing_saveable')")
        logger.info("remat_policy=%r has no effect: activation_checkpointing is off", policy)
    return remat


def _checkpoints_to_resume(cfg: dict) -> list[str]:
    """The checkpoint-N directories in output_dir the JAX trainer would
    resume from (`resume`, true by default)."""
    out = cfg.get("output_dir")
    if not cfg.get("resume", True) or not out or not os.path.isdir(out):
        return []
    return sorted(e for e in os.listdir(out) if _CHECKPOINT_DIR.match(e))


def _check_supported(cfg: dict) -> None:
    """Refuse what this trainer does not run, naming the keys; log once the
    keys that have no effect on one device."""
    mesh = cfg.get("mesh") or {}
    layout = {ax: int(mesh.get(ax, 1)) for ax in ("pp", "dp", "tp", "sp")}
    if any(n != 1 for n in layout.values()):
        raise NotImplementedError(
            f"this trainer runs on one device (pp=dp=tp=sp=1); got {layout}. "
            f"Pipeline, data, tensor and sequence parallelism come with later slices")
    schedule = cfg.get("pipeline_schedule") or "1f1b"
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(f"unknown pipeline_schedule {schedule!r}; choose one of "
                         f"{PIPELINE_SCHEDULES}")
    asked = [key for key in _NOT_PORTED if cfg.get(key)]
    asked += [key for key, default in _NOT_PORTED_UNLESS_DEFAULT.items()
              if cfg.get(key) is not None and cfg.get(key) != default]
    asked += [key for key in _NOT_PORTED_BLOCKS if _block_asks(cfg.get(key))]
    if asked:
        raise NotImplementedError(f"not ported yet: {asked}")
    found = _checkpoints_to_resume(cfg)
    if found:
        raise NotImplementedError(
            f"output_dir {cfg['output_dir']} holds {found}, which resume (true by default) "
            f"would restore, and resume is not ported yet: pass resume=false to start "
            f"from step 0, or another output_dir")
    moot = [key for key, default in _ONE_STAGE_KEYS.items()
            if cfg.get(key) is not None and cfg.get(key) != default]
    if moot:
        logger.warning("%s: no effect on one device (one pipeline stage runs its "
                       "microbatches in order)", moot)
    if cfg.get("resume", True):
        logger.info("resume is not ported yet; output_dir holds no checkpoint, so the run "
                    "starts at step 0")


def _block_asks(node: Any) -> bool:
    """Whether a config block asks for its feature: any value set, unless
    it says `enabled: false`."""
    if not isinstance(node, dict):
        return bool(node)
    return node.get("enabled", True) is not False and any(bool(v) for v in node.values())


@dataclasses.dataclass
class Run:
    """A configured training run on one device: what `run_training` loops
    over, and what tools/torch_step_profile.py profiles."""

    device: torch.device
    model_cfg: LlamaConfig
    loader: DataLoader
    state: TrainState
    attn_fn: Any
    num_microbatches: int
    remat: bool
    head: LossHead
    kernel_prologue: bool
    seq_length: int
    end_step: int

    def batches(self) -> Iterator[dict[str, torch.Tensor]]:
        for batch in RepeatingLoader(self.loader):
            yield {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def step(self, batch: dict[str, torch.Tensor]) -> dict:
        return train_step(self.state, batch, self.model_cfg,
                          num_microbatches=self.num_microbatches, attn_fn=self.attn_fn,
                          remat=self.remat, head=self.head,
                          kernel_prologue=self.kernel_prologue)


def build_run(cfg: dict, device: str | torch.device = "cuda") -> Run:
    """Model, optimizer, data and attention for `cfg` on `device` (the card
    unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but torch.cuda.is_available() is false; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    _check_supported(cfg)
    remat = _remat(cfg)
    seed = cfg.get("seed", 42)
    model_cfg = build_model_config(cfg["model"])
    head = _loss_head(cfg, model_cfg)
    kernel_prologue = _kernel_flags(cfg)[1]
    if head.kernel_ce or kernel_prologue:
        logger.info("hand-written kernels enabled (ce=%s prologue=%s): %s", head.kernel_ce,
                    kernel_prologue, "CUDA" if device.type == "cuda"
                    else "their plain PyTorch versions on the CPU")
    dataset, collator = build_dataset_and_collator(cfg, model_cfg)
    micro_batch = cfg.get("per_device_train_batch_size", 1)
    num_microbatches = cfg.get("gradient_accumulation_steps", 1)
    loader = DataLoader(dataset, collator, per_replica_batch=micro_batch * num_microbatches,
                        seed=seed)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise ValueError(f"dataset of {len(dataset)} examples yields 0 steps at "
                         f"batch {micro_batch * num_microbatches}")

    # `total_steps` (schedule horizon) is separate from `max_steps` (loop end)
    epochs = cfg.get("num_train_epochs", 1)
    t_total = cfg.get("total_steps") or cfg.get("max_steps") or steps_per_epoch * epochs
    end_step = min(cfg.get("max_steps") or t_total, t_total)
    warmup = cfg.get("warmup_steps")
    if warmup is None:
        warmup = max(int(t_total * cfg.get("warmup_proportion", 0.0)), 1)
    ocfg = OptimizerConfig(
        learning_rate=cfg.get("learning_rate", 1e-6),
        weight_decay=cfg.get("weight_decay", 0.001),
        beta1=cfg.get("adam_beta1", 0.9), beta2=cfg.get("adam_beta2", 0.99),
        eps=cfg.get("adam_eps", 1e-8),
        max_grad_norm=cfg.get("max_grad_norm", 5.0),
        total_steps=t_total, warmup_steps=warmup)

    generator = torch.Generator(device=device).manual_seed(seed)
    model = LlamaForCausalLM(model_cfg, init_params(model_cfg, device=device,
                                                    generator=generator))
    params = model.params()
    seq_length = int(collator([dataset[0]])["input_ids"].shape[1])
    return Run(device=device, model_cfg=model_cfg, loader=loader,
               state=TrainState(step=0, params=params, optimizer=AdamW(params, ocfg)),
               attn_fn=select_attention(cfg.get("attention", "auto"), seq_length, device,
                                        model_cfg=model_cfg, micro_batch=micro_batch),
               num_microbatches=num_microbatches,
               remat=remat, head=head,
               kernel_prologue=kernel_prologue, seq_length=seq_length, end_step=end_step)


def run_training(cfg: dict, device: str | torch.device = "cuda") -> dict:
    """The training run; returns a summary dict for programmatic callers.
    Runs on `device` (the card unless the caller asks for the CPU)."""
    run = build_run(cfg, device)
    device = run.device
    if cfg.get("save_steps") or cfg.get("save_final", True):
        logger.warning("checkpointing is not ported yet: save_steps / save_final "
                       "write nothing")
    logging_steps = cfg.get("logging_steps", 10)
    peak = peak_flops(device)
    flops_per_token = train_flops_per_token(run.model_cfg, run.seq_length)

    def peak_bytes():
        return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    writer = MetricsWriter(cfg["output_dir"], config_snapshot=cfg)
    batches = run.batches()
    losses, step_times, window = [], [], []
    tokens_per_step = 0
    try:
        for step in range(run.end_step):
            batch = next(batches)
            tokens_per_step = batch["input_ids"].numel()
            t0 = time.perf_counter()
            metrics = run.step(batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            window.append(step)
            if (step + 1) % logging_steps == 0 or step + 1 == run.end_step:
                secs = sum(step_times[s] for s in window)
                tps = tokens_per_step * len(window) / max(secs, 1e-9)
                scalars = {"loss": float(np.mean([losses[s] for s in window])),
                           "lr": metrics["lr"],
                           "grad_norm": float(metrics["grad_norm"]),
                           "tokens_per_sec": tps, "tokens_per_sec_per_chip": tps,
                           "step_time": secs / len(window),
                           "device_peak_bytes": peak_bytes()}
                if peak:
                    scalars["mfu"] = flops_per_token * tps / peak
                writer.log(step + 1, scalars)
                window.clear()
    finally:
        writer.close()
    return {"final_step": run.end_step,
            "final_loss": losses[-1] if losses else float("nan"),
            "steps_per_epoch": len(run.loader), "output_dir": cfg["output_dir"],
            "losses": losses, "step_times": step_times,
            "tokens_per_step": tokens_per_step, "peak_memory_bytes": peak_bytes()}
