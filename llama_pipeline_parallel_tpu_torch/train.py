"""The trainer: config -> model -> data -> step loop.

The counterpart of llama_pipeline_parallel_tpu/train.py at dp = tp = sp = 1:
one device at pp = 1, or a pipeline of `mesh.pp` stages (parallel/pipeline.py)
under `pipeline_schedule` (1f1b, interleaved_1f1b, zb1, solver with
`schedule_file`), `virtual_stages`, `layer_counts` / `stage_balance` and
`gradient_accumulation_chunks`, either with every stage in this process on
one device or one stage per process of a `torch.distributed` group of `pp`
processes (cli.py under `python -m torch.distributed.run`; the metrics line
and the logs come from process 0). The same config keys, the same data for the same
seed, the same schedule-total rules and the same metrics line keys where they
apply. Data is the synthetic dataset or a tokenizer-backed one (`dataset:
{_target_: ...}` with `tokenizer_path`), packed `packing_factor` examples to
a row when asked, through the loader's retry, quarantine
(`data.quarantine_bad_shards`), sample ledger (`data.log_sample_ids`) and
prefetch thread (`prefetch_depth`). Checkpoints keep the JAX trainer's contract
(ckpt/checkpoint.py): `save_steps`, `save_final`, `async_save`,
`save_total_limit` and `save_sync_command` save; `resume` (true by default)
restores the full state from `output_dir`'s newest complete checkpoint, with
the data stream reopened at its O(1) position, falling back past a corrupt
one; otherwise `model_name_or_path` warm-starts the weights from a converted
checkpoint (tools/convert_hf.py). `eval_dataset` with `eval_steps` evaluates
the exact token-mean loss of a held-out set (`per_device_eval_batch_size`
rows a microbatch) with no autograd graph, and later checkpoints carry it
(`eval_loss`, `eval_step`). SIGTERM or SIGINT stops the run at the next
step with a checkpoint there (`preempted_at`); a second signal force-quits.
`activation_checkpointing` recomputes each layer under `remat_policy`
(models/llama/model.remat_layer). A fault plan (`fault_plan`, or
LPT_FAULT_PLAN, which wins) drives the sites this trainer has: `step`,
`data_read`, `storage_write` and `ckpt_commit`. The metrics line goes to
`metrics.jsonl` and, with `use_wandb` / `use_tensorboard`, to those sinks. The
observatories and the resilience actions are not ported yet; a config that
asks for a layout or feature this trainer does not have is refused, naming
its key, and keys that mean nothing with one stage (the pipeline schedule) are
logged once. A run of several processes saves and resumes nothing, and takes
no preemption signal (cross-process checkpoints and the stop vote come with
the next slice).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import (
    CheckpointCorruptError,
    CheckpointManager,
    config_from_meta,
)
from llama_pipeline_parallel_tpu_torch.data.collator import (
    CausalLMCollator,
    PackedCausalLMCollator,
    PretokenizedCollator,
)
from llama_pipeline_parallel_tpu_torch.data.datasets import SyntheticDataset
from llama_pipeline_parallel_tpu_torch.data.loader import (
    DataLoader,
    PrefetchIterator,
    RepeatingLoader,
)
from llama_pipeline_parallel_tpu_torch.data.tokenization import expand_special_tokenizer
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.models.llama.model import (
    REMAT_POLICIES,
    LlamaForCausalLM,
    init_params,
)
from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
)
from llama_pipeline_parallel_tpu_torch.optim.optimizer import AdamW, OptimizerConfig
from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
from llama_pipeline_parallel_tpu_torch.parallel import schedule as usched
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
    LossHead,
    TrainState,
    eval_step,
    train_step,
)
from llama_pipeline_parallel_tpu_torch.utils import faults
from llama_pipeline_parallel_tpu_torch.utils.config import instantiate
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger
from llama_pipeline_parallel_tpu_torch.utils.metrics import (
    MetricsWriter,
    NullMetricsWriter,
    Throughput,
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

# config keys that name features of the JAX trainer this one does not have
# yet, with what ports each
_NOT_PORTED = {"optimizer_offload": "host offload", "optimizer_offload_zero2": "host offload",
               "profile_steps": "the profiler", "health_interval": "the health heartbeat"}
# the fault sites this trainer fires (utils/faults.py); a plan with a rule at
# any other site is refused
FAULT_SITES = ("step", "data_read", "storage_write", "ckpt_commit")
# (site, op) rules this trainer cannot honour, with what each needs: a plan
# that holds one is refused
_NOT_PORTED_FAULTS = {("step", "grad_nonfinite"): "the numerics observatory",
                      ("step", "oom"): "the memory observatory"}
# blocks of the JAX trainer (host offload tiers, the observatories, the
# resilience actions) that ask for their feature when any of their values is
# set, with what ports each
_NOT_PORTED_BLOCKS = {"offload": "host offload", "numerics": "the numerics observatory",
                      "timeline": "the schedule observatory", "profiler": "the profiler",
                      "memory": "the memory observatory", "actions": "the resilience actions"}
# keys that order the pipeline's stages, with their defaults: with one stage
# (pp = 1) the microbatches run in order whatever they say
_ONE_STAGE_KEYS = {"pipeline_schedule": "1f1b", "virtual_stages": 1, "schedule_file": None,
                   "gradient_accumulation_chunks": 1}
PIPELINE_SCHEDULES = pl.SCHEDULES
# what a run of several processes cannot do yet, by key (value when unset)
_ONE_PROCESS_KEYS = {"save_steps": 0, "save_final": True, "resume": True, "async_save": False}


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


def _packing_factor(cfg: dict) -> int:
    """The one place `packing_factor` is parsed (collator and loader)."""
    return int(cfg.get("packing_factor", 1) or 1)


def build_dataset_and_collator(cfg: dict, model_cfg: LlamaConfig,
                               tokenizer: Any = None) -> tuple[Any, Any]:
    """The synthetic dataset with its pass-through collator, or
    `instantiate(dataset)` with the collator `_target_` or, by default, a
    tokenizer's causal-LM collator (packed with `packing_factor` > 1). The
    tokenizer is `AutoTokenizer.from_pretrained(tokenizer_path)` unless the
    caller hands one in as `tokenizer`; either goes through
    expand_special_tokenizer and must fit the model's vocabulary."""
    packing = _packing_factor(cfg)
    data_cfg = cfg.get("dataset")
    if data_cfg is None or data_cfg.get("synthetic"):
        if packing > 1:
            raise ValueError("packing_factor requires a tokenizer-backed dataset (the "
                             "synthetic dataset emits fixed full-length rows)")
        seq = (data_cfg or {}).get("seq_length", cfg.get("max_seq_length", 512))
        ds = SyntheticDataset(
            vocab_size=model_cfg.vocab_size, seq_length=seq,
            pseudo_dataset_len=(data_cfg or {}).get("pseudo_dataset_len", 4096),
            seed=cfg.get("seed", 42),
            pad_fraction=(data_cfg or {}).get("pad_fraction", 0.0))
        return ds, PretokenizedCollator()
    ds = instantiate(data_cfg)
    coll_cfg = cfg.get("collator")
    if coll_cfg is not None and "_target_" in coll_cfg:
        if packing > 1:
            raise ValueError("packing_factor cannot be combined with a custom collator "
                             "_target_; construct PackedCausalLMCollator there directly")
        return ds, instantiate(coll_cfg)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(cfg["tokenizer_path"])
    expand_special_tokenizer(tokenizer)
    if len(tokenizer) > model_cfg.vocab_size:
        raise ValueError(
            f"tokenizer has {len(tokenizer)} tokens but model vocab_size is "
            f"{model_cfg.vocab_size}; re-convert the checkpoint with vocab expansion "
            f"(tools/convert_hf.py resizes the embeddings)")
    max_len = cfg.get("max_seq_length", 512)
    if packing > 1:
        return ds, PackedCausalLMCollator(tokenizer, max_len, pack_factor=packing)
    return ds, CausalLMCollator(tokenizer, max_len)


def _flash_without_mask(q, k, v, padding_mask=None, *, causal=True):
    """flash_attention minus the segment-id stream: for unpacked right-padded
    batches the segment test is a documented no-op."""
    return flash_attention(q, k, v, None, causal=causal)


def _measure_segments(batch: int, seq_len: int, device: torch.device) -> torch.Tensor:
    """Representative packed-row segment ids for the auto measurement: four
    equal segments over ~4/5 of the row, then a pad tail."""
    seg = torch.zeros((batch, seq_len), dtype=torch.int32)
    fifth = max(seq_len // 5, 1)
    for i in range(4):
        seg[:, i * fifth:(i + 1) * fifth] = i + 1
    return seg.to(device)


def _measure_attention(model_cfg: LlamaConfig, seq_len: int, micro_batch: int,
                       device: torch.device, packed: bool = False) -> Any:
    """Time exact vs flash (fwd+bwd, bf16, device-synchronised) at the run's
    (microbatch, seq) shape on the card, with segment ids when the run packs,
    and return the faster."""
    rng = np.random.RandomState(0)
    h, hkv, hd = model_cfg.num_attention_heads, model_cfg.kv_heads, model_cfg.head_dim
    b = max(int(micro_batch), 1)

    def rand(heads):
        return torch.from_numpy(rng.randn(b, seq_len, heads, hd).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16).requires_grad_()

    q, k, v = rand(h), rand(hkv), rand(hkv)
    mask = _measure_segments(b, seq_len, device) if packed else None

    def time_one(fn):
        def run():
            out = fn(q, k, v, mask, causal=True)
            out.float().square().sum().backward()
        run()  # warm-up (and the kernels' build on first use)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / 3

    t_exact, t_flash = time_one(attention), time_one(flash_attention)
    flash = flash_attention if packed else _flash_without_mask
    winner = flash if t_flash < t_exact else attention
    logger.info("attention=auto @ batch %d seq %d packed=%s: exact %.2fms, flash %.2fms -> %s",
                b, seq_len, packed, 1e3 * t_exact, 1e3 * t_flash,
                "exact" if winner is attention else "flash")
    return winner


def select_attention(impl: str, seq_length: int, device: torch.device,
                     model_cfg: LlamaConfig | None = None, micro_batch: int = 1,
                     packed: bool = False) -> Any:
    """'exact' | 'flash' | 'auto'. `auto` (needs `model_cfg`) measures both
    paths on the card at the run's (microbatch, seq) shape, with segment ids
    when `packed`, and keeps the faster; off the card it takes the exact path
    (the flash kernels' plain version is slower there). Flash takes the
    batch's segment ids when the run packs; otherwise it drops them
    (`_flash_without_mask`): unpacked batches are right-padded."""
    flash = flash_attention if packed else _flash_without_mask
    if impl == "exact":
        return attention
    if impl == "flash":
        return flash
    if impl == "auto":
        if device.type != "cuda":
            return attention
        if model_cfg is None:
            raise ValueError("attention=auto measures at the model's shape: pass model_cfg")
        if model_cfg.head_dim not in KERNEL_HEAD_DIMS:
            logger.warning("attention=auto: head_dim %d has no flash kernel; using "
                           "the exact path", model_cfg.head_dim)
            return attention
        return _measure_attention(model_cfg, seq_length, micro_batch, device, packed)
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


def _remat(cfg: dict) -> tuple[bool, str]:
    """(`activation_checkpointing`, its `remat_policy`): a name outside the
    JAX trainer's policies is refused; a policy other than the default with
    checkpointing off is logged as having no effect."""
    remat = bool(cfg.get("activation_checkpointing", True))
    policy = cfg.get("remat_policy", "nothing_saveable")
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; choose one of {REMAT_POLICIES}")
    if policy != "nothing_saveable" and not remat:
        logger.info("remat_policy=%r has no effect: activation_checkpointing is off", policy)
    return remat, policy


def _mesh_config(cfg: dict) -> MeshConfig:
    mesh = cfg.get("mesh") or {}
    return MeshConfig(**{ax: int(mesh.get(ax, 1)) for ax in ("pp", "dp", "tp", "sp")})


def _check_supported(cfg: dict) -> None:
    """Refuse what this trainer does not run, naming the keys and what ports
    each; log once the keys that have no effect with one stage."""
    mesh_cfg = _mesh_config(cfg)
    layout = mesh_cfg.axis_sizes()
    other = {ax: n for ax, n in layout.items() if ax != "pp" and n != 1}
    if other:
        raise NotImplementedError(
            f"not ported yet: {other} of {mesh_cfg.describe()} (data, tensor and sequence "
            f"parallelism come with later slices; this trainer runs pp >= 1 with "
            f"dp = tp = sp = 1)")
    schedule = cfg.get("pipeline_schedule") or "1f1b"
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(f"unknown pipeline_schedule {schedule!r}; choose one of "
                         f"{PIPELINE_SCHEDULES}")
    asked = {key: what for key, what in _NOT_PORTED.items() if cfg.get(key)}
    asked.update({key: what for key, what in _NOT_PORTED_BLOCKS.items()
                  if _block_asks(cfg.get(key))})
    if asked:
        raise NotImplementedError(
            f"not ported yet: {list(asked)} ("
            + "; ".join(f"{key} comes with {what}" for key, what in asked.items()) + ")")
    if distributed.process_count() > 1:
        multi = [key for key, unset in _ONE_PROCESS_KEYS.items()
                 if cfg.get(key, unset)]
        if multi:
            raise NotImplementedError(
                f"not ported yet: {multi} in a run of {distributed.process_count()} processes "
                f"(cross-process checkpoints, resume and the preemption stop vote come with "
                f"the next slice); set save_steps=0 save_final=false resume=false")
    if mesh_cfg.pp == 1:
        chunks = int(cfg.get("gradient_accumulation_chunks") or 1)
        if chunks < 1 or cfg.get("gradient_accumulation_steps", 1) % chunks:
            raise ValueError(f"gradient_accumulation_chunks={chunks} must divide "
                             f"gradient_accumulation_steps="
                             f"{cfg.get('gradient_accumulation_steps', 1)}")
        moot = [key for key, default in _ONE_STAGE_KEYS.items()
                if cfg.get(key) is not None and cfg.get(key) != default]
        if moot:
            logger.warning("%s: no effect on one device (one pipeline stage runs its "
                           "microbatches in order)", moot)


def _virtual_stages(cfg: dict) -> int:
    """The `virtual_stages` knob, parsed in one place (the reference's
    `_virtual_stages`)."""
    v = int(cfg.get("virtual_stages", 1) or 1)
    if v > 1 and cfg.get("pipeline_schedule", "1f1b") not in ("interleaved_1f1b", "zb1",
                                                               "solver"):
        raise ValueError(
            f"virtual_stages={v} requires pipeline_schedule: interleaved_1f1b, zb1, or "
            f"solver (got {cfg.get('pipeline_schedule', '1f1b')!r})")
    return v


def _load_unit_schedule(cfg: dict) -> usched.UnitSchedule | None:
    """The `schedule_file` key under `pipeline_schedule: solver`: a unit
    sequence JSON (schedule.to_json, of either package), loaded and
    validated; None for the named schedules (they generate their canonical
    sequences)."""
    if cfg.get("pipeline_schedule", "1f1b") != "solver":
        if cfg.get("schedule_file"):
            raise ValueError("schedule_file only applies under pipeline_schedule: solver "
                             f"(got {cfg.get('pipeline_schedule', '1f1b')!r})")
        return None
    path = cfg.get("schedule_file")
    if not path:
        raise ValueError("pipeline_schedule: solver needs schedule_file: <path> (a unit "
                         "sequence written by parallel/schedule.py's to_json)")
    return usched.load(path)


def build_manifest(cfg: dict, model_cfg: LlamaConfig, pp: int) -> StageManifest:
    """The stage partition, as the reference's `build_manifest` chooses it:
    explicit `layer_counts` > cost-balanced (`stage_balance: cost`, or a
    layer count that pp does not divide) > even; `virtual_stages` > 1 takes
    the round-robin chunked layout, which has no uneven form."""
    v = _virtual_stages(cfg)
    if v > 1:
        if cfg.get("layer_counts") or cfg.get("stage_balance", "even") == "cost":
            raise ValueError(
                "virtual_stages > 1 (interleaved 1F1B / zb1) uses the round-robin even chunk "
                "partition; layer_counts/stage_balance: cost cannot apply — drop them or fall "
                "back to a flat schedule")
        return StageManifest.for_config(model_cfg, pp, virtual_stages=v)
    if cfg.get("layer_counts"):
        return StageManifest(num_layers=model_cfg.num_hidden_layers, num_stages=pp,
                             layer_counts=tuple(cfg["layer_counts"]))
    if cfg.get("stage_balance", "even") == "cost" or model_cfg.num_hidden_layers % pp:
        manifest = StageManifest.balanced(model_cfg, pp)
        logger.info("stage partition (cost-balanced): %s", manifest.stage_layer_counts)
        return manifest
    return StageManifest.for_config(model_cfg, pp)


def build_pipeline_config(cfg: dict, mesh_cfg: MeshConfig, manifest: StageManifest
                          ) -> pl.PipelineConfig:
    """The PipelineConfig of the run config (the reference's
    `build_pipeline_config`, without its offload and sp knobs)."""
    kernel_ce, kernel_prologue = _kernel_flags(cfg)
    remat, remat_policy = _remat(cfg)
    return pl.PipelineConfig(
        num_stages=mesh_cfg.pp,
        unit_schedule=_load_unit_schedule(cfg),
        num_microbatches=cfg.get("gradient_accumulation_steps", 1),
        remat=remat, remat_policy=remat_policy,
        schedule=cfg.get("pipeline_schedule", "1f1b"),
        virtual_stages=manifest.virtual_stages,
        accum_chunks=cfg.get("gradient_accumulation_chunks", 1) or 1,
        loss_chunks=cfg.get("loss_vocab_chunks", 1),
        layer_counts=None if manifest.is_even else manifest.stage_layer_counts,
        kernel_ce=kernel_ce, kernel_prologue=kernel_prologue)


def _configure_faults(cfg: dict) -> None:
    """Install the run's fault plan: LPT_FAULT_PLAN when set (it wins over
    the config, as in the JAX trainer), else `fault_plan`, else none. A plan
    with a rule at a site this trainer does not fire, or with an op it cannot
    honour there (_NOT_PORTED_FAULTS), is refused by name."""
    if os.environ.get(faults.ENV_PLAN):
        source, injector = f"${faults.ENV_PLAN}", faults.configure_from_env()
    else:
        source, injector = "fault_plan", faults.configure(cfg.get("fault_plan"))
    rules = {(rule["site"], rule["op"]) for rule in injector.stats()} if injector else set()
    other = sorted({site for site, _ in rules} - set(FAULT_SITES))
    if other:
        faults.configure(None)
        raise NotImplementedError(
            f"not ported yet: {source} has rules at site(s) {other}; this trainer fires "
            f"{list(FAULT_SITES)}")
    needs = {f"{op}@{site}": what for (site, op), what in _NOT_PORTED_FAULTS.items()
             if (site, op) in rules}
    if needs:
        faults.configure(None)
        raise NotImplementedError(
            f"not ported yet: {source} has rules {sorted(needs)}; "
            + "; ".join(f"{rule} needs {what}" for rule, what in needs.items()))


def _block_asks(node: Any) -> bool:
    """Whether a config block asks for its feature: any value set, unless
    it says `enabled: false`."""
    if not isinstance(node, dict):
        return bool(node)
    return node.get("enabled", True) is not False and any(bool(v) for v in node.values())


@dataclasses.dataclass
class Run:
    """A configured training run: what `train_run` loops over, and what
    tools/torch_step_profile.py profiles. `start_step` is the restored
    checkpoint's step (0 on a fresh or warm start) and `data_start` the
    (epoch, batch) the data stream reopens at. `eval_loader` is the
    held-out set (None without `eval_dataset`) and `last_eval` the newest
    evaluation ({"step", "loss"}), which later checkpoints carry. At pp > 1
    `pipeline` runs the steps: `state.params` are then its StageParams'
    flat() leaves (this process's stages), and `manifest` is the run's
    partition; checkpoints hold the canonical tree either way."""

    cfg: dict
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
    manifest: StageManifest
    ckpt: CheckpointManager
    topology: dict
    start_step: int = 0
    data_start: tuple[int, int] = (0, 0)
    remat_policy: str = "nothing_saveable"
    eval_loader: DataLoader | None = None
    last_eval: dict = dataclasses.field(default_factory=dict)
    pipeline: pl.Pipeline | None = None

    def canonical_state(self) -> tuple[dict[str, torch.Tensor], Any]:
        """(params, optimizer) in the canonical naming and layout that
        checkpoints hold: the run's own at pp = 1, else the pipeline's
        chunks merged (copies) and their moments seen through
        pl.CanonicalOptimizer."""
        if self.pipeline is None:
            return self.state.params, self.state.optimizer
        sp = self.pipeline.stage_params
        return sp.to_canonical(), pl.CanonicalOptimizer(self.state.optimizer, sp)

    def on_device(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """A collated batch (numpy) as tensors on the run's device."""
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def batches(self) -> Iterator[dict[str, torch.Tensor]]:
        """The data stream from `data_start` on, collated `prefetch_depth`
        batches ahead on a background thread."""
        stream = PrefetchIterator(RepeatingLoader(self.loader, *self.data_start),
                                  depth=self.cfg.get("prefetch_depth", 2))
        for batch in stream:
            yield self.on_device(batch)

    def host_scalars(self) -> dict:
        """The host-side counters of the metrics line: the packed collator's
        drops and, when the quarantine is armed, the records it skipped."""
        out = {}
        collator = self.loader.collate_fn
        if isinstance(collator, PackedCausalLMCollator):
            out["packing_dropped_total"] = collator.dropped_total
            out["packing_drop_rate"] = round(collator.drop_rate(), 4)
        if self.loader.quarantine_bad_records:
            out["data_quarantined_records"] = self.loader.quarantine_count
        return out

    def step(self, batch: dict[str, torch.Tensor]) -> dict:
        return train_step(self.state, batch, self.model_cfg,
                          num_microbatches=self.num_microbatches, attn_fn=self.attn_fn,
                          remat=self.remat, head=self.head,
                          kernel_prologue=self.kernel_prologue,
                          remat_policy=self.remat_policy, pipeline=self.pipeline)

    def eval_sum_count(self, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss sum, valid count) of one eval batch on the training step's
        attention, head and prologue, without an autograd graph."""
        return eval_step(self.state.params, batch, self.model_cfg,
                         num_microbatches=self.num_microbatches, attn_fn=self.attn_fn,
                         head=self.head, kernel_prologue=self.kernel_prologue,
                         pipeline=self.pipeline)

    def evaluate(self) -> float:
        """eval_loss: the exact token mean over every batch of the eval set
        (summed over batches, then divided once: not a mean of means)."""
        total, tokens = 0.0, 0
        for batch in self.eval_loader:
            loss_sum, count = self.eval_sum_count(self.on_device(batch))
            total += float(loss_sum)
            tokens += int(count)
        return total / max(tokens, 1)

    def save(self, step: int, final: bool = False) -> str:
        """The full state at `step` into `output_dir`: blocking when `final`
        or without `async_save` (the process may exit right after a final
        save, and a daemon commit thread would die with it)."""
        cfg = self.cfg
        batch_delta = (self.data_start[0] * max(len(self.loader), 1)
                       + self.data_start[1] - self.start_step)
        params, optimizer = self.canonical_state()
        return self.ckpt.save(
            step, params, self.manifest, self.model_cfg,
            optimizer=optimizer,
            blocking=final or not cfg.get("async_save", False),
            on_complete=lambda path: _sync_checkpoint(cfg, path),
            keep_last=cfg.get("save_total_limit"),
            extra_meta={"topology": self.topology,
                        "data_state": _data_state(step, self.loader, len(self.loader.dataset),
                                                  cfg.get("seed", 42), batch_delta),
                        **_eval_meta(self.last_eval)})


def build_run(cfg: dict, device: str | torch.device = "cuda", tokenizer: Any = None) -> Run:
    """Model, optimizer, data and attention for `cfg` on `device` (the card
    unless the caller asks for the CPU), restored from `output_dir`'s newest
    complete checkpoint under `resume` (true by default), else warm-started
    from `model_name_or_path` when given. `tokenizer` replaces the load of
    `tokenizer_path` (build_dataset_and_collator). Installs the run's fault
    plan (or none) for the process."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but torch.cuda.is_available() is false; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    _check_supported(cfg)
    _configure_faults(cfg)
    remat, remat_policy = _remat(cfg)
    seed = cfg.get("seed", 42)
    model_cfg = build_model_config(cfg["model"])
    head = _loss_head(cfg, model_cfg)
    kernel_prologue = _kernel_flags(cfg)[1]
    if head.kernel_ce or kernel_prologue:
        logger.info("hand-written kernels enabled (ce=%s prologue=%s): %s", head.kernel_ce,
                    kernel_prologue, "CUDA" if device.type == "cuda"
                    else "their plain PyTorch versions on the CPU")
    dataset, collator = build_dataset_and_collator(cfg, model_cfg, tokenizer)
    micro_batch = cfg.get("per_device_train_batch_size", 1)
    num_microbatches = cfg.get("gradient_accumulation_steps", 1)
    packing = _packing_factor(cfg)
    data_node = cfg.get("data") or {}
    ledger = None
    if data_node.get("log_sample_ids"):
        os.makedirs(cfg["output_dir"], exist_ok=True)
        ledger = os.path.join(cfg["output_dir"], "samples.jsonl")
    # with packing the loader feeds packing_factor examples per emitted row,
    # and the data position (data_state) counts examples
    loader = DataLoader(dataset, collator,
                        per_replica_batch=micro_batch * num_microbatches * packing, seed=seed,
                        quarantine_bad_records=bool(data_node.get("quarantine_bad_shards", False)),
                        sample_ledger=ledger)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise ValueError(f"dataset of {len(dataset)} examples yields 0 steps at "
                         f"batch {loader.per_replica_batch}")
    eval_loader = _eval_loader(cfg, model_cfg, tokenizer, num_microbatches)

    # `total_steps` (schedule horizon) is separate from `max_steps` (loop end)
    # so an interrupted-then-resumed run sees the uninterrupted run's LR curve
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
    mesh_cfg = _mesh_config(cfg)
    seq_length = int(collator([dataset[0]])["input_ids"].shape[1])
    attn_fn = select_attention(cfg.get("attention", "auto"), seq_length, device,
                               model_cfg=model_cfg, micro_batch=micro_batch,
                               packed=packing > 1)
    mesh = make_mesh(mesh_cfg)  # refuses a process count other than 1 or pp
    pipeline = None
    if mesh_cfg.pp == 1:
        params = model.params()
        # the canonical layout is the one-stage manifest's
        manifest = StageManifest(num_layers=model_cfg.num_hidden_layers, num_stages=1)
    else:
        manifest = build_manifest(cfg, model_cfg, mesh_cfg.pp)
        pcfg = build_pipeline_config(cfg, mesh_cfg, manifest)
        stage_params = pl.StageParams.from_canonical(model.params(), manifest, mesh.stages)
        del model
        pipeline = pl.Pipeline(model_cfg, pcfg, mesh, stage_params, attn_fn)
        params = stage_params.flat()
        logger.info("pipeline %s: schedule %s, %d microbatches in %d flush(es), stages of %s "
                    "layers (virtual_stages %d), counted bubble %.4f", mesh_cfg.describe(),
                    pcfg.schedule, pcfg.num_microbatches, pcfg.accum_chunks,
                    list(manifest.stage_layer_counts), manifest.virtual_stages,
                    pl.bubble_fraction(pcfg))
    state = TrainState(step=0, params=params, optimizer=AdamW(params, ocfg))
    topology = _topology_meta(cfg, manifest)
    mgr = CheckpointManager(cfg["output_dir"])
    run = Run(cfg=cfg, device=device, model_cfg=model_cfg, loader=loader, state=state,
              attn_fn=attn_fn, num_microbatches=num_microbatches, remat=remat, head=head,
              kernel_prologue=kernel_prologue, seq_length=seq_length, end_step=end_step,
              manifest=manifest, ckpt=mgr, topology=topology, remat_policy=remat_policy,
              eval_loader=eval_loader, pipeline=pipeline)
    if cfg.get("resume", True) and distributed.process_count() == 1:
        restored = _restore_with_fallback(mgr, lambda s: _restore(run, s))
    else:
        restored = None
    if restored is not None:
        run.start_step = state.step = restored
        logger.info("resumed full state from checkpoint-%d", run.start_step)
        _note_topology_change(mgr, run.start_step, topology)
        run.data_start = _resume_data_position(mgr, run.start_step, loader, len(dataset), seed)
    elif cfg.get("model_name_or_path"):
        _warm_start(cfg["model_name_or_path"], run)
    return run


def _restore(run: Run, step: int) -> int:
    """Full-state restore of checkpoint-`step` into the run (its canonical
    tree carried into the pipeline's chunks at pp > 1); returns the step."""
    params, optimizer = run.canonical_state()
    step = run.ckpt.load(step, params, optimizer, run.manifest)[2]
    if run.pipeline is not None:
        run.pipeline.stage_params.copy_canonical(params)
    return step


def _eval_loader(cfg: dict, model_cfg: LlamaConfig, tokenizer: Any,
                 num_microbatches: int) -> DataLoader | None:
    """The held-out set of `eval_dataset` (None without one), as the JAX
    trainer's `_make_evaluator` builds it: the training config's tokenizer
    and collator over that dataset node, in dataset order, a batch of
    `num_microbatches` microbatches of `per_device_eval_batch_size` rows
    (default: the training micro-batch), times `packing_factor` examples.
    Refused when the set holds no whole batch."""
    eval_cfg = cfg.get("eval_dataset")
    if eval_cfg is None:
        return None
    dataset, collator = build_dataset_and_collator({**cfg, "dataset": eval_cfg}, model_cfg,
                                                   tokenizer)
    rows = cfg.get("per_device_eval_batch_size", cfg.get("per_device_train_batch_size", 1))
    loader = DataLoader(dataset, collator,
                        per_replica_batch=rows * num_microbatches * _packing_factor(cfg),
                        shuffle=False)
    if len(loader) == 0:
        raise ValueError(f"eval dataset too small for one batch ({len(dataset)} examples, "
                         f"batch {loader.per_replica_batch})")
    return loader


def _eval_meta(last_eval: dict) -> dict:
    """meta.json's share of the newest evaluation: `eval_loss` and the step
    it was measured at; nothing before the first evaluation."""
    if "loss" in last_eval:
        return {"eval_loss": last_eval["loss"], "eval_step": last_eval["step"]}
    return {}


# the config fields that fix the parameters' shapes
_SHAPE_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                 "num_attention_heads", "kv_heads")


def _warm_start(path: str, run: Run) -> None:
    """Module-only warm start from the newest checkpoint under `path` (the
    output of tools/convert_hf.py, or any checkpoint of this package), into
    the run's params (its pipeline's chunks at pp > 1)."""
    model_cfg = run.model_cfg
    warm = CheckpointManager(path)
    step = warm.latest_step()
    if step is None:
        raise FileNotFoundError(
            f"no checkpoint under model_name_or_path={path} (run python -m "
            f"llama_pipeline_parallel_tpu_torch.tools.convert_hf first)")
    source = config_from_meta(warm.load_meta(step))
    differ = {f: (getattr(source, f), getattr(model_cfg, f)) for f in _SHAPE_FIELDS
              if getattr(source, f) != getattr(model_cfg, f)}
    if differ:
        raise ValueError(
            f"model_name_or_path={path} checkpoint-{step} does not fit this run's model "
            f"({', '.join(f'{k}: {a} there, {b} here' for k, (a, b) in differ.items())}): "
            f"re-convert the HF model (tools.convert_hf) or set the model block to match")
    params = run.canonical_state()[0]
    warm.load_params(step, params, run.manifest)
    if run.pipeline is not None:
        run.pipeline.stage_params.copy_canonical(params)
    logger.info("warm-started module weights from %s (checkpoint-%d)", path, step)


def _topology_meta(cfg: dict, manifest: StageManifest) -> dict:
    """The run's topology as meta.json records it (the JAX trainer's
    `_topology_meta`): the source half of the elastic-restore contract, read
    by a later run to log what changed. `layer_counts` names the partition:
    "even/<k>" or the per-stage list."""
    mc = MeshConfig(pp=manifest.num_stages)
    return {"pp": mc.pp, "dp": mc.dp, "tp": mc.tp, "sp": mc.sp, "layout": mc.describe(),
            "schedule": cfg.get("pipeline_schedule", "1f1b"),
            "virtual_stages": manifest.virtual_stages,
            "process_count": distributed.process_count(),
            "layer_counts": (f"even/{manifest.stage_layer_counts[0]}" if manifest.is_even
                             else list(manifest.stage_layer_counts))}


def _data_state(step: int, loader: DataLoader, dataset_len: int,
                seed: int, batch_delta: int = 0) -> dict:
    """The sampler position at `step`, in dp-width-independent units: the
    epoch permutation is a function of (seed, epoch) only, and step b
    consumes exactly global-order positions [b*G, (b+1)*G) -- so
    consumed_samples is the canonical resume coordinate.

    `batch_delta`: data-stream batches minus step count, established at
    resume (nonzero only after a changed-global-batch remap) -- without it,
    a SECOND resume from a checkpoint written after such a remap would
    reposition from step*G and re-train whole spans of data."""
    spe = max(len(loader), 1)
    g = loader.global_batch_examples
    batches = step + batch_delta
    return {"epoch": batches // spe, "offset_batches": batches % spe,
            "consumed_samples": batches * g, "shuffle_seed": seed,
            "global_batch_examples": g, "dataset_len": dataset_len,
            "steps_per_epoch": spe}


def _resume_data_position(mgr: CheckpointManager, resume_step: int,
                          loader: DataLoader, dataset_len: int,
                          seed: int) -> tuple[int, int]:
    """O(1) resume position (start_epoch, start_batch) for the data stream.

    The checkpoint's data_state pins (seed, dataset_len, consumed samples),
    and index arithmetic alone repositions the sampler. Checkpoints without
    a data_state derive the position from the step count. A changed global
    batch is remapped by consumed-sample count (exact only when G is
    unchanged -- re-trains at most one partial batch otherwise, and warns);
    a changed shuffle seed or dataset cannot be remapped and falls back to
    step-count positioning with a warning. The batch count folds into
    (epoch, batch) by divmod: the loader opens only inside an epoch."""
    spe = max(len(loader), 1)
    g = loader.global_batch_examples
    batches = resume_step
    data_state = None
    try:
        data_state = mgr.load_meta(resume_step).get("data_state")
    except Exception as e:  # meta vanished under us -- position by step count
        logger.warning("could not re-read checkpoint-%d meta for data_state "
                       "(%r); positioning the loader by step count",
                       resume_step, e)
    if data_state:
        if (data_state.get("shuffle_seed") != seed
                or data_state.get("dataset_len") != dataset_len):
            logger.warning(
                "checkpoint data_state (seed=%s, dataset_len=%s) does not "
                "match this run (seed=%s, dataset_len=%s); positioning by "
                "step count -- the shuffle order differs, sample-exact "
                "continuity is not guaranteed",
                data_state.get("shuffle_seed"), data_state.get("dataset_len"),
                seed, dataset_len)
        else:
            consumed = int(data_state.get("consumed_samples", resume_step * g))
            src_g = data_state.get("global_batch_examples")
            if src_g not in (None, g):
                logger.warning(
                    "global batch changed across resume (%s -> %s examples/"
                    "step); sample-exact continuity only holds for an "
                    "unchanged global batch -- remapping by consumed-sample "
                    "count, re-training at most one partial batch", src_g, g)
            batches = consumed // g
    epoch, offset = divmod(batches, spe)
    logger.info("O(1) data resume: step %d -> epoch %d, batch offset %d "
                "(no loader replay)", resume_step, epoch, offset)
    return epoch, offset


def _note_topology_change(mgr: CheckpointManager, step: int, current: dict) -> None:
    """Log a restore across topologies: the checkpoint's recorded source
    topology vs this run's. Purely informational."""
    try:
        source = mgr.load_meta(step).get("topology")
    except Exception:
        return
    if not source:
        return  # nothing recorded
    keys = ["pp", "dp", "tp", "sp", "schedule", "virtual_stages"]
    if "layer_counts" in source:
        keys.append("layer_counts")
    changed = sorted(k for k in keys if source.get(k) != current.get(k))
    if changed:
        logger.warning(
            "elastic restore: checkpoint-%d was written at %s (schedule=%s, v=%s, "
            "layer_counts=%s); restoring onto %s (schedule=%s, v=%s, layer_counts=%s) -- "
            "changed: %s. Keep the global batch unchanged for sample-exact data continuity",
            step, source.get("layout"), source.get("schedule"),
            source.get("virtual_stages"), source.get("layer_counts"),
            current.get("layout"), current.get("schedule"),
            current.get("virtual_stages"), current.get("layer_counts"), changed)
    else:
        logger.info("resume topology matches checkpoint-%d (%s)", step, current.get("layout"))


def _restore_with_fallback(mgr: CheckpointManager, restore_fn) -> Any | None:
    """Resume restore with automatic fallback: when the newest checkpoint
    fails integrity verification, `verify` quarantines it, `latest_step()`
    then resolves to the previous complete one, and the restore re-runs --
    until a checkpoint verifies or none remain (fresh start). Only
    CheckpointCorruptError falls back; layout/compat errors (ValueError) stay
    fatal -- they mean a misconfigured run."""
    prev: int | None = None
    while True:
        step = mgr.latest_step()
        if step is None:
            return None
        if step == prev:
            # quarantine could not move the dir -- re-raising beats spinning
            raise CheckpointCorruptError(
                f"checkpoint-{step} is corrupt and could not be quarantined")
        try:
            return restore_fn(step)
        except CheckpointCorruptError as e:
            logger.error("resume blocked by corrupt checkpoint-%d (%s); falling back", step, e)
            prev = step


def _sync_checkpoint(cfg: dict, path: str) -> None:
    """Off-node durability hook: run `save_sync_command` with {path}
    substituted after the checkpoint is durably on disk, e.g.
    `save_sync_command: "rsync -a {path} /mnt/backup/run/"`. Failures are
    logged, never fatal -- a sync outage must not kill training."""
    command = cfg.get("save_sync_command")
    if not command:
        return
    import subprocess

    # plain replace (not str.format): the command may contain shell braces
    cmd = command.replace("{path}", path)
    try:
        result = subprocess.run(cmd, shell=True, capture_output=True, text=True,
                                timeout=cfg.get("save_sync_timeout", 1800))
        if result.returncode != 0:
            logger.warning("save_sync_command failed (%d): %s", result.returncode,
                           result.stderr.strip()[-500:])
        else:
            logger.info("checkpoint synced: %s", cmd)
    except Exception as e:  # timeout / spawn failure -- never kill training
        logger.warning("save_sync_command error: %r", e)


# Preemption: SIGTERM / SIGINT (a maintenance event, a spot reclaim, Ctrl+C)
# set a flag that the step loop reads at the top of every step; it then saves
# at that step and returns with `preempted_at`. The handlers are installed when
# run_training starts, so a signal during setup or the kernels' build is
# honoured at the first step. Signal dispositions belong to the process, so
# this state is module-level; it is changed only on the main thread (the
# handler runs there too).
_STOP_SIGNALS: list[int] = []
_INSTALLED_SIGNALS: list[int] = []
_PREVIOUS_HANDLERS: dict = {}


def _in_main_thread() -> bool:
    return threading.current_thread() is threading.main_thread()


def _on_preemption_signal(sig, frame):
    _STOP_SIGNALS.append(sig)
    # async-signal-safe notice: the stop itself waits for the next step
    os.write(2, b"\n[trainer] signal received; will checkpoint at the next "
                b"step and exit (signal again to force-quit)\n")
    for s in _INSTALLED_SIGNALS:  # a second signal takes the default action
        signal.signal(s, signal.SIG_DFL)


def _install_preemption_handlers() -> None:
    """Record SIGTERM / SIGINT from the start of the run. A run on a worker
    thread (an embedding caller) installs nothing: Python handlers live on
    the main thread, whose run may be another."""
    if not _in_main_thread():
        return
    _STOP_SIGNALS.clear()  # a stale flag from a prior run must not stop this one
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev = signal.signal(sig, _on_preemption_signal)
        # None: a handler installed outside Python, which signal.signal
        # cannot reinstate; restore the default instead of ours
        _PREVIOUS_HANDLERS[sig] = signal.SIG_DFL if prev is None else prev
        _INSTALLED_SIGNALS.append(sig)


def _release_preemption_handlers() -> None:
    """Restore the handlers from before the run. Idempotent: the loop hands
    the signals back before the final save (a signal there must interrupt,
    as nothing reads the flag any more), and run_training's finally is the
    backstop for every other exit."""
    if not _in_main_thread():
        return
    for sig, handler in list(_PREVIOUS_HANDLERS.items()):
        signal.signal(sig, handler)
        del _PREVIOUS_HANDLERS[sig]
    _STOP_SIGNALS.clear()
    _INSTALLED_SIGNALS.clear()


def run_training(cfg: dict, device: str | torch.device = "cuda", tokenizer: Any = None) -> dict:
    """The training run; returns a summary dict for programmatic callers.
    Runs on `device` (the card unless the caller asks for the CPU);
    `tokenizer` as in build_run. Installs the preemption handlers first; the
    run's fault plan is cleared and the handlers restored at the end."""
    if distributed.process_count() == 1:
        _install_preemption_handlers()
    else:
        logger.warning("%d processes: SIGTERM / SIGINT end this process without a checkpoint "
                       "(the cross-process stop vote comes with the next slice)",
                       distributed.process_count())
    try:
        return train_run(build_run(cfg, device, tokenizer))
    finally:
        faults.configure(None)
        _release_preemption_handlers()


def train_run(run: Run) -> dict:
    """Steps `run.start_step` .. `run.end_step` (the JAX trainer's
    `_train_loop` for one process). Each step fires the `step` fault site,
    then stops the run on a preemption signal: a blocking save at that step,
    and the summary's `preempted_at` and `final_step` name it. Every
    `logging_steps` the metrics line: the window's mean loss, tokens/s over
    its wall time (data wait, eval and saves included; `real_tokens_per_sec`
    over the non-pad positions where they differ), and `step_time`, that
    wall less the first step (the kernels' build and warm-up), eval and
    checkpoint seconds, per step. Every `eval_steps` with an eval set,
    `eval_loss`, before a save at the same step. Saves every `save_steps`
    and, under `save_final` (true by default), at the end unless the last
    step was just saved. The summary's `step_times` and `losses` are per
    step, device-synchronised; the trained state stays in `run.state`."""
    cfg, device = run.cfg, run.device
    logging_steps = cfg.get("logging_steps", 10)
    save_steps = cfg.get("save_steps", 0)
    eval_steps = cfg.get("eval_steps", 0) if run.eval_loader is not None else 0
    # The stop flag is read every step when the run is one process, as in the
    # JAX trainer when process_count() == 1; `preempt_check_every` paces the
    # cross-process stop vote, which comes with the next slice (a run of
    # several processes installs no handler, so its flag stays down).
    process_count = distributed.process_count()
    check_every = max(int(cfg.get("preempt_check_every", 10)), 1)

    def peak_bytes():
        return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    writer = (MetricsWriter(cfg["output_dir"], config_snapshot=cfg,
                            use_wandb=cfg.get("use_wandb", False),
                            use_tensorboard=cfg.get("use_tensorboard", False))
              if distributed.process_index() == 0 else NullMetricsWriter())
    meter = Throughput(run.model_cfg, run.seq_length, device=device)
    batches = run.batches()
    losses, step_times, window = [], [], []
    tokens_per_step = 0
    last_saved = -1
    preempted_at = None
    window_t0 = time.perf_counter()
    window_overhead = 0.0  # first-step, eval and checkpoint seconds: not step_time
    try:
        for step in range(run.start_step, run.end_step):
            faults.fire("step", step=step)
            check_now = process_count == 1 or step % check_every == 0
            if check_now and _STOP_SIGNALS:
                logger.warning("preemption signal; checkpointing at step %d and exiting for "
                               "clean resume", step)
                preempted_at = step
                run.save(step, final=True)  # joins an async save in flight first
                last_saved = run.end_step  # no save_final after it
                break
            batch = next(batches)
            tokens_per_step = batch["input_ids"].numel()
            t0 = time.perf_counter()
            metrics = run.step(batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_times.append(time.perf_counter() - t0)
            if step == run.start_step:
                window_overhead += step_times[-1]
            losses.append(float(metrics["loss"]))
            window.append(losses[-1])
            mask = batch.get("attention_mask")
            meter.update(tokens_per_step, None if mask is None else int((mask != 0).sum()))
            if (step + 1) % logging_steps == 0 or step + 1 == run.end_step:
                step_time = max(time.perf_counter() - window_t0 - window_overhead,
                                0.0) / len(window)
                window_t0 = time.perf_counter()
                window_overhead = 0.0
                writer.log(step + 1, {"loss": float(np.mean(window)), "lr": metrics["lr"],
                                      "grad_norm": float(metrics["grad_norm"]),
                                      **meter.read_and_reset(), "step_time": step_time,
                                      "device_peak_bytes": peak_bytes(),
                                      **run.host_scalars()})
                window.clear()
            if eval_steps and (step + 1) % eval_steps == 0:
                t_eval = time.perf_counter()
                eval_loss = run.evaluate()
                writer.log(step + 1, {"eval_loss": eval_loss})
                run.last_eval = {"step": step + 1, "loss": eval_loss}
                window_overhead += time.perf_counter() - t_eval
            if save_steps and (step + 1) % save_steps == 0:
                t_save = time.perf_counter()
                run.save(step + 1)
                last_saved = step + 1
                window_overhead += time.perf_counter() - t_save
    except BaseException:
        # join the in-flight commit, but never let ITS failure replace the
        # training exception that actually killed the run
        try:
            run.ckpt.finalize()
        except Exception:
            logger.exception("async checkpoint commit also failed while "
                             "unwinding a training error")
        raise
    finally:
        run.loader.close_ledger()
        writer.close()
        _release_preemption_handlers()
    if cfg.get("save_final", True) and last_saved != run.end_step:
        run.save(run.end_step, final=True)
    run.ckpt.finalize()  # surface any async-commit failure on the clean path
    return {"final_step": run.end_step if preempted_at is None else preempted_at,
            "start_step": run.start_step, "preempted_at": preempted_at,
            "final_loss": losses[-1] if losses else float("nan"),
            "steps_per_epoch": len(run.loader), "output_dir": cfg["output_dir"],
            "losses": losses, "step_times": step_times,
            "tokens_per_step": tokens_per_step, "peak_memory_bytes": peak_bytes()}
