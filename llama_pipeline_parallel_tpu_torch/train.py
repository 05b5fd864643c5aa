"""The trainer: config -> model -> data -> step loop.

The counterpart of llama_pipeline_parallel_tpu/train.py: one
device at pp = 1, or a pipeline of `mesh.pp` stages (parallel/pipeline.py)
under `pipeline_schedule` (1f1b, interleaved_1f1b, zb1, solver with
`schedule_file`, gpipe), `virtual_stages`, `layer_counts` / `stage_balance`
and `gradient_accumulation_chunks`, with every stage in this process on one
device or one stage per process; `mesh.dp` data-parallel replicas, a
process each (parallel/mesh.py: pp * dp processes of one stage, or dp
processes of every stage), with ZeRO-1 moments (optim/optimizer.Zero1AdamW);
and `mesh.tp` tensor-parallel ranks, a process each (pp * dp * tp processes;
Megatron layers and the vocab-parallel CE head: parallel/tp.py), each
process initialising only the leaves, rows and tp slices it holds
(parallel/train_step.init_params_sharded); and `mesh.sp` sequence slabs, a
process each (pp * dp * sp * tp processes; `sequence_parallel`: ring or
ulysses attention, parallel/sp.py), each process stepping on its column
slab of its replica's rows (parallel/mesh.sp_slab).
Several processes run under `python -m torch.distributed.run` (cli.py); the
metrics line and the logs come from process 0. The same config keys, the same data for the same
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
`actions.resize_on_request` (utils/actions.TrainActions) makes the run watch
for `<output_dir>/resize.request`, which the supervisor (tools.supervisor
--actuate) drops to move the run to another layout rung: on the stop vote's
cadence every process votes on it, all stop at one step with a checkpoint
there, and process 0 renames the request to `resize.request.ack` once the
save has committed; the run then ends cleanly for the relaunch.
`activation_checkpointing` recomputes each layer under `remat_policy`
(models/llama/model.remat_layer). `optimizer_offload` keeps the fp32
masters and Adam moments in host memory (optim/offload.py): the card holds
the working copy in the compute dtype and fp32 gradients, and each step is
loss and gradients on the card, then the host AdamW streaming gradients down
and the working copy up (`offload_device_norm`, true by default, clips by
the norm taken on the card); its checkpoints take the `offload_parts`
layout. At dp > 1 the host optimizer runs
replicated (every replica steps its leaves on the dp-summed gradients) or,
with `optimizer_offload_zero2`, in the ZeRO-2 layout (a replica's 1/dp of
each leaf's masters and moments; the working copy all-gathered over dp).
`offload.wgrad_stash` / `offload.activations` keep a pipeline's W
queue / stage inputs in host memory (parallel/pipeline.py). A fault plan (`fault_plan`, or
LPT_FAULT_PLAN, which wins) drives the sites this trainer has: `step`,
`data_read`, `storage_write`, `ckpt_commit` and `barrier`. The metrics line goes to
`metrics.jsonl` and, with `use_wandb` / `use_tensorboard`, to those sinks.
The observability layer is the JAX trainer's (train_run): spans.jsonl and
goodput (utils/trace.py), health.json every `health_interval` seconds, the
numerics observatory (`numerics.*`, on by default: numerics.jsonl and the
nonfinite guard), the memory watch (`memory.*`), the schedule timeline
(`timeline.*`), the triggered profiler (`profiler.*`), a `profile_steps`
window, perf.jsonl, and the `grad_nonfinite` and `oom` drills at the `step`
site. A config that asks for a
layout or feature this trainer does not have is refused, naming its key,
and keys that mean nothing with one stage (the pipeline schedule) are
logged once. A run of several processes saves through process 0 (which
writes the canonical tree leaf by leaf from every process's pieces:
ckpt/gather.py; ckpt/checkpoint.py's commit barriers),
resumes in every process, and stops every process at the same step on a
signal to any one of them: the stop vote every `preempt_check_every` steps.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import signal
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from llama_pipeline_parallel_tpu_torch.ckpt import gather, tensor_io
from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import (
    OFFLOAD_LAYOUT,
    CheckpointCorruptError,
    CheckpointManager,
    config_from_meta,
    copy_tensors,
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
    param_shapes,
)
from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa_mod
from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc_mod
from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp_mod
from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
)
from llama_pipeline_parallel_tpu_torch.optim.offload import HostOffloadAdamW
from llama_pipeline_parallel_tpu_torch.optim.optimizer import (
    AdamW,
    OptimizerConfig,
    Zero1AdamW,
    zero1_dims,
)
from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
from llama_pipeline_parallel_tpu_torch.parallel import schedule as usched
from llama_pipeline_parallel_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    host_dp_shard,
    layout_for,
    make_mesh,
    sp_slab,
)
from llama_pipeline_parallel_tpu_torch.parallel.sp import check_sp, make_sp_attention
from llama_pipeline_parallel_tpu_torch.parallel.tp import check_tp, tp_dim, tp_shard
from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
    LossHead,
    TrainState,
    eval_step,
    init_params_sharded,
    train_step,
)
from llama_pipeline_parallel_tpu_torch.utils import faults, memwatch, numerics, perf, trace
from llama_pipeline_parallel_tpu_torch.utils import profiler as profiler_mod
from llama_pipeline_parallel_tpu_torch.utils import timeline as timeline_mod
from llama_pipeline_parallel_tpu_torch.utils.actions import (
    RESIZE_ACK_NAME,
    RESIZE_REQUEST_NAME,
    TrainActions,
)
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

# the fault sites this trainer fires (utils/faults.py); the plan's rules at
# the others are the supervisor's, the actuators' and the gateway's
FAULT_SITES = ("step", "data_read", "storage_write", "ckpt_commit", "barrier")
# keys that order the pipeline's stages, with their defaults: with one stage
# (pp = 1) the microbatches run in order whatever they say
_ONE_STAGE_KEYS = {"pipeline_schedule": "1f1b", "virtual_stages": 1, "schedule_file": None,
                   "gradient_accumulation_chunks": 1}
PIPELINE_SCHEDULES = pl.SCHEDULES


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
    winner = flash_attention if t_flash < t_exact else attention
    logger.info("attention=auto @ batch %d seq %d packed=%s: exact %.2fms, flash %.2fms -> %s",
                b, seq_len, packed, 1e3 * t_exact, 1e3 * t_flash,
                "exact" if winner is attention else "flash")
    return winner


def select_attention(impl: str, seq_length: int, device: torch.device,
                     model_cfg: LlamaConfig | None = None, micro_batch: int = 1,
                     packed: bool = False, sp: int = 1,
                     sequence_parallel: str = "ring") -> Any:
    """'exact' | 'flash' | 'auto'. `auto` (needs `model_cfg`) measures both
    paths on the card at the run's (microbatch, kernel length) shape, with
    segment ids when `packed`, and keeps the faster; off the card it takes
    the exact path (the flash kernels' plain version is slower there). The
    kernel length under sp is the ring's slab, seq / sp (Ulysses re-shards
    to the full sequence). Flash takes the batch's segment ids when the run
    packs; otherwise, at sp = 1, it drops them (`_flash_without_mask`:
    unpacked batches are right-padded). Under sp > 1 the mask is never
    dropped here: parallel/sp.make_sp_attention picks the ring's backend by
    the identity of `flash_attention`, and the ring drops the mask itself."""

    def finish(fn):
        if fn is flash_attention and not packed and sp == 1:
            return _flash_without_mask
        return fn

    if impl == "exact":
        return attention
    if impl == "flash":
        return finish(flash_attention)
    if impl == "auto":
        if device.type != "cuda":
            return attention
        if model_cfg is None:
            raise ValueError("attention=auto measures at the model's shape: pass model_cfg")
        if model_cfg.head_dim not in KERNEL_HEAD_DIMS:
            logger.warning("attention=auto: head_dim %d has no flash kernel; using "
                           "the exact path", model_cfg.head_dim)
            return attention
        kernel_len = seq_length // sp if (sp > 1 and sequence_parallel == "ring") \
            else seq_length
        return finish(_measure_attention(model_cfg, kernel_len, micro_batch, device, packed))
    raise ValueError(f"unknown attention impl {impl!r} (use exact|flash|auto)")


def _offload_flags(cfg: dict) -> tuple[bool, bool]:
    """The `offload.*` block, as the reference's `_offload_flags` parses it:
    `wgrad_stash` keeps the zb1 W queue, `activations` the stage-input
    buffer, in host memory (utils/host_stash.py); unknown keys refused.
    Returns (wgrad_stash, activations)."""
    node = cfg.get("offload") or {}
    if not isinstance(node, dict):
        raise ValueError(f"offload must be a mapping of tier knobs, e.g. "
                         f"offload: {{wgrad_stash: true}} -- got {node!r}")
    known = {"wgrad_stash", "activations"}
    unknown = set(node) - known
    if unknown:
        raise ValueError(f"unknown offload.* key(s) {sorted(unknown)}; known: {sorted(known)}")
    return bool(node.get("wgrad_stash", False)), bool(node.get("activations", False))


def _offload_static(pcfg: pl.PipelineConfig, mb_rows: int, local_seqlen: int,
                    hidden_size: int, dtype_bytes: int) -> dict:
    """The metrics line's host-stash keys (the reference's): which stores are
    tiered (`offload_stash`) and the GiB a stage keeps in host memory
    (`offload_stash_resident_gib`); nothing with both tiers off."""
    wgrad_off = pl.wgrad_offloaded_units(pcfg)
    wgrad_name = "wgrad_stash"
    if pcfg.schedule == "solver" and wgrad_off:
        total = pcfg.unit_schedule.n_units
        if wgrad_off < total:
            wgrad_name = f"wgrad_stash[{wgrad_off}/{total}]"
    tiers = [name for name, on in ((wgrad_name, wgrad_off > 0),
                                   ("activations", pcfg.offload_activations)) if on]
    if not tiers:
        return {}
    resident = pl.host_stash_bytes(pcfg, mb_rows, local_seqlen, hidden_size, dtype_bytes)
    # 6 decimals: KiB resolution, so a tiny model's residency is not 0
    return {"offload_stash": "+".join(tiers),
            "offload_stash_resident_gib": round(resident / (1 << 30), 6)}


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
    model_cfg = build_model_config(cfg["model"])
    head = _loss_head(cfg, model_cfg)
    check_sp(model_cfg, mesh_cfg.tp, mesh_cfg.sp, cfg.get("sequence_parallel", "ring"))
    check_tp(model_cfg, mesh_cfg.tp, head.loss_chunks, head.kernel_ce)
    layout_for(mesh_cfg, distributed.process_count())  # the process count
    schedule = cfg.get("pipeline_schedule") or "1f1b"
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(f"unknown pipeline_schedule {schedule!r}; choose one of "
                         f"{PIPELINE_SCHEDULES}")
    TrainActions.from_cfg(cfg.get("actions"))
    # the observatories' blocks, each refused on an unknown key or a value
    # out of its range as the JAX trainer refuses it
    numerics.NumericsConfig.from_cfg(cfg.get("numerics"))
    timeline_mod.TimelineConfig.from_cfg(cfg.get("timeline"))
    profiler_mod.CaptureConfig.from_cfg(cfg.get("profiler"))
    memwatch.MemoryConfig.from_cfg(cfg.get("memory"))
    if mesh_cfg.pp == 1:
        chunks = int(cfg.get("gradient_accumulation_chunks") or 1)
        if chunks < 1 or cfg.get("gradient_accumulation_steps", 1) % chunks:
            raise ValueError(f"gradient_accumulation_chunks={chunks} must divide "
                             f"gradient_accumulation_steps="
                             f"{cfg.get('gradient_accumulation_steps', 1)}")
        moot = [key for key, default in _ONE_STAGE_KEYS.items()
                if cfg.get(key) is not None and cfg.get(key) != default]
        tiers = _offload_flags(cfg)
        pl.check_offload_tiers(cfg.get("pipeline_schedule") or "1f1b", *tiers)
        if any(tiers):
            moot.append("offload")
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
    `build_pipeline_config`)."""
    kernel_ce, kernel_prologue = _kernel_flags(cfg)
    remat, remat_policy = _remat(cfg)
    offload_wgrad, offload_activations = _offload_flags(cfg)
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
        kernel_ce=kernel_ce, kernel_prologue=kernel_prologue,
        offload_wgrad=offload_wgrad, offload_activations=offload_activations,
        sequence_parallel=cfg.get("sequence_parallel", "ring"),
        packed=_packing_factor(cfg) > 1)


def _configure_faults(cfg: dict, ncfg: numerics.NumericsConfig, num_stages: int) -> None:
    """Install the run's fault plan: LPT_FAULT_PLAN when set (it wins over
    the config, as in the JAX trainer), else `fault_plan`, else none. A plan
    is the pod's: its rules at the sites this trainer does not fire
    (`device_probe`, `action_execute`, `gateway_dispatch`: the supervisor,
    the actuators and the gateway fire them from the same plan) are taken
    and named once in the log; a
    `grad_nonfinite` rule is refused, as the JAX trainer refuses it, with
    numerics off (the guard would be unarmed) or at a stage outside
    [0, `num_stages`) (the drill would poison nothing)."""
    if os.environ.get(faults.ENV_PLAN):
        source, injector = f"${faults.ENV_PLAN}", faults.configure_from_env()
    else:
        source, injector = "fault_plan", faults.configure(cfg.get("fault_plan"))
    rules = {(rule["site"], rule["op"]) for rule in injector.stats()} if injector else set()
    other = sorted({site for site, _ in rules} - set(FAULT_SITES))
    if other:
        logger.info("%s has rules at site(s) %s, which this trainer does not fire (the "
                    "supervisor, the actuators or the gateway do)", source, other)
    if faults.has_rule("step", "grad_nonfinite"):
        bad = [st for st in faults.rule_field_values("step", "grad_nonfinite", "stage")
               if not 0 <= st < num_stages]
        problem = None
        if not ncfg.enabled:
            problem = ("fault plan contains a grad_nonfinite rule but numerics.enabled is "
                       "false — the nonfinite guard would be unarmed; enable numerics or "
                       "drop the rule")
        elif bad:
            problem = (f"grad_nonfinite rule stage(s) {bad} out of range for "
                       f"num_stages={num_stages}")
        if problem:
            faults.configure(None)
            raise ValueError(problem)


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
    partition; checkpoints hold the canonical tree either way. Under
    `optimizer_offload`, `host` is the host AdamW (also `state.optimizer`),
    `state.params` its working copy and `grads` the fp32 gradient buffers
    beside it (both named as the params), and `offload_static` the metrics
    line's host-stash keys. `mesh` is the layout as this process sees it
    (its stages, its dp replica and the process groups)."""

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
    host: HostOffloadAdamW | None = None
    grads: dict[str, torch.Tensor] | None = None
    offload_static: dict = dataclasses.field(default_factory=dict)
    mesh: Mesh = dataclasses.field(default_factory=lambda: Mesh(MeshConfig(), (0,)))
    numerics: numerics.NumericsConfig = dataclasses.field(
        default_factory=numerics.NumericsConfig)

    def sharded_state(self) -> gather.ShardedState:
        """The params and the optimizer's state as this process holds them
        (its stages' chunks and tp slices; its ZeRO-1 slices of the moments,
        or the host optimizer's masters and moments, whole or in ZeRO-2
        slices), for CheckpointManager.save: process 0 writes the canonical
        tree from every process's pieces, one leaf at a time
        (ckpt/gather.py)."""
        mesh = self.mesh
        shapes = {name: torch.empty(shape, device="meta")
                  for name, shape in param_shapes(self.model_cfg).items()}
        if self.host is not None:
            host = self.host
            local = {"params": host.masters_tree(), "m": host.moments_tree("m"),
                     "v": host.moments_tree("v")}
            dims = None if host.dims is None else dict.fromkeys(local, host.dims)
            count = host.step_count
        else:
            opt = self.state.optimizer
            local = {"params": self.state.params, "mu": opt.mu, "nu": opt.nu}
            split = getattr(opt, "dims", None)  # Zero1AdamW's
            dims = None if split is None else {"mu": split, "nu": split}
            count = opt.count
        return gather.ShardedState.of_run(
            local, dims, count, self.manifest,
            pl.chunk_views(shapes, self.manifest, tp_rank=0, tp=mesh.tp),
            pipelined=self.pipeline is not None, dp=mesh.dp, rank=mesh.rank,
            rank_of=mesh.rank_of, group=distributed.commit_group(), tp=mesh.tp,
            offload=self.host is not None)

    def canonical_of(self, tree: dict[str, torch.Tensor]) -> Any:
        """A tree named as the run's params, held whole by this process (one
        process, tp = 1), in the canonical naming and layout: itself at pp =
        1, else each leaf merged from the chunks when it is written
        (tensor_io.Lazy: one leaf in memory at a time)."""
        if self.pipeline is None:
            return tree
        chunks = pl.chunks_like(self.pipeline.stage_params.chunks, tree)
        return {name: tensor_io.Lazy(shape, tree[next(iter(tree))].dtype, functools.partial(
                    pl.canonical_leaf, chunks, self.manifest, name))
                for name, shape in param_shapes(self.model_cfg).items()}

    def canonical_copy(self, part: Any = None) -> Any:
        """The `copy` of CheckpointManager.load_params for targets named as
        the run's params: of each canonical leaf this process's rows (at pp >
        1), its tp slice and, with `part(name, tensor)`, an optimizer's dp
        slice of that; None where that is the leaf itself (pp = tp = 1, no
        part)."""
        if self.pipeline is not None:
            sp = self.pipeline.stage_params

            def copy(targets, source, what):
                sp.copy_canonical({name: source[name] for name in source.keys()},
                                  flat=targets, what=what, part=part)

            return copy
        if self.mesh.tp == 1 and part is None:
            return None
        tp_rank, tp = self.mesh.tp_rank, self.mesh.tp

        def cut(name, t):
            t = tp_shard(name, t, tp_rank, tp)
            return t if part is None else part(name, t)

        def copy(targets, source, what):
            # views: a file's tensor is read only where its slice is copied
            copy_tensors(targets, {name: cut(name, source[name]) for name in source.keys()},
                         what)

        return copy

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
        drops and, when the quarantine is armed, the records it skipped;
        under the host optimizer its last step's phases (ms) and the
        host-stash keys."""
        out = dict(self.offload_static)
        if self.host is not None:
            out.update({k: round(v, 2) for k, v in self.host.last_timings.items()})
        collator = self.loader.collate_fn
        if isinstance(collator, PackedCausalLMCollator):
            out["packing_dropped_total"] = collator.dropped_total
            out["packing_drop_rate"] = round(collator.drop_rate(), 4)
        if self.loader.quarantine_bad_records:
            out["data_quarantined_records"] = self.loader.quarantine_count
        return out

    def step(self, batch: dict[str, torch.Tensor], fault: str | None = None) -> dict:
        """One step on a batch of this replica's rows (this process's
        column slab of them under sp). With numerics on (the default) the
        metrics carry the step's stats (`numerics`) and the nonfinite guard
        is armed; `fault` is the step site's verdict (a `grad_nonfinite`
        one poisons its stage's gradients)."""
        metrics = train_step(self.state, sp_slab(batch, self.mesh), self.model_cfg,
                             num_microbatches=self.num_microbatches, attn_fn=self.attn_fn,
                             remat=self.remat, head=self.head,
                             kernel_prologue=self.kernel_prologue,
                             remat_policy=self.remat_policy, pipeline=self.pipeline,
                             grads=self.grads, dp_group=self.mesh.dp_group,
                             tp_group=self.mesh.tp_group, sp_group=self.mesh.sp_group,
                             collect_stats=self.numerics.enabled,
                             poison_stage=numerics.fault_stage(fault), mesh=self.mesh,
                             manifest=self.manifest)
        if self.host is not None:  # the norm the host clipped by
            metrics["grad_norm"] = self.host.last_grad_norm
        return metrics

    def eval_sum_count(self, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss sum, valid count) of one eval batch on the training step's
        attention, head and prologue, without an autograd graph."""
        return eval_step(self.state.params, sp_slab(batch, self.mesh), self.model_cfg,
                         num_microbatches=self.num_microbatches, attn_fn=self.attn_fn,
                         head=self.head, kernel_prologue=self.kernel_prologue,
                         pipeline=self.pipeline, dp_group=self.mesh.dp_group,
                         tp_group=self.mesh.tp_group, sp_group=self.mesh.sp_group)

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
        save, and a daemon commit thread would die with it). The host
        optimizer's state is saved blocking whatever `async_save` says: the
        next step updates its masters in place. Every process of a run of
        several must call it: process 0 writes the state from every
        process's pieces (sharded_state)."""
        cfg = self.cfg
        batch_delta = (self.data_start[0] * max(len(self.loader), 1)
                       + self.data_start[1] - self.start_step)
        extra_meta = {"topology": self.topology,
                      "data_state": _data_state(step, self.loader, len(self.loader.dataset),
                                                cfg.get("seed", 42), batch_delta),
                      **_eval_meta(self.last_eval)}
        return self.ckpt.save(
            step, self.sharded_state(), self.manifest, self.model_cfg,
            blocking=final or not cfg.get("async_save", False) or self.host is not None,
            on_complete=lambda path: _sync_checkpoint(cfg, path),
            keep_last=cfg.get("save_total_limit"), extra_meta=extra_meta)


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
    ncfg = numerics.NumericsConfig.from_cfg(cfg.get("numerics"))
    _configure_faults(cfg, ncfg, _mesh_config(cfg).pp)
    # the span stream from here on: until the step loop starts is `init`
    trace.configure(cfg["output_dir"], write=distributed.process_index() == 0)
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
    mesh_cfg = _mesh_config(cfg)
    mesh = make_mesh(mesh_cfg)  # refuses a process count the layout cannot run
    data_node = cfg.get("data") or {}
    ledger = None
    if data_node.get("log_sample_ids") and distributed.process_index() == 0:
        # process 0 writes it; each row names the whole global batch
        os.makedirs(cfg["output_dir"], exist_ok=True)
        ledger = os.path.join(cfg["output_dir"], "samples.jsonl")
    # with packing the loader feeds packing_factor examples per emitted row,
    # and the data position (data_state) counts examples; each process loads
    # its replica's rows (host_dp_shard)
    loader = DataLoader(dataset, collator,
                        per_replica_batch=micro_batch * num_microbatches * packing,
                        dp_size=mesh_cfg.dp, seed=seed, dp_range=host_dp_shard(mesh),
                        quarantine_bad_records=bool(data_node.get("quarantine_bad_shards", False)),
                        sample_ledger=ledger)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise ValueError(f"dataset of {len(dataset)} examples yields 0 steps at "
                         f"batch {loader.per_replica_batch} a replica x dp {mesh_cfg.dp}")
    eval_loader = _eval_loader(cfg, model_cfg, tokenizer, num_microbatches, mesh)

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

    seq_length = int(collator([dataset[0]])["input_ids"].shape[1])
    if seq_length % mesh_cfg.sp:
        raise ValueError(f"sequence length {seq_length} must divide into "
                         f"sp={mesh_cfg.sp} equal slabs")
    sequence_parallel = cfg.get("sequence_parallel", "ring")
    attn_fn = select_attention(cfg.get("attention", "auto"), seq_length, device,
                               model_cfg=model_cfg, micro_batch=micro_batch,
                               packed=packing > 1, sp=mesh_cfg.sp,
                               sequence_parallel=sequence_parallel)
    pipeline = pcfg = None
    if mesh_cfg.pp == 1:
        # the canonical layout is the one-stage manifest's
        manifest = StageManifest(num_layers=model_cfg.num_hidden_layers, num_stages=1)
    else:
        manifest = build_manifest(cfg, model_cfg, mesh_cfg.pp)
        pcfg = build_pipeline_config(cfg, mesh_cfg, manifest)
    # what this process holds, drawn leaf by leaf: its stages' chunks (all of
    # them at pp = 1: the canonical tree, in its order) and its tp slices
    chunks = init_params_sharded(model_cfg, seed, manifest, mesh.stages, tp_rank=mesh.tp_rank,
                                 tp=mesh.tp, device=device)
    if pcfg is None:
        init = {name: chunks[0][0][name] for name in param_shapes(model_cfg)}
    else:
        init = pl.flatten_chunks(chunks)
    structure = {s: [dict.fromkeys(tree) for tree in trees] for s, trees in chunks.items()}
    del chunks
    stage_kw = dict(tp_rank=mesh.tp_rank, tp=mesh.tp)
    if cfg.get("optimizer_offload"):
        host, params, grads = _offload_state(cfg, ocfg, model_cfg, init, mesh, device,
                                             skip_nonfinite=ncfg.enabled)
        if pcfg is not None:
            stage_params = pl.StageParams(manifest, pl.chunks_like(structure, params),
                                          grads=pl.chunks_like(structure, grads), **stage_kw)
        optimizer = host
    else:
        host = grads = None
        if pcfg is None:
            params = LlamaForCausalLM(model_cfg, init).params()
        else:
            stage_params = pl.StageParams(manifest, pl.chunks_like(structure, init), **stage_kw)
            params = stage_params.flat()
        del init
        if mesh.dp > 1:
            optimizer = Zero1AdamW(params, ocfg, mesh.dp, mesh.replica, mesh.dp_group,
                                   tp=mesh.tp)
        else:
            optimizer = AdamW(params, ocfg)
    offload_static = {}
    if pcfg is not None:
        pipeline = pl.Pipeline(model_cfg, pcfg, mesh, stage_params, attn_fn)
        logger.info("pipeline %s: schedule %s, %d microbatches in %d flush(es), stages of %s "
                    "layers (virtual_stages %d), counted bubble %.4f", mesh_cfg.describe(),
                    pcfg.schedule, pcfg.num_microbatches, pcfg.accum_chunks,
                    list(manifest.stage_layer_counts), manifest.virtual_stages,
                    pl.bubble_fraction(pcfg))
        offload_static = _offload_static(pcfg, *pl.stash_dims(
            micro_batch, seq_length, mesh_cfg.sp, model_cfg.hidden_size, model_cfg.dtype))
    elif mesh.sp > 1:  # the pipeline wraps its own
        attn_fn = make_sp_attention(sequence_parallel, attn_fn, mesh.sp_group,
                                    packed=packing > 1)
    state = TrainState(step=0, params=params, optimizer=optimizer)
    topology = _topology_meta(cfg, manifest)
    mgr = CheckpointManager(cfg["output_dir"])
    run = Run(cfg=cfg, device=device, model_cfg=model_cfg, loader=loader, state=state,
              attn_fn=attn_fn, num_microbatches=num_microbatches, remat=remat, head=head,
              kernel_prologue=kernel_prologue, seq_length=seq_length, end_step=end_step,
              manifest=manifest, ckpt=mgr, topology=topology, remat_policy=remat_policy,
              eval_loader=eval_loader, pipeline=pipeline, host=host, grads=grads,
              offload_static=offload_static, mesh=mesh, numerics=ncfg)
    if cfg.get("resume", True):
        restored = _restore_with_fallback(
            mgr, lambda s: (_restore_offload if host is not None else _restore)(run, s))
    else:
        restored = None
    if restored is not None:
        run.start_step = state.step = restored
        logger.info("resumed full state from checkpoint-%d", run.start_step)
        _note_topology_change(mgr, run.start_step, topology)
        run.data_start = _resume_data_position(mgr, run.start_step, loader, len(dataset), seed)
        # every process has read the checkpoint before process 0 may replace
        # it (a final save of the step resumed at rewrites its directory)
        distributed.barrier(f"resumed-{run.start_step}")
    elif cfg.get("model_name_or_path"):
        _warm_start(cfg["model_name_or_path"], run)
    return run


def _offload_state(cfg: dict, ocfg: OptimizerConfig, model_cfg: LlamaConfig,
                   init: dict[str, torch.Tensor], mesh: Mesh, device: torch.device,
                   skip_nonfinite: bool = False) -> tuple:
    """The host optimizer's state from this process's fp32 init (the JAX
    trainer's `_run_offload` set-up; `init` is named as the run's params):
    its masters copied to host memory leaf by leaf (the init's fp32 on the
    card is then dropped), the working copy in the compute dtype on
    `device`, and fp32 gradient buffers beside it. At dp > 1 the replicas
    keep whole leaves, or under `optimizer_offload_zero2` their ZeRO-2
    slices (optim/offload.py), the same on every sp peer. The host-path norm
    counts each element once over the processes. Returns (host, working
    copy, gradient buffers)."""
    zero2 = bool(cfg.get("optimizer_offload_zero2"))
    if zero2 and mesh.dp == 1:
        logger.info("optimizer_offload_zero2 has no effect at dp=1; running the plain "
                    "offload layout")
        zero2 = False
    dims = (zero1_dims({name: tuple(t.shape) for name, t in init.items()}, mesh.dp, mesh.tp)
            if zero2 else None)
    ndims = {name: t.dim() for name, t in init.items()}

    def counts_in_norm(name: str) -> bool:
        """Whether this process adds leaf `name` to the host norm: its own
        dp slice, or a leaf whole over dp on replica 0; a leaf replicated
        over tp on tp rank 0; every leaf on sp rank 0 only (sp peers hold
        the same masters, moments and summed gradients)."""
        whole_over_dp = dims is None or dims[name] is None
        replicated_over_tp = tp_dim(name, ndims[name]) is None
        return ((not whole_over_dp or mesh.replica == 0)
                and (not replicated_over_tp or mesh.tp_rank == 0) and mesh.sp_rank == 0)

    several = distributed.process_count() > 1
    host = HostOffloadAdamW(ocfg, device_norm=cfg.get("offload_device_norm", True),
                            skip_nonfinite=skip_nonfinite,
                            reduce_norm_sq=_all_reduce_float if several else None,
                            counts_in_norm=counts_in_norm if several else None,
                            dims=dims, dp=mesh.dp, index=mesh.replica, group=mesh.dp_group)
    host.init(init)
    init.clear()  # the fp32 init leaves the card before the step's buffers arrive
    if device.type == "cuda":
        torch.cuda.empty_cache()
    working = host.device_params(model_cfg.dtype, device)
    grads = {name: torch.zeros(w.shape, dtype=torch.float32, device=device)
             for name, w in working.items()}
    return host, working, grads


def _all_reduce_float(x: float) -> float:
    """`x` summed over every process (the host norm's square), over the
    host group."""
    return float(distributed.all_reduce(torch.tensor(x, dtype=torch.float64),
                                        distributed.host_group()))


def _restore(run: Run, step: int) -> int:
    """Full-state restore of checkpoint-`step` into the run, in every
    process: the rows of its stages of the canonical tree (at pp > 1) and its
    tp slices and, under ZeRO-1, its slices of the moments; returns the
    step."""
    optimizer = run.state.optimizer
    if run.pipeline is not None:
        optimizer = pl.CanonicalOptimizer(optimizer, run.pipeline.stage_params)
    elif run.mesh.tp > 1:
        optimizer = _TpSliceOptimizer(optimizer, run.mesh.tp_rank, run.mesh.tp)
    return run.ckpt.load(step, run.state.params, optimizer, copy=run.canonical_copy())[2]


@dataclasses.dataclass
class _TpSliceOptimizer:
    """An optimizer of one tp rank's slices (pp = 1) loaded from canonical
    moments: `load_state_dict` hands it this rank's slice of each."""

    optimizer: Any
    tp_rank: int
    tp: int

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict({"count": state["count"], **{
            moment: {name: tp_shard(name, t, self.tp_rank, self.tp)
                     for name, t in state[moment].items()} for moment in ("mu", "nu")}})


def _restore_offload(run: Run, step: int) -> int:
    """Full-state restore of an `offload_parts` checkpoint-`step` into the
    host optimizer (masters, moments, step count), then its working copy;
    returns the step. A checkpoint without optimizer state or of the fused
    layout is refused, naming the way to continue its weights."""
    meta = run.ckpt.load_meta(step)
    if not meta.get("has_optimizer_state"):
        raise ValueError(f"checkpoint-{step} has no optimizer state (module-only / converter "
                         f"output); point model_name_or_path at it instead")
    layout = meta.get("opt_layout")
    if layout != OFFLOAD_LAYOUT:
        writer = ("the on-device optimizer (opt.safetensors)" if layout is None
                  else f"an unknown optimizer layout {layout!r}")
        raise ValueError(
            f"checkpoint-{step}'s optimizer state was written by {writer}, not the offload "
            f"layout ({OFFLOAD_LAYOUT}). To continue those weights under the offloaded "
            f"optimizer, point model_name_or_path at this checkpoint and use a fresh "
            f"output_dir (module-only warm start; optimizer moments restart)")
    host, copy = run.host, run.canonical_copy(part=run.host.part)
    run.ckpt.load_params(step, host.masters_tree(), copy=copy)  # verifies every file
    host.step_count = run.ckpt.load_offload_moments(step, host.moments_tree("m"),
                                                    host.moments_tree("v"), verify=False,
                                                    copy=copy)
    host.device_params(out=run.state.params)
    return int(meta["step"])


def _eval_loader(cfg: dict, model_cfg: LlamaConfig, tokenizer: Any,
                 num_microbatches: int, mesh: Mesh) -> DataLoader | None:
    """The held-out set of `eval_dataset` (None without one), as the JAX
    trainer's `_make_evaluator` builds it: the training config's tokenizer
    and collator over that dataset node, in dataset order, a batch of
    `num_microbatches` microbatches of `per_device_eval_batch_size` rows
    (default: the training micro-batch), times `packing_factor` examples,
    for each dp replica (this process loads its own). Refused when the set
    holds no whole batch."""
    eval_cfg = cfg.get("eval_dataset")
    if eval_cfg is None:
        return None
    dataset, collator = build_dataset_and_collator({**cfg, "dataset": eval_cfg}, model_cfg,
                                                   tokenizer)
    rows = cfg.get("per_device_eval_batch_size", cfg.get("per_device_train_batch_size", 1))
    loader = DataLoader(dataset, collator,
                        per_replica_batch=rows * num_microbatches * _packing_factor(cfg),
                        dp_size=mesh.dp, dp_range=host_dp_shard(mesh), shuffle=False)
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
    if run.host is not None:
        warm.load_params(step, run.host.masters_tree(),
                         copy=run.canonical_copy(part=run.host.part))
        run.host.device_params(out=run.state.params)
    else:
        warm.load_params(step, run.state.params, copy=run.canonical_copy())
    logger.info("warm-started module weights from %s (checkpoint-%d)", path, step)


def _topology_meta(cfg: dict, manifest: StageManifest) -> dict:
    """The run's topology as meta.json records it (the JAX trainer's
    `_topology_meta`): the source half of the elastic-restore contract, read
    by a later run to log what changed. `layer_counts` names the partition:
    "even/<k>" or the per-stage list."""
    mesh = _mesh_config(cfg)
    mc = MeshConfig(pp=manifest.num_stages, dp=mesh.dp, tp=mesh.tp, sp=mesh.sp)
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
    `tokenizer` as in build_run. Installs the preemption handlers first (in
    every process of a run of several: the stop vote carries one process's
    signal to all); the run's fault plan is cleared, its span stream closed
    and the handlers restored at the end."""
    _install_preemption_handlers()
    try:
        return train_run(build_run(cfg, device, tokenizer))
    finally:
        trace.configure(None)  # close this run's spans.jsonl writer
        faults.configure(None)
        _release_preemption_handlers()


@dataclasses.dataclass
class _Observatory:
    """The run's observability pieces (the JAX trainer's
    `_make_observatory` and monitor): the numerics monitor (on by default),
    the schedule timeline (`timeline.*`), the triggered profiler (process 0;
    without a `profiler:` block it arms only the capture-trigger file) and
    the memory watch (`memory.*`)."""

    monitor: numerics.NumericsMonitor | None
    timeline: timeline_mod.StepTimeline | None
    profiler: profiler_mod.TriggeredProfiler | None
    memory: memwatch.MemoryWatch | None

    @classmethod
    def of(cls, run: Run) -> "_Observatory":
        cfg, out = run.cfg, run.cfg["output_dir"]
        first = distributed.process_index() == 0
        several = distributed.process_count() > 1
        monitor = (numerics.NumericsMonitor(out, run.numerics, write=first,
                                            recorder=trace.recorder())
                   if run.numerics.enabled else None)
        tcfg = timeline_mod.TimelineConfig.from_cfg(cfg.get("timeline"))
        step_tl = None
        if tcfg.enabled:
            # at pp = 1 the plan is one stage's (its analytic bubble, 0)
            pcfg = (pl.PipelineConfig(num_stages=1, num_microbatches=run.num_microbatches)
                    if run.pipeline is None else run.pipeline.pcfg)
            step_tl = timeline_mod.StepTimeline(
                pcfg, out, write=first,
                window=tcfg.window, device=run.device,
                group=distributed.host_group() if several else None)
            if run.pipeline is not None:
                run.pipeline.timeline_marks = step_tl.segmented
            logger.info("timeline enabled: segment boundary marks on the card, every step "
                        "synchronised (timeline.jsonl)")
        pcap = profiler_mod.CaptureConfig.from_cfg(cfg.get("profiler"))
        if pcap is None:
            pcap = profiler_mod.CaptureConfig(zscore=0.0, on_anomaly=False)
        prof = profiler_mod.TriggeredProfiler(pcap, out) if first else None
        mcfg = memwatch.MemoryConfig.from_cfg(cfg.get("memory"))
        mem = None
        if mcfg.enabled:
            # the host stash's resident bytes by its byte model (the rings
            # fill during the first step)
            stash = 0 if run.pipeline is None else pl.host_stash_bytes(
                run.pipeline.pcfg, *pl.stash_dims(
                    cfg.get("per_device_train_batch_size", 1), run.seq_length, run.mesh.sp,
                    run.model_cfg.hidden_size, run.model_cfg.dtype))
            mem = memwatch.MemoryWatch(out, every=mcfg.every, top_buffers=mcfg.top_buffers,
                                       write=first, stash_bytes=stash or None)
            logger.info("memory watch enabled: first step's measured peak, live sampler "
                        "every %d step(s) (memory.jsonl)", mcfg.every)
        return cls(monitor, step_tl, prof, mem)

    def health_extra(self) -> Any:
        """The live health.json contributions (the monitor's counters, the
        timeline's rolling fields), or None."""
        live = [m.health_fields for m in (self.monitor, self.timeline) if m is not None]
        return collections.ChainMap(*live) if live else None

    def scalars(self) -> dict:
        out = {}
        for part in (self.monitor, self.timeline):
            if part is not None:
                out.update(part.scalars())
        return out

    def close(self) -> None:
        if self.profiler is not None:
            trace.recorder().remove_listener(self.profiler.on_span)
            self.profiler.close()  # a capture window open at exit is finalized
        for part in (self.timeline, self.memory, self.monitor):
            if part is not None:
                part.close()


def _health_static(run: Run) -> dict:
    """The static health.json payload (the JAX trainer's
    `_schedule_health_static`): the topology, the zb1 W-queue depth, the
    host-stash keys."""
    out = {"topology": run.topology, **run.offload_static}
    depth = _schedule_scalars(run).get("wgrad_queue_depth")
    if depth:
        out["wgrad_queue_depth"] = depth
    return out


def _schedule_scalars(run: Run) -> dict:
    """The schedule's run constants on every metrics line (the JAX
    trainer's `_schedule_static_scalars`): its name, its counted bubble and,
    under zb1, the W queue's peak depth."""
    pcfg = None if run.pipeline is None else run.pipeline.pcfg
    out = {"schedule": run.cfg.get("pipeline_schedule", "1f1b"),
           "bubble_fraction": 0.0 if pcfg is None else round(pl.bubble_fraction(pcfg), 4)}
    if pcfg is not None and pl.wgrad_queue_peak(pcfg):
        out["wgrad_queue_depth"] = pl.wgrad_queue_peak(pcfg)
    return out


def _kernel_launches() -> dict:
    """Launches of the nine CUDA kernels in this process so far (each
    wrapper's count; nothing counts on the CPU, where the plain versions run)."""
    return {**fa_mod.launch_counts, **fc_mod.launch_counts, **fp_mod.launch_counts}


def _write_perf_rows(run: Run, obs: _Observatory, launches: dict) -> None:
    """Close the run into the perf ledger (utils/perf.py), process 0: the
    analytic bubble next to its timeline-measured counterpart, the step-time
    percentiles and the card's peak, the memory watch's rows, and one
    `kernel_launches` row for each kernel this process launched in the loop
    (`launches`), so a run driven from outside (a supervised launch) shows
    which kernels it went through."""
    step_tl, mem = obs.timeline, obs.memory
    if (step_tl is None and mem is None and not launches) or distributed.process_index() != 0:
        return
    out = run.cfg["output_dir"]
    rows = [perf.make_row("kernel_launches", measured=n, unit="launches", source="train",
                          run=out, kernel=name) for name, n in launches.items()]
    if step_tl is not None:
        pcfg = None if run.pipeline is None else run.pipeline.pcfg
        rows.append(perf.make_row(
            "bubble_fraction", model=0.0 if pcfg is None else pl.bubble_fraction(pcfg),
            measured=step_tl.measured_bubble_median(), source="train", run=out,
            schedule=run.cfg.get("pipeline_schedule", "1f1b"),
            virtual_stages=run.manifest.virtual_stages))
        sc = step_tl.scalars()
        if "step_time_p50" in sc:
            rows.append(perf.make_row(
                "step_time_s", measured=sc["step_time_p50"], unit="s",
                source="train", run=out, p95=sc.get("step_time_p95")))
        peak_bytes, src = trace.device_peak_bytes()
        if peak_bytes is not None and src == "device":
            rows.append(perf.make_row(
                "peak_gib", measured=peak_bytes / (1 << 30), unit="GiB",
                source="train", run=out))
    if mem is not None:
        rows.extend(mem.perf_rows(run=out))
    perf.append_rows(os.path.join(out, "perf.jsonl"), rows)


def _profile_window(cfg: dict, start: int, end: int) -> tuple[int, int] | None:
    """`profile_steps: [lo, hi]` clamped into [start, end), or None."""
    window = cfg.get("profile_steps")
    if not window:
        return None
    lo, hi = max(int(window[0]), start), min(int(window[1]), end)
    if lo >= hi:
        logger.info("profile_steps %s empty after clamping to [%d, %d); skipping trace",
                    list(window), start, end)
        return None
    return lo, hi


def train_run(run: Run) -> dict:
    """Steps `run.start_step` .. `run.end_step` (the JAX trainer's
    `_train_loop`). Each step fires the `step` fault site (a `grad_nonfinite`
    verdict poisons its stage's gradients; an `oom` one raises the
    allocation-failure error), then stops the run on a preemption signal: a
    blocking save at that step (or, when the step's periodic save was just
    written, its commit joined), and the summary's `preempted_at` and
    `final_step` name it. One process reads its flag every step; several
    vote (distributed.should_stop) at every step that `preempt_check_every`
    divides, the same steps in every process, so a signal to any one stops
    all of them at the same step. Every `logging_steps` the metrics line:
    the window's mean loss, tokens/s over its wall time (data wait, eval and
    saves included; `real_tokens_per_sec` over the non-pad positions where
    they differ), and `step_time`, that wall less the first step (the
    kernels' build and warm-up), eval and checkpoint seconds, per step, with
    `goodput`, the numerics counters and the timeline's fields. Every
    `eval_steps` with an eval set, `eval_loss`, before a save at the same
    step. Saves every `save_steps` and, under `save_final` (true by
    default), at the end unless the last step was just saved. The summary's
    `step_times` and `losses` are per step, device-synchronised; the trained
    state stays in `run.state`.

    Observability (utils/trace.py and the observatories): the spans
    `init` (retroactive, from build_run), `data_wait`, `compile_block` (the
    first step, synchronised), `step_dispatch`, `device_step` (the step's
    synchronisation and loss read) and `eval`; the RunClock with the resumed
    run's prior from health.json, the Heartbeat (process 0) every
    `health_interval` seconds; the numerics monitor (lag one step;
    `halt_on_nonfinite` -> a final checkpoint at the last completed step,
    then NonfiniteHaltError); the timeline, the memory watch, the triggered
    profiler and `profile_steps` (a torch.profiler window written to
    `<output_dir>/profile`); an allocation failure writes the OOM snapshot,
    triggers a capture and re-raises; `perf.jsonl` at close."""
    cfg, device = run.cfg, run.device
    output_dir = cfg["output_dir"]
    first = distributed.process_index() == 0
    logging_steps = cfg.get("logging_steps", 10)
    save_steps = cfg.get("save_steps", 0)
    eval_steps = cfg.get("eval_steps", 0) if run.eval_loader is not None else 0
    # The stop flag is read every step when the run is one process, as in the
    # JAX trainer when process_count() == 1; `preempt_check_every` paces the
    # cross-process stop vote, a collective, so it is taken at the same steps
    # in every process whatever its own flag says.
    process_count = distributed.process_count()
    check_every = max(int(cfg.get("preempt_check_every", 10)), 1)
    # actions.resize_on_request: the resize vote rides the same cadence and
    # the same collective; the config is the same in every process, so every
    # process makes the same calls
    resize_watch = TrainActions.from_cfg(cfg.get("actions")).resize_on_request

    def peak_bytes():
        return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    writer = (MetricsWriter(output_dir, config_snapshot=cfg,
                            use_wandb=cfg.get("use_wandb", False),
                            use_tensorboard=cfg.get("use_tensorboard", False))
              if first else NullMetricsWriter())
    # the meter counts every replica's rows; its MFU is against the cards the
    # processes hold (several may share one under LPT_DIST_BACKEND=gloo)
    cards = (min(process_count, torch.cuda.device_count()) if device.type == "cuda"
             else process_count)
    meter = Throughput(run.model_cfg, run.seq_length, n_chips=cards, device=device)

    # ---- run-health telemetry: everything since build_run configured the
    # span stream is the `init` bucket, recorded retroactively
    obs = _Observatory.of(run)
    rec = trace.recorder()
    if obs.profiler is not None:
        rec.add_listener(obs.profiler.on_span)
    rec.emit("init", rec.configured_at, time.time() - rec.configured_at)
    prior = trace.load_health(output_dir) if run.start_step else None
    init_secs = time.time() - rec.configured_at
    clock = trace.RunClock(prior=(prior or {}).get("clock"), already_elapsed=init_secs)
    clock.add("init", init_secs)
    rec.add_listener(clock.on_span)
    heartbeat = (trace.Heartbeat(output_dir, clock, interval=cfg.get("health_interval", 10.0),
                                 extra=obs.health_extra(), static=_health_static(run))
                 if first else None)
    dev_peak, dev_src = trace.device_peak_bytes()
    logger.info("device memory telemetry: %s (%s)",
                "unavailable" if dev_peak is None else f"{dev_peak} B peak", dev_src)
    profile_window = _profile_window(cfg, run.start_step, run.end_step)
    static = _schedule_scalars(run)
    trace_prof = None

    batches = run.batches()
    launches_at_start = _kernel_launches()
    losses, step_times, window = [], [], []
    tokens_per_step = 0
    last_saved = -1
    preempted_at = None
    completed = run.start_step  # steps whose update the live state reflects
    window_t0 = time.perf_counter()
    window_overhead = 0.0  # first-step, eval and checkpoint seconds: not step_time
    try:
        for step in range(run.start_step, run.end_step):
            iter_t0 = time.perf_counter()
            fault = faults.fire("step", step=step)
            if fault == "oom":
                raise memwatch.oom_error(step)
            check_now = process_count == 1 or step % check_every == 0
            # both votes are taken before they are combined: each is a
            # collective, so neither may be skipped because the other is true
            stop_vote = check_now and distributed.should_stop(bool(_STOP_SIGNALS))
            resize_vote = (resize_watch and check_now
                           and distributed.should_stop(_resize_requested(output_dir)))
            if stop_vote or resize_vote:
                logger.warning("%s; checkpointing at step %d and exiting for clean resume",
                               "resize request" if resize_vote else "preemption signal", step)
                preempted_at = step
                if last_saved == step:
                    # the boundary's periodic save holds this very state:
                    # wait for its commit instead of writing it again
                    run.ckpt.finalize()
                else:
                    run.save(step, final=True)  # joins an async save in flight first
                last_saved = run.end_step  # no save_final after it
                if resize_vote and first:
                    # ack only after the (blocking) save has committed: a
                    # request that outlives a crash mid-save is honoured by
                    # the relaunch
                    _ack_resize_request(output_dir)
                break
            if (profile_window and trace_prof is None
                    and profile_window[0] <= step < profile_window[1]):
                trace_prof = profiler_mod.start_profile(os.path.join(output_dir, "profile"))
            with trace.span("data_wait", step=step):
                batch = next(batches)
            tokens_per_step = batch["input_ids"].numel() * run.mesh.dp
            if obs.timeline is not None:
                obs.timeline.pre_step(step + 1)
            measure = (obs.memory is not None and device.type == "cuda"
                       and not obs.memory.compiled)
            if measure:  # the first step's measured peak
                sync()
                torch.cuda.reset_peak_memory_stats(device)
                at_start = torch.cuda.memory_allocated(device)
            t0 = time.perf_counter()
            try:
                if step == run.start_step:
                    # the kernels' build and first launches land in `compile`
                    with trace.span("compile_block", step=step) as sp:
                        metrics = _observed_step(run, obs, batch, step, fault)
                        sync()
                    window_overhead += sp["dur"]
                else:
                    with trace.span("step_dispatch", step=step):
                        metrics = _observed_step(run, obs, batch, step, fault)
            except numerics.NonfiniteHaltError:
                # raised after this step's update: the halt's save labels it
                completed = step + 1
                raise
            completed = step + 1
            with trace.span("device_step", step=step + 1, steps=1):
                sync()
                losses.append(float(metrics["loss"]))
            step_times.append(time.perf_counter() - t0)
            if measure:
                obs.memory.note_compiled("train_step" if run.host is None else "loss_and_grad",
                                         at_start, torch.cuda.max_memory_allocated(device))
            if obs.timeline is not None:
                if run.host is not None:  # the host update has no mark on the card
                    obs.timeline.add_host_segment(
                        "optimizer_host", sum(run.host.last_timings.values()) / 1e3)
                obs.timeline.post_step(step + 1, metrics["loss"])
            if obs.memory is not None:
                obs.memory.sample(step + 1)
            if obs.profiler is not None:
                # the first step stays out of the z-score baseline
                obs.profiler.observe_step(step + 1, None if step == run.start_step
                                          else time.perf_counter() - iter_t0)
            if heartbeat is not None:
                heartbeat.beat(step + 1)
            if trace_prof is not None and (step + 1 >= profile_window[1]
                                           or step + 1 == run.end_step):
                trace_prof.stop()
                trace_prof = None
                logger.info("profiler trace written to %s/profile", output_dir)
            window.append(losses[-1])
            mask = batch.get("attention_mask")
            meter.update(tokens_per_step,
                         None if mask is None else int((mask != 0).sum()) * run.mesh.dp)
            if (step + 1) % logging_steps == 0 or step + 1 == run.end_step:
                step_time = max(time.perf_counter() - window_t0 - window_overhead,
                                0.0) / len(window)
                window_t0 = time.perf_counter()
                window_overhead = 0.0
                writer.log(step + 1, {"loss": float(np.mean(window)), "lr": metrics["lr"],
                                      "grad_norm": float(metrics["grad_norm"]),
                                      **meter.read_and_reset(), **static,
                                      **obs.scalars(),
                                      "goodput": round(clock.goodput(), 4),
                                      "step_time": step_time,
                                      "device_peak_bytes": trace.device_peak_bytes()[0],
                                      **run.host_scalars()})
                if heartbeat is not None:
                    heartbeat.beat(step + 1, step_time)
                window.clear()
            if eval_steps and (step + 1) % eval_steps == 0:
                with trace.span("eval", step=step + 1) as sp:
                    eval_loss = run.evaluate()
                writer.log(step + 1, {"eval_loss": eval_loss})
                run.last_eval = {"step": step + 1, "loss": eval_loss}
                window_overhead += sp["dur"]
            if save_steps and (step + 1) % save_steps == 0:
                t_save = time.perf_counter()
                run.save(step + 1)
                last_saved = step + 1
                window_overhead += time.perf_counter() - t_save
        if obs.monitor is not None:
            # the last step's verdict (a halt included) before the final save
            obs.monitor.flush()
    except numerics.NonfiniteHaltError as e:
        # the nonfinite update was skipped, so the live state is finite: save
        # it under `completed` (the halt surfaces a step after the nonfinite
        # one), then exit nonzero
        logger.error("halting on nonfinite gradients at step %d; writing a final checkpoint "
                     "at step %d before exiting nonzero", e.step, completed)
        _finalize_quietly(run)
        run.save(completed, final=True)
        raise
    except BaseException as e:
        if isinstance(e, Exception) and memwatch.is_resource_exhausted(e):
            # write the bounded snapshot first, then re-raise; no final save:
            # after an allocation failure the card's state is not trusted
            logger.error("allocation failure at step %d; writing OOM snapshot to %s before "
                         "exiting", completed, memwatch.oom_dir(output_dir))
            memwatch.dump_oom_snapshot(output_dir, completed, e, memwatch=obs.memory)
            if obs.profiler is not None:
                obs.profiler.trigger("oom", completed)
        _finalize_quietly(run)
        raise
    finally:
        if trace_prof is not None:  # preemption break / exception inside the window
            trace_prof.stop()
            logger.info("profiler trace (early exit) written to %s/profile", output_dir)
        obs.close()
        run.loader.close_ledger()
        writer.close()
        if heartbeat is not None:
            heartbeat.stop()
        _release_preemption_handlers()
    if cfg.get("save_final", True) and last_saved != run.end_step:
        run.save(run.end_step, final=True)
        if heartbeat is not None:  # fold the final save into health.json
            heartbeat.write()
    run.ckpt.finalize()  # surface any async-commit failure on the clean path
    launches = {name: n - launches_at_start[name]
                for name, n in _kernel_launches().items() if n > launches_at_start[name]}
    _write_perf_rows(run, obs, launches)
    return {"final_step": run.end_step if preempted_at is None else preempted_at,
            "start_step": run.start_step, "preempted_at": preempted_at,
            "final_loss": losses[-1] if losses else float("nan"),
            "steps_per_epoch": len(run.loader), "output_dir": cfg["output_dir"],
            "losses": losses, "step_times": step_times,
            "tokens_per_step": tokens_per_step, "peak_memory_bytes": peak_bytes()}


def _resize_requested(output_dir: str) -> bool:
    """Whether an actuator's `resize.request` (utils/actions) is in the run's
    output directory: the supervisor asking this run to move to another
    layout rung at a step boundary instead of taking a SIGTERM mid-step."""
    return os.path.exists(os.path.join(output_dir, RESIZE_REQUEST_NAME))


def _ack_resize_request(output_dir: str) -> None:
    """Rename `resize.request` -> `resize.request.ack` (atomic on POSIX): the
    actuator sees the request honoured exactly once; a crash before the
    rename leaves the request for the relaunched incarnation."""
    try:
        os.replace(os.path.join(output_dir, RESIZE_REQUEST_NAME),
                   os.path.join(output_dir, RESIZE_ACK_NAME))
    except OSError:
        pass  # never landed, or already acked


def _observed_step(run: Run, obs: _Observatory, batch: dict, step: int,
                   fault: str | None) -> dict:
    """run.step, then the numerics monitor's lag-1 observe (which may raise
    NonfiniteHaltError for the previous step)."""
    metrics = run.step(batch, fault)
    if obs.monitor is not None:
        obs.monitor.observe(step + 1, metrics["loss"], metrics["grad_norm"],
                            metrics.get("numerics"))
    return metrics


def _finalize_quietly(run: Run) -> None:
    """Join the in-flight commit, but never let ITS failure replace the
    training exception that actually killed the run."""
    try:
        run.ckpt.finalize()
    except Exception:
        logger.exception("async checkpoint commit also failed while unwinding a training "
                         "error")
