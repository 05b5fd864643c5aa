"""Preflight: the per-device byte model, schedule and layout selection, the
elastic ladder and resume compatibility, with the memory check measured on
the card.

The counterpart of the root tools/preflight.py, with its flags and report
keys. What it computes from a config, on any machine:

- the per-device byte model (`preflight`): the reference's terms (the
  stage's working params, gradient trees and optimizer state,
  `layout_device_gib`; the stage-input ring, the W stash and the loss head,
  `candidate_device_terms_gib`) plus the terms of this port's own step as
  rows of their own (`port_device_terms_gib`: the one fp32 gradient tree
  it keeps, the bf16 weight casts and activations autograd saves, the
  exact attention's probabilities, the host optimizer's fp32 embedding,
  the cuBLAS workspace), scaled by `--mem-scale` / `--calibration`;
- `--select`: the (schedule, virtual_stages, accum_chunks, offload, ce)
  candidates and the solver's sequences scored against the budget and the
  host link, `--emit-schedule` writing the winner's unit sequence for
  `pipeline_schedule: solver` + `schedule_file`;
- `--layout-devices` / `--emit-ladder`: the (pp, tp, dp, sp) frontier and
  the elastic ladder that tools/supervisor.py's `--layout-ladder` reads;
- `resume_compat`: what a resume from the config's output_dir would change;
- `--all`: every matching config's verdict, in this one process.

The verdict comes from the model, not a compile: PyTorch has no ahead-of-
time memory analysis of a step, and a trace on the meta device would
measure the eager twins (exact attention's L^2 scores), not the kernels'
working memory. So the model is held to the card instead: `--calibrate`
and `--memory-audit` run the trainer's own step (flash attention, the
prologue kernels and, at tp 1, the CE kernels) at one tp rank's shapes in
this one process, at one and two layers, read `torch.cuda.
max_memory_allocated` and `memory_stats`, and extrapolate affinely in
layers to the stage's depth; the ratio of that to the model is the
`mem_scale` the verdict takes. Both need a card and fail without one. The
reference's anchored-compile mode (a workaround for XLA-CPU's over-count
of buffers past 2^31 elements) has no counterpart: nothing here compiles.

The verdict holds allocated bytes. The CUDA context and what the caching
allocator reserves on top of what it hands out come out of the same
budget; `--calibrate` prints the reserved / allocated ratio it read at two
layers beside the verdict, so a config close to the budget is not shown
to fit by the model alone.

Defaults come from the card: `--hbm-gb` is its total memory (without a
card the flag is required), `--chip-flops` its dense bf16 peak
(utils/metrics.peak_flops), `--host-bw-gibps` the host link as
chip_smoke.py measures it, `--ici-bw-gibps` NVLink's data-sheet rate.

Usage:
  python -m llama_pipeline_parallel_tpu_torch.tools.preflight \
      --config conf/llama2_70b_pp4_tp4_dp2.yaml [--hbm-gb 79.2] [key=value ...]
  python -m llama_pipeline_parallel_tpu_torch.tools.preflight --all 'conf/*.yaml'
  python -m llama_pipeline_parallel_tpu_torch.tools.preflight \
      --config conf/llama_7b_pp4.yaml --select --emit-schedule /tmp/s.json
Exit code 1 when the estimate exceeds the budget.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import glob
import json
import os
import re
import sys

import numpy as np
import torch

from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
from llama_pipeline_parallel_tpu_torch.parallel import schedule as usched
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig
from llama_pipeline_parallel_tpu_torch.utils.metrics import peak_flops, train_flops_per_token

GIB = 1 << 30
# The host link: the slower direction of `host_stash.measure_transfer_bandwidth`
# (1 GiB of pinned memory, 3 copies each way), as chip_smoke.py's offload phase
# read it (its preflight phase prints each run's reading beside this default):
# 52.79 GB/s up, 54.77 GB/s down on an NVIDIA H100 80GB HBM3 at 700.00 W
HOST_BW_GIBPS = 49.17
# The card-to-card link: NVLink 4 on an H100 SXM, 450 GB/s each way (NVIDIA's
# H100 data sheet: 900 GB/s bidirectional). Never measured here: the card
# machine holds one H100, so every collective there is gloo over loopback.
ICI_BW_GIBPS = 419.1
# cuBLAS's workspace on sm_90 as torch allocates it (8 chunks of 4 MiB)
CUBLAS_WORKSPACE_BYTES = 32 << 20


# ---------------------------------------------------------------------------
# The byte model
# ---------------------------------------------------------------------------

def _peak(chip_flops: float | None) -> float:
    """The compute model's FLOP/s: the caller's, else the card's."""
    peak = chip_flops or (peak_flops(torch.device("cuda")) if torch.cuda.is_available()
                          else None)
    if not peak:
        raise SystemExit("the compute model needs the card's peak FLOP/s: pass "
                         "--chip-flops (no card here, or one not in "
                         "utils/metrics.GPU_PEAK_FLOPS)")
    return peak


def _step_compute_seconds(model_cfg, mesh_cfg, pcfg, mb_rows: int, seq: int,
                          mfu: float, chip_flops: float | None) -> float:
    """Modeled per-device compute seconds of one training step: the
    overlap budget the offload traffic must hide inside. Each device sees
    its dp shard's tokens through 1/(pp*tp*sp) of the model (PaLM
    accounting, utils/metrics.train_flops_per_token)."""
    tokens = mb_rows * pcfg.num_microbatches * seq
    shards = mesh_cfg.pp * mesh_cfg.tp * mesh_cfg.sp
    return train_flops_per_token(model_cfg, seq) * tokens / shards / (
        _peak(chip_flops) * max(mfu, 1e-6))


def offload_traffic_bytes(pcfg, dims: tuple) -> int:
    """Host-link bytes ONE STEP moves for the enabled offload knobs, both
    directions: the zb1 W queue moves 2 buffers per unit x Mv units x 2
    directions, the activation ring 1 buffer per unit x 2 directions. A
    mixed per-unit vector is charged the full per-flush unit count (the
    reference's rule: its interpreter moves every unit's buffers)."""
    mb_rows, local_seqlen, hidden_size, dtype_bytes = dims
    slot = mb_rows * local_seqlen * hidden_size * dtype_bytes
    units = pcfg.num_microbatches * pcfg.virtual_stages
    total = 0
    hbm_slots, host_slots = pl.wgrad_partition(pcfg)
    if host_slots:
        wgrad_units = (pl.wgrad_offloaded_units(pcfg) if hbm_slots == 0
                       else units // pcfg.accum_chunks)
        total += 4 * wgrad_units * pcfg.accum_chunks * slot
    if pcfg.offload_activations and pl.activation_ring_slots(pcfg):
        total += 2 * units * slot
    return total


def offload_feasibility(pcfg, dims: tuple, step_compute_s: float,
                        host_bw_gibps: float) -> dict:
    """The bandwidth half of the memory model: modeled transfer seconds over
    modeled compute seconds (`offload_hide_ratio`); above 1 the copies
    stall the step however they are scheduled."""
    traffic = offload_traffic_bytes(pcfg, dims)
    transfer_s = traffic / (host_bw_gibps * GIB)
    return {
        "offload_traffic_gib_per_step": round(traffic / GIB, 2),
        "offload_transfer_s_model": round(transfer_s, 3),
        "offload_compute_s_model": round(step_compute_s, 3),
        "offload_hide_ratio": round(transfer_s / max(step_compute_s, 1e-9), 3),
    }


def _stash_device_bytes(hbm_slots: int, host_slots: int, slot: int) -> int:
    """Device-resident bytes of a W queue's slot split: the full device-side
    buffers plus, when anything tiers to host, the in-flight transfer slots
    (2 per buffer direction, capped at 4 slot-equivalents)."""
    return 2 * hbm_slots * slot + (min(2 * host_slots * slot, 4 * slot)
                                   if host_slots else 0)


def candidate_device_terms_gib(pcfg, dims: tuple, vocab: int | None = None) -> dict:
    """The schedule-DEPENDENT device-memory terms of one candidate, GiB: the
    stage-input ring and (zb1 / solver) the W stash, each replaced by two
    in-flight transfer slots when its store tiers to host, plus, with
    `vocab`, the last stage's loss head (pl.loss_head_bytes). Everything
    else is schedule-independent at a fixed batch shape, which lets
    selection anchor on one base."""
    mb_rows, local_seqlen, hidden_size, dtype_bytes = dims
    slot = mb_rows * local_seqlen * hidden_size * dtype_bytes
    ring = pl.activation_ring_bytes(pcfg, *dims)
    ring_dev = min(ring, 2 * slot) if pcfg.offload_activations else ring
    hbm_slots, host_slots = pl.wgrad_partition(pcfg)
    stash_dev = _stash_device_bytes(hbm_slots, host_slots, slot)
    head = (pl.loss_head_bytes(pcfg, mb_rows, local_seqlen, hidden_size, vocab)
            if vocab else 0)
    return {"ring_gib": ring_dev / GIB, "stash_gib": stash_dev / GIB,
            "host_gib": pl.host_stash_bytes(pcfg, *dims) / GIB,
            "loss_head_gib": head / GIB}


def _dtype_bytes(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _stage_params(model_cfg, pp: int, tp: int, layer_counts: tuple | None) -> float:
    """Parameters the reference's layout model charges a device: one
    stage's (padded) layer slots at the tp shard width, the replicated
    embedding and final norm, the vocab-parallel lm-head."""
    d = model_cfg.hidden_size
    kv_dim = model_cfg.kv_heads * model_cfg.head_dim
    matmul = 2 * d * d + 2 * d * kv_dim + 3 * d * model_cfg.intermediate_size
    k_max = (max(layer_counts) if layer_counts
             else -(-model_cfg.num_hidden_layers // pp))
    stage = k_max * (matmul / tp + 2 * d)
    shared = model_cfg.vocab_size * d + model_cfg.vocab_size * d / tp + d
    return stage + shared


def layout_device_gib(model_cfg, pp: int, tp: int, dp: int,
                      layer_counts: tuple | None = None,
                      optimizer_offload: bool = True, zero2: bool = True) -> float:
    """Schedule-INDEPENDENT analytic device memory of a layout, GiB (the
    reference's model): the working params in the compute dtype, the fp32
    gradient trees its step holds (accumulator, per-tick and returned; the
    returned one dp-sharded under ZeRO-2) and, with the optimizer on the
    device, the fp32 masters and dp-sharded Adam moments."""
    n = _stage_params(model_cfg, pp, tp, layer_counts)
    weights = n * _dtype_bytes(model_cfg.dtype)
    if optimizer_offload:
        grads = n * 4 * (2 + (1.0 / dp if zero2 else 1.0))
        opt = 0.0
    else:
        grads = n * 4 * 2
        opt = n * 4 + n * 8 / dp
    return (weights + grads + opt) / GIB


def _attention_impl(cfg: dict) -> str:
    """The attention the model charges: `auto` counts as exact, the larger
    (the reference's conservative resolution; on a card auto may pick
    flash)."""
    impl = cfg.get("attention", "auto")
    return "exact" if impl == "auto" else impl


def port_device_terms_gib(cfg: dict, model_cfg, mesh_cfg, pcfg, dims: tuple, seq: int,
                          in_process: bool = False) -> dict:
    """The device bytes of this port's step that the reference's terms do
    not hold, GiB, one named row each:

    - `port_grad_trees`: the port accumulates one fp32 gradient tree in
      place (the masters' `.grad`, or the host optimizer's buffers), where
      the reference's model counts two (three under the host optimizer); a
      negative row;
    - `port_working_copy`: with the optimizer on the card the step reads the
      fp32 masters themselves and keeps no working copy in the compute dtype
      between steps (the reference's model counts one); a negative row;
    - `port_weight_casts`: the bf16 copies of fp32 masters that autograd
      keeps for the backward: every layer of the chunk a unit runs (one
      layer under remat) and the lm-head; none under the host optimizer
      (its working copy is already bf16);
    - `port_activations`: what autograd keeps of one microbatch (units run
      one at a time): per layer the input, q / k / v, the attention out and
      its fp32 lse, the residual, the MLP's normed input, gate, up, their
      product and silu, plus the composed prologue's normed input; under
      remat each layer's input and one layer's whole set;
    - `port_exact_scores`: the exact attention's fp32 softmax and its bf16
      copy, per kept layer (`attention: exact`, or `auto`);
    - `port_embed_fp32`: the host optimizer's fp32 upcast of the embedding
      (optim/offload.bind_fp32_grads);
    - `port_cublas_workspace`.

    `in_process`: every stage in this one process (pp in memory)."""
    mb_rows, s_loc, d, b = dims
    tokens = mb_rows * s_loc
    tp, dp = mesh_cfg.tp, mesh_cfg.dp
    hd = model_cfg.head_dim
    h_loc = model_cfg.num_attention_heads // tp
    q_loc = h_loc * hd
    kv_loc = model_cfg.kv_heads // tp * hd
    f_loc = model_cfg.intermediate_size // tp
    vocab_loc = model_cfg.vocab_size // tp
    offload = bool(cfg.get("optimizer_offload"))
    zero2 = bool(cfg.get("optimizer_offload_zero2"))
    pp_params = 1 if in_process else mesh_cfg.pp
    counts = None if in_process else pcfg.layer_counts
    n = _stage_params(model_cfg, pp_params, tp, counts)
    model_grads = n * 4 * ((2 + (1.0 / dp if zero2 else 1.0)) if offload else 2)
    k_stage = (max(pcfg.layer_counts) if pcfg.layer_counts
               else -(-model_cfg.num_hidden_layers // mesh_cfg.pp))
    k_unit = -(-k_stage // pcfg.virtual_stages) if mesh_cfg.pp > 1 else k_stage
    kept = 1 if pcfg.remat else k_unit
    per_layer = tokens * (b * (3 * d + 2 * q_loc + 2 * kv_loc + 4 * f_loc
                               + (0 if pcfg.kernel_prologue else d))
                          + 4 * (h_loc + 2))
    acts = (k_unit * tokens * d * b + per_layer) if pcfg.remat else k_unit * per_layer
    casts = 0.0
    if not offload and model_cfg.dtype != model_cfg.param_dtype:
        matmul_loc = d * q_loc + 2 * d * kv_loc + q_loc * d + 3 * d * f_loc
        casts = (kept * matmul_loc + d * vocab_loc) * b
    scores = 0.0
    if _attention_impl(cfg) == "exact" and mesh_cfg.sp == 1:
        scores = kept * mb_rows * h_loc * s_loc * seq * (4 + b)
    embed32 = model_cfg.vocab_size * d * 4 if offload else 0.0
    working = 0.0 if offload else -n * b
    return {"port_grad_trees_gib": (n * 4 - model_grads) / GIB,
            "port_working_copy_gib": working / GIB,
            "port_weight_casts_gib": casts / GIB,
            "port_activations_gib": acts / GIB,
            "port_exact_scores_gib": scores / GIB,
            "port_embed_fp32_gib": embed32 / GIB,
            "port_cublas_workspace_gib": CUBLAS_WORKSPACE_BYTES / GIB}


def _seq_length(cfg: dict) -> int:
    """The trainer's row length: the synthetic dataset's seq_length, else
    max_seq_length."""
    data_cfg = cfg.get("dataset") or {}
    if not data_cfg or data_cfg.get("synthetic"):
        return int(data_cfg.get("seq_length", cfg.get("max_seq_length", 512)))
    return int(cfg.get("max_seq_length", 512))


def _builders(cfg: dict):
    """(mesh_cfg, model_cfg, manifest, pcfg) from the trainer's own
    builders."""
    from llama_pipeline_parallel_tpu_torch.train import (
        _mesh_config,
        build_manifest,
        build_model_config,
        build_pipeline_config,
    )

    mesh_cfg = _mesh_config(cfg)
    model_cfg = build_model_config(cfg["model"])
    manifest = build_manifest(cfg, model_cfg, mesh_cfg.pp)
    return mesh_cfg, model_cfg, manifest, build_pipeline_config(cfg, mesh_cfg, manifest)


def device_rows_gib(cfg: dict, in_process: bool = False) -> dict:
    """Every named term of the byte model for `cfg`, GiB: the reference's
    (`params_grads_optimizer_gib`, `ring_gib`, `stash_gib`, `loss_head_gib`)
    then the port's. `in_process`: every stage in this one process (the
    params of all layers, each stage's ring and stash)."""
    mesh_cfg, model_cfg, _, pcfg = _builders(cfg)
    mb_rows = int(cfg.get("per_device_train_batch_size", 1))
    seq = _seq_length(cfg)
    dims = pl.stash_dims(mb_rows, seq, mesh_cfg.sp, model_cfg.hidden_size, model_cfg.dtype)
    stages = mesh_cfg.pp if in_process else 1
    terms = candidate_device_terms_gib(pcfg, dims)
    rows = {"params_grads_optimizer_gib": layout_device_gib(
                model_cfg, 1 if in_process else mesh_cfg.pp, mesh_cfg.tp, mesh_cfg.dp,
                layer_counts=None if in_process else pcfg.layer_counts,
                optimizer_offload=bool(cfg.get("optimizer_offload")),
                zero2=bool(cfg.get("optimizer_offload_zero2"))),
            "ring_gib": stages * terms["ring_gib"],
            "stash_gib": stages * terms["stash_gib"],
            "loss_head_gib": pl.loss_head_bytes(
                pcfg, *dims[:3], model_cfg.vocab_size // max(mesh_cfg.tp, 1)) / GIB}
    rows.update(port_device_terms_gib(cfg, model_cfg, mesh_cfg, pcfg, dims, seq,
                                      in_process=in_process))
    return rows


def preflight(cfg: dict, hbm_gb: float, host_bw_gibps: float = HOST_BW_GIBPS,
              mfu: float = 0.45, hide_max: float = 1.0,
              chip_flops: float | None = None, mem_scale: float = 1.0) -> dict:
    """The as-written verdict: the byte model's per-device bytes (device_rows_gib,
    times `mem_scale`) against `hbm_gb`, with the W-stash and host-link
    verdicts of the reference's report."""
    if cfg.get("optimizer_offload_zero2") and not cfg.get("optimizer_offload"):
        # the trainer's rejection: a preflight that passes a config the run
        # refuses defeats its purpose
        raise ValueError("optimizer_offload_zero2 requires optimizer_offload: true")
    mesh_cfg, model_cfg, _, pcfg = _builders(cfg)
    seq = _seq_length(cfg)
    mb_rows = int(cfg.get("per_device_train_batch_size", 1))
    dims = pl.stash_dims(mb_rows, seq, mesh_cfg.sp, model_cfg.hidden_size, model_cfg.dtype)
    rows = device_rows_gib(cfg)
    model_gib = sum(rows.values())
    peak_gib = model_gib * mem_scale
    n = _stage_params(model_cfg, mesh_cfg.pp, mesh_cfg.tp, pcfg.layer_counts)
    offload = bool(cfg.get("optimizer_offload"))
    state = n * _dtype_bytes(model_cfg.dtype) + (0 if offload else n * 4 + n * 8 / mesh_cfg.dp)
    grads = rows["params_grads_optimizer_gib"] * GIB - state + rows["port_grad_trees_gib"] * GIB
    state += rows["port_working_copy_gib"] * GIB
    report = {
        "compiled_path": "offload_loss_and_grad" if offload else "fused_train_step",
        "verdict_source": "byte model (no compile; held to the card by --calibrate)",
        "devices": mesh_cfg.pp * mesh_cfg.dp * mesh_cfg.tp * mesh_cfg.sp,
        "global_batch_rows": mb_rows * pcfg.num_microbatches * mesh_cfg.dp,
        "seq": seq,
        "schedule": pcfg.schedule,
        # the reference's four buffers, from the model: the state the step
        # reads, the gradients it returns, its working memory, no aliasing
        "arguments_gib": round(state / GIB, 2),
        "outputs_gib": round(grads / GIB, 2),
        "temp_gib": round(model_gib - (state + grads) / GIB, 2),
        "aliased_gib": 0.0,
        **{k: round(v, 2) + 0.0 for k, v in rows.items()},
        "model_peak_gib": round(model_gib, 2),
        "mem_scale": mem_scale,
        "per_device_peak_gib": round(peak_gib, 2),
        "hbm_budget_gib": hbm_gb,
        "fits": peak_gib <= hbm_gb,
    }
    kernels_on = [name for name, on in (("ce", pcfg.kernel_ce),
                                        ("prologue", pcfg.kernel_prologue)) if on]
    if kernels_on:
        report["kernels"] = "+".join(kernels_on)
    hbm_slots, host_slots = pl.wgrad_partition(pcfg)
    host_bytes = pl.host_stash_bytes(pcfg, *dims)
    if host_bytes:
        report["host_stash_gib"] = round(host_bytes / GIB, 2)
        wgrad_tier = "wgrad_stash"
        if pcfg.schedule == "solver" and host_slots and hbm_slots:
            wgrad_tier = (f"wgrad_stash[{pl.wgrad_offloaded_units(pcfg)}"
                          f"/{pcfg.unit_schedule.n_units}]")
        report["offload"] = "+".join(
            name for name, on in ((wgrad_tier, host_slots > 0),
                                  ("activations", pcfg.offload_activations)) if on)
    if pl.wgrad_queue_peak(pcfg):
        stash = pl.wgrad_stash_bytes(pcfg, *dims)
        slot_b = dims[0] * dims[1] * dims[2] * dims[3]
        stash_hbm = 2 * hbm_slots * slot_b
        report["wgrad_queue_depth"] = pl.wgrad_queue_peak(pcfg)
        report["wgrad_stash_gib"] = round(stash / GIB, 2)
        if host_slots and not hbm_slots:
            report["wgrad_stash_verdict"] = (
                "tiered to host memory (offload.wgrad_stash or an all-host sequence "
                "vector) — the card holds only the in-flight transfer slots")
        else:
            headroom = hbm_gb - (peak_gib - stash_hbm / GIB)
            if stash_hbm / GIB > max(headroom, 0.0):
                report["wgrad_stash_verdict"] = (
                    f"device-resident W-stash {round(stash_hbm / GIB, 2)} GiB exceeds the "
                    f"{round(max(headroom, 0.0), 2)} GiB headroom left by the rest of the "
                    f"step — {stash_remedies(pcfg)}")
            else:
                report["wgrad_stash_verdict"] = "fits within headroom"
    if pcfg.offload_activations or host_slots:
        feas = offload_feasibility(
            pcfg, dims, _step_compute_seconds(model_cfg, mesh_cfg, pcfg, mb_rows, seq, mfu,
                                              chip_flops), host_bw_gibps)
        report.update(feas)
        if feas["offload_hide_ratio"] > hide_max:
            report["fits"] = False
            report["offload_bw_verdict"] = (
                f"offload traffic cannot hide behind compute: modeled transfer time is "
                f"{feas['offload_hide_ratio']:.2f}x the step's compute at {host_bw_gibps} "
                f"GiB/s host bandwidth (--host-bw-gibps) and {mfu} MFU — raise "
                f"gradient_accumulation_chunks, shrink the stash, or drop the offload")
        else:
            report["offload_bw_verdict"] = "hides behind compute"
    if offload:
        # host side: fp32 masters + two fp32 Adam moments of every parameter
        from llama_pipeline_parallel_tpu_torch.utils.metrics import param_count

        report["host_dram_total_gib"] = round(param_count(model_cfg) * 12 / GIB, 1)
    return report


# ---------------------------------------------------------------------------
# Schedule selection
# ---------------------------------------------------------------------------

def enumerate_candidates(num_stages: int, microbatches: int, num_layers: int,
                         max_virtual: int = 4, accum_options: tuple = (1, 2, 4, 8),
                         ce_options: tuple | None = None,
                         layer_counts: tuple | None = None) -> list:
    """Every valid PipelineConfig of the selection grid: schedule x
    virtual_stages (layer-divisible) x accum_chunks (microbatch-divisible)
    x offload tiers x, with `ce_options`, the loss-head axis ((loss_chunks,
    kernel_ce) pairs). Validity is PipelineConfig's own. An uneven
    `layer_counts` is offered to flat 1f1b and zb1 at v 1 only."""
    uneven = layer_counts is not None and len(set(layer_counts)) != 1
    ce_axis = tuple(ce_options) if ce_options else ((1, False),)
    cands = []
    for schedule in ("1f1b", "interleaved_1f1b", "zb1"):
        if schedule == "1f1b":
            vs = (1,)
        elif uneven:
            vs = (1,) if schedule == "zb1" else ()
        else:
            vs = tuple(v for v in (1, 2, 4)
                       if v <= max_virtual and num_layers % (num_stages * v) == 0)
        for v in vs:
            for c in accum_options:
                offloads = [(False, False), (False, True)]
                if schedule == "zb1":
                    offloads += [(True, False), (True, True)]
                for ow, oa in offloads:
                    for ce_chunks, ce_kernel in ce_axis:
                        try:
                            cands.append(pl.PipelineConfig(
                                num_stages=num_stages, num_microbatches=microbatches,
                                schedule=schedule, virtual_stages=v, accum_chunks=c,
                                offload_wgrad=ow, offload_activations=oa,
                                loss_chunks=ce_chunks, kernel_ce=ce_kernel,
                                layer_counts=layer_counts))
                        except ValueError:
                            continue
    return cands


def solver_candidates(num_stages: int, microbatches: int, num_layers: int,
                      base_gib: float, dims: tuple, hbm_gb: float,
                      max_virtual: int = 4, accum_options: tuple = (1, 2, 4, 8),
                      head_gib: float = 0.0, mem_scale: float = 1.0) -> list:
    """Solver-emitted sequences as candidates: for each split-backward (v,
    accum, W placement) point the list scheduler emits a sequence, whose
    per-unit offload vector tiers the fewest units (earliest first) for base
    + ring + the device stash + `head_gib` (times `mem_scale`, as
    select_schedule scores it) to fit; a point that cannot fit is emitted
    fully tiered, for select_schedule to refuse."""
    mb_rows, local_seqlen, hidden_size, dtype_bytes = dims
    slot = mb_rows * local_seqlen * hidden_size * dtype_bytes
    cands = []
    vs = tuple(v for v in (1, 2, 4)
               if v <= max_virtual and num_layers % (num_stages * v) == 0)
    for v in vs:
        for c in accum_options:
            if microbatches % c:
                continue
            m_flush = microbatches // c
            if v > 1 and m_flush % num_stages:
                continue
            for placement in ("trailing", "drain"):
                try:
                    seq = usched.list_schedule(m_flush, num_stages, v, w_placement=placement)
                except usched.ScheduleError:
                    continue
                ring = seq.ring_slots * slot if bool(seq.has_f.any()) else 0

                def est(vector, seq=seq, ring=ring):
                    s = usched.with_offload(seq, vector)
                    stash = _stash_device_bytes(s.wq_hbm_slots, s.wq_host_slots, slot)
                    return (base_gib + (ring + stash) / GIB + head_gib) * mem_scale

                n = seq.n_units
                if est(np.zeros(n, bool)) <= hbm_gb:
                    k = 0
                else:
                    lo, hi = 1, n
                    while lo < hi:
                        mid = (lo + hi) // 2
                        vec = np.zeros(n, bool)
                        vec[:mid] = True
                        if est(vec) <= hbm_gb:
                            hi = mid
                        else:
                            lo = mid + 1
                    k = lo
                vec = np.zeros(n, bool)
                vec[:k] = True
                cands.append(pl.PipelineConfig(
                    num_stages=num_stages, num_microbatches=microbatches,
                    schedule="solver", virtual_stages=v, accum_chunks=c,
                    unit_schedule=usched.with_offload(seq, vec)))
    return cands


def select_schedule(candidates: list, base_gib: float, dims: tuple, hbm_gb: float,
                    host_bw_gibps: float, step_compute_fn, hide_max: float = 1.0,
                    vocab: int | None = None, mem_scale: float = 1.0) -> tuple:
    """Score every candidate against the budget and the host-link bound and
    pick the feasible one with the lowest counted bubble (ties: less host
    residency, then a lower peak). `base_gib`: the schedule-independent
    anchor (the as-written model minus its ring / stash / loss-head terms);
    `mem_scale` scales every estimate. Returns (winner_row_or_None,
    all_rows)."""
    rows = []
    for pcfg in candidates:
        terms = candidate_device_terms_gib(pcfg, dims, vocab)
        est = (base_gib + terms["ring_gib"] + terms["stash_gib"]
               + terms["loss_head_gib"]) * mem_scale
        feas = offload_feasibility(pcfg, dims, step_compute_fn(pcfg), host_bw_gibps)
        fits_hbm = est <= hbm_gb
        hides = feas["offload_hide_ratio"] <= hide_max
        row_extra = {}
        if pcfg.schedule == "solver":
            us = pcfg.unit_schedule
            row_extra = {"label": us.label, "wgrad_offload_units": us.offloaded_units,
                         "wgrad_units_total": us.n_units, "_pcfg": pcfg}
        rows.append({
            "schedule": pcfg.schedule, "virtual_stages": pcfg.virtual_stages,
            "accum_chunks": pcfg.accum_chunks,
            "offload_wgrad": pcfg.offload_wgrad,
            "offload_activations": pcfg.offload_activations,
            "loss_chunks": pcfg.loss_chunks,
            "kernel_ce": pcfg.kernel_ce,
            **row_extra,
            "est_peak_gib": round(est, 2) + 0.0,  # normalize -0.0
            "host_stash_gib": round(terms["host_gib"], 2) + 0.0,
            "loss_head_gib": round(terms["loss_head_gib"], 2) + 0.0,
            "bubble_fraction": round(pl.bubble_fraction(pcfg), 4),
            "hide_ratio": feas["offload_hide_ratio"],
            "feasible": fits_hbm and hides,
            "why_not": None if fits_hbm and hides else
                       ("exceeds HBM budget" if not fits_hbm else
                        "offload traffic cannot hide behind compute"),
        })
    feasible = [r for r in rows if r["feasible"]]
    winner = min(feasible, key=lambda r: (r["bubble_fraction"], r["host_stash_gib"],
                                          r["est_peak_gib"]), default=None)
    return winner, rows


def ce_axis_options(loss_chunks: int, vocab: int, tp: int) -> tuple | None:
    """The loss-head axis --select scores: the as-written chunking, an 8-way
    chunked head where the vocab divides, and one CE-kernel option at
    128-wide vocab tiles (V/128 chunks). None at tp > 1: the head is
    vocab-parallel there and the trainer refuses loss_chunks / kernels.ce."""
    if tp > 1:
        return None
    opts = {(loss_chunks, False)}
    if vocab % 8 == 0:
        opts.add((8, False))
    if vocab % 128 == 0:
        opts.add((vocab // 128, True))
    return tuple(sorted(opts))


# ---------------------------------------------------------------------------
# Layout selection
# ---------------------------------------------------------------------------

def _divisors(n: int) -> tuple:
    return tuple(d for d in range(1, n + 1) if n % d == 0)


def enumerate_layouts(devices: int, model_cfg, seq: int, global_batch_examples: int,
                      mb_rows: int, max_tp: int = 8, max_sp: int = 4) -> list[dict]:
    """Every (pp, tp, dp, sp) mesh of exactly `devices` cards the model and
    batch admit, each with its microbatch count at the preserved global
    batch and its stage partition (StageManifest.balanced where pp does
    not divide the layers). The rules are the trainer's."""
    layouts = []
    for pp in _divisors(devices):
        if pp > model_cfg.num_hidden_layers:
            continue
        for tp in _divisors(devices // pp):
            if tp > max_tp:
                continue
            if (model_cfg.num_attention_heads % tp or model_cfg.kv_heads % tp
                    or model_cfg.intermediate_size % tp or model_cfg.vocab_size % tp):
                continue
            for sp in _divisors(devices // (pp * tp)):
                if sp > max_sp or seq % sp:
                    continue
                dp = devices // (pp * tp * sp)
                micro, rem = divmod(global_batch_examples, mb_rows * dp)
                if rem or micro < 1:
                    continue
                counts = (None if model_cfg.num_hidden_layers % pp == 0
                          else StageManifest.balanced(model_cfg, pp).stage_layer_counts)
                layouts.append({"pp": pp, "tp": tp, "dp": dp, "sp": sp,
                                "microbatches": micro, "layer_counts": counts})
    return layouts


def layout_step_seconds(model_cfg, lay: dict, bubble: float, mb_rows: int, seq: int,
                        mfu: float, chip_flops: float | None, ici_bw_gibps: float,
                        zero2: bool = True) -> float:
    """Analytic per-step seconds of a layout running its chosen schedule, the
    frontier's ranking score: compute / (1 - bubble), plus the tp
    all-reduces (4 a layer a microbatch of the [mb, seq/sp, d] block), the
    dp gradient reduction (reduce-scatter under ZeRO-2, else all-reduce),
    the pp hand-offs and the sp ring's k / v rotation, each charged
    serially at `ici_bw_gibps`."""
    pp, tp, dp, sp = lay["pp"], lay["tp"], lay["dp"], lay["sp"]
    micro = lay["microbatches"]
    devices = pp * tp * dp * sp
    tokens = mb_rows * micro * dp * seq
    t_comp = (train_flops_per_token(model_cfg, seq) * tokens / devices
              / (_peak(chip_flops) * max(mfu, 1e-6)))
    wall = t_comp / max(1.0 - bubble, 1e-6)
    d = model_cfg.hidden_size
    dtype_b = _dtype_bytes(model_cfg.dtype)
    bw = ici_bw_gibps * GIB
    slab = mb_rows * (seq // sp) * d * dtype_b
    counts = lay.get("layer_counts")
    k_max = max(counts) if counts else -(-model_cfg.num_hidden_layers // pp)
    t_tp = (2 * (tp - 1) / tp) * 4 * k_max * micro * slab / bw if tp > 1 else 0.0
    kv_dim = model_cfg.kv_heads * model_cfg.head_dim
    matmul = 2 * d * d + 2 * d * kv_dim + 3 * d * model_cfg.intermediate_size
    stage_grads = k_max * (matmul / tp) * 4
    dp_factor = (dp - 1) / dp if zero2 else 2 * (dp - 1) / dp
    t_dp = dp_factor * stage_grads / bw if dp > 1 else 0.0
    t_pp = 2 * micro * slab / bw if pp > 1 else 0.0
    kv_slab = 2 * mb_rows * (seq // sp) * kv_dim * dtype_b
    t_sp = 3 * (sp - 1) * k_max * micro * kv_slab / bw if sp > 1 else 0.0
    return wall + t_tp + t_dp + t_pp + t_sp


def layout_frontier(model_cfg, devices: int, mb_rows: int, seq: int,
                    global_batch_examples: int, base_gib_aw: float, aw_layout: tuple,
                    hbm_gb: float, host_bw_gibps: float = HOST_BW_GIBPS, mfu: float = 0.45,
                    chip_flops: float | None = None, ici_bw_gibps: float = ICI_BW_GIBPS,
                    hide_max: float = 1.0, optimizer_offload: bool = True,
                    zero2: bool = True, loss_chunks_aw: int = 1,
                    vocab_enabled: bool = True, solver_lane: bool = True,
                    max_virtual: int = 4, mem_scale: float = 1.0) -> tuple:
    """The (pp, tp, dp, sp) frontier at `devices` cards: per layout, the
    schedule / offload / ce selection rerun against that mesh's base (its
    layout_device_gib plus the as-written residual, scaled to its tp x sp
    shard width), then the feasible layouts ranked by layout_step_seconds.
    Returns (winner_row, rows), best first."""
    pp_aw, tp_aw, dp_aw, sp_aw = aw_layout
    residual = base_gib_aw - layout_device_gib(model_cfg, pp_aw, tp_aw, dp_aw,
                                               optimizer_offload=optimizer_offload,
                                               zero2=zero2)
    rows = []
    for lay in enumerate_layouts(devices, model_cfg, seq, global_batch_examples, mb_rows):
        pp, tp, dp, sp = lay["pp"], lay["tp"], lay["dp"], lay["sp"]
        micro = lay["microbatches"]
        dims = pl.stash_dims(mb_rows, seq, sp, model_cfg.hidden_size, model_cfg.dtype)
        base = (layout_device_gib(model_cfg, pp, tp, dp, layer_counts=lay["layer_counts"],
                                  optimizer_offload=optimizer_offload, zero2=zero2)
                + residual * (tp_aw * sp_aw) / (tp * sp))
        ce_axis = (ce_axis_options(loss_chunks_aw, model_cfg.vocab_size, tp)
                   if vocab_enabled else None)
        vocab = model_cfg.vocab_size if vocab_enabled and tp <= 1 else None
        cands = enumerate_candidates(pp, micro, model_cfg.num_hidden_layers,
                                     max_virtual=max_virtual, ce_options=ce_axis,
                                     layer_counts=lay["layer_counts"])
        if solver_lane and lay["layer_counts"] is None:
            solver_head = 0.0
            if vocab:
                solver_head = pl.loss_head_bytes(
                    pl.PipelineConfig(num_stages=pp, num_microbatches=micro),
                    *dims[:3], vocab) / GIB
            cands += solver_candidates(pp, micro, model_cfg.num_hidden_layers, base, dims,
                                       hbm_gb, max_virtual=max_virtual,
                                       head_gib=solver_head, mem_scale=mem_scale)
        mesh_cfg = MeshConfig(pp=pp, tp=tp, dp=dp, sp=sp)
        compute_fn = lambda c, _mc=mesh_cfg: _step_compute_seconds(
            model_cfg, _mc, c, mb_rows, seq, mfu, chip_flops)
        sched_winner, _ = select_schedule(cands, base, dims, hbm_gb, host_bw_gibps,
                                          compute_fn, hide_max=hide_max, vocab=vocab,
                                          mem_scale=mem_scale)
        row = {"pp": pp, "tp": tp, "dp": dp, "sp": sp,
               "layout": f"pp{pp}xtp{tp}xdp{dp}xsp{sp}",
               "microbatches": micro,
               "layer_counts": list(lay["layer_counts"]) if lay["layer_counts"] else None,
               "base_gib": round(base, 2)}
        if sched_winner is None:
            row.update({"feasible": False, "score_s": None,
                        "why_not": "no schedule fits this layout's memory model"})
        else:
            score = layout_step_seconds(model_cfg, lay, sched_winner["bubble_fraction"],
                                        mb_rows, seq, mfu, chip_flops, ici_bw_gibps,
                                        zero2=zero2)
            row.update({"feasible": True, "score_s": round(score, 4), "_score": score,
                        "why_not": None, "sched": sched_winner,
                        "est_peak_gib": sched_winner["est_peak_gib"],
                        "bubble_fraction": sched_winner["bubble_fraction"]})
        rows.append(row)
    rows.sort(key=lambda r: (not r["feasible"], r.get("_score", float("inf")), r["layout"]))
    winner = rows[0] if rows and rows[0]["feasible"] else None
    return winner, rows


def layout_overrides(row: dict, schedule_file: str | None = None) -> list:
    """One frontier row as the override list a ladder rung (or a launch
    line) appends: the mesh axes, the preserved-global-batch microbatch
    count, an uneven partition, and the schedule's own overrides."""
    parts = [f"mesh.pp={row['pp']}", f"mesh.tp={row['tp']}",
             f"mesh.dp={row['dp']}", f"mesh.sp={row['sp']}",
             f"gradient_accumulation_steps={row['microbatches']}"]
    if row.get("layer_counts"):
        parts.append("layer_counts=[" + ",".join(str(c) for c in row["layer_counts"]) + "]")
    parts += select_overrides(row["sched"], schedule_file=schedule_file).split()
    return parts


def build_ladder(model_cfg, devices: int, mb_rows: int, seq: int,
                 global_batch_examples: int, base_gib_aw: float, aw_layout: tuple,
                 hbm_gb: float, top_k: int = 3, schedule_file_for=None,
                 **frontier_kw) -> tuple:
    """The supervisor ladder: the top-k frontier survivors at `devices`
    cards, then the best survivor at each halved device count, best first,
    in tools/supervisor.py's --layout-ladder format ({name, devices,
    overrides}). `schedule_file_for(rung_name, pcfg) -> path` writes a
    solver rung's sequence (None: canonical schedules only). Returns
    (rungs, {device count: scored rows})."""
    rungs, frontiers = [], {}
    n = devices
    while n >= 1:
        kw = dict(frontier_kw)
        if schedule_file_for is None:
            kw["solver_lane"] = False  # a solver rung needs its sequence file
        _, rows = layout_frontier(model_cfg, n, mb_rows, seq, global_batch_examples,
                                  base_gib_aw, aw_layout, hbm_gb, **kw)
        frontiers[n] = rows
        feasible = [r for r in rows if r["feasible"]]
        for r in feasible[:top_k if n == devices else 1]:
            name = f"{r['layout']}-{r['sched']['schedule']}"
            if any(rg["name"] == name for rg in rungs):
                name += f"-c{r['sched']['accum_chunks']}"
            sfile = None
            if r["sched"]["schedule"] == "solver":
                sfile = schedule_file_for(name, r["sched"]["_pcfg"])
            rungs.append({"name": name, "devices": n,
                          "overrides": layout_overrides(r, schedule_file=sfile)})
        if n == 1:
            break
        n //= 2
    return rungs, frontiers


def select_overrides(row: dict, schedule_file: str | None = None) -> str:
    """The winning candidate as `key=value` overrides for the launch line; a
    solver winner also needs its sequence file (`--emit-schedule`)."""
    parts = [f"pipeline_schedule={row['schedule']}",
             f"virtual_stages={row['virtual_stages']}",
             f"gradient_accumulation_chunks={row['accum_chunks']}"]
    if row["schedule"] == "solver":
        parts.append(f"schedule_file={schedule_file or '<path from --emit-schedule>'}")
    if row["offload_wgrad"]:
        parts.append("offload.wgrad_stash=true")
    if row["offload_activations"]:
        parts.append("offload.activations=true")
    if row.get("loss_chunks", 1) > 1:
        parts.append(f"loss_vocab_chunks={row['loss_chunks']}")
    if row.get("kernel_ce"):
        parts.append("kernels.ce=pallas")
    return " ".join(parts)


def stash_remedies(pcfg) -> str:
    """Remedies for a blown W-stash, derived from the emitted sequences: the
    queue depth from the sequence's slot accounting, each fallback named
    with its bubble counted from its canonical sequence at this shape."""
    depth = pl.wgrad_queue_peak(pcfg)
    own_b = pl.bubble_fraction(pcfg)
    parts = [f"raise gradient_accumulation_chunks (the per-flush W-queue holds {depth} "
             f"residual units; each doubling halves it)",
             "tier residuals to host DRAM (offload.wgrad_stash, or a solver sequence's "
             "per-unit offload vector via --select)"]
    alts = []
    for name, v in (("interleaved_1f1b", pcfg.virtual_stages), ("1f1b", 1)):
        try:
            alt = dataclasses.replace(pcfg, schedule=name, virtual_stages=v,
                                      offload_wgrad=False, unit_schedule=None)
            alts.append((pl.bubble_fraction(alt), name))
        except ValueError:
            continue
    if alts:
        b, name = min(alts)
        parts.append(f"fall back to pipeline_schedule: {name} (no W stash; bubble "
                     f"{100 * b:.2f}% vs {100 * own_b:.2f}% here — both counted from the "
                     f"schedules' emitted sequences)")
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# The memory check on the card
# ---------------------------------------------------------------------------

def _require_card(flag: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit(f"{flag} measures the trainer's step on the card: "
                         f"torch.cuda.is_available() is false here")


def rank_overrides(cfg: dict) -> list[str]:
    """The cut --calibrate and --memory-audit measure: one process (pp, dp,
    tp, sp 1 in the mesh), flash attention and the prologue kernels, the CE
    kernels where the config's tp is 1 (under tp the head is the
    vocab-parallel dense one), the config's own remat, optimizer and
    microbatch rows."""
    mesh_cfg, model_cfg, _, pcfg = _builders(cfg)
    out = ["mesh.pp=1", "mesh.dp=1", "mesh.tp=1", "mesh.sp=1", "attention=flash",
           "kernels.prologue=pallas", "pipeline_schedule=1f1b", "virtual_stages=1",
           "gradient_accumulation_chunks=1", "offload={}"]
    if mesh_cfg.tp == 1:
        chunks = pcfg.loss_chunks if pcfg.loss_chunks > 1 else 4
        if model_cfg.vocab_size % chunks:
            chunks = 1
        out += ["kernels.ce=pallas", f"loss_vocab_chunks={chunks}"]
    return out


def measure_rank_step(cfg: dict, layers: int, microbatches: int = 2,
                      device: str = "cuda", snapshot_top: int = 0) -> dict:
    """One training step of tp rank 0 of the config's first stage, as the
    trainer runs it, in this process: `layers` decoder layers at the rank's
    shapes (its tp slices of q/k/v/gate/up/wo/down and lm_head, seq / sp
    tokens a row), `microbatches` microbatches of the config's rows, its
    remat and optimizer (the device AdamW, or the host optimizer's device
    side: the bf16 working copy and fp32 gradient buffers). Returns the
    step's peak allocated bytes over the built state (the peak is reset
    once params and optimizer exist: the init's whole-leaf draws are no
    part of a step), the allocator's reserved peak (both over what the
    process held before the call, so earlier work in it does not count)
    and, with `snapshot_top`, the largest live blocks at the end of the
    step."""
    from llama_pipeline_parallel_tpu_torch.optim.optimizer import AdamW, OptimizerConfig
    from llama_pipeline_parallel_tpu_torch.parallel import train_step as ts
    from llama_pipeline_parallel_tpu_torch.train import (
        _loss_head,
        _mesh_config,
        _remat,
        build_model_config,
        select_attention,
    )
    from llama_pipeline_parallel_tpu_torch.utils.config import apply_overrides

    mesh_cfg = _mesh_config(cfg)
    tp, sp = mesh_cfg.tp, mesh_cfg.sp
    rcfg = apply_overrides(copy.deepcopy(cfg), rank_overrides(cfg))
    model_cfg = dataclasses.replace(build_model_config(rcfg["model"]),
                                    num_hidden_layers=layers)
    manifest = StageManifest.for_config(model_cfg, 1)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held, held_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    params = ts.init_params_sharded(model_cfg, 0, manifest, (0,), tp_rank=0, tp=tp,
                                    device=dev)[0][0]
    offloaded = bool(rcfg.get("optimizer_offload"))
    grads = None
    if offloaded:
        # the host optimizer's device side: the working copy in the compute
        # dtype and fp32 gradient buffers (train._offload_state); its update
        # runs on the host, so the step here stops at the gradients
        params = {n: t.to(model_cfg.dtype) for n, t in params.items()}
        grads = {n: torch.zeros(t.shape, dtype=torch.float32, device=dev)
                 for n, t in params.items()}

        class _DeviceSide:
            def step(self, params, grads, norm):
                return 0.0

        optimizer = _DeviceSide()
    else:
        params = {n: t.requires_grad_() for n, t in params.items()}
        optimizer = AdamW(params, OptimizerConfig(learning_rate=1e-5, total_steps=10,
                                                  warmup_steps=1))
    seq = _seq_length(rcfg) // sp
    mb_rows = int(rcfg.get("per_device_train_batch_size", 1))
    rows = mb_rows * microbatches
    vocab = params["lm_head"].shape[-1]
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, vocab, (rows, seq), generator=gen).to(dev)
    batch = {"input_ids": ids, "labels": ids.clone(),
             "attention_mask": torch.ones_like(ids),
             "position_ids": torch.arange(seq, device=dev).expand(rows, seq).contiguous()}
    remat, policy = _remat(rcfg)
    attn_fn = select_attention("flash", seq, dev)
    state = ts.TrainState(step=0, params=params, optimizer=optimizer)
    if on_card:  # the step's peak over the built state, not the init's draws
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    metrics = ts.train_step(state, batch, model_cfg, num_microbatches=microbatches,
                            attn_fn=attn_fn, remat=remat, remat_policy=policy,
                            head=_loss_head(rcfg, dataclasses.replace(
                                model_cfg, vocab_size=vocab)),
                            kernel_prologue=True, grads=grads)
    out = {"layers": layers, "microbatches": microbatches, "loss": float(metrics["loss"])}
    if on_card:
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        out.update(peak_bytes=torch.cuda.max_memory_allocated() - held,
                   reserved_peak_bytes=stats.get("reserved_bytes.all.peak", 0) - held_reserved,
                   alloc_retries=stats.get("num_alloc_retries", 0))
        if snapshot_top:
            sizes = [blk["size"] for seg in torch.cuda.memory_snapshot()
                     for blk in seg["blocks"] if blk["state"] == "active_allocated"]
            out["top_blocks_bytes"] = sorted(sizes, reverse=True)[:snapshot_top]
    del state, params, grads, optimizer, batch
    if on_card:
        torch.cuda.empty_cache()
    return out


def _rank_model_gib(cfg: dict, layers: int) -> dict:
    """The byte model of the cut measure_rank_step runs (one stage of
    `layers` layers at the rank's shapes, dp 1), GiB by row."""
    from llama_pipeline_parallel_tpu_torch.utils.config import apply_overrides

    mesh_cfg = _builders(cfg)[0]
    rcfg = apply_overrides(copy.deepcopy(cfg), rank_overrides(cfg) + [
        f"mesh.tp={mesh_cfg.tp}", f"mesh.sp={mesh_cfg.sp}",
        f"model.num_hidden_layers={layers}", "gradient_accumulation_steps=2"])
    return device_rows_gib(rcfg)


def calibrate(cfg: dict) -> dict:
    """The byte model held to the card: measure_rank_step at 1 and 2 layers,
    the peak extrapolated affinely to the stage's depth (plus the model's
    ring and stash, which one process at pp 1 does not hold), beside the
    model of the same cut; `mem_scale` = measured / model. The allocator's
    reserved peak at 2 layers over its allocated peak is reported beside it:
    the verdict holds allocated bytes, and what the allocator keeps on top
    of them at the stage's depth is not measured."""
    _require_card("--calibrate")
    mesh_cfg, model_cfg, _, pcfg = _builders(cfg)
    k = (max(pcfg.layer_counts) if pcfg.layer_counts
         else -(-model_cfg.num_hidden_layers // mesh_cfg.pp))
    one = measure_rank_step(cfg, 1)
    two = measure_rank_step(cfg, 2)
    per_layer = (two["peak_bytes"] - one["peak_bytes"]) / GIB
    measured_k = one["peak_bytes"] / GIB + (k - 1) * per_layer
    model_1 = sum(_rank_model_gib(cfg, 1).values())
    model_2 = sum(_rank_model_gib(cfg, 2).values())
    model_k = sum(_rank_model_gib(cfg, k).values())
    return {"stage_layers": k,
            "measured_1_layer_gib": round(one["peak_bytes"] / GIB, 3),
            "measured_2_layers_gib": round(two["peak_bytes"] / GIB, 3),
            "measured_per_layer_gib": round(per_layer, 4),
            "model_1_layer_gib": round(model_1, 3), "model_2_layers_gib": round(model_2, 3),
            "model_per_layer_gib": round(model_2 - model_1, 4),
            "measured_stage_gib": round(measured_k, 2), "model_stage_gib": round(model_k, 2),
            "mem_scale": round(measured_k / model_k, 4),
            "reserved_peak_2_layers_gib": round(two["reserved_peak_bytes"] / GIB, 3),
            "reserved_over_allocated": round(two["reserved_peak_bytes"] / two["peak_bytes"], 4),
            "alloc_retries": two["alloc_retries"]}


def memory_audit(cfg: dict, top_buffers: int = 8) -> dict:
    """The model's terms beside the card's peak at a ladder of microbatch
    counts (1, 2 and the as-written count up to 4), one layer at the rank's
    shapes: the residual (measured minus the model) must not move with the
    count, as the port accumulates gradients in place and runs one
    microbatch at a time; each rung names its largest live blocks
    (torch.cuda.memory_snapshot)."""
    _require_card("--memory-audit")
    m_real = _builders(cfg)[3].num_microbatches
    ladder = sorted({1, 2, min(m_real, 4)})
    model = _rank_model_gib(cfg, 1)
    rungs = []
    for m in ladder:
        got = measure_rank_step(cfg, 1, microbatches=m, snapshot_top=top_buffers)
        peak = got["peak_bytes"] / GIB
        rungs.append({"microbatches": m, "as_written": m == m_real,
                      "raw_peak_gib": round(peak, 3),
                      "model_gib": round(sum(model.values()), 3),
                      "residual_gib": round(peak - sum(model.values()), 3),
                      "top_buffers_gib": [round(b / GIB, 3) for b in got.get("top_blocks_bytes", [])]})
    return {"schedule": _builders(cfg)[3].schedule, "as_written_microbatches": m_real,
            "terms_gib": {k: round(v, 3) for k, v in model.items()}, "rungs": rungs}


def print_memory_audit(audit: dict) -> None:
    """The --memory-audit table: a row a rung, the residual last; a flat
    residual column holds the model's microbatch scaling."""
    print(f"memory audit (one layer at the rank's shapes, one process): as-written "
          f"M={audit['as_written_microbatches']}")
    print("  model terms, GiB: " + ", ".join(f"{k}={v}" for k, v in
                                              audit["terms_gib"].items()))
    print(f"{'M':>6s} {'raw_peak':>9s} {'model':>8s} {'residual':>9s}  note")
    for r in audit["rungs"]:
        note = "as-written" if r["as_written"] else ""
        print(f"{r['microbatches']:>6d} {r['raw_peak_gib']:>9.3f} {r['model_gib']:>8.3f} "
              f"{r['residual_gib']:>9.3f}  {note}")
    for r in audit["rungs"]:
        if r["top_buffers_gib"]:
            print(f"  top live blocks at M={r['microbatches']}: "
                  + ", ".join(f"{b} GiB" for b in r["top_buffers_gib"]))


# ---------------------------------------------------------------------------
# Resume compatibility, calibration constants, the sweep
# ---------------------------------------------------------------------------

def resume_compat(cfg: dict) -> dict | None:
    """When the config's output_dir holds a checkpoint this run would
    resume, compare its recorded topology and data contract against the
    config (the reference's report, on the port's meta.json). None when
    there is nothing to resume; never a failure (topology changes are the
    point of an elastic restore)."""
    out_dir = cfg.get("output_dir")
    if not out_dir or not os.path.isdir(out_dir) or not cfg.get("resume", True):
        return None
    latest = None
    try:
        for d in os.listdir(out_dir):
            m = re.match(r"^checkpoint-(\d+)$", d)
            if m and os.path.isfile(os.path.join(out_dir, d, "meta.json")):
                latest = max(latest or 0, int(m.group(1)))
        if latest is None:
            return None
        with open(os.path.join(out_dir, f"checkpoint-{latest}", "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None  # torn/corrupt meta: the trainer's quarantine handles it
    mesh = dict(cfg.get("mesh") or {})
    current = {"pp": int(mesh.get("pp", 1)), "dp": int(mesh.get("dp", 1)),
               "tp": int(mesh.get("tp", 1)), "sp": int(mesh.get("sp", 1)),
               "schedule": cfg.get("pipeline_schedule", "1f1b"),
               "virtual_stages": int(cfg.get("virtual_stages", 1) or 1)}
    report: dict = {"resume_step": latest}
    source = meta.get("topology")
    if source and "layer_counts" in source:
        try:
            from llama_pipeline_parallel_tpu_torch.train import (
                build_manifest,
                build_model_config,
            )

            man = build_manifest(cfg, build_model_config(cfg["model"]), current["pp"])
            current["layer_counts"] = (f"even/{man.stage_layer_counts[0]}" if man.is_even
                                       else list(man.stage_layer_counts))
        except Exception:
            pass  # unresolvable model node: skip the partition comparison
    if source:
        changed = sorted(k for k in current if source.get(k) != current[k])
        report["source_topology"] = source.get("layout", source)
        report["topology_changed"] = changed or "no"
        if source.get("schedule") != current["schedule"]:
            report["schedule_changed"] = (
                f"{source.get('schedule', '1f1b')} -> {current['schedule']} (layout "
                f"re-stacks from the canonical checkpoint; docs/SCHEDULES.md)")
    data_state = meta.get("data_state")
    if data_state:
        packing = int(cfg.get("packing_factor", 1) or 1)
        g_now = (current["dp"] * int(cfg.get("per_device_train_batch_size", 1))
                 * int(cfg.get("gradient_accumulation_steps", 1)) * packing)
        g_ckpt = data_state.get("global_batch_examples")
        report["global_batch_examples"] = {"checkpoint": g_ckpt, "config": g_now}
        report["data_contract"] = (
            "exact (O(1) reposition, zero dropped/duplicated samples)"
            if g_ckpt == g_now else
            "REMAPPED — global batch changed; re-trains at most one partial batch and "
            "shifts the lr-schedule/epoch mapping (docs/RESILIENCE.md)")
    return report


CALIBRATION_KEYS = {"mfu": "mfu", "host_bw_gibps": "host_bw_gibps",
                    "ici_bw_gibps": "ici_bw_gibps", "mem_scale": "mem_scale"}


def load_calibration(path: str) -> dict:
    """Read a perf_report --emit-calibration constants file: a readable
    verdict (SystemExit) on an unreadable or non-object file; {} when it
    carries no usable key."""
    try:
        with open(path) as f:
            calib = json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--calibration {path} is not readable JSON: {e}")
    if not isinstance(calib, dict):
        raise SystemExit(f"--calibration {path} is not a JSON object "
                         f"(got {type(calib).__name__})")
    out = {}
    for key in CALIBRATION_KEYS:
        try:
            v = float(calib[key])
        except (KeyError, TypeError, ValueError):
            continue
        if v > 0:
            out[key] = v
    return out


def apply_calibration(args, path: str) -> dict:
    """The file's measured constants over the CLI's (only the keys it
    carries). Returns what was applied."""
    applied = load_calibration(path)
    for key, attr in CALIBRATION_KEYS.items():
        if key in applied:
            setattr(args, attr, applied[key])
    return applied


def _verdict(path: str, overrides: list[str], args) -> tuple[dict | None, str]:
    """(report or None, error text) of one config at the CLI's constants."""
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    try:
        cfg = load_config(path, overrides)
        return preflight(cfg, args.hbm_gb, host_bw_gibps=args.host_bw_gibps, mfu=args.mfu,
                         hide_max=args.hide_ratio_max, chip_flops=args.chip_flops,
                         mem_scale=args.mem_scale), ""
    except (ValueError, KeyError, TypeError) as e:
        return None, f"{type(e).__name__}: {e}"


def _run_all(patterns: list[str], overrides: list[str], args) -> int:
    """Every config matching `patterns`, in this process, and the pass/fail
    table; 1 if any fails."""
    paths = sorted({p for pat in patterns for p in glob.glob(pat)})
    if not paths:
        raise SystemExit(f"no configs match {patterns!r}")
    rows, any_fail = [], False
    for path in paths:
        report, err = _verdict(path, overrides, args)
        ok = report is not None and report["fits"]
        peak = "?" if report is None else str(report["per_device_peak_gib"])
        any_fail |= not ok
        rows.append((path, peak, "OK" if ok else "FAIL"))
        print(f"{'OK  ' if ok else 'FAIL'} {path}: peak {peak} GiB", flush=True)
        if err:
            print(f"  {err}", flush=True)
    print(f"\n{'config':<40} {'peak GiB':>9}  verdict (budget {args.hbm_gb} GiB)")
    for path, peak, verdict in rows:
        print(f"{path:<40} {peak:>9}  {verdict}")
    return 1 if any_fail else 0


def card_hbm_gib() -> float | None:
    """The card's memory, GiB (torch.cuda.get_device_properties(0)), or None
    without a card."""
    if not torch.cuda.is_available():
        return None
    return round(torch.cuda.get_device_properties(0).total_memory / GIB, 2)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None,
                   help="one config yaml (or use --all for a sweep)")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="per-card memory budget in GiB (default: the card's total "
                        "memory, torch.cuda.get_device_properties(0); required "
                        "without a card)")
    p.add_argument("--all", dest="all_globs", nargs="*", default=None, metavar="GLOB",
                   help="the verdict of every config matching the GLOB pattern(s) "
                        "(default conf/*.yaml), in this process, and a summary table; "
                        "exit 1 if any fails")
    p.add_argument("--calibrate", action="store_true",
                   help="with --config: run the trainer's step at one tp rank's shapes "
                        "on the card at 1 and 2 layers, extrapolate the peak to the "
                        "stage's depth and print it beside the byte model (mem_scale); "
                        "needs a card")
    p.add_argument("--select", action="store_true",
                   help="after the as-written verdict, score (schedule, virtual_stages, "
                        "accum_chunks, offload, ce) candidates and solver sequences "
                        "against the budget and the host-link bound, and print the "
                        "chosen config")
    p.add_argument("--emit-schedule", default=None, metavar="PATH",
                   help="write the selected unit sequence (the --select winner's, else "
                        "the as-written config's canonical one) as JSON to PATH and "
                        "print its per-stage ASCII timeline; the file feeds "
                        "pipeline_schedule: solver + schedule_file")
    p.add_argument("--layout-devices", type=int, default=None, metavar="N",
                   help="with --select: score every (pp, tp, dp, sp) mesh of N devices "
                        "(default: the as-written world size) and rank the frontier by "
                        "the analytic step-time score")
    p.add_argument("--emit-ladder", default=None, metavar="PATH",
                   help="with --select: write the frontier's top-k survivors plus the "
                        "best rung at each halved device count as a "
                        "tools/supervisor.py --layout-ladder JSON; solver rungs get "
                        "their sequence files next to PATH")
    p.add_argument("--ladder-top-k", type=int, default=3,
                   help="rungs to emit at the full device count (default 3)")
    p.add_argument("--ici-bw-gibps", type=float, default=ICI_BW_GIBPS,
                   help="card-to-card link bandwidth, GiB/s, for the layout score's "
                        "collective terms (default: NVLink 4 on an H100 SXM, 450 GB/s "
                        "each way, NVIDIA's H100 data sheet; never measured here)")
    p.add_argument("--host-bw-gibps", type=float, default=HOST_BW_GIBPS,
                   help="host-link bandwidth, GiB/s, for the offload feasibility bound "
                        f"(default {HOST_BW_GIBPS}: chip_smoke.py's measurement, the "
                        "slower direction, NVIDIA H100 80GB HBM3 at 700 W)")
    p.add_argument("--mfu", type=float, default=0.45,
                   help="assumed MFU of the modeled step compute the offload traffic "
                        "must hide inside")
    p.add_argument("--hide-ratio-max", type=float, default=1.0,
                   help="reject offload whose modeled transfer/compute ratio exceeds "
                        "this")
    p.add_argument("--mem-scale", type=float, default=1.0,
                   help="measured-peak / byte-model ratio scaling the verdict and every "
                        "--select candidate (--calibrate measures it)")
    p.add_argument("--memory-audit", action="store_true",
                   help="with --config: the model's terms beside the card's measured "
                        "peak at a ladder of microbatch counts, with the largest live "
                        "blocks; needs a card")
    p.add_argument("--chip-flops", type=float, default=None,
                   help="card peak FLOP/s for the compute model (default: the card's, "
                        "utils/metrics.peak_flops)")
    p.add_argument("--calibration", default=None, metavar="JSON",
                   help="measured constants from tools/perf_report.py "
                        "--emit-calibration: its keys (mfu, host_bw_gibps, "
                        "ici_bw_gibps, mem_scale) override the assumptions above")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    args, unknown = p.parse_known_args(argv)
    bad = [u for u in unknown if not (u.startswith("--") and "=" in u)]
    if bad:
        p.error(f"unrecognized arguments: {' '.join(bad)}")
    args.overrides += unknown

    if args.hbm_gb is None:
        args.hbm_gb = card_hbm_gib()
        if args.hbm_gb is None:
            p.error("no card here (torch.cuda.is_available() is false): pass --hbm-gb, "
                    "the per-card budget in GiB")
    if args.chip_flops is None and torch.cuda.is_available():
        args.chip_flops = peak_flops(torch.device("cuda"))
    if args.calibration:
        applied = apply_calibration(args, args.calibration)
        if applied:
            print("calibration: " + ", ".join(f"{k}={v}" for k, v in applied.items())
                  + f" (measured — {args.calibration})")
        else:
            print(f"calibration: {args.calibration} carries no usable keys; keeping the "
                  f"CLI assumptions")
    if (args.emit_ladder or args.layout_devices) and not args.select:
        p.error("--emit-ladder/--layout-devices extend --select")
    if args.all_globs is not None:
        if args.config:
            p.error("--config and --all are mutually exclusive")
        # nargs='*' takes trailing key=value overrides too: route anything
        # that is no yaml path or glob back to the overrides
        globs = [g for g in args.all_globs if g.endswith((".yaml", ".yml")) or "*" in g]
        stray = [g for g in args.all_globs if g not in globs]
        if any("=" not in s for s in stray):
            p.error(f"--all takes .yaml globs; got {stray}")
        return _run_all(globs or ["conf/*.yaml"], stray + args.overrides, args)
    if args.config is None:
        p.error("--config is required (or pass --all for a sweep)")

    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, args.overrides)
    print(f"preflight: {args.config} — the byte model against {args.hbm_gb} GiB (no "
          f"compile; --calibrate holds it to the card)")
    report = preflight(cfg, args.hbm_gb, host_bw_gibps=args.host_bw_gibps, mfu=args.mfu,
                       hide_max=args.hide_ratio_max, chip_flops=args.chip_flops,
                       mem_scale=args.mem_scale)
    for k, v in report.items():
        print(f"  {k}: {v}")
    resume = resume_compat(cfg)
    if resume:
        print("resume preflight (elastic — docs/RESILIENCE.md):")
        for k, v in resume.items():
            print(f"  {k}: {v}")
    if args.calibrate:
        print("calibration on the card:")
        cal = calibrate(cfg)
        for k, v in cal.items():
            print(f"  {k}: {v}")
        reserved = report["per_device_peak_gib"] * cal["reserved_over_allocated"]
        print(f"  the verdict holds allocated bytes against the card's total memory, the "
              f"CUDA context included; at 2 layers the allocator reserved "
              f"{cal['reserved_over_allocated']}x what it allocated, which would make the "
              f"peak {reserved:.2f} GiB reserved (not measured at the stage's depth)")
    if args.memory_audit:
        print()
        print_memory_audit(memory_audit(cfg))
    if args.select:
        _print_selection(cfg, report, args)
    elif args.emit_schedule:
        _emit_schedule(args.emit_schedule, None, None, int((cfg.get("mesh") or {}).get("pp", 1)),
                       _builders(cfg)[3])
    if not report["fits"]:
        print(f"preflight FAIL: per-device peak {report['per_device_peak_gib']} GiB exceeds "
              f"the {args.hbm_gb} GiB budget"
              if "offload_bw_verdict" not in report
              or report["offload_hide_ratio"] <= args.hide_ratio_max else
              f"preflight FAIL: {report['offload_bw_verdict']}")
        if "wgrad_queue_depth" in report and not report.get("offload"):
            print(f"  W-stash: {report['wgrad_stash_gib']} GiB across "
                  f"{report['wgrad_queue_depth']} queued units — "
                  f"{stash_remedies(_builders(cfg)[3])}")
        return 1
    print("preflight OK")
    return 0


def _print_selection(cfg: dict, report: dict, args) -> None:
    """The --select pass: anchor on the as-written model, enumerate the
    candidate grid, print the scored table and the chosen config (or why
    nothing fits)."""
    mesh_cfg, model_cfg, _, pcfg = _builders(cfg)
    mb_rows = int(cfg.get("per_device_train_batch_size", 1))
    seq = report["seq"]
    dims = pl.stash_dims(mb_rows, seq, mesh_cfg.sp, model_cfg.hidden_size, model_cfg.dtype)
    # the schedule-independent anchor: the as-written model minus its own
    # ring / stash / loss-head terms (the ce axis exists at tp 1 only)
    vocab = model_cfg.vocab_size if mesh_cfg.tp <= 1 else None
    mem_scale = getattr(args, "mem_scale", 1.0) or 1.0
    terms = candidate_device_terms_gib(pcfg, dims, vocab)
    base = (sum(device_rows_gib(cfg).values()) - terms["ring_gib"] - terms["stash_gib"]
            - terms["loss_head_gib"])
    compute_fn = lambda c: _step_compute_seconds(model_cfg, mesh_cfg, c, mb_rows, seq,
                                                 args.mfu, args.chip_flops)
    ce_axis = ce_axis_options(pcfg.loss_chunks, model_cfg.vocab_size, mesh_cfg.tp)
    candidates = enumerate_candidates(mesh_cfg.pp, pcfg.num_microbatches,
                                      model_cfg.num_hidden_layers, ce_options=ce_axis,
                                      layer_counts=pcfg.layer_counts)
    solver_head = 0.0
    if vocab:
        solver_head = pl.loss_head_bytes(dataclasses.replace(pcfg, loss_chunks=1,
                                                             kernel_ce=False),
                                         *dims[:3], vocab) / GIB
    if pcfg.layer_counts is None or len(set(pcfg.layer_counts)) == 1:
        candidates += solver_candidates(mesh_cfg.pp, pcfg.num_microbatches,
                                        model_cfg.num_hidden_layers, base, dims, args.hbm_gb,
                                        head_gib=solver_head, mem_scale=mem_scale)
    winner, rows = select_schedule(candidates, base, dims, args.hbm_gb, args.host_bw_gibps,
                                   compute_fn, hide_max=args.hide_ratio_max, vocab=vocab,
                                   mem_scale=mem_scale)
    scale_note = f", mem_scale {mem_scale}" if mem_scale != 1.0 else ""
    print(f"schedule selection ({len(rows)} candidates; base {round(base, 2)} GiB + "
          f"per-candidate ring/stash/loss-head; bw {args.host_bw_gibps} GiB/s, mfu "
          f"{args.mfu}{scale_note}):")
    print(f"  {'schedule':<17} {'v':>2} {'c':>2} {'offload':<14} {'ce':<10} "
          f"{'peak GiB':>9} {'host GiB':>9} {'head GiB':>9} {'bubble%':>8} {'hide':>6}  "
          f"verdict")
    for r in sorted(rows, key=lambda r: (not r["feasible"], r["bubble_fraction"],
                                         r["est_peak_gib"])):
        off = "+".join(n for n, on in (("wgrad", r["offload_wgrad"]),
                                       ("acts", r["offload_activations"])) if on) or "-"
        if r.get("wgrad_offload_units"):
            off = f"wgrad[{r['wgrad_offload_units']}/{r['wgrad_units_total']}]"
        name = r.get("label") or r["schedule"]
        ce = f"{'pallas' if r['kernel_ce'] else 'xla'}/{r['loss_chunks']}"
        mark = "*" if r is winner else " "
        print(f" {mark}{name:<17} {r['virtual_stages']:>2} {r['accum_chunks']:>2} "
              f"{off:<14} {ce:<10} {r['est_peak_gib']:>9} {r['host_stash_gib']:>9} "
              f"{r['loss_head_gib']:>9} {100 * r['bubble_fraction']:>8.2f} "
              f"{r['hide_ratio']:>6}  {'OK' if r['feasible'] else r['why_not']}")
    if args.layout_devices or args.emit_ladder:
        _print_layout_frontier(cfg, args, model_cfg, mesh_cfg, pcfg, base, mb_rows, seq)
    if winner is None:
        print("selection: NO feasible candidate — grow the mesh (tp/pp) or shrink the "
              "batch shape")
        if getattr(args, "emit_schedule", None):
            _emit_schedule(args.emit_schedule, None, None, mesh_cfg.pp, pcfg)
        return
    emitted = None
    if getattr(args, "emit_schedule", None):
        emitted = _emit_schedule(args.emit_schedule, winner.get("_pcfg"), winner,
                                 mesh_cfg.pp, pcfg)
    print(f"selected: {select_overrides(winner, schedule_file=emitted)}  (est peak "
          f"{winner['est_peak_gib']} GiB, bubble {100 * winner['bubble_fraction']:.2f}%, "
          f"host stash {winner['host_stash_gib']} GiB)")


def _print_layout_frontier(cfg: dict, args, model_cfg, mesh_cfg, pcfg, base: float,
                           mb_rows: int, seq: int) -> None:
    """The layout lane of --select: the scored (pp, tp, dp, sp) frontier and,
    with --emit-ladder, the supervisor ladder (and any solver rung's
    sequence file)."""
    devices = args.layout_devices or mesh_cfg.pp * mesh_cfg.dp * mesh_cfg.tp * mesh_cfg.sp
    g_examples = mb_rows * pcfg.num_microbatches * mesh_cfg.dp
    aw_layout = (mesh_cfg.pp, mesh_cfg.tp, mesh_cfg.dp, mesh_cfg.sp)
    kw = dict(host_bw_gibps=args.host_bw_gibps, mfu=args.mfu, chip_flops=args.chip_flops,
              ici_bw_gibps=args.ici_bw_gibps, hide_max=args.hide_ratio_max,
              optimizer_offload=bool(cfg.get("optimizer_offload")),
              zero2=bool(cfg.get("optimizer_offload_zero2")),
              loss_chunks_aw=pcfg.loss_chunks,
              mem_scale=getattr(args, "mem_scale", 1.0) or 1.0)
    # the display ranks layouts by the bubble, which the solver's per-unit
    # vectors do not change: they are saved for the ladder's rungs
    winner, rows = layout_frontier(model_cfg, devices, mb_rows, seq, g_examples, base,
                                   aw_layout, args.hbm_gb, solver_lane=False, **kw)
    print(f"layout frontier ({devices} devices, global batch {g_examples} examples "
          f"preserved; the byte model per layout, score = compute/(1-bubble) + "
          f"collectives at {args.ici_bw_gibps} GiB/s):")
    print(f"  {'layout':<20} {'M':>4} {'partition':<14} {'schedule':<17} {'v':>2} {'c':>2} "
          f"{'peak GiB':>9} {'bubble%':>8} {'score s':>8}  verdict")
    for r in rows:
        part = "even" if not r["layer_counts"] else ",".join(str(c) for c in r["layer_counts"])
        mark = "*" if r is winner else " "
        if r["feasible"]:
            s = r["sched"]
            name = s.get("label") or s["schedule"]
            print(f" {mark}{r['layout']:<20} {r['microbatches']:>4} {part:<14} {name:<17} "
                  f"{s['virtual_stages']:>2} {s['accum_chunks']:>2} {r['est_peak_gib']:>9} "
                  f"{100 * r['bubble_fraction']:>8.2f} {r['score_s']:>8}  OK")
        else:
            print(f" {mark}{r['layout']:<20} {r['microbatches']:>4} {part:<14} {'-':<17} "
                  f"{'-':>2} {'-':>2} {r['base_gib']:>9} {'-':>8} {'-':>8}  {r['why_not']}")
    if winner is not None:
        print(f"layout selected: {winner['layout']} (score {winner['score_s']} s, est peak "
              f"{winner['est_peak_gib']} GiB) — overrides: "
              f"{' '.join(layout_overrides(winner))}")
    else:
        print("layout selection: NO feasible layout at this device count — shrink the "
              "batch shape or raise --hbm-gb")
    if args.emit_ladder:
        stem = args.emit_ladder
        if stem.endswith(".json"):
            stem = stem[: -len(".json")]

        def schedule_file_for(rung_name: str, rung_pcfg) -> str:
            path = f"{stem}-{rung_name}.schedule.json"
            with open(path, "w") as fh:
                fh.write(usched.to_json(rung_pcfg.unit_schedule))
            return path

        rungs, _ = build_ladder(model_cfg, devices, mb_rows, seq, g_examples, base,
                                aw_layout, args.hbm_gb, top_k=args.ladder_top_k,
                                schedule_file_for=schedule_file_for, **kw)
        with open(args.emit_ladder, "w") as fh:
            json.dump(rungs, fh, indent=1)
            fh.write("\n")
        print(f"emitted ladder -> {args.emit_ladder} ({len(rungs)} rungs, best-first; feed "
              f"it to tools/supervisor.py --layout-ladder @{args.emit_ladder}):")
        for rg in rungs:
            print(f"  {rg['devices']:>5} devices  {rg['name']:<28} {' '.join(rg['overrides'])}")


def _emit_schedule(path: str, winner_pcfg, row: dict | None, pp: int,
                   as_written_pcfg=None) -> str:
    """`--emit-schedule PATH`: the relevant unit sequence (the --select
    winner's, else the as-written config's canonical one) as JSON, and its
    per-stage ASCII timeline."""
    pcfg = winner_pcfg
    if pcfg is None and row is None and as_written_pcfg is not None \
            and as_written_pcfg.schedule == "gpipe":
        print("--emit-schedule: gpipe has no unit sequence (its backward is AD of the "
              "forward) — nothing emitted")
        return path
    if pcfg is None and row is not None:
        if as_written_pcfg is None:
            raise ValueError("_emit_schedule needs the as-written pcfg to size a canonical "
                             "winner's flush")
        pcfg = pl.PipelineConfig(
            num_stages=pp, num_microbatches=as_written_pcfg.num_microbatches,
            schedule=row["schedule"], virtual_stages=row["virtual_stages"],
            accum_chunks=row["accum_chunks"], offload_wgrad=row["offload_wgrad"],
            offload_activations=row["offload_activations"])
    if pcfg is None:
        pcfg = as_written_pcfg
    flush_pcfg = dataclasses.replace(
        pcfg, num_microbatches=pcfg.num_microbatches // pcfg.accum_chunks, accum_chunks=1)
    seq = (flush_pcfg.unit_schedule if flush_pcfg.schedule == "solver"
           else usched.canonical_schedule(
               flush_pcfg.schedule, flush_pcfg.num_microbatches, flush_pcfg.num_stages,
               flush_pcfg.virtual_stages, offload_wgrad=flush_pcfg.offload_wgrad))
    with open(path, "w") as fh:
        fh.write(usched.to_json(seq))
    idle, wall = usched.bubble_stats(seq)
    print(f"emitted unit sequence -> {path} ({seq.num_ticks} ticks, {idle}/{wall} idle "
          f"units = {idle / wall:.4f} bubble per flush)")
    print(usched.ascii_timeline(seq))
    return path


if __name__ == "__main__":
    sys.exit(main())
