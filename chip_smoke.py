#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llama_pipeline_parallel_tpu_torch) on one
NVIDIA card and check it.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each of
which raises on failure:

1. build   -- nvcc builds every `csrc/*.cu` of the port (one process per
              source, all started together); prints the build seconds and
              the card's name and power limit.
2. kernels -- each flash attention kernel (forward out + lse, dq, dk/dv)
              against its plain PyTorch version on the same inputs, element
              by element: at the training step's shape (b=1, h=32, s=2048,
              hd=128, bf16, causal) against the plain version in fp32, in a
              small fp32 case with GQA, segment ids and offsets (with rows
              that see no key), and in a small bf16 case ragged to every
              tile with sq != skv, GQA, segment ids (a pad tail: rows that
              see no key) and offsets. TF32 is off. Each case asserts the
              route of the forward, dq and dk/dv (`tensor_core_counts`): bf16
              the tensor cores, fp32 the SIMT kernels. At the
              step's shape and in the small bf16 case the same check must
              also reject planted faults confined to the last tiles, on the
              same route. Counts HGMMA and UTMALDG in the SASS of the three
              tensor-core kernels. Times each kernel, its plain version and,
              as yardsticks the port never calls,
              F.scaled_dot_product_attention's forward and its backward
              alone (dq, dk, dv in one call: the yardstick of both backward
              kernels).
3. ce      -- each fused CE kernel (forward lse + target logit, dh, dW)
              against its plain PyTorch version on the same inputs, element
              by element: at the training step's head shape (2048 tokens,
              width 4096, vocab 32000, bf16) with 4 vocab chunks and with 1,
              against the plain version in fp32; and in small cases ragged to
              every tile, 300 tokens, width 200: vocab 1000 (chunks of 250)
              and vocab 1088 (chunks of 272), each in fp32 and bf16, and
              vocab 1004 (chunks of 251) in bf16; targets on chunk edges, in
              the last vocab tile and ignored. Each case asserts which
              forward and backward route it took (`tensor_core_counts`):
              bf16 with width and vocab (forward) or chunk (backward)
              multiples of 8 the tensor cores, the rest (fp32, bf16 vocab
              1004, bf16 chunks of 250 or 251) the SIMT kernels. The same
              check must reject planted faults: the kernels on W without its
              last vocab columns (forward, dh) or on the tokens without the
              last ones (dW), at the slice and in the small bf16 cases, on
              every route. Counts the HGMMA and UTMALDG instructions of each
              tensor-core product kernel in the library's SASS (cuobjdump).
              Times each kernel, the dh + dW pair, its plain version and, as
              yardsticks the port never calls, cuBLAS h @ W, g @ W^T and
              h^T @ g.
4. prologue -- each fused prologue kernel (forward q/k/v, dhidden, dW)
              against its plain PyTorch version on the same inputs (the same
              rounding points in the inputs' dtype, fp32 math), element by
              element: at the training step's layer shape (2048 tokens, width
              4096, 32 q and 32 kv heads of 128, bf16) and in small cases
              ragged to every tile (2 x 150 tokens, MQA 4:1, positions from
              37): width 200 in fp32 and bf16, width 196 in bf16 (bf16 q, k,
              v bit for bit up to rounding flips: see FLIP_RTOL). Each case
              asserts the route of the forward, dhidden and dW
              (`tensor_core_counts`): bf16 with a width that is a multiple of
              8 the tensor cores, fp32 and width 196 the SIMT kernels. The
              same check must reject planted faults (in every bf16 case, on
              its route): forward and dhidden on weights whose last
              PLANT_CUT input rows are zero, dW on the tokens without the
              last PLANT_CUT. Counts HGMMA and UTMALDG in the SASS of each
              tensor-core product kernel (forward, dhidden, dW). Times each
              kernel, its plain version and, as yardsticks the port never
              calls, cuBLAS hidden @ [wq|wk|wv], [dq|dk|dv] @ [wq|wk|wv]^T and
              hidden^T @ [dq|dk|dv].
5. trainer -- `run_training` on conf/llama_7b_pp4.yaml at LLaMA-7B width, cut
              to 4 layers, seq 2048, 2 microbatches, 4 steps, attention=flash,
              kernels.ce=pallas, loss_vocab_chunks=4, kernels.prologue=pallas,
              saving and resuming nothing (save_final=false, resume=false):
              every loss finite, exactly layers x microbatches x steps
              launches of each flash and each prologue kernel and
              microbatches x steps of each CE kernel, every flash forward, dq
              and dk/dv call, every CE forward, dh and dW call and every
              prologue forward, dhidden and dW call on the tensor cores.
              Then step 1 again on the
              same params and batch (each time on the run's prologue) with
              flash and with exact attention: per-token losses and gradients
              agree, and a planted attention fault is rejected; with the CE
              kernel head and the dense head: step losses and gradients agree,
              and a planted CE fault is rejected; and with the prologue
              kernels and the composed prologue: step losses and gradients
              agree, and a planted prologue fault is rejected.
6. checkpoint -- the trainer's checkpoints at LLaMA-7B width cut to 2 layers
              (CKPT_OVERRIDES): free disk checked first; run A trains 6 steps
              and saves step 4 with async_save; meta.json's keys checked;
              run B resumes from it and repeats steps 5-6 through every
              kernel (launch and tensor-core counts checked), its losses
              within RESUME_LOSS_TOL of A's and its final params and moments
              held to A's; a flipped byte is caught by verify and
              quarantined; A's params go out through export_hf and back
              through convert_hf into a run with model_name_or_path, which
              starts from them bit for bit and takes a step. Prints the
              seconds and GB/s of the save (the loop's device-to-host copy,
              the background write, digest and commit), verify, reading,
              host-to-device and the HF round trip. build/chip_smoke/ is
              cleared at the start of the script and the phase removes what
              it wrote.
7. packed  -- the fine-tune config conf/llama_7b_flan_packed.yaml at LLaMA-7B
              width (PACKED_OVERRIDES: 4 layers, 8 rows of 512 tokens a
              microbatch, packing_factor 4, 2 microbatches, 4 steps) on a
              JSONL of synthetic {"inputs", "targets"} rows (FLAN's record
              format) written from a seed and a
              SentencePiece-Unigram tokenizer trained on them here
              (tokenizers + transformers), through `run_training` and
              `tokenizer_path`: finite losses, the expected first loss,
              exact launch counts with every call on the tensor cores and
              every flash call carrying segment ids (`segmented_counts`),
              the packing counters in the metrics line; the three flash
              kernels on the segment ids [8, 512] of each microbatch of step
              1 (at least one boundary a row inside the tiles, a pad tail)
              against their plain versions (out and dq exactly 0 on pad
              rows; the same calls without segment ids rejected), timed
              with and without them; the CE kernels on the run's hidden
              states, lm_head and mostly-IGNORE targets, and the prologue
              kernels on layer 0's input and weights with positions that
              restart in each segment, against their plain versions with
              planted faults (ignored tokens weighted, labels unshifted,
              positions not restarted, ...) rejected; step 1 again with
              flash (segment ids) against the exact op, the CE kernel head
              against the dense head and the prologue kernels against the
              composed prologue, in bf16 and fp32, each with a planted
              fault rejected; one packed row's fp32 logits through the
              kernels against each of its examples run alone. Prints the
              step time,
              tokens/s (row tokens and non-pad tokens), peak memory, the
              drop rate and what attention=auto picks at this shape. The run
              also evaluates a held-out JSONL (PACKED_EVAL_SEED) every 2
              steps: each eval's launches exactly (forward only, segment ids
              on every flash call), `real_tokens_per_sec` and `eval_loss` on
              the metrics lines, and the eval against the plain path
              (eval_parity, segments dropped as the planted fault).
8. eval    -- the trainer's slice (TRAIN_OVERRIDES + EVAL_OVERRIDES) with a
              held-out synthetic set at seq 2048 evaluated at steps 2 and 4,
              the state saved at step 4: each eval's launches exactly (the
              flash, prologue and CE forwards, no backward kernel, all on the
              tensor cores), parameters and optimizer moments bit-equal
              across an eval, the losses those of the trainer phase within
              RUN_REPEAT_TOL, checkpoint-4's meta.json carrying the last
              eval_loss and eval_step 4, the eval's (loss sum, count) against
              the plain path (exact attention, dense head, composed
              prologue) in bf16 and fp32 with a planted fault rejected.
              Prints eval ms per token, the forward kernels' device ms per
              call inside an eval (torch.profiler) and peak memory in eval
              against training.
9. preempt -- the checkpoint phase's run through the CLI in a subprocess,
              stopped with SIGTERM partway (PREEMPT_RUN): rc 0, a complete
              checkpoint-N and `latest` at the step the log names; resumed,
              its losses those of the checkpoint phase's uninterrupted run
              within RESUME_LOSS_TOL; a resume one batch late rejected.
10. remat  -- the slice with activation checkpointing under each policy of
              REMAT_TABLE: step 1's launches (forwards twice under a
              recomputing policy), ms, peak memory (not falling as the
              policy keeps more), loss and gradients against
              everything_saveable in bf16 and fp32.
11. pipeline -- conf/llama_7b_pp4.yaml with its own mesh.pp: 4 (every stage in
              this process on the one card, the local transport) at LLaMA-7B
              width cut to 8 layers (two a stage), seq 2048, 8 microbatches of
              1 row (PIPE_OVERRIDES), 3 steps through `run_training` under
              each of PIPE_SCHEDULES (flat 1f1b, interleaved_1f1b with
              virtual_stages 2, zb1 with virtual_stages 2): every loss finite,
              each of the nine kernels launched exactly as the unit grid
              says (pipeline_launches) and every call on the tensor cores;
              step ms, tokens/s, MFU, max_memory_allocated and the counted
              bubble per schedule, beside the unpipelined step at the same
              depth and microbatches with activation checkpointing on. Then
              step 1 again on the same params and batch: the flat pipeline
              against the unpipelined step (bf16 step loss; fp32 compute at
              4 microbatches: loss and gradients), interleaved and zb1
              against flat (the same tolerances; bit-equality reported), and
              the flat pipeline with one B unit's received cotangent zeroed
              rejected by the fp32 gradient check.

Prints one JSON line of per-kernel numbers, then the card's name and power
limit (nvidia-smi), then, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without that line when there is no CUDA device, outside a
checkout of the repository, or when any check fails.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): dense bf16
# tensor-core rate and HBM3 bandwidth, for the bound of each kernel
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

SLICE = dict(b=1, h=32, h_kv=32, s=2048, hd=128)
SMALL = dict(b=2, h=8, h_kv=2, s=256, hd=128, q_offset=64, kv_offset=128)
# bf16 on the tensor cores, ragged to every tile (q and kv tiles of 32, 64
# and 128 rows), sq != skv (a ring-attention slab), GQA 4:1, offsets, and
# segment ids of the global positions: batch row 0 ends in a pad tail (rows
# that see no key), row 1 has none, so the last keys and queries matter
SMALL_TC = dict(b=2, h=8, h_kv=2, sq=300, skv=333, hd=128, q_offset=100, kv_offset=37)
TRAIN_OVERRIDES = [
    "mesh.pp=1", "mesh.dp=1", "model.num_hidden_layers=4", "dataset.seq_length=2048",
    "max_seq_length=2048", "per_device_train_batch_size=1",
    "gradient_accumulation_steps=2", "max_steps=4", "total_steps=8", "warmup_steps=1",
    "attention=flash", "activation_checkpointing=false", "kernels.ce=pallas",
    "loss_vocab_chunks=4", "kernels.prologue=pallas", "save_final=false", "resume=false",
]
# the packed phase: conf/llama_7b_flan_packed.yaml (max_seq_length 512,
# packing_factor 4, 8 rows a microbatch, loss_vocab_chunks 4) at LLaMA-7B
# width, cut to 4 layers, 2 microbatches and one card, 4 steps, on a JSONL of
# synthetic {"inputs", "targets"} rows written from PACKED_SEED and a
# SentencePiece-Unigram tokenizer trained on it in the process (tokenizers +
# transformers)
PACKED_OVERRIDES = [
    "mesh.pp=1", "mesh.dp=1", "model.num_hidden_layers=4", "per_device_train_batch_size=8",
    "gradient_accumulation_steps=2", "max_steps=4", "total_steps=8", "warmup_steps=1",
    "attention=flash", "kernels.ce=pallas", "kernels.prologue=pallas", "save_final=false",
    "resume=false",
]
PACKED_SEED = 10
PACKED_ROWS = 1024
# synthetic data, not FLAN: words per prompt and per target in these ranges,
# lo * (hi / lo) ** (u * u) for u uniform in [0, 1), words of 1-3
# consonant-vowel syllables, PACKED_WORDS of them drawn Zipf-like. The skew to
# short is chosen, not measured: the tokenizer trained here splits a word into
# 2-3 pieces, and uniform lengths over these ranges put one example in each
# 512-token row (no segment boundary for the kernels to meet), where the
# config's packing_factor 4 expects about four. With the skew, rows hold 1-8
# examples and some examples fit no row; the drop rate and the segments per
# row describe this data only
PACKED_PROMPT_WORDS = (20, 300)
PACKED_TARGET_WORDS = (1, 60)
PACKED_WORDS = 1500
PACKED_TOKENIZER_VOCAB = 8000
# a segment boundary (or a pad tail's start) at a position that is not a
# multiple of TILE_EDGE lies inside a tile of every flash kernel (q tiles of 32
# in dk/dv, kv tiles of 64 in dq, 128 elsewhere); each microbatch the flash
# kernels are held on must hold at least one such boundary a row
TILE_EDGE = 32
# one packed row's logits against each of its examples run alone, fp32 compute
# through every kernel (the SIMT flash and prologue routes, cuBLAS without
# TF32): other segments add exact zeros, so only summation order moves them
PACKED_LOGIT_TOL = 1e-4
# the checkpoint phase: the slice cut to 2 layers (666.9 M parameters, 12
# bytes each on disk: fp32 weights and both Adam moments, ~8.0 GB). Run A
# trains 6 steps and saves the full state once, at step 4, in the background
# while steps 5-6 run (save_steps=4; a multiple of 2 would also save at the
# last step and prune step 4 away); run B resumes from it and takes steps 5-6
CKPT_OVERRIDES = TRAIN_OVERRIDES + ["model.num_hidden_layers=2", "max_steps=6"]
CKPT_RUN_A = ["save_steps=4", "save_final=false", "async_save=true", "save_total_limit=1",
              "resume=false"]
CKPT_RUN_B = ["save_steps=0", "save_final=false", "resume=true"]
CKPT_SAVE_STEP = 4
# B's losses against A's for the same steps, from the same restored state
RESUME_LOSS_TOL = 1e-5
# free disk the phase needs beyond one full-state checkpoint: the HF export
# and the converted checkpoint (fp32 params each), and 2 GiB of room
CKPT_DISK_SLACK = 2 * 2**30
# the fused CE head: the step's shape (tokens of one microbatch, width,
# vocab) and small cases ragged to every kernel tile (SIMT 128 x 128 x 16,
# tensor cores 128 x 256 x 64): vocab 1000 in chunks of 250 (bf16: the
# tensor-core forward, the SIMT backward: 250 is not a multiple of 8), 1088
# in chunks of 272 (bf16: tensor cores both ways) and 1004 in chunks of 251
# (bf16: SIMT both ways)
CE_SLICE = dict(n=2048, d=4096, v=32000)
CE_SMALL = dict(n=300, d=200, v=1000, chunks=4)
CE_SMALL_TC = dict(n=300, d=200, v=1088, chunks=4)
CE_SMALL_SIMT = dict(n=300, d=200, v=1004, chunks=4)
# the CUDA kernels of each bf16 CE pass on the tensor cores, by the TPU kernel
# each serves
CE_TC_KERNELS = {"ce_fwd": ("ce_stats_tc_kernel", "ce_lse_kernel"),
                 "ce_dh": ("ce_grad_tc_kernel", "ce_dh_tc_kernel"),
                 "ce_dw": ("ce_grad_tc_kernel", "ce_dw_tc_kernel")}
# the CUDA kernels of each bf16 prologue pass on the tensor cores, by the TPU
# kernel each serves
PRO_TC_KERNELS = {"prologue_fwd": ("prologue_norm_kernel", "prologue_fwd_tc_kernel"),
                  "prologue_dhidden": ("prologue_unrope_kernel", "prologue_dhidden_tc_kernel"),
                  "prologue_dw": ("prologue_norm_kernel", "prologue_unrope_kernel",
                                  "prologue_dw_tc_kernel")}
# the kernels whose products run on wgmma fed by TMA, by library: each must
# hold HGMMA and UTMALDG in its SASS
TC_PRODUCT_KERNELS = {"flash_attention": ("fwd_tc_kernel", "bwd_dq_tc_kernel",
                                          "bwd_dkv_tc_kernel"),
                      "fused_ce": ("ce_stats_tc_kernel", "ce_grad_tc_kernel", "ce_dh_tc_kernel",
                                   "ce_dw_tc_kernel"),
                      "fused_prologue": ("prologue_fwd_tc_kernel", "prologue_dhidden_tc_kernel",
                                         "prologue_dw_tc_kernel")}
# the fused prologue: one layer's shape at the step (tokens of one
# microbatch, width, q and kv heads) and a small case ragged to every tile
# (128 tokens x 128 features, depth 16), with MQA and positions from 37
PRO_SLICE = dict(b=1, s=2048, d=4096, h=32, kv=32, pos0=0)
PRO_SMALL = dict(b=2, s=150, d=200, h=4, kv=1, pos0=37)
PRO_SMALL_SIMT = dict(PRO_SMALL, d=196)  # bf16 off the tensor cores' grid
PRO_EPS = 1e-6
# bf16 outputs, held element by element to |got - ref| <= rtol * |ref| + atol:
# rounding an fp32 result to bf16 (8 significant bits, to nearest) costs at
# most 2^-8 of the element's own size; fp32 summation order and expf add
# ~1e-6 relative, which atol = 2^-8 * rms(ref) covers near zero
BF16_RTOL = 2.0 ** -8
# fp32 against fp32 (absolute): products of O(1) values over <= 2048 terms,
# in another summation order, and expf / logf against torch's
FP32_TOL = 1e-4
# bf16 q, k, v against the plain forward. Both round each projection to bf16
# before RoPE, but the kernel sums the fp32 product in another order (the
# tensor cores' own accumulation), so a projection whose fp32 value lies next
# to a rounding midpoint may round the other way: a whole bf16 step (up to
# 2^-7 of the element), which RoPE then carries into its output; near zero,
# where the sum cancels, both sums are off by more than a step. So q, k, v
# are not held to the 2^-8 rule but, bit for bit, to the plain forward of a
# projection moved by at most FLIP_RTOL x |p| + FLIP_ATOL x rms(p) from the
# plain fp32 value p (each element's RoPE is monotone in its own and its
# partner projection, so its output must lie between those of the bounds'
# four corners). At most FLIP_SHARE of the elements may differ at all.
FLIP_RTOL = 2.0 ** -10
FLIP_ATOL = 2.0 ** -10
FLIP_SHARE = 1e-2
# planted faults: how many keys (or queries) the kernels are made to miss
PLANT_CUT = 64
# the trainer, step 1 again on the same params and batch. In bf16 (the
# slice's compute dtype) any two implementations differ by more than their
# attention does: one rounding flip cascades through the bf16 GEMMs until
# every activation carries ~2^-8 relative noise, which moves per-token losses
# by up to ~5e-2 (measured on an H100 against exact attention computed in
# fp32 inside the bf16 model; 8.9e-2 against the bf16 exact path). So in
# bf16 only the step's mean loss is held to the exact path ...
STEP_LOSS_TOL = 2e-3
# ... and per-token losses and gradients are held in fp32 compute (the fp32
# kernels against exact attention): fp32 summation order only, ~1e-6
# relative, which the same cascade spreads to ~1e-5 on a loss of 11.2
TOKEN_LOSS_TOL = 1e-3  # max over the step's 4096 tokens of |loss_flash - loss_exact|
GRAD_REL_TOL = 1e-3    # ||g_flash - g_exact|| / ||g_exact|| over all parameters
# the CE kernel head against the dense head, and the prologue kernels against
# the composed prologue, fp32 compute: the same loss up to fp32 summation
# order (~1e-6 relative on a loss of 11.2); gradients within GRAD_REL_TOL.
# Step 1 recomputed on the run's path must repeat the run's loss.
FP32_STEP_LOSS_TOL = 1e-4
RUN_REPEAT_TOL = 1e-4
# the eval phase: the trainer's slice with a held-out synthetic set at seq
# 2048 (4 rows: 2 eval batches of 2 microbatches of 1 row), evaluated every 2
# steps, and the full state saved at step 4
EVAL_OVERRIDES = ["eval_dataset={synthetic: true, seq_length: 2048, pseudo_dataset_len: 4}",
                  "eval_steps=2", "save_steps=4"]
EVAL_SAVE_STEP = 4
# an eval's loss sum through the kernels against the plain path (exact
# attention, dense head, composed prologue) on the same params and batches, in
# fp32 compute: summation order only (~1e-7 of a loss of 11.2); the planted
# fault (the last PLANT_CUT keys hidden) moves the trainer phase's fp32 step
# loss by ~7e-5 of it on an H100. In bf16 the token mean is held to
# STEP_LOSS_TOL, as a step's loss.
EVAL_SUM_RTOL = 1e-5
# the packed phase's held-out set: rows from the same generator with another
# seed (2 eval batches of 2 microbatches of 8 rows of 4 examples)
PACKED_EVAL_SEED = 11
PACKED_EVAL_ROWS = 128
# the preemption phase: the checkpoint phase's run (CKPT_OVERRIDES) through the
# CLI in a subprocess, slowed at the `step` fault site so that the SIGTERM sent
# after its second logged step lands mid-run; then resumed in this process
PREEMPT_RUN = ["save_steps=0", "save_final=false", "resume=false", "logging_steps=1",
               "fault_plan={faults: [{site: step, op: slow, seconds: 0.5}]}"]
PREEMPT_RESUME = ["save_steps=0", "save_final=false", "resume=true"]
# the remat table: the slice with activation checkpointing, under each
# policy, in order of what it keeps; step 1's loss and gradients held to
# everything_saveable's (no remat): fp32 compute within REMAT_FP32_RTOL
# relative (recompute repeats the same kernels on the same inputs), bf16
# within STEP_LOSS_TOL
REMAT_TABLE = ("nothing_saveable", "dots_with_no_batch_dims_saveable", "dots_saveable",
               "everything_saveable")
REMAT_FP32_RTOL = 1e-6
# the pipeline phase: conf/llama_7b_pp4.yaml with its own mesh.pp: 4, every
# stage in this process on the one card, at LLaMA-7B width cut to 8 layers (two
# a stage; 1.88 B parameters, ~30 GB of fp32 masters, gradients and moments),
# seq 2048, 8 microbatches of 1 row (M = 2S: 1F1B reaches its steady state), 3
# steps a schedule. activation_checkpointing stays the config's (off): every
# unit schedule recomputes a stage's chunk in its backward anyway
PIPE_OVERRIDES = [
    "mesh.dp=1", "model.num_hidden_layers=8", "dataset.seq_length=2048",
    "max_seq_length=2048", "per_device_train_batch_size=1", "gradient_accumulation_steps=8",
    "max_steps=3", "total_steps=8", "warmup_steps=1", "attention=flash", "kernels.ce=pallas",
    "loss_vocab_chunks=4", "kernels.prologue=pallas", "save_final=false", "resume=false",
    "logging_steps=1",
]
PIPE_SCHEDULES = {
    "1f1b": [],
    "interleaved_1f1b": ["pipeline_schedule=interleaved_1f1b", "virtual_stages=2"],
    "zb1": ["pipeline_schedule=zb1", "virtual_stages=2"],
}
# the fp32 parity runs the first PIPE_FP32_MICROBATCHES rows of the batch (M = S)
PIPE_FP32_MICROBATCHES = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Median device time of one call, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tolerance(ref, fp32: bool) -> tuple[float, float]:
    """(rtol, atol) of an output held to |got - ref| <= rtol * |ref| + atol."""
    if fp32:
        return 0.0, FP32_TOL
    return BF16_RTOL, BF16_RTOL * ref.float().square().mean().sqrt().item()


def reading(got, ref, rtol: float, atol: float) -> tuple[float, float]:
    """(max |got - ref|, max over elements of |got - ref| / their limit)."""
    diff = (got.float() - ref.float()).abs()
    ratio = diff / (rtol * ref.float().abs() + atol)
    return diff.max().item(), ratio.max().item()


def check(name: str, got, ref, tol: tuple[float, float]) -> float:
    err, ratio = reading(got, ref, *tol)
    log(f"  {name}: max_abs_err {err:.3e}, worst err / limit {ratio:.3f} "
        f"(limit {tol[0]:.4g} x |ref| + {tol[1]:.3e})")
    if not math.isfinite(ratio) or ratio > 1.0:
        raise AssertionError(f"{name}: an element is {ratio} times its limit")
    return err


def expect_rejected(name: str, got, ref, tol: tuple[float, float]) -> None:
    err, ratio = reading(got, ref, *tol)
    log(f"  planted {name}: max_abs_err {err:.3e}, worst err / limit {ratio:.1f} "
        f"(must exceed 1)")
    if not ratio > 1.0:
        raise AssertionError(f"the check of {name} passes a planted fault "
                             f"(worst err / limit {ratio})")


def phase_build() -> None:
    from llama_pipeline_parallel_tpu_torch.ops import kernel_build

    sources = sorted(f[:-3] for f in os.listdir(kernel_build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.perf_counter()
    reports = kernel_build.build(sources)
    log(f"[build] {sources} built in {time.perf_counter() - t0:.1f} s "
        f"({'compiled' if reports else 'already built'})")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"[build] card: {card_line()}")


def make_inputs(b, h, h_kv, sq, skv, hd, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    return (randn(b, h, sq, hd), randn(b, h_kv, skv, hd), randn(b, h_kv, skv, hd),
            randn(b, h, sq, hd))


def kernel_case(fa, q, k, v, do, kw, fp32: bool, route: str, plant: bool = False) -> dict:
    """Run the three kernels on (q, k, v, do) and hold each against its plain
    version in fp32 on the same inputs (the bwd ones given the same lse and
    delta); the forward, dq and dk/dv must take `route`.
    Returns {kernel: max_abs_err}.

    With `plant`, the same check must reject each kernel made wrong in the last
    tiles only, on the same route: forward and dq run on K/V (and their
    segment ids) without the last PLANT_CUT keys (the last q block loses its
    diagonal tile), dk/dv on q, dO, lse, delta (and their segment ids)
    without the last PLANT_CUT queries (the last kv tile gets nothing)."""
    routes = {"fwd": route, "dq": route, "dkv": route}
    fa.reset_launch_counts()
    group = q.shape[1] // k.shape[1]
    k_full = k.repeat_interleave(group, dim=1).contiguous()
    v_full = v.repeat_interleave(group, dim=1).contiguous()
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    kf32, vf32 = k_full.float(), v_full.float()

    out, lse = fa._fwd_cuda(q, k, v, **kw)
    ref_out, ref_lse = fa._fwd_plain(q32, k32, v32, **kw)
    delta = (do32 * ref_out).sum(dim=-1, keepdim=True)
    dq = fa._bwd_dq_cuda(q, k_full, v_full, delta, ref_lse, do, **kw)
    dk, dv = fa._bwd_dkv_cuda(q, k_full, v_full, delta, ref_lse, do, **kw)
    ref_dq = fa._bwd_dq_plain(q32, kf32, vf32, delta, ref_lse, do32, **kw)
    ref_dk, ref_dv = fa._bwd_dkv_plain(q32, kf32, vf32, delta, ref_lse, do32, **kw)
    expect_routes(fa, routes, 1)
    log(f"  forward, dq and dk/dv route: {route} (tensor_core_counts "
        f"{fa.tensor_core_counts})")

    tol = {name: tolerance(ref, fp32) for name, ref in
           (("out", ref_out), ("dq", ref_dq), ("dk", ref_dk), ("dv", ref_dv))}
    empty = int((ref_lse <= fa.NEG_INF / 2).sum())
    log(f"  rows that see no key: {empty}")
    errs = {
        "fwd": max(check("fwd out", out, ref_out, tol["out"]),
                   check("fwd lse", lse, ref_lse, (0.0, FP32_TOL))),
        "dq": check("dq", dq, ref_dq, tol["dq"]),
        "dkv": max(check("dk", dk, ref_dk, tol["dk"]), check("dv", dv, ref_dv, tol["dv"])),
    }
    if plant:
        def cut(t):
            return t[:, :, :-PLANT_CUT].contiguous()

        def cut_ids(key):
            ids = kw[key]
            return dict(kw, **{key: None if ids is None else ids[:, :-PLANT_CUT].contiguous()})

        kw_keys, kw_queries = cut_ids("segments_kv"), cut_ids("segments_q")
        expect_rejected("fwd out (last keys hidden)",
                        fa._fwd_cuda(q, cut(k), cut(v), **kw_keys)[0], ref_out, tol["out"])
        expect_rejected("dq (last keys hidden)", fa._bwd_dq_cuda(
            q, cut(k_full), cut(v_full), delta, ref_lse, do, **kw_keys), ref_dq, tol["dq"])
        dk_bad, dv_bad = fa._bwd_dkv_cuda(cut(q), k_full, v_full, cut(delta), cut(ref_lse),
                                          cut(do), **kw_queries)
        expect_rejected("dk (last queries hidden)", dk_bad, ref_dk, tol["dk"])
        expect_rejected("dv (last queries hidden)", dv_bad, ref_dv, tol["dv"])
        expect_routes(fa, routes, 2)
    return errs


def causal_pairs(b, h, s) -> int:
    return b * h * s * (s + 1) // 2


def bounds(b, h, s, hd, elem_bytes, pairs: int | None = None, seg_bytes: int = 0) -> dict:
    """Least time of each kernel on the card: the larger of its bytes (each
    input read once, each output written once) over the memory rate and its
    operations (the (q, k) pairs this run needs: every causal pair, or the
    `pairs` the segment ids leave visible) over the bf16 peak. `seg_bytes`:
    the segment ids read."""
    tensor = b * h * s * hd * elem_bytes
    rows = b * h * s * 4
    pairs = causal_pairs(b, h, s) if pairs is None else pairs
    work = {  # (bytes moved, operations)
        "fwd": (4 * tensor + rows + seg_bytes, 2 * 2 * hd * pairs),     # q k v in, out + lse
        "dq": (5 * tensor + 2 * rows + seg_bytes, 3 * 2 * hd * pairs),  # q k v dO lse delta, dq
        "dkv": (6 * tensor + 2 * rows + seg_bytes, 4 * 2 * hd * pairs),  # ..., dk dv
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS
        out[name] = {"bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops else "operations"}
    return out


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[kernels] TF32 off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")
    sass_counts("flash_attention")

    c = SMALL
    log(f"[kernels] small case fp32 GQA {c['h']}:{c['h_kv']} s={c['s']} segments, "
        f"q_offset={c['q_offset']} kv_offset={c['kv_offset']} (tol {FP32_TOL})")
    q, k, v, do = make_inputs(c["b"], c["h"], c["h_kv"], c["s"], c["s"], c["hd"],
                              torch.float32, 1)
    seg = torch.zeros((c["b"], c["s"]), dtype=torch.int32, device="cuda")
    seg[0, :100], seg[0, 100:200] = 1, 2           # two segments, then a pad tail
    seg[1, :30], seg[1, 30:160], seg[1, 160:] = 3, 4, 5
    kw = dict(causal=True, scale=c["hd"] ** -0.5, q_offset=c["q_offset"],
              kv_offset=c["kv_offset"], segments_q=seg, segments_kv=seg)
    kernel_case(fa, q, k, v, do, kw, fp32=True, route=fa.SIMT)

    c = SMALL_TC
    log(f"[kernels] small case bf16 GQA {c['h']}:{c['h_kv']} sq={c['sq']} skv={c['skv']} "
        f"segments, q_offset={c['q_offset']} kv_offset={c['kv_offset']} vs the plain "
        f"version in fp32")
    q, k, v, do = make_inputs(c["b"], c["h"], c["h_kv"], c["sq"], c["skv"], c["hd"],
                              torch.bfloat16, 2)
    seg = torch.zeros((c["b"], c["q_offset"] + c["sq"]), dtype=torch.int32, device="cuda")
    seg[0, :180], seg[0, 180:340] = 1, 2           # by global position: a pad tail from 340
    seg[1, :250], seg[1, 250:] = 3, 4
    kw = dict(causal=True, scale=c["hd"] ** -0.5, q_offset=c["q_offset"],
              kv_offset=c["kv_offset"],
              segments_q=seg[:, c["q_offset"]:].contiguous(),
              segments_kv=seg[:, c["kv_offset"]:c["kv_offset"] + c["skv"]].contiguous())
    kernel_case(fa, q, k, v, do, kw, fp32=False, route=fa.TENSOR_CORE, plant=True)

    c = SLICE
    log(f"[kernels] slice shape b={c['b']} h={c['h']} s={c['s']} hd={c['hd']} bf16 causal "
        f"vs the plain version in fp32")
    q, k, v, do = make_inputs(c["b"], c["h"], c["h_kv"], c["s"], c["s"], c["hd"],
                              torch.bfloat16, 0)
    kw = dict(causal=True, scale=c["hd"] ** -0.5, q_offset=0, kv_offset=0,
              segments_q=None, segments_kv=None)
    errs = kernel_case(fa, q, k, v, do, kw, fp32=False, route=fa.TENSOR_CORE, plant=True)

    out, lse = fa._fwd_cuda(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    bwd_args = (q, k, v, delta, lse, do)
    timings = {
        "fwd": (cuda_ms(lambda: fa._fwd_cuda(q, k, v, **kw)),
                cuda_ms(lambda: fa._fwd_plain(q, k, v, **kw))),
        "dq": (cuda_ms(lambda: fa._bwd_dq_cuda(*bwd_args, **kw)),
               cuda_ms(lambda: fa._bwd_dq_plain(*bwd_args, **kw))),
        "dkv": (cuda_ms(lambda: fa._bwd_dkv_cuda(*bwd_args, **kw)),
                cuda_ms(lambda: fa._bwd_dkv_plain(*bwd_args, **kw))),
    }
    # yardstick only: one PyTorch call computing the same forward
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)

    sdpa_both = cuda_ms(sdpa_fwd_bwd)
    # its backward alone (dq, dk and dv in one call), the forward run once outside the timing
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True))
    del o
    log(f"[kernels] yardstick F.scaled_dot_product_attention: fwd {sdpa_fwd:.4f} ms, "
        f"bwd {sdpa_bwd:.4f} ms, fwd+bwd {sdpa_both:.4f} ms")
    library = {"fwd": sdpa_fwd, "dq": sdpa_bwd, "dkv": sdpa_bwd}

    bound = bounds(c["b"], c["h"], c["s"], c["hd"], 2)
    source = "llama_pipeline_parallel_tpu_torch/csrc/flash_attention.cu"
    replaces = {"fwd": "llama_pipeline_parallel_tpu/ops/flash_attention.py:194",
                "dq": "llama_pipeline_parallel_tpu/ops/flash_attention.py:343",
                "dkv": "llama_pipeline_parallel_tpu/ops/flash_attention.py:364"}
    names = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}
    rows = {}
    for key in ("fwd", "dq", "dkv"):
        ms, plain_ms = timings[key]
        rows[key] = {"name": names[key], "route": "cuda", "source": source,
                     "replaces": replaces[key], "launches": None,
                     "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
                     **bound[key], "library_ms": library[key]}
        log(f"  {names[key]}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{bound[key]['bound_ms']:.4f} ms by {bound[key]['bound_by']})")
    return rows


def ce_inputs(n, d, v, dtype, seed, w_scale):
    """h [n, d], w [d, V] in `dtype`; int32 safe targets with some tokens
    ignored and targets on every 4-chunk edge and in the last PLANT_CUT vocab
    columns; svec = valid * 0.37 (a cotangent that is not 1)."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc

    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(n, d, generator=g, device="cuda").to(dtype)
    w = (w_scale * torch.randn(d, v, generator=g, device="cuda")).to(dtype)
    t = torch.randint(0, v, (n,), generator=g, device="cuda")
    vc = v // 4
    edges = [0, vc - 1, vc, 2 * vc - 1, 2 * vc, 3 * vc - 1, 3 * vc, v - PLANT_CUT, v - 2, v - 1]
    t[:len(edges)] = torch.tensor(edges, device="cuda")
    t[len(edges)::37] = fc.IGNORE_INDEX
    valid = t != fc.IGNORE_INDEX
    safe_t = torch.where(valid, t, 0).to(torch.int32)
    return h, w, safe_t, valid.float() * 0.37


def expect_routes(module, routes: dict, calls: int) -> None:
    """The calls since the last reset of `module`'s counts took `routes`
    ({pass: route}): the tensor cores counted every one of `calls` calls of
    each pass whose route is TENSOR_CORE, and none of the others."""
    want = {key: calls if route == module.TENSOR_CORE else 0 for key, route in routes.items()}
    if module.tensor_core_counts != want:
        raise AssertionError(f"tensor_core_counts {module.tensor_core_counts}, expected {want}: "
                             f"the calls did not take the routes {routes}")


def ce_case(h, w, safe_t, svec, chunks: int, fp32: bool, routes: tuple[str, str],
            plant: bool = False) -> dict:
    """Run the three CE kernels and hold each against its plain version in
    fp32 on the same inputs (the backward ones given the same lse, with g
    rounded to the inputs' dtype as the kernels round it); the forward must
    take routes[0], the backward routes[1]. Returns {kernel: max_abs_err}.

    With `plant`, the same check must reject each kernel made wrong at the
    edge only: forward and dh on W without its last PLANT_CUT vocab columns
    (the tokens whose target lay there lose it), dW on the tokens without
    the last PLANT_CUT; the planted calls take the same routes."""
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc

    route = dict(zip(("ce_fwd", "ce_dh", "ce_dw"), (routes[0], routes[1], routes[1])))
    hf, wf = h.float(), w.float()
    fc.reset_launch_counts()
    lse, tgt = fc._fwd_stats_cuda(h, w, safe_t, chunks)
    ref_lse, ref_tgt = fc._fwd_stats_plain(hf, wf, safe_t, chunks)
    dh, dw = fc._backward_cuda(h, w, safe_t, ref_lse, svec, chunks)
    expect_routes(fc, route, 1)
    log(f"  forward route: {routes[0]}, backward route: {routes[1]} (tensor_core_counts "
        f"{fc.tensor_core_counts})")
    ref_dh = fc._dh_plain(hf, wf, safe_t, ref_lse, svec, chunks, g_dtype=h.dtype)
    ref_dw = fc._dw_plain(hf, wf, safe_t, ref_lse, svec, chunks, g_dtype=h.dtype)
    tol = {"dh": tolerance(ref_dh, fp32), "dw": tolerance(ref_dw, fp32)}
    errs = {"ce_fwd": max(check("ce lse", lse, ref_lse, (0.0, FP32_TOL)),
                          check("ce tgt", tgt, ref_tgt, (0.0, FP32_TOL))),
            "ce_dh": check("ce dh", dh, ref_dh, tol["dh"]),
            "ce_dw": check("ce dW", dw, ref_dw, tol["dw"])}
    if plant:
        cut_w = w[:, :-PLANT_CUT].contiguous()
        lse_bad, tgt_bad = fc._fwd_stats_cuda(h, cut_w, safe_t, chunks)
        expect_rejected("ce lse (last vocab columns hidden)", lse_bad, ref_lse, (0.0, FP32_TOL))
        expect_rejected("ce tgt (last vocab columns hidden)", tgt_bad, ref_tgt, (0.0, FP32_TOL))
        expect_rejected("ce dh (last vocab columns hidden)",
                        fc._dh_cuda(h, cut_w, safe_t, ref_lse, svec, chunks), ref_dh, tol["dh"])
        keep = slice(0, h.shape[0] - PLANT_CUT)
        expect_rejected("ce dW (last tokens hidden)",
                        fc._dw_cuda(h[keep], w, safe_t[keep], ref_lse[keep], svec[keep], chunks),
                        ref_dw, tol["dw"])
        expect_routes(fc, route, 2)  # and the cut forward, dh and dW calls
    return errs


def sass_counts(library: str) -> None:
    """Log the HGMMA (wgmma) and UTMALDG (TMA load) instructions of each
    tensor-core product kernel of `library` (TC_PRODUCT_KERNELS) in its SASS;
    fail if one has none. Says so plainly where the toolkit has no cuobjdump."""
    import shutil

    from llama_pipeline_parallel_tpu_torch.ops import kernel_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        log(f"[sass] cuobjdump is absent ({tool}); HGMMA / UTMALDG not counted")
        return
    sass = subprocess.run([tool, "-sass", kernel_build.library_path(library)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    kernels = set(TC_PRODUCT_KERNELS[library])
    counts = {}
    for function in sass.split("Function : ")[1:]:
        lines = function.splitlines()
        name = next((k for k in kernels if k in lines[0]), None)
        if name:
            counts[name] = {op: sum(op in line for line in lines) for op in ("HGMMA", "UTMALDG")}
    log(f"[sass] {library} library (cuobjdump -sass): {counts}")
    if set(counts) != kernels or not all(c["HGMMA"] and c["UTMALDG"] for c in counts.values()):
        raise AssertionError(f"the tensor-core kernels of {library} lack HGMMA or UTMALDG: "
                             f"{counts}")


def ce_bounds(n, d, v, elem_bytes) -> dict:
    """Least time of each CE kernel (and of the dh + dW pair, which shares
    one logits recompute) on the card: the larger of its bytes (each input
    read once, each output written once) over the memory rate and its
    operations over the bf16 peak. A product is 2 n d V operations: the
    forward does one; dh and dW, as the TPU kernels define them, a recompute
    and their own product each; the pair three."""
    flops = 2 * n * d * v
    ins = (n * d + d * v) * elem_bytes + 3 * n * 4        # h, W; t, lse, s
    work = {  # (bytes moved, operations)
        "ce_fwd": (ins - n * 4 + 2 * n * 4, flops),         # h W t in, lse tgt out
        "ce_dh": (ins + n * d * 4, 2 * flops),              # dh fp32 out
        "ce_dw": (ins + d * v * elem_bytes, 2 * flops),     # dW out
        "pair": (ins + n * d * 4 + d * v * elem_bytes, 3 * flops),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS
        out[name] = {"bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops else "operations"}
    return out


def phase_ce() -> dict:
    import torch

    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    sass_counts("fused_ce")
    tc, simt = fc.TENSOR_CORE, fc.SIMT
    for c, dtype, routes in ((CE_SMALL, torch.float32, (simt, simt)),
                             (CE_SMALL, torch.bfloat16, (tc, simt)),
                             (CE_SMALL_TC, torch.float32, (simt, simt)),
                             (CE_SMALL_TC, torch.bfloat16, (tc, tc)),
                             (CE_SMALL_SIMT, torch.bfloat16, (simt, simt))):
        fp32 = dtype == torch.float32
        tol = f"tol {FP32_TOL}" if fp32 else "vs the plain version in fp32"
        log(f"[ce] small case {'fp32' if fp32 else 'bf16'} n={c['n']} d={c['d']} V={c['v']} "
            f"chunks={c['chunks']} (ragged to every tile; {tol})")
        h, w, safe_t, svec = ce_inputs(c["n"], c["d"], c["v"], dtype, 2, w_scale=0.3)
        ce_case(h, w, safe_t, svec, c["chunks"], fp32=fp32, routes=routes, plant=not fp32)

    c = CE_SLICE
    for chunks in (1, 4):
        log(f"[ce] slice shape n={c['n']} d={c['d']} V={c['v']} bf16, {chunks} vocab "
            f"chunk(s), vs the plain version in fp32")
        h, w, safe_t, svec = ce_inputs(c["n"], c["d"], c["v"], torch.bfloat16, 3, w_scale=0.02)
        log(f"  ignored tokens: {int((svec == 0).sum())}")
        errs = ce_case(h, w, safe_t, svec, chunks, fp32=False, routes=(tc, tc),
                       plant=chunks == 4)
        torch.cuda.empty_cache()

    lse, _ = fc._fwd_stats_cuda(h, w, safe_t, chunks)
    bwd = (h, w, safe_t, lse, svec, chunks)
    timings = {
        "ce_fwd": (cuda_ms(lambda: fc._fwd_stats_cuda(h, w, safe_t, chunks)),
                   cuda_ms(lambda: fc._fwd_stats_plain(h, w, safe_t, chunks))),
        "ce_dh": (cuda_ms(lambda: fc._dh_cuda(*bwd)), cuda_ms(lambda: fc._dh_plain(*bwd))),
        "ce_dw": (cuda_ms(lambda: fc._dw_cuda(*bwd)), cuda_ms(lambda: fc._dw_plain(*bwd))),
    }
    pair_ms = cuda_ms(lambda: fc._backward_cuda(*bwd))
    # yardsticks only: cuBLAS on each product the kernels compute
    g = torch.randn(c["n"], c["v"], device="cuda").to(torch.bfloat16)
    library = {"ce_fwd": cuda_ms(lambda: h @ w), "ce_dh": cuda_ms(lambda: g @ w.T),
               "ce_dw": cuda_ms(lambda: h.T @ g)}
    del g
    torch.cuda.empty_cache()
    bound = ce_bounds(c["n"], c["d"], c["v"], 2)
    log(f"[ce] yardsticks (cuBLAS bf16): h @ W {library['ce_fwd']:.4f} ms, g @ W^T "
        f"{library['ce_dh']:.4f} ms, h^T @ g {library['ce_dw']:.4f} ms")
    log(f"[ce] dh + dW pair (one recompute): {pair_ms:.4f} ms (bound "
        f"{bound['pair']['bound_ms']:.4f} ms by {bound['pair']['bound_by']})")
    source = "llama_pipeline_parallel_tpu_torch/csrc/fused_ce.cu"
    replaces = {"ce_fwd": "llama_pipeline_parallel_tpu/ops/pallas_ce.py:111",
                "ce_dh": "llama_pipeline_parallel_tpu/ops/pallas_ce.py:222",
                "ce_dw": "llama_pipeline_parallel_tpu/ops/pallas_ce.py:239"}
    rows = {}
    for key in ("ce_fwd", "ce_dh", "ce_dw"):
        ms, plain_ms = timings[key]
        rows[key] = {"name": key, "route": "cuda", "source": source,
                     "replaces": replaces[key], "launches": None, "max_abs_err": errs[key],
                     "ms": ms, "plain_ms": plain_ms, **bound[key],
                     "library_ms": library[key]}
        # bf16 takes the tensor-core kernels
        rows[key]["cuda_kernels"] = " + ".join(CE_TC_KERNELS[key]) + " (tensor cores)"
        log(f"  {key}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{bound[key]['bound_ms']:.4f} ms by {bound[key]['bound_by']})")
    return rows


def prologue_inputs(b, s, d, h, kv, pos0, dtype, seed) -> dict:
    """One layer's prologue inputs on the card: x [n, d], the fp32 norm weight
    1 + 0.1 randn, weights 0.02 randn in `dtype`, cos / sin of positions
    pos0 .. pos0 + s - 1 in each of b rows, and random cotangents dq, dk, dv."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ops.fused_prologue import KERNEL_HEAD_DIMS
    from llama_pipeline_parallel_tpu_torch.ops.rope import rope_cos_sin

    hd, n = KERNEL_HEAD_DIMS[0], b * s
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dtype)

    pos = (pos0 + torch.arange(s, device="cuda")).expand(b, s)
    cos, sin = (t.reshape(n, hd).contiguous() for t in rope_cos_sin(pos, hd, dtype=dtype))
    return dict(x=randn(n, d), norm_w=1 + 0.1 * torch.randn(d, generator=g, device="cuda"),
                wq=randn(d, h * hd, scale=0.02), wk=randn(d, kv * hd, scale=0.02),
                wv=randn(d, kv * hd, scale=0.02), cos=cos, sin=sin, dq=randn(n, h * hd),
                dk=randn(n, kv * hd), dv=randn(n, kv * hd), hd=hd)


def projection_bounds(p32, dtype):
    """(lo, hi) as fp32: the roundings to `dtype` of p32 moved down and up
    by FLIP_RTOL x |p32| + FLIP_ATOL x rms(p32)."""
    slack = FLIP_RTOL * p32.abs() + FLIP_ATOL * p32.square().mean().sqrt()
    return (p32 - slack).to(dtype).float(), (p32 + slack).to(dtype).float()


def rope_of(pa, pb, cos, sin, hd, dtype):
    """The plain RoPE of q or k (`fused_prologue._rope_plain`: each product
    and the sum rounded to `dtype`), each column's own projection taken from
    pa and its rotate_half partner's from pb."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ops.fused_prologue import _rnd

    n, half = pa.shape[0], hd // 2
    a3, b3 = pa.reshape(n, -1, hd), pb.reshape(n, -1, hd)
    rot = torch.cat([-b3[..., half:], b3[..., :half]], dim=-1)
    out = _rnd(a3 * cos.float()[:, None], dtype) + _rnd(rot * sin.float()[:, None], dtype)
    return _rnd(out, dtype).reshape(n, -1)


def forward_flips(inp: dict, out) -> dict:
    """{q, k, v: (elements outside the bounds' outputs, share of elements off
    the plain version, max |got - plain|)} for bf16 outputs (see FLIP_RTOL)."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp

    x, cos, sin, hd = inp["x"], inp["cos"], inp["sin"], inp["hd"]
    hidden = fp._hidden_plain(x, inp["norm_w"], PRO_EPS)
    res = {}
    for name, got in zip("qkv", out):
        p32 = hidden @ inp[f"w{name}"].float()
        plain = p32.to(x.dtype).float()
        lo, hi = projection_bounds(p32, x.dtype)
        if name != "v":
            plain = rope_of(plain, plain, cos, sin, hd, x.dtype)
            corners = [rope_of(a, b, cos, sin, hd, x.dtype) for a in (lo, hi) for b in (lo, hi)]
            lo = torch.stack(corners).amin(dim=0)
            hi = torch.stack(corners).amax(dim=0)
            del corners
        g = got.float()
        res[name] = (int(((g < lo) | (g > hi)).sum()), (g != plain).float().mean().item(),
                     (g - plain).abs().max().item())
    return res


def check_forward_flips(inp: dict, out) -> float:
    """Hold bf16 q, k, v to the plain forward up to rounding flips. Returns
    the max |got - plain|."""
    worst = 0.0
    for name, (off, share, err) in forward_flips(inp, out).items():
        log(f"  prologue {name}: {off} elements outside the rounding bounds, {share:.2e} of "
            f"the elements off the plain version (limit {FLIP_SHARE}), max_abs_err {err:.3e}")
        if off or not share <= FLIP_SHARE:
            raise AssertionError(f"prologue {name}: {off} elements outside the rounding bounds "
                                 f"of the plain forward, {share} of them off it")
        worst = max(worst, err)
    return worst


def prologue_case(inp: dict, fp32: bool, route: str, plant: bool = False) -> dict:
    """Run the three prologue kernels and hold each against its plain version
    on the same inputs (the plain versions round where the kernels do); the
    forward, dhidden and dW must each take `route`. Returns {kernel:
    max_abs_err}.

    With `plant`, the same check must reject each kernel made wrong at the
    edge only: forward and dhidden on weights whose last PLANT_CUT input rows
    are zero, dW on the tokens without the last PLANT_CUT; the planted calls
    take `route` too."""
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp

    x, nw, cos, sin, hd = inp["x"], inp["norm_w"], inp["cos"], inp["sin"], inp["hd"]
    w = (inp["wq"], inp["wk"], inp["wv"])
    dy = (inp["dq"], inp["dk"], inp["dv"])
    routes = {key: route for key in fp.launch_counts}
    fp.reset_launch_counts()
    out = fp._fwd_cuda(x, nw, *w, cos, sin, PRO_EPS, hd)
    dh = fp._dhidden_cuda(*dy, *w, cos, sin, hd)
    ref_dh = fp._dhidden_plain(*dy, *w, cos, sin, hd)
    dw = fp._dw_cuda(x, nw, *dy, cos, sin, PRO_EPS, hd)
    expect_routes(fp, routes, 1)
    log(f"  forward, dhidden and dW route: {route} (tensor_core_counts "
        f"{fp.tensor_core_counts})")
    ref_dw = fp._dw_plain(x, nw, *dy, cos, sin, PRO_EPS, hd)
    tol = {name: tolerance(r, fp32) for name, r in
           zip(("dh", "dwq", "dwk", "dwv"), (ref_dh, *ref_dw))}
    if fp32:
        fwd_err = max(check(f"prologue {name}", got, r, (0.0, FP32_TOL)) for name, got, r
                      in zip("qkv", out, fp._fwd_plain(x, nw, *w, cos, sin, PRO_EPS, hd)))
    else:
        fwd_err = check_forward_flips(inp, out)
    errs = {"prologue_fwd": fwd_err,
            "prologue_dhidden": check("prologue dhidden", dh, ref_dh, tol["dh"]),
            "prologue_dw": max(check(f"prologue {name}", got, r, tol[name]) for name, got, r
                               in zip(("dwq", "dwk", "dwv"), dw, ref_dw))}
    if plant:
        def cut(t):
            t = t.clone()
            t[-PLANT_CUT:] = 0
            return t

        w_bad = [cut(t) for t in w]
        bad = forward_flips(inp, fp._fwd_cuda(x, nw, *w_bad, cos, sin, PRO_EPS, hd))
        for name, (off, share, err) in bad.items():
            log(f"  planted prologue {name} (last weight rows zero): {off} elements outside the "
                f"rounding bounds, {share:.2e} off the plain version (must exceed 0 or "
                f"{FLIP_SHARE})")
            if not off and share <= FLIP_SHARE:
                raise AssertionError(f"the check of prologue {name} passes a planted fault")
        expect_rejected("prologue dhidden (last weight rows zero)",
                        fp._dhidden_cuda(*dy, *w_bad, cos, sin, hd), ref_dh, tol["dh"])
        keep = slice(0, x.shape[0] - PLANT_CUT)
        dw_bad = fp._dw_cuda(x[keep], nw, *(t[keep] for t in dy), cos[keep], sin[keep], PRO_EPS,
                             hd)
        for name, got, r in zip(("dwq", "dwk", "dwv"), dw_bad, ref_dw):
            expect_rejected(f"prologue {name} (last tokens hidden)", got, r, tol[name])
        expect_routes(fp, routes, 2)  # and the planted forward, dhidden and dW calls
    return errs


def prologue_bounds(n, d, width, hd, elem_bytes) -> dict:
    """Least time of each prologue kernel on the card: the larger of its bytes
    (each input read once, each output written once) over the memory rate and
    its operations (one product of 2 n d width, width = the q, k and v widths
    together) over the bf16 peak."""
    ops = 2 * n * d * width
    x, weights, rows = n * d * elem_bytes, d * width * elem_bytes, n * width * elem_bytes
    trig = 2 * n * hd * elem_bytes                      # cos, sin
    work = {  # (bytes moved, operations)
        "prologue_fwd": (x + d * 4 + weights + trig + rows, ops),        # x nw W cos sin, q k v
        "prologue_dhidden": (rows + weights + trig + n * d * 4, ops),    # dq dk dv W, dh fp32
        "prologue_dw": (x + d * 4 + rows + trig + weights, ops),         # x nw dq dk dv, dW
    }
    out = {}
    for name, (nbytes, n_ops) in work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, n_ops / PEAK_BF16_FLOPS
        out[name] = {"bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops else "operations"}
    return out


def phase_prologue() -> dict:
    import torch

    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.ops.rmsnorm import rms_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    sass_counts("fused_prologue")
    tc, simt = fp.TENSOR_CORE, fp.SIMT
    for c, dtype, route in ((PRO_SMALL, torch.float32, simt),
                            (PRO_SMALL, torch.bfloat16, tc),
                            (PRO_SMALL_SIMT, torch.bfloat16, simt)):
        fp32 = dtype == torch.float32
        tol = f"tol {FP32_TOL}" if fp32 else "vs the plain version (fp32 math, bf16 rounding points)"
        log(f"[prologue] small case {'fp32' if fp32 else 'bf16'} {c['b']} x {c['s']} tokens "
            f"d={c['d']} MQA {c['h']}:{c['kv']} positions from {c['pos0']} (ragged to every "
            f"tile; {tol})")
        prologue_case(prologue_inputs(**c, dtype=dtype, seed=5), fp32=fp32, route=route,
                      plant=not fp32)

    c = PRO_SLICE
    log(f"[prologue] slice shape {c['s']} tokens d={c['d']} heads {c['h']}:{c['kv']} bf16, vs "
        f"the plain version (fp32 math, bf16 rounding points)")
    inp = prologue_inputs(**c, dtype=torch.bfloat16, seed=6)
    errs = prologue_case(inp, fp32=False, route=tc, plant=True)
    torch.cuda.empty_cache()

    x, nw, cos, sin, hd = inp["x"], inp["norm_w"], inp["cos"], inp["sin"], inp["hd"]
    w = (inp["wq"], inp["wk"], inp["wv"])
    dy = (inp["dq"], inp["dk"], inp["dv"])
    fwd = (x, nw, *w, cos, sin, PRO_EPS, hd)
    dh = (*dy, *w, cos, sin, hd)
    dw = (x, nw, *dy, cos, sin, PRO_EPS, hd)
    timings = {
        "prologue_fwd": (cuda_ms(lambda: fp._fwd_cuda(*fwd)), cuda_ms(lambda: fp._fwd_plain(*fwd))),
        "prologue_dhidden": (cuda_ms(lambda: fp._dhidden_cuda(*dh)),
                             cuda_ms(lambda: fp._dhidden_plain(*dh))),
        "prologue_dw": (cuda_ms(lambda: fp._dw_cuda(*dw)), cuda_ms(lambda: fp._dw_plain(*dw))),
    }
    # yardsticks only: cuBLAS on the product each kernel computes
    hidden = rms_norm(x, nw, PRO_EPS)
    w_all, dy_all = torch.cat(w, dim=1), torch.cat(dy, dim=1)
    library = {"prologue_fwd": cuda_ms(lambda: hidden @ w_all),
               "prologue_dhidden": cuda_ms(lambda: dy_all @ w_all.T),
               "prologue_dw": cuda_ms(lambda: hidden.T @ dy_all)}
    del w_all, dy_all
    torch.cuda.empty_cache()
    log(f"[prologue] yardsticks (cuBLAS bf16): hidden @ [wq|wk|wv] "
        f"{library['prologue_fwd']:.4f} ms, [dq|dk|dv] @ [wq|wk|wv]^T "
        f"{library['prologue_dhidden']:.4f} ms, hidden^T @ [dq|dk|dv] "
        f"{library['prologue_dw']:.4f} ms")
    width = sum(t.shape[1] for t in w)
    bound = prologue_bounds(x.shape[0], x.shape[1], width, hd, 2)
    source = "llama_pipeline_parallel_tpu_torch/csrc/fused_prologue.cu"
    replaces = {"prologue_fwd": "llama_pipeline_parallel_tpu/ops/pallas_prologue.py:117",
                "prologue_dhidden": "llama_pipeline_parallel_tpu/ops/pallas_prologue.py:198",
                "prologue_dw": "llama_pipeline_parallel_tpu/ops/pallas_prologue.py:215"}
    rows = {}
    for key in ("prologue_fwd", "prologue_dhidden", "prologue_dw"):
        ms, plain_ms = timings[key]
        rows[key] = {"name": key, "route": "cuda", "source": source,
                     "replaces": replaces[key], "launches": None, "max_abs_err": errs[key],
                     "ms": ms, "plain_ms": plain_ms, **bound[key],
                     "library_ms": library[key]}
        if key in PRO_TC_KERNELS:  # bf16 takes the tensor-core kernels
            rows[key]["cuda_kernels"] = " + ".join(PRO_TC_KERNELS[key]) + " (tensor cores)"
        log(f"  {key}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{bound[key]['bound_ms']:.4f} ms by {bound[key]['bound_by']})")
    return rows


def phase_trainer() -> tuple[dict, list]:
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.train import (
        build_model_config,
        build_run,
        run_training,
    )
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    cfg = load_config(config, TRAIN_OVERRIDES + [f"output_dir={out_dir}/flash"])
    layers = cfg["model"]["num_hidden_layers"]
    microbatches = cfg["gradient_accumulation_steps"] * cfg["max_steps"]
    expected = {**{key: layers * microbatches for key in fa.launch_counts},
                **{key: microbatches for key in fc.launch_counts},
                **{key: layers * microbatches for key in fp.launch_counts}}
    log(f"[trainer] {config} {' '.join(TRAIN_OVERRIDES)}")

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    fc.reset_launch_counts()
    fp.reset_launch_counts()
    summary = run_training(cfg, device="cuda")
    launches = {**fa.launch_counts, **fc.launch_counts, **fp.launch_counts}
    tensor_core = {**fa.tensor_core_counts, **fc.tensor_core_counts, **fp.tensor_core_counts}
    losses = summary["losses"]
    step_ms = 1e3 * statistics.median(summary["step_times"][1:])
    log(f"[trainer] losses {losses}")
    log(f"[trainer] step {step_ms:.1f} ms (median of steps 2-{len(losses)}), "
        f"{summary['tokens_per_step'] / step_ms * 1e3:.0f} tokens/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"kernel launches {launches} (expected {expected}), calls on the tensor cores "
        f"{tensor_core}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected} (flash and "
                             f"prologue: {layers} layers x microbatches x steps; CE: "
                             f"microbatches x steps)")
    want_tc = {**{key: layers * microbatches for key in fa.tensor_core_counts},
               **{key: microbatches for key in fc.tensor_core_counts},
               **{key: layers * microbatches for key in fp.tensor_core_counts}}
    if tensor_core != want_tc:
        raise AssertionError(f"calls on the tensor cores {tensor_core}, expected {want_tc} "
                             f"(the bf16 slice is on their grid)")
    # at init the logits are about normal with variance 0.02^2 * d (lm_head
    # std 0.02 over a unit-rms hidden), so the expected loss is ln V + var / 2
    mcfg = build_model_config(cfg["model"])
    expected_loss = math.log(mcfg.vocab_size) + 0.02 ** 2 * mcfg.hidden_size / 2
    if abs(losses[0] - expected_loss) > 0.1:
        raise AssertionError(f"first loss {losses[0]} far from {expected_loss:.3f}, "
                             f"the expectation at random init")
    del summary
    gc.collect()
    torch.cuda.empty_cache()

    run = build_run(load_config(config, TRAIN_OVERRIDES + [f"output_dir={out_dir}/parity"]),
                    "cuda")
    step_parity(run, (f"last {PLANT_CUT} keys hidden", hide_last_keys), losses[0], "[trainer]")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses


def hide_last_keys(q, k, v, padding_mask=None, *, causal=True):
    """Flash attention that misses the last PLANT_CUT keys, so the last q
    block loses its diagonal tile (a planted fault)."""
    from llama_pipeline_parallel_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k[:, :-PLANT_CUT], v[:, :-PLANT_CUT], None, causal=causal)


def step_parity(run, plant: tuple, run_loss: float, tag: str) -> None:
    """Step 1 of a run again on `run`, a fresh build_run of its config (the
    same seed: the params and the batch the run started from), three ways:
    flash against exact attention (attention_parity, with the attention
    fault `plant`), the CE kernel head against the dense head (ce_parity)
    and the prologue kernels against the composed prologue
    (prologue_parity), each with its planted fault."""
    import gc

    import torch

    attention_parity(run, plant, tag)
    for check_one in (lambda: ce_parity(run, run_loss, tag), lambda: prologue_parity(run, tag)):
        for p in run.state.params.values():
            p.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        check_one()


def attention_parity(run, plant: tuple, tag: str) -> None:
    """Step 1 of a run again, on the params and batch the trainer's run
    started from (`run` is a fresh build_run of the same config, same seed),
    on the run's prologue, with the run's flash attention and with exact
    attention (given the batch's segment ids): in bf16 the step loss; in fp32
    compute the per-token losses and the gradients, which attention decides
    (the mean loss at random init barely depends on it). A planted fault,
    `plant` = (what it does, an attention function), must fail the per-token
    check."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
    from llama_pipeline_parallel_tpu_torch.ops.attention import attention
    from llama_pipeline_parallel_tpu_torch.parallel.train_step import shift_labels

    batch = next(run.batches())
    params = run.state.params
    targets = shift_labels(batch["labels"])
    count = (targets != llama.IGNORE_INDEX).sum()
    mb = targets.shape[0] // run.num_microbatches

    def step_one(attn_fn, mcfg, grad: bool):
        """Per-token losses of step 1 ([tokens] fp32) and, with `grad`, the
        gradients of the step's mean loss."""
        for p in params.values():
            p.grad = None
        losses = []
        for i in range(run.num_microbatches):
            rows = slice(i * mb, (i + 1) * mb)
            with torch.set_grad_enabled(grad):
                logits = llama.forward(params, batch["input_ids"][rows],
                                       batch["attention_mask"][rows],
                                       batch["position_ids"][rows], cfg=mcfg,
                                       attn_fn=attn_fn, kernel_prologue=run.kernel_prologue)
                tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                      targets[rows].reshape(-1).long(),
                                      ignore_index=llama.IGNORE_INDEX, reduction="none")
                if grad:
                    (tok.sum() / count).backward()
            losses.append(tok.detach())
            del logits
        grads = {k: p.grad for k, p in params.items()} if grad else None
        return torch.cat(losses), grads

    def mean(tok) -> float:
        return tok.sum().item() / count.item()

    bf16 = run.model_cfg
    flash_bf16, _ = step_one(run.attn_fn, bf16, grad=False)
    exact_bf16, _ = step_one(attention, bf16, grad=False)
    step_diff = abs(mean(flash_bf16) - mean(exact_bf16))

    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    flash_tok, flash_grads = step_one(run.attn_fn, fp32, grad=True)
    flash_grads = {k: g.clone() for k, g in flash_grads.items()}
    exact_tok, exact_grads = step_one(attention, fp32, grad=True)
    tok_diff = (flash_tok - exact_tok).abs().max().item()
    grad_rel = rel_diff(flash_grads, exact_grads)
    del flash_grads, exact_grads
    log(f"{tag} step 1 on the same params and batch, flash vs exact attention: bf16 "
        f"step loss |diff| {step_diff:.3e} (tol {STEP_LOSS_TOL}; per-token max |diff| "
        f"{(flash_bf16 - exact_bf16).abs().max().item():.3e}, not held); fp32 per-token "
        f"loss max |diff| {tok_diff:.3e} (tol {TOKEN_LOSS_TOL}), gradient rel diff "
        f"{grad_rel:.3e} (tol {GRAD_REL_TOL})")
    if not step_diff <= STEP_LOSS_TOL:
        raise AssertionError(f"flash vs exact step loss differ by {step_diff}")
    if not tok_diff <= TOKEN_LOSS_TOL:
        raise AssertionError(f"flash vs exact per-token losses differ by {tok_diff}")
    if not grad_rel <= GRAD_REL_TOL:
        raise AssertionError(f"flash vs exact gradients differ by {grad_rel} (relative)")

    bad_tok, _ = step_one(plant[1], fp32, grad=False)
    bad_diff = (bad_tok - exact_tok).abs().max().item()
    log(f"{tag} planted fault ({plant[0]}), fp32: per-token loss "
        f"max |diff| {bad_diff:.3e}, step loss |diff| {abs(mean(bad_tok) - mean(exact_tok)):.3e}")
    if not bad_diff > TOKEN_LOSS_TOL:
        raise AssertionError(f"the per-token check passes a planted fault ({bad_diff})")


def rel_diff(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over all the tensors of two gradient dicts."""
    sq_diff = sum((a[k] - g).square().sum() for k, g in b.items())
    return (sq_diff / sum(g.square().sum() for g in b.values())).sqrt().item()


def first_step(run):
    """step_one(mcfg, grad, head=None, kernel_prologue=None) -> (step 1's
    mean loss, its gradients with `grad`) on `run`'s params and first batch,
    on the loss head `head` ((hn, targets, mcfg) -> loss sum; None: the
    run's) and the prologue `kernel_prologue` (None: the run's)."""
    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
    from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
        head_loss_sum_count,
        shift_labels,
    )

    batch = next(run.batches())
    params = run.state.params
    targets = shift_labels(batch["labels"])
    count = (targets != llama.IGNORE_INDEX).sum()
    mb = targets.shape[0] // run.num_microbatches

    def step_one(mcfg, grad: bool, head=None, kernel_prologue=None):
        if kernel_prologue is None:
            kernel_prologue = run.kernel_prologue
        for p in params.values():
            p.grad = None
        total = 0.0
        for i in range(run.num_microbatches):
            rows = slice(i * mb, (i + 1) * mb)
            with torch.set_grad_enabled(grad):
                hn = llama.hidden_states(params, batch["input_ids"][rows],
                                         batch["attention_mask"][rows],
                                         batch["position_ids"][rows], cfg=mcfg,
                                         attn_fn=run.attn_fn, kernel_prologue=kernel_prologue)
                if head is None:
                    loss = head_loss_sum_count(params, hn, targets[rows], mcfg, run.head)[0]
                else:
                    loss = head(hn, targets[rows], mcfg)
                loss = loss / count
                if grad:
                    loss.backward()
            total += loss.item()
        grads = {k: p.grad.clone() for k, p in params.items()} if grad else None
        return total, grads

    return step_one


def ce_parity(run, run_loss: float, tag: str) -> None:
    """Step 1 again on `run` (see step_parity), on the run's attention and
    prologue, with the CE kernel head (the run's)
    and the dense head (lm_head + cross-entropy on fp32 logits): in bf16 the
    step loss, which must also repeat the run's first loss; in fp32 compute
    the step loss and the gradients, where only summation order separates the
    heads. A planted fault -- the kernel head on W without its last PLANT_CUT
    vocab columns -- must fail the fp32 check."""
    import dataclasses

    import torch

    from llama_pipeline_parallel_tpu_torch.ops.fused_ce import kernel_ce_sum_count
    from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
        LossHead,
        head_loss_sum_count,
    )

    step_one = first_step(run)
    if not run.head.kernel_ce:
        raise AssertionError(f"{tag} the run does not take the CE kernel head: {run.head}")
    params = run.state.params

    def dense_head(hn, tgt, mcfg):
        return head_loss_sum_count(params, hn, tgt, mcfg, LossHead())[0]

    def cut_head(hn, tgt, mcfg):
        w = params["lm_head"].to(mcfg.dtype)[:, :-PLANT_CUT]
        return kernel_ce_sum_count(hn, w, tgt, run.head.loss_chunks)[0]

    bf16 = run.model_cfg
    kernel_bf16, _ = step_one(bf16, grad=False)
    dense_bf16, _ = step_one(bf16, grad=False, head=dense_head)
    step_diff, run_diff = abs(kernel_bf16 - dense_bf16), abs(kernel_bf16 - run_loss)
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    kernel_loss, kernel_grads = step_one(fp32, grad=True)
    dense_loss, dense_grads = step_one(fp32, grad=True, head=dense_head)
    loss_diff, grad_rel = abs(kernel_loss - dense_loss), rel_diff(kernel_grads, dense_grads)
    del kernel_grads
    log(f"{tag} step 1 on the same params and batch, CE kernel head vs dense head: "
        f"bf16 step loss |diff| {step_diff:.3e} (tol {STEP_LOSS_TOL}); fp32 step loss "
        f"|diff| {loss_diff:.3e} (tol {FP32_STEP_LOSS_TOL}), gradient rel diff "
        f"{grad_rel:.3e} (tol {GRAD_REL_TOL}); this step's bf16 loss on the run's path vs "
        f"the run's first: {run_diff:.2e} (tol {RUN_REPEAT_TOL})")
    if not step_diff <= STEP_LOSS_TOL:
        raise AssertionError(f"CE kernel vs dense head step loss differ by {step_diff}")
    if not loss_diff <= FP32_STEP_LOSS_TOL:
        raise AssertionError(f"CE kernel vs dense head fp32 step loss differ by {loss_diff}")
    if not grad_rel <= GRAD_REL_TOL:
        raise AssertionError(f"CE kernel vs dense head gradients differ by {grad_rel}")
    # the same params and batch as the run (a different batch moves it ~3e-2)
    if not run_diff <= RUN_REPEAT_TOL:
        raise AssertionError(f"step 1 recomputed gives loss {run_diff} off the run's")

    bad_loss, bad_grads = step_one(fp32, grad=True, head=cut_head)
    bad_diff, bad_rel = abs(bad_loss - dense_loss), rel_diff(bad_grads, dense_grads)
    log(f"{tag} planted CE fault (last {PLANT_CUT} vocab columns hidden), fp32: step "
        f"loss |diff| {bad_diff:.3e}, gradient rel diff {bad_rel:.3e}")
    if bad_diff <= FP32_STEP_LOSS_TOL and bad_rel <= GRAD_REL_TOL:
        raise AssertionError(f"the CE head check passes a planted fault ({bad_diff}, "
                             f"{bad_rel})")


def prologue_parity(run, tag: str) -> None:
    """Step 1 again on `run` (see step_parity), with the prologue kernels
    (the run's) and the composed
    prologue (rms_norm, the three matmuls, apply_rope), each with the run's
    attention and loss head: in bf16 the step loss; in fp32 compute the step
    loss and the gradients, where only summation order separates the two. A
    planted fault -- the prologue kernels on wq without its last head's
    columns -- must fail the fp32 check."""
    import dataclasses

    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama

    step_one = first_step(run)
    if not run.kernel_prologue:
        raise AssertionError(f"{tag} the run does not take the prologue kernels")
    bf16 = run.model_cfg
    step_diff = abs(step_one(bf16, grad=False)[0]
                    - step_one(bf16, grad=False, kernel_prologue=False)[0])
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    kernel_loss, kernel_grads = step_one(fp32, grad=True)
    composed_loss, composed_grads = step_one(fp32, grad=True, kernel_prologue=False)
    loss_diff = abs(kernel_loss - composed_loss)
    grad_rel = rel_diff(kernel_grads, composed_grads)
    del kernel_grads
    log(f"{tag} step 1 on the same params and batch, prologue kernels vs composed "
        f"prologue: bf16 step loss |diff| {step_diff:.3e} (tol {STEP_LOSS_TOL}); fp32 step "
        f"loss |diff| {loss_diff:.3e} (tol {FP32_STEP_LOSS_TOL}), gradient rel diff "
        f"{grad_rel:.3e} (tol {GRAD_REL_TOL})")
    if not step_diff <= STEP_LOSS_TOL:
        raise AssertionError(f"prologue kernels vs composed step loss differ by {step_diff}")
    if not loss_diff <= FP32_STEP_LOSS_TOL:
        raise AssertionError(f"prologue kernels vs composed fp32 step loss differ by "
                             f"{loss_diff}")
    if not grad_rel <= GRAD_REL_TOL:
        raise AssertionError(f"prologue kernels vs composed gradients differ by {grad_rel}")

    good = llama.fused_prologue

    def cut_last_q_head(x, norm_w, wq, wk, wv, cos, sin, *, eps, head_dim):
        wq = torch.cat([wq[:, :-head_dim], torch.zeros_like(wq[:, -head_dim:])], dim=1)
        return good(x, norm_w, wq, wk, wv, cos, sin, eps=eps, head_dim=head_dim)

    llama.fused_prologue = cut_last_q_head  # what decoder_layer calls
    try:
        bad_loss, bad_grads = step_one(fp32, grad=True)
    finally:
        llama.fused_prologue = good
    bad_diff, bad_rel = abs(bad_loss - composed_loss), rel_diff(bad_grads, composed_grads)
    log(f"{tag} planted prologue fault (wq without its last head's columns), fp32: step "
        f"loss |diff| {bad_diff:.3e}, gradient rel diff {bad_rel:.3e}")
    if bad_diff <= FP32_STEP_LOSS_TOL and bad_rel <= GRAD_REL_TOL:
        raise AssertionError(f"the prologue check passes a planted fault ({bad_diff}, "
                             f"{bad_rel})")


def gbps(nbytes: float, secs: float) -> str:
    return f"{nbytes / 1e9:.3f} GB in {secs:.3f} s ({nbytes / 1e9 / max(secs, 1e-9):.2f} GB/s)"


def phase_checkpoint() -> list:
    """Save, resume and warm start on the card at LLaMA-7B width (2 layers).

    Run A (CKPT_RUN_A) trains 6 steps and saves the full state at step 4 with
    async_save: the loop pays the device-to-host copy, a background thread
    writes, digests and commits while steps 5-6 run. Run B (CKPT_RUN_B)
    resumes from it in the same directory and takes steps 5-6 through every
    kernel of the slice. B's losses must equal A's within RESUME_LOSS_TOL;
    B's final params and moments are held to A's (their largest difference
    printed, and whether they are bit-equal). Then a byte of the checkpoint
    is flipped: verify must raise and quarantine it, after which no
    checkpoint is left to resume. Last, A's final params go out through
    export_hf and back through convert_hf, and a run with model_name_or_path
    starts from params bit-equal to A's and takes a step."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as ck
    from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.tools import convert_hf, export_hf
    from llama_pipeline_parallel_tpu_torch.train import build_model_config, build_run, train_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config
    from llama_pipeline_parallel_tpu_torch.utils.metrics import param_count

    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    root = os.path.join(ROOT, "build", "chip_smoke")
    ckpt_dir, hf_dir = os.path.join(root, "ckpt"), os.path.join(root, "hf")
    warm_dir = os.path.join(root, "warm")
    os.makedirs(root, exist_ok=True)

    def cfg(*overrides):
        return load_config(config, CKPT_OVERRIDES + list(overrides))

    cfg_a = cfg(*CKPT_RUN_A, f"output_dir={ckpt_dir}")
    log(f"[checkpoint] {config} TRAIN_OVERRIDES + "
        f"{' '.join(CKPT_OVERRIDES[len(TRAIN_OVERRIDES):] + CKPT_RUN_A)}")
    n_params = param_count(build_model_config(cfg_a["model"]))
    need = 12 * n_params + 2 * 4 * n_params + CKPT_DISK_SLACK
    free = shutil.disk_usage(root).free
    log(f"[checkpoint] {n_params / 1e6:.1f} M parameters: a full-state checkpoint is "
        f"{12 * n_params / 1e9:.2f} GB; free disk {free / 1e9:.1f} GB, the phase needs "
        f"{need / 1e9:.1f} GB")
    if free < need:
        raise AssertionError(f"free disk under {root}: {free} bytes, the checkpoint phase "
                             f"needs {need}")
    run_a = build_run(cfg_a, "cuda")

    # -- run A: the uninterrupted run, saving at step 4 in the background
    summary_a = train_run(run_a)
    save = dict(run_a.ckpt.last_save)
    losses_a, times_a = summary_a["losses"], summary_a["step_times"]
    log(f"[checkpoint] run A losses {losses_a}")
    log(f"[checkpoint] async save of checkpoint-{CKPT_SAVE_STEP}: the loop paid "
        f"{save['d2h_s']:.3f} s for the device-to-host copy of {save['d2h_bytes'] / 1e9:.3f} GB "
        f"({save['d2h_bytes'] / 1e9 / save['d2h_s']:.2f} GB/s, host buffers pinned on this "
        f"first save); in the background: write {gbps(save['bytes'], save['write_s'])}, "
        f"sha256 {gbps(save['bytes'], save['digest_s'])}, commit in all "
        f"{save['commit_s']:.3f} s")
    meta = json.load(open(os.path.join(ckpt_dir, f"checkpoint-{CKPT_SAVE_STEP}", "meta.json")))
    g = run_a.loader.global_batch_examples
    checks = {"step": meta["step"] == CKPT_SAVE_STEP,
              "has_optimizer_state": meta["has_optimizer_state"] is True,
              "data_state": meta["data_state"]["consumed_samples"] == CKPT_SAVE_STEP * g,
              "topology.layout": meta["topology"]["layout"] == "pp1xdp1xtp1xsp1",
              "storage": meta["storage"] == "safetensors",
              "integrity": sorted(meta["integrity"]["files"]) == ["opt.safetensors",
                                                                  "params.safetensors"]}
    log(f"[checkpoint] meta.json: {checks}; data_state {meta['data_state']}")
    if not all(checks.values()):
        raise AssertionError(f"meta.json of checkpoint-{CKPT_SAVE_STEP}: {checks}")

    mgr = ck.CheckpointManager(ckpt_dir)
    t0 = time.perf_counter()
    mgr.verify(CKPT_SAVE_STEP)
    verify_s = time.perf_counter() - t0
    params_file = os.path.join(mgr.step_dir(CKPT_SAVE_STEP), ck.PARAMS_FILE)
    t0 = time.perf_counter()
    with tensor_io.TensorFile(params_file) as f:
        host = {name: f.tensor(name).clone() for name in f.keys()}
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_card = {name: t.to("cuda") for name, t in host.items()}
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    host_bytes = sum(t.numel() * t.element_size() for t in host.values())
    del host, on_card
    log(f"[checkpoint] verify (sha256 of both files) {gbps(save['bytes'], verify_s)}; "
        f"reading params.safetensors into host memory {gbps(host_bytes, read_s)} (page "
        f"cache warm from the write); host-to-device {gbps(host_bytes, h2d_s)} (pageable)")

    # -- run B: resume from step 4 in the same directory
    t0 = time.perf_counter()
    run_b = build_run(cfg(*CKPT_RUN_B, f"output_dir={ckpt_dir}"), "cuda")
    restore_s = time.perf_counter() - t0
    if (run_b.start_step, run_b.data_start) != (CKPT_SAVE_STEP,
                                                divmod(CKPT_SAVE_STEP, len(run_b.loader))):
        raise AssertionError(f"run B starts at {run_b.start_step}, data {run_b.data_start}")
    log(f"[checkpoint] run B build_run with the restore (verify, read, copy onto the card): "
        f"{restore_s:.3f} s; starts at step {run_b.start_step}, data position "
        f"{run_b.data_start}")
    fa.reset_launch_counts()
    fc.reset_launch_counts()
    fp.reset_launch_counts()
    summary_b = train_run(run_b)
    launches = {**fa.launch_counts, **fc.launch_counts, **fp.launch_counts}
    tensor_core = {**fa.tensor_core_counts, **fc.tensor_core_counts, **fp.tensor_core_counts}
    layers = run_b.model_cfg.num_hidden_layers
    microbatches = run_b.num_microbatches * len(summary_b["losses"])
    expected = {**{key: layers * microbatches for key in fa.launch_counts},
                **{key: microbatches for key in fc.launch_counts},
                **{key: layers * microbatches for key in fp.launch_counts}}
    want_tc = {**{key: layers * microbatches for key in fa.tensor_core_counts},
               **{key: microbatches for key in fc.tensor_core_counts},
               **{key: layers * microbatches for key in fp.tensor_core_counts}}
    losses_b = summary_b["losses"]
    diffs = [abs(b - a) for a, b in zip(losses_a[CKPT_SAVE_STEP:], losses_b)]
    log(f"[checkpoint] run B losses {losses_b}; |B - A| {diffs} (tol {RESUME_LOSS_TOL}); "
        f"kernel launches {launches} (expected {expected}), on the tensor cores "
        f"{tensor_core}")
    log(f"[checkpoint] step {CKPT_SAVE_STEP + 1}: {1e3 * times_a[CKPT_SAVE_STEP]:.1f} ms in A "
        f"(commit in flight) against {1e3 * summary_b['step_times'][0]:.1f} ms in B; A's steps "
        f"{[round(1e3 * t, 1) for t in times_a]} ms")
    if len(losses_b) != len(losses_a) - CKPT_SAVE_STEP or not max(diffs) <= RESUME_LOSS_TOL:
        raise AssertionError(f"resumed losses {losses_b} against {losses_a}")
    if launches != expected or tensor_core != want_tc:
        raise AssertionError(f"run B launches {launches}, tensor cores {tensor_core}, "
                             f"expected {expected}")
    # Adam moves each parameter by about the learning rate a step whatever its
    # gradient, so a step that is not bit-reproducible moves a parameter by up
    # to ~2 lr; the moments follow the gradients, held relative to their size
    state_a, state_b = run_a.state, run_b.state
    lr_sum = sum(state_b.optimizer.schedule(c) for c in range(CKPT_SAVE_STEP, run_b.end_step))
    differ, worst = [], {"params": 0.0, "mu": 0.0, "nu": 0.0}
    for group, a_side, b_side in (("params", state_a.params, state_b.params),
                                  ("mu", state_a.optimizer.mu, state_b.optimizer.mu),
                                  ("nu", state_a.optimizer.nu, state_b.optimizer.nu)):
        for k, ta in a_side.items():
            d = (ta.detach() - b_side[k].detach()).abs().max().item()
            if group != "params":
                d /= max(ta.abs().max().item(), 1e-30)
            worst[group] = max(worst[group], d)
            if d > 0:
                differ.append(f"{group} {k} {d:.3e}")
    log(f"[checkpoint] B's final state against A's: largest |diff| of params "
        f"{worst['params']:.3e} (limit 4 x the lr of B's steps = {4 * lr_sum:.3e}), of mu and "
        f"nu relative to their largest element {worst['mu']:.3e} and {worst['nu']:.3e} (limit "
        f"{GRAD_REL_TOL}); {'bit-equal' if not differ else 'not bit-equal: ' + ', '.join(differ)};"
        f" count {state_b.optimizer.count} vs {state_a.optimizer.count}")
    if (state_b.optimizer.count != state_a.optimizer.count
            or not worst["params"] <= 4 * lr_sum
            or not max(worst["mu"], worst["nu"]) <= GRAD_REL_TOL):
        raise AssertionError(f"run B's final state is {worst} from A's")
    del run_b, state_b, summary_b

    # -- a planted fault: one flipped byte
    with open(params_file, "r+b") as f:
        f.seek(-4096, os.SEEK_END)
        byte = f.read(1)
        f.seek(-4096, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x01]))
    try:
        mgr.verify(CKPT_SAVE_STEP)
    except ck.CheckpointCorruptError as e:
        log(f"[checkpoint] planted byte flip caught: {e}")
    else:
        raise AssertionError("verify passed a checkpoint with a flipped byte")
    quarantined = os.path.isdir(mgr.step_dir(CKPT_SAVE_STEP) + ck.QUARANTINE_SUFFIX)
    left = ck.find_resume_checkpoint(ckpt_dir)
    log(f"[checkpoint] quarantined: {quarantined}; find_resume_checkpoint -> {left}")
    if not quarantined or left is not None:
        raise AssertionError(f"quarantine {quarantined}, resume candidate {left}")
    shutil.rmtree(ckpt_dir)

    # -- the HF round trip and a warm start on the card
    t0 = time.perf_counter()
    hf_bytes = export_hf.export_params(state_a.params, run_a.model_cfg, hf_dir)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_hf.convert(hf_dir, warm_dir)
    convert_s = time.perf_counter() - t0
    log(f"[checkpoint] export_hf of A's final params {gbps(hf_bytes, export_s)}; convert_hf "
        f"back (read, stack, write, sha256) {gbps(hf_bytes, convert_s)}")
    shutil.rmtree(hf_dir)
    run_w = build_run(cfg("resume=false", "max_steps=1", f"model_name_or_path={warm_dir}",
                          f"output_dir={root}/warm_run"), "cuda")
    unequal = [k for k, v in state_a.params.items() if not torch.equal(v, run_w.state.params[k])]
    if unequal:
        raise AssertionError(f"warm-started params differ from A's: {unequal}")
    warm = train_run(run_w)
    log(f"[checkpoint] warm start from {warm_dir}: params bit-equal to A's; one step, loss "
        f"{warm['losses']}")
    if not (len(warm["losses"]) == 1 and math.isfinite(warm["losses"][0])):
        raise AssertionError(f"warm-started step: {warm['losses']}")
    del run_w, run_a, state_a
    for path in (warm_dir, f"{root}/warm_run"):
        shutil.rmtree(path, ignore_errors=True)
    return losses_a


def packed_corpus(root: str) -> tuple[str, str, str]:
    """Write PACKED_ROWS synthetic {"inputs", "targets"} rows from
    PACKED_SEED to <root>/train.jsonl and PACKED_EVAL_ROWS more, drawn from
    the same words with PACKED_EVAL_SEED, to <root>/eval.jsonl; train a
    SentencePiece-Unigram tokenizer on the training rows (no pad token: the
    trainer falls back to eos) and save it to <root>/tok. Returns (training
    jsonl, eval jsonl, tokenizer dir)."""
    import numpy as np
    from tokenizers import SentencePieceUnigramTokenizer
    from transformers import PreTrainedTokenizerFast

    rng = np.random.RandomState(PACKED_SEED)
    syllables = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
    words = sorted({"".join(rng.choice(syllables, n))
                    for n in rng.randint(1, 4, 2 * PACKED_WORDS)})
    words = np.array(words[:PACKED_WORDS])
    zipf = 1.0 / np.arange(1, len(words) + 1)
    zipf /= zipf.sum()

    def text(rng, lo: int, hi: int) -> str:
        n = int(round(lo * (hi / lo) ** (rng.uniform() ** 2)))
        return " ".join(words[rng.choice(len(words), n, p=zipf)])

    def write(name: str, rng, n: int) -> tuple[str, list]:
        rows = [{"inputs": text(rng, *PACKED_PROMPT_WORDS),
                 "targets": text(rng, *PACKED_TARGET_WORDS)} for _ in range(n)]
        path = os.path.join(root, name)
        with open(path, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")
        return path, rows

    jsonl, rows = write("train.jsonl", rng, PACKED_ROWS)
    eval_jsonl, _ = write("eval.jsonl", np.random.RandomState(PACKED_EVAL_SEED), PACKED_EVAL_ROWS)
    spm = SentencePieceUnigramTokenizer()
    spm.train_from_iterator([f"{r['inputs']} {r['targets']}" for r in rows],
                            vocab_size=PACKED_TOKENIZER_VOCAB, unk_token="<unk>",
                            special_tokens=["<unk>", "<s>", "</s>"])
    tok_dir = os.path.join(root, "tok")
    PreTrainedTokenizerFast(tokenizer_object=spm._tokenizer, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(tok_dir)
    return jsonl, eval_jsonl, tok_dir


def tile_boundaries(seg) -> int:
    """Segment boundaries and pad-tail starts of segment ids `seg` [b, s]
    that lie inside a tile of every flash kernel (see TILE_EDGE)."""
    import torch

    change = seg[:, 1:] != seg[:, :-1]
    pos = torch.arange(1, seg.shape[1], device=seg.device)
    return int((change & (pos % TILE_EDGE != 0)).sum())


def segment_kernel_case(seg, timed: bool) -> None:
    """The three flash kernels on the tensor cores with a packed microbatch's
    segment ids `seg` [b, s] (at least one boundary a row inside the tiles,
    and a pad tail: both asserted), bf16 q/k/v/dO from a seed against the
    plain versions in fp32 (the 2^-8 rule; lse to FP32_TOL): out and dq
    exactly 0 on pad rows, every call counted as segmented, and the same
    calls without the segment ids rejected by the same check. With `timed`,
    each kernel's time with and without segments (cuda_ms), beside its bound
    on the pairs each leaves visible."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa

    b, s = seg.shape
    inside, pad_rows = tile_boundaries(seg), int((seg == 0).sum())
    log(f"  {inside} segment boundaries inside tiles, {pad_rows} pad rows of {b * s}; segments "
        f"per row {seg.max(dim=1).values.tolist()}")
    if inside < b or not pad_rows:
        raise AssertionError(f"the microbatch holds {inside} boundaries inside tiles (want at "
                             f"least {b}, one a row) and {pad_rows} pad rows (want some)")
    h, hd = 32, 128
    q, k, v, do = make_inputs(b, h, h, s, s, hd, torch.bfloat16, PACKED_SEED)
    kw = dict(causal=True, scale=hd ** -0.5, q_offset=0, kv_offset=0, segments_q=seg,
              segments_kv=seg)
    fa.reset_launch_counts()
    out, lse = fa._fwd_cuda(q, k, v, **kw)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    ref_out, ref_lse = fa._fwd_plain(q32, k32, v32, **kw)
    delta = (do32 * ref_out).sum(dim=-1, keepdim=True)
    dq = fa._bwd_dq_cuda(q, k, v, delta, ref_lse, do, **kw)
    dk, dv = fa._bwd_dkv_cuda(q, k, v, delta, ref_lse, do, **kw)
    ref_dq = fa._bwd_dq_plain(q32, k32, v32, delta, ref_lse, do32, **kw)
    ref_dk, ref_dv = fa._bwd_dkv_plain(q32, k32, v32, delta, ref_lse, do32, **kw)
    expect_routes(fa, {"fwd": fa.TENSOR_CORE, "dq": fa.TENSOR_CORE, "dkv": fa.TENSOR_CORE}, 1)
    if fa.segmented_counts != {"fwd": 1, "dq": 1, "dkv": 1}:
        raise AssertionError(f"segmented calls {fa.segmented_counts}, expected one each")
    pad = (seg == 0)[:, None, :].expand(b, h, s)
    tol = {name: tolerance(ref, False) for name, ref in
           (("out", ref_out), ("dq", ref_dq), ("dk", ref_dk), ("dv", ref_dv))}
    check("fwd out", out, ref_out, tol["out"])
    check("fwd lse", lse, ref_lse, (0.0, FP32_TOL))
    check("dq", dq, ref_dq, tol["dq"])
    check("dk", dk, ref_dk, tol["dk"])
    check("dv", dv, ref_dv, tol["dv"])
    for name, t in (("out", out), ("dq", dq)):
        nonzero = int((t[pad] != 0).sum())
        log(f"  {name} on pad rows: {nonzero} nonzero elements (must be 0)")
        if nonzero:
            raise AssertionError(f"{name} is not exactly 0 on pad rows ({nonzero} elements)")

    plain = dict(kw, segments_q=None, segments_kv=None)
    expect_rejected("fwd out (segments dropped)", fa._fwd_cuda(q, k, v, **plain)[0], ref_out,
                    tol["out"])
    expect_rejected("dq (segments dropped)",
                    fa._bwd_dq_cuda(q, k, v, delta, ref_lse, do, **plain), ref_dq, tol["dq"])
    dk_bad, dv_bad = fa._bwd_dkv_cuda(q, k, v, delta, ref_lse, do, **plain)
    expect_rejected("dk (segments dropped)", dk_bad, ref_dk, tol["dk"])
    expect_rejected("dv (segments dropped)", dv_bad, ref_dv, tol["dv"])
    if not timed:
        return

    bwd = (q, k, v, delta, lse, do)
    calls = {"fwd": lambda kw: fa._fwd_cuda(q, k, v, **kw),
             "dq": lambda kw: fa._bwd_dq_cuda(*bwd, **kw),
             "dkv": lambda kw: fa._bwd_dkv_cuda(*bwd, **kw)}
    lengths = [int(n) for row in seg.tolist() for n in _run_lengths(row)]
    visible = h * sum(n * (n + 1) // 2 for n in lengths)
    bound_seg = bounds(b, h, s, hd, 2, pairs=visible, seg_bytes=2 * b * s * 4)
    bound_all = bounds(b, h, s, hd, 2)
    log(f"[packed] flash kernels at b={b} h={h} s={s} hd={hd} bf16: {visible} visible (q, k) "
        f"pairs with segments, {causal_pairs(b, h, s)} causal pairs without")
    for key, name in (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
        ms_seg, ms_all = cuda_ms(lambda: calls[key](kw)), cuda_ms(lambda: calls[key](plain))
        log(f"  {name}: with segments {ms_seg:.4f} ms (bound {bound_seg[key]['bound_ms']:.4f} "
            f"ms by {bound_seg[key]['bound_by']}), without {ms_all:.4f} ms (bound "
            f"{bound_all[key]['bound_ms']:.4f} ms by {bound_all[key]['bound_by']})")


def packed_ce_case(run, batch, rows: slice) -> None:
    """The three CE kernels on the tensor cores at the packed path's inputs:
    the final-normed hidden states of microbatch `rows` of `batch` in bf16
    through the run's model, the run's lm_head, its shifted targets (most of
    them IGNORE: prompts, pads, each segment's first token) and the step's
    cotangent 1 / (valid targets of the step) on the valid ones, against the
    plain versions in fp32 (ce_case). Planted faults on the same inputs must
    be rejected by the same check: the forward on W without its last
    PLANT_CUT vocab columns (lse) and on the labels unshifted (the target
    logit), dh and dW with the ignored tokens weighted as valid."""
    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.parallel.train_step import shift_labels

    params, chunks = run.state.params, run.head.loss_chunks
    targets = shift_labels(batch["labels"])
    count = (targets != fc.IGNORE_INDEX).sum()
    with torch.no_grad():
        h = llama.hidden_states(params, batch["input_ids"][rows], batch["attention_mask"][rows],
                                batch["position_ids"][rows], cfg=run.model_cfg,
                                attn_fn=run.attn_fn, kernel_prologue=run.kernel_prologue)
    h = h.reshape(-1, h.shape[-1])
    w = params["lm_head"].to(h.dtype).contiguous()
    t = targets[rows].reshape(-1)
    valid = t != fc.IGNORE_INDEX
    safe_t = torch.where(valid, t, 0).to(torch.int32)
    svec = valid.float() / count
    log(f"[packed] CE kernels at the path's inputs: {h.shape[0]} tokens x {h.shape[1]} x "
        f"{w.shape[1]} bf16, {chunks} vocab chunks, {int((~valid).sum())} targets IGNORE, vs "
        f"the plain versions in fp32")
    ce_case(h, w, safe_t, svec, chunks, fp32=False, routes=(fc.TENSOR_CORE, fc.TENSOR_CORE))

    hf, wf = h.float(), w.float()
    ref_lse, ref_tgt = fc._fwd_stats_plain(hf, wf, safe_t, chunks)
    ref_dh = fc._dh_plain(hf, wf, safe_t, ref_lse, svec, chunks, g_dtype=h.dtype)
    ref_dw = fc._dw_plain(hf, wf, safe_t, ref_lse, svec, chunks, g_dtype=h.dtype)
    del hf, wf
    expect_rejected("ce lse (last vocab columns hidden)",
                    fc._fwd_stats_cuda(h, w[:, :-PLANT_CUT].contiguous(), safe_t, chunks)[0],
                    ref_lse, (0.0, FP32_TOL))
    unshifted = batch["labels"][rows].reshape(-1)
    unshifted = torch.where(unshifted != fc.IGNORE_INDEX, unshifted, 0).to(torch.int32)
    expect_rejected("ce tgt (labels unshifted)",
                    fc._fwd_stats_cuda(h, w, unshifted, chunks)[1], ref_tgt, (0.0, FP32_TOL))
    every = torch.full_like(svec, 1.0) / count
    dh_bad, dw_bad = fc._backward_cuda(h, w, safe_t, ref_lse, every, chunks)
    expect_rejected("ce dh (ignored tokens weighted)", dh_bad, ref_dh, tolerance(ref_dh, False))
    expect_rejected("ce dW (ignored tokens weighted)", dw_bad, ref_dw, tolerance(ref_dw, False))
    if fc.tensor_core_counts != fc.launch_counts:
        raise AssertionError(f"CE calls on the tensor cores {fc.tensor_core_counts}, launches "
                             f"{fc.launch_counts}: every call at these inputs must take them")


def packed_prologue_case(run, batch, rows: slice) -> None:
    """The three prologue kernels on the tensor cores at the packed path's
    inputs: layer 0's input (the embedded tokens of microbatch `rows` of
    `batch`), its norm weight and q/k/v weights in bf16, and cos / sin of the
    batch's positions, which restart in each segment; cotangents from a
    seed. Held to the plain versions (prologue_case, with its planted
    faults); the forward with the positions of the row (0 .. s - 1, not
    restarted) must fall outside the rounding bounds of q and k."""
    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.ops.rope import rope_cos_sin

    mcfg, params = run.model_cfg, run.state.params
    if mcfg.rms_norm_eps != PRO_EPS:
        raise AssertionError(f"the model's rms_norm_eps {mcfg.rms_norm_eps} is not PRO_EPS")
    ids, pos = batch["input_ids"][rows], batch["position_ids"][rows]
    b, s = ids.shape
    n, hd, dt = b * s, mcfg.head_dim, mcfg.dtype

    def trig(positions):
        return tuple(t.reshape(n, hd).contiguous()
                     for t in rope_cos_sin(positions, hd, mcfg.rope_theta, dtype=dt))

    g = torch.Generator(device="cuda").manual_seed(PACKED_SEED)
    with torch.no_grad():
        x = llama.embed(params, ids, mcfg).reshape(n, -1).contiguous()
    w = {name: params[f"layers.attn.{name}"][0].to(dt).contiguous() for name in ("wq", "wk", "wv")}
    cos, sin = trig(pos)
    inp = dict(x=x, norm_w=params["layers.input_norm"][0], **w, cos=cos, sin=sin, hd=hd,
               **{f"d{name}": torch.randn(n, w[f"w{name}"].shape[1], generator=g,
                                          device="cuda").to(dt) for name in "qkv"})
    restarts = int((pos[:, 1:] < pos[:, :-1]).sum())
    log(f"[packed] prologue kernels at the path's inputs: {n} tokens d={x.shape[1]} bf16, "
        f"layer 0's weights, positions restarting {restarts} times, vs the plain versions")
    prologue_case(inp, fp32=False, route=fp.TENSOR_CORE, plant=True)
    row_cos, row_sin = trig(torch.arange(s, device="cuda").expand(b, s))
    bad = forward_flips(inp, fp._fwd_cuda(x, inp["norm_w"], w["wq"], w["wk"], w["wv"], row_cos,
                                          row_sin, PRO_EPS, hd))
    for name in "qk":
        off, share, err = bad[name]
        log(f"  planted prologue {name} (positions not restarted): {off} elements outside the "
            f"rounding bounds, {share:.2e} off the plain version (must exceed 0 or {FLIP_SHARE})")
        if not off and share <= FLIP_SHARE:
            raise AssertionError(f"the check of prologue {name} passes unrestarted positions")
    if not restarts or fp.tensor_core_counts != fp.launch_counts:
        raise AssertionError(f"positions restart {restarts} times (want some); prologue calls "
                             f"on the tensor cores {fp.tensor_core_counts}, launches "
                             f"{fp.launch_counts} (want all)")


def _run_lengths(row: list) -> list:
    """Lengths of the runs of equal nonzero ids in a row of segment ids."""
    out, prev = [], 0
    for x in row:
        if x and x == prev:
            out[-1] += 1
        elif x:
            out.append(1)
        prev = x
    return out


def packed_alone_parity(run, batch) -> None:
    """In fp32 compute with every kernel of the run on (flash with segments,
    the prologue kernels), the logits of each segment of the batch's row with
    the most segments against its example run alone (positions from 0, no
    segment ids), within PACKED_LOGIT_TOL."""
    import dataclasses

    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama

    fp32 = dataclasses.replace(run.model_cfg, dtype=torch.float32)
    params = run.state.params
    r = int(batch["attention_mask"].max(dim=1).values.argmax())
    row = slice(r, r + 1)
    seg = batch["attention_mask"][r]
    worst = 0.0
    with torch.no_grad():
        packed = llama.forward(params, batch["input_ids"][row], batch["attention_mask"][row],
                               batch["position_ids"][row], cfg=fp32, attn_fn=run.attn_fn,
                               kernel_prologue=True)[0]
        ids = sorted(set(seg.tolist()) - {0})
        for sid in ids:
            at = (seg == sid).nonzero().squeeze(1)
            alone = llama.forward(params, batch["input_ids"][row, at], cfg=fp32,
                                  attn_fn=run.attn_fn, kernel_prologue=True)[0]
            err, ratio = reading(packed[at], alone, PACKED_LOGIT_TOL, PACKED_LOGIT_TOL)
            worst = max(worst, ratio)
            log(f"  segment {sid}: {len(at)} tokens at {at[0].item()}..{at[-1].item()}, "
                f"logits max_abs_err {err:.3e}")
    log(f"[packed] packed row {r} vs its {len(ids)} examples alone, fp32 through the kernels: "
        f"worst err / limit {worst:.3f} (rtol = atol = {PACKED_LOGIT_TOL})")
    if not worst <= 1.0 or len(ids) < 2:
        raise AssertionError(f"packed logits differ from the examples alone ({worst} x the "
                             f"limit) or the row holds {len(ids)} segment(s)")


def phase_packed() -> None:
    """The fine-tune config conf/llama_7b_flan_packed.yaml on the card at
    LLaMA-7B width (PACKED_OVERRIDES): a JSONL and a tokenizer made here,
    sequence packing with segment ids through the flash kernels. Checks:
    finite losses and the expected first loss; exact launch counts, every
    call on the tensor cores and every flash call with segment ids; the
    packing counters in the metrics line; the flash kernels at the segment
    ids of each microbatch of step 1 against their plain versions
    (segment_kernel_case), timed on the one with the most boundaries inside
    tiles; on that microbatch the CE kernels (packed_ce_case) and the
    prologue kernels (packed_prologue_case) at the path's inputs against
    their plain versions; step 1 again (step_parity): flash (segments)
    against the exact op with segments dropped as the planted fault, the CE
    kernel head against the dense head and the prologue kernels against the
    composed prologue, each with its planted fault; one packed row against
    its examples alone."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch import train
    from llama_pipeline_parallel_tpu_torch.data.loader import RepeatingLoader
    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    root = os.path.join(ROOT, "build", "chip_smoke", "packed")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    jsonl, eval_jsonl, tok_dir = packed_corpus(root)
    config = os.path.join(ROOT, "conf", "llama_7b_flan_packed.yaml")
    data = [f"dataset.path={jsonl}", f"tokenizer_path={tok_dir}"]
    held_out = ["eval_dataset={_target_: llama_pipeline_parallel_tpu.data.datasets."
                f"LazyJsonlDataset, path: {eval_jsonl}}}", "eval_steps=2"]
    cfg = load_config(config, PACKED_OVERRIDES + data + held_out + [f"output_dir={root}/run"])
    log(f"[packed] {config} {' '.join(PACKED_OVERRIDES)} (max_seq_length "
        f"{cfg['max_seq_length']}, packing_factor {cfg['packing_factor']}, "
        f"loss_vocab_chunks {cfg['loss_vocab_chunks']}); {PACKED_ROWS} rows, {PACKED_EVAL_ROWS} "
        f"held out (eval every 2 steps) and a {PACKED_TOKENIZER_VOCAB}-piece tokenizer made in "
        f"{time.perf_counter() - t0:.1f} s")
    layers = cfg["model"]["num_hidden_layers"]
    microbatches = cfg["gradient_accumulation_steps"] * cfg["max_steps"]
    expected = {**{key: layers * microbatches for key in fa.launch_counts},
                **{key: microbatches for key in fc.launch_counts},
                **{key: layers * microbatches for key in fp.launch_counts}}

    def counts():
        return ({**fa.launch_counts, **fc.launch_counts, **fp.launch_counts},
                {**fa.tensor_core_counts, **fc.tensor_core_counts, **fp.tensor_core_counts},
                dict(fa.segmented_counts))

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    fc.reset_launch_counts()
    fp.reset_launch_counts()
    run = train.build_run(cfg, "cuda")
    evals = []  # each eval's launches, tensor-core calls and segmented flash calls
    evaluate = run.evaluate

    def counted_eval():
        before = counts()
        eval_loss = evaluate()
        evals.append([{k: v - b[k] for k, v in after.items()}
                      for after, b in zip(counts(), before)])
        return eval_loss

    run.evaluate = counted_eval
    summary = train.train_run(run)
    launches, tensor_core, segmented = counts()
    eval_launches = {k: sum(e[0][k] for e in evals) for k in launches}
    eval_tc = {k: sum(e[1][k] for e in evals) for k in tensor_core}
    peak = torch.cuda.max_memory_allocated()
    losses = summary["losses"]
    step_s = statistics.median(summary["step_times"][1:])
    with open(os.path.join(root, "run", "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    line = [r for r in lines if "loss" in r][-1]
    eval_lines = [r for r in lines if "eval_loss" in r]
    log(f"[packed] losses {losses}; metrics line at step {line['step']}: packing_dropped_total "
        f"{line.get('packing_dropped_total')}, packing_drop_rate {line.get('packing_drop_rate')}, "
        f"tokens_per_sec {line['tokens_per_sec']:.0f}, real_tokens_per_sec "
        f"{line.get('real_tokens_per_sec')}; eval lines {eval_lines}")
    log(f"[packed] kernel launches {launches} ({eval_launches} of them in {len(evals)} evals; "
        f"training expected {expected}), on the tensor cores {tensor_core}, flash calls with "
        f"segment ids {segmented}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    mcfg = train.build_model_config(cfg["model"])
    expected_loss = math.log(mcfg.vocab_size) + 0.02 ** 2 * mcfg.hidden_size / 2
    if abs(losses[0] - expected_loss) > 0.1:
        raise AssertionError(f"first loss {losses[0]} far from {expected_loss:.3f}, "
                             f"the expectation at random init")
    trained = {k: v - eval_launches[k] for k, v in launches.items()}
    trained_tc = {k: v - eval_tc[k] for k, v in tensor_core.items()}
    if trained != expected or trained_tc != expected:
        raise AssertionError(f"training launch counts {trained} and tensor-core calls "
                             f"{trained_tc}, both expected {expected}")
    eval_mb = len(run.eval_loader) * run.num_microbatches
    check_eval_counts("[packed]", evals, layers, eval_mb)
    if segmented != fa.launch_counts:
        raise AssertionError(f"flash calls with segment ids {segmented}, launches "
                             f"{fa.launch_counts}: the packed run must pass them on every call")
    rate, dropped = line.get("packing_drop_rate"), line.get("packing_dropped_total")
    if rate is None or dropped is None or not 0.0 <= rate <= 1.0 or not dropped > 0:
        raise AssertionError(f"packing counters in the metrics line: dropped {dropped}, "
                             f"rate {rate} (want a rate in [0, 1] and drops on this data)")
    real = line.get("real_tokens_per_sec")
    if real is None or not 0 < real < line["tokens_per_sec"]:
        raise AssertionError(f"real_tokens_per_sec {real} on the metrics line (want it, below "
                             f"tokens_per_sec {line['tokens_per_sec']})")
    if [r["step"] for r in eval_lines] != [2, 4] or len(evals) != 2:
        raise AssertionError(f"eval lines {eval_lines}, {len(evals)} evals: want steps 2 and 4")
    eval_parity(run, train.attention, ("segments dropped", train._flash_without_mask),
                "[packed]")
    del summary, run, evaluate
    gc.collect()
    torch.cuda.empty_cache()

    run = train.build_run(load_config(config, PACKED_OVERRIDES + data
                                      + [f"output_dir={root}/parity"]), "cuda")
    stream = iter(RepeatingLoader(run.loader))
    rows = [next(stream) for _ in losses]
    row_tokens = rows[0]["input_ids"].size
    real = [int((b["attention_mask"] != 0).sum()) for b in rows]
    mb = cfg["per_device_train_batch_size"]
    log(f"[packed] card {card_line()}: step {1e3 * step_s:.1f} ms (median of steps "
        f"2-{len(losses)}), {row_tokens / step_s:.0f} tokens/s counting every row token, "
        f"{statistics.mean(real) / step_s:.0f} counting non-pad tokens ({real} a step), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, drop rate {rate}")
    auto = train._measure_attention(run.model_cfg, cfg["max_seq_length"], mb,
                                    torch.device("cuda"), packed=True)
    log(f"[packed] attention=auto at batch {mb} seq {cfg['max_seq_length']} with segment ids "
        f"picks {'flash (with segment ids)' if auto is train.flash_attention else 'exact'} "
        f"(its timings on stderr); this phase runs attention=flash")

    batch = {k: torch.from_numpy(v).cuda() for k, v in rows[0].items()}
    step_rows = [slice(i, i + mb) for i in range(0, batch["input_ids"].shape[0], mb)]
    inside = [tile_boundaries(batch["attention_mask"][r]) for r in step_rows]
    busiest = step_rows[inside.index(max(inside))]
    for i, r in enumerate(step_rows):
        log(f"[packed] flash kernels on step 1's microbatch {i + 1} segment ids [{mb}, "
            f"{batch['attention_mask'].shape[1]}] vs the plain versions in fp32")
        segment_kernel_case(batch["attention_mask"][r], timed=r == busiest)
        gc.collect()
        torch.cuda.empty_cache()
    packed_ce_case(run, batch, busiest)
    gc.collect()
    torch.cuda.empty_cache()
    packed_prologue_case(run, batch, busiest)
    gc.collect()
    torch.cuda.empty_cache()

    if run.attn_fn is not train.flash_attention:
        raise AssertionError(f"the packed run attends with {run.attn_fn}, not flash_attention "
                             f"with segment ids")
    step_parity(run, ("segments dropped", train._flash_without_mask), losses[0], "[packed]")
    for p in run.state.params.values():
        p.grad = None
    gc.collect()
    torch.cuda.empty_cache()
    packed_alone_parity(run, batch)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[packed] phase {time.perf_counter() - t0:.1f} s")


def check_eval_counts(tag: str, evals: list, layers: int, eval_mb: int) -> None:
    """Each eval's launches and tensor-core calls (`evals`: [launches, tensor
    core, ...] per eval), exactly: the flash and prologue forwards once a
    layer and eval microbatch, the CE forward once a microbatch, no backward
    kernel; every call on the tensor cores."""
    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp

    want = {**{key: 0 for key in (*fa.launch_counts, *fc.launch_counts, *fp.launch_counts)},
            "fwd": layers * eval_mb, "prologue_fwd": layers * eval_mb, "ce_fwd": eval_mb}
    for i, (launches, tensor_core, *_) in enumerate(evals):
        if launches != want or tensor_core != want:
            raise AssertionError(f"{tag} eval {i + 1}: launches {launches}, tensor-core calls "
                                 f"{tensor_core}; both expected {want} ({layers} layers x "
                                 f"{eval_mb} eval microbatches, forward only)")
    log(f"{tag} each of {len(evals)} evals: launches {want} (forward only; {layers} layers x "
        f"{eval_mb} eval microbatches), all on the tensor cores")


def eval_parity(run, plain_attn, plant: tuple, tag: str) -> None:
    """The run's eval pass ((loss sum, count) over its eval set, on its
    current params) through its kernels against the plain path on the same
    params and batches: `plain_attn` (the exact op), the dense head and the
    composed prologue. bf16: the token means within STEP_LOSS_TOL; fp32
    compute: the sums within EVAL_SUM_RTOL (relative); counts equal. A
    planted fault, `plant` = (what it does, an attention function) on the
    run's head and prologue, must fail the fp32 check."""
    import dataclasses

    import torch

    from llama_pipeline_parallel_tpu_torch.parallel.train_step import LossHead, eval_step

    batches = [run.on_device(b) for b in run.eval_loader]

    def total(mcfg, attn_fn, head, kernel_prologue):
        loss_sum, count = 0.0, 0
        for batch in batches:
            s, n = eval_step(run.state.params, batch, mcfg, num_microbatches=run.num_microbatches,
                             attn_fn=attn_fn, head=head, kernel_prologue=kernel_prologue)
            loss_sum += float(s)
            count += int(n)
        return loss_sum, count

    bf16 = run.model_cfg
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    k16, c16 = total(bf16, run.attn_fn, run.head, run.kernel_prologue)
    p16, pc16 = total(bf16, plain_attn, LossHead(), False)
    k32, c32 = total(fp32, run.attn_fn, run.head, run.kernel_prologue)
    p32, pc32 = total(fp32, plain_attn, LossHead(), False)
    bad32, _ = total(fp32, plant[1], run.head, run.kernel_prologue)
    mean_diff = abs(k16 / c16 - p16 / pc16)
    rel, bad_rel = abs(k32 - p32) / abs(p32), abs(bad32 - p32) / abs(p32)
    log(f"{tag} eval over {len(batches)} batches ({c16} targets) on the same params, kernels vs "
        f"the plain path: bf16 token mean {k16 / c16:.6f} vs {p16 / pc16:.6f}, |diff| "
        f"{mean_diff:.3e} (tol {STEP_LOSS_TOL}); fp32 sum {k32:.4f} vs {p32:.4f}, relative diff "
        f"{rel:.3e} (tol {EVAL_SUM_RTOL}); planted fault ({plant[0]}), fp32: relative diff "
        f"{bad_rel:.3e} (must exceed {EVAL_SUM_RTOL})")
    if not (c16 == pc16 == c32 == pc32):
        raise AssertionError(f"eval counts differ: {c16}, {pc16}, {c32}, {pc32}")
    if not mean_diff <= STEP_LOSS_TOL or not rel <= EVAL_SUM_RTOL:
        raise AssertionError(f"eval through the kernels vs the plain path: bf16 {mean_diff}, "
                             f"fp32 {rel}")
    if not bad_rel > EVAL_SUM_RTOL:
        raise AssertionError(f"the eval check passes a planted fault ({bad_rel})")


# the kernels of each forward pass, as torch.profiler names them (substrings)
FORWARD_KERNELS = {"fwd": ("fwd_tc_kernel",), "ce_fwd": ("ce_stats_tc_kernel", "ce_lse_kernel"),
                   "prologue_fwd": ("prologue_norm_kernel", "prologue_fwd_tc_kernel")}


def forward_kernel_ms(run) -> dict:
    """Device ms per call of each forward pass inside one more eval of `run`
    (torch.profiler, device-side events; its launches from the counters)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp

    fa.reset_launch_counts()
    fc.reset_launch_counts()
    fp.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run.evaluate()
        torch.cuda.synchronize()
    launches = {**fa.launch_counts, **fc.launch_counts, **fp.launch_counts}
    ms = {key: 0.0 for key in FORWARD_KERNELS}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for key, names in FORWARD_KERNELS.items():
            # "fwd_tc_kernel" is also inside "prologue_fwd_tc_kernel"
            if any(n in evt.key for n in names) and (key != "fwd" or "prologue" not in evt.key):
                ms[key] += evt.self_device_time_total / 1e3
    if not all(ms.values()):
        raise AssertionError(f"the eval's profile holds no device time for {ms}")
    return {key: ms[key] / launches[key] for key in ms}


def phase_eval(train_losses: list) -> None:
    """Evaluation at the slice (TRAIN_OVERRIDES + EVAL_OVERRIDES): the
    trainer's 4 steps with a held-out set evaluated at steps 2 and 4 and the
    state saved at step 4. Each eval's launches exactly (forward only, on the
    tensor cores); parameters and optimizer moments bit-equal across the
    second eval (the first measures peak memory, with nothing extra held);
    the training losses those of the trainer phase (no eval)
    within RUN_REPEAT_TOL; checkpoint-4's meta.json carries the last
    eval_loss of the metrics line and eval_step 4; the eval's (sum, count)
    against the plain path (eval_parity, the last PLANT_CUT keys hidden as
    the planted fault). Prints eval ms per token, the forward kernels' ms
    per call inside an eval, and peak memory in eval against training."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.ops.attention import attention
    from llama_pipeline_parallel_tpu_torch.train import build_run, train_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "eval")
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    log(f"[eval] {config} TRAIN_OVERRIDES + {' '.join(EVAL_OVERRIDES)}")
    run = build_run(load_config(config, TRAIN_OVERRIDES + EVAL_OVERRIDES
                                + [f"output_dir={out_dir}"]), "cuda")
    state = run.state
    evals = []  # [launches, tensor-core calls, seconds, train peak, eval peak, bit-equal]
    evaluate = run.evaluate

    def measured_eval():
        train_peak = torch.cuda.max_memory_allocated()
        kept = None
        if evals:  # the second eval: hold the state to compare (the first measures memory)
            kept = ({k: v.detach().clone() for k, v in state.params.items()},
                    {k: v.clone() for k, v in state.optimizer.mu.items()},
                    {k: v.clone() for k, v in state.optimizer.nu.items()})
        fa.reset_launch_counts()
        fc.reset_launch_counts()
        fp.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        eval_loss = evaluate()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        same = None
        if kept is not None:
            same = (all(torch.equal(v, kept[0][k]) for k, v in state.params.items())
                    and all(torch.equal(v, kept[1][k]) for k, v in state.optimizer.mu.items())
                    and all(torch.equal(v, kept[2][k]) for k, v in state.optimizer.nu.items()))
            del kept
        evals.append([{**fa.launch_counts, **fc.launch_counts, **fp.launch_counts},
                      {**fa.tensor_core_counts, **fc.tensor_core_counts,
                       **fp.tensor_core_counts}, secs, train_peak,
                      torch.cuda.max_memory_allocated(), same])
        return eval_loss

    run.evaluate = measured_eval
    torch.cuda.reset_peak_memory_stats()
    summary = train_run(run)
    run.evaluate = evaluate
    losses = summary["losses"]
    layers = run.model_cfg.num_hidden_layers
    eval_mb = len(run.eval_loader) * run.num_microbatches
    eval_tokens = sum(b["input_ids"].size for b in run.eval_loader)
    repeat = max(abs(a - b) for a, b in zip(losses, train_losses))
    log(f"[eval] losses {losses}; |diff| from the trainer phase's run without eval {repeat:.2e} "
        f"(tol {RUN_REPEAT_TOL}); parameters and moments bit-equal across the second eval: "
        f"{evals[-1][5] if evals else None}")
    if len(evals) != 2 or len(losses) != len(train_losses) or not repeat <= RUN_REPEAT_TOL:
        raise AssertionError(f"{len(evals)} evals (want 2), losses {losses} against "
                             f"{train_losses}")
    if evals[-1][5] is not True:
        raise AssertionError("an eval changed the parameters or the optimizer's moments")
    check_eval_counts("[eval]", evals, layers, eval_mb)

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        eval_lines = [r for r in map(json.loads, f) if "eval_loss" in r]
    meta = json.load(open(os.path.join(out_dir, f"checkpoint-{EVAL_SAVE_STEP}", "meta.json")))
    log(f"[eval] metrics eval lines {eval_lines}; checkpoint-{EVAL_SAVE_STEP} meta.json "
        f"eval_loss {meta.get('eval_loss')}, eval_step {meta.get('eval_step')}")
    if ([r["step"] for r in eval_lines] != [2, EVAL_SAVE_STEP]
            or meta.get("eval_loss") != eval_lines[-1]["eval_loss"]
            or meta.get("eval_step") != EVAL_SAVE_STEP):
        raise AssertionError(f"eval lines {eval_lines}, meta.json {meta.get('eval_loss')} at "
                             f"{meta.get('eval_step')}")
    shutil.rmtree(os.path.join(out_dir, f"checkpoint-{EVAL_SAVE_STEP}"))

    per_call = forward_kernel_ms(run)
    secs = statistics.median(e[2] for e in evals)
    log(f"[eval] card {card_line()}: an eval of {eval_tokens} row tokens ({eval_mb} microbatches) "
        f"takes {1e3 * secs:.1f} ms (median of {len(evals)}), "
        f"{1e3 * secs / eval_tokens:.5f} ms per eval token; forward kernels' device ms per "
        f"call inside an eval: flash_fwd {per_call['fwd']:.4f}, ce_fwd {per_call['ce_fwd']:.4f}, "
        f"prologue_fwd {per_call['prologue_fwd']:.4f}; max_memory_allocated in the first "
        f"eval {evals[0][4] / 2**30:.2f} GiB against training (steps 1-2, 3-4) "
        f"{evals[0][3] / 2**30:.2f}, {evals[1][3] / 2**30:.2f} GiB")
    eval_parity(run, attention, (f"last {PLANT_CUT} keys hidden", hide_last_keys), "[eval]")
    del run, state, summary, evaluate
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[eval] phase {time.perf_counter() - t0:.1f} s")


def phase_preempt(losses_a: list) -> None:
    """Preemption on the card: the checkpoint phase's run (CKPT_OVERRIDES)
    through the CLI in a subprocess (PREEMPT_RUN), sent SIGTERM after its
    second logged step. It must exit 0 with a complete checkpoint-N and
    `latest` at the step its log names; resumed here (PREEMPT_RESUME: the
    restore verifies the checkpoint's digests), steps
    N+1.. must repeat the checkpoint phase's uninterrupted run A within
    RESUME_LOSS_TOL. Planted: the resumed stream opened one batch late (a
    skipped batch) must give a first-step loss outside that limit."""
    import gc
    import re
    import signal

    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as ck
    from llama_pipeline_parallel_tpu_torch.data.loader import RepeatingLoader
    from llama_pipeline_parallel_tpu_torch.train import build_run, train_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "preempt")
    metrics = os.path.join(out_dir, "metrics.jsonl")
    cmd = [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config", config,
           *CKPT_OVERRIDES, *PREEMPT_RUN, f"output_dir={out_dir}"]
    log(f"[preempt] CLI: {config} TRAIN_OVERRIDES + "
        f"{' '.join(CKPT_OVERRIDES[len(TRAIN_OVERRIDES):] + PREEMPT_RUN)}")
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.monotonic() + 300
        logged = 0
        while logged < 2 and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
            if os.path.exists(metrics):
                with open(metrics) as f:
                    logged = sum(1 for x in f if x.strip())
        t_signal = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    stop_s = time.perf_counter() - t_signal
    found = re.search(r"preemption signal; checkpointing at step (\d+)", err)
    n = int(found.group(1)) if found else None
    mgr = ck.CheckpointManager(out_dir)
    log(f"[preempt] SIGTERM after {logged} logged steps: rc {proc.returncode}, log names step "
        f"{n}, {stop_s:.1f} s from the signal to the exit (the blocking save included); latest "
        f"complete checkpoint {mgr.latest_step()}; stdout {out.strip()[-300:]!r}")
    if proc.returncode != 0 or n is None or mgr.latest_step() != n or not 2 <= n < len(losses_a):
        raise AssertionError(f"preempted CLI: rc {proc.returncode}, step {n}, latest "
                             f"{mgr.latest_step()}; stderr {err[-2000:]}")
    with open(os.path.join(out_dir, "latest")) as f:
        if f.read().strip() != f"checkpoint-{n}":
            raise AssertionError(f"latest does not name checkpoint-{n}")

    run = build_run(load_config(config, CKPT_OVERRIDES + PREEMPT_RESUME
                                + [f"output_dir={out_dir}"]), "cuda")
    if run.start_step != n:
        raise AssertionError(f"the resume starts at {run.start_step}, not {n}")
    epoch, offset = run.data_start
    spe = len(run.loader)

    def first_loss(start_batch: int) -> float:
        """Step N+1's loss from the batch at this stream position, forward
        only, on the restored params."""
        batch = next(iter(RepeatingLoader(run.loader, *divmod(epoch * spe + start_batch, spe))))
        loss_sum, count = run.eval_sum_count(run.on_device(batch))
        return float(loss_sum) / int(count)

    honest, skipped = first_loss(offset), first_loss(offset + 1)
    summary = train_run(run)
    diffs = [abs(b - a) for a, b in zip(losses_a[n:], summary["losses"])]
    log(f"[preempt] resumed at step {n}: losses {summary['losses']} against run A's "
        f"{losses_a[n:]}, |diff| {diffs} (tol {RESUME_LOSS_TOL}; "
        f"{'bit-equal' if not any(diffs) else 'not bit-equal'}); step {n + 1}'s loss forward "
        f"only {abs(honest - losses_a[n]):.2e} off A's; planted (one batch skipped): "
        f"{abs(skipped - losses_a[n]):.2e} off (must exceed {RESUME_LOSS_TOL})")
    if len(diffs) != len(losses_a) - n or not max(diffs) <= RESUME_LOSS_TOL:
        raise AssertionError(f"resumed losses {summary['losses']} against {losses_a[n:]}")
    if not abs(honest - losses_a[n]) <= RESUME_LOSS_TOL:
        raise AssertionError(f"step {n + 1} forward only: {honest} against {losses_a[n]}")
    if not abs(skipped - losses_a[n]) > RESUME_LOSS_TOL:
        raise AssertionError("the resume check passes a skipped batch")
    del run, summary
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[preempt] phase {time.perf_counter() - t0:.1f} s")


def phase_remat() -> None:
    """The remat policies at the slice with activation checkpointing (the
    trainer's attention, loss head and prologue): per policy of REMAT_TABLE,
    step 1's forward and backward (no update) on the same params and batch:
    its launches (the flash and prologue forwards twice a layer and
    microbatch under a recomputing policy, once under everything_saveable),
    its ms (median of 3 after a warm-up), max_memory_allocated and the
    memory the first microbatch's forward leaves allocated for the backward,
    neither of which may fall as the policy keeps more (and what the forward
    keeps must grow from nothing_saveable to everything_saveable); its loss and gradients against
    everything_saveable's, in bf16 within STEP_LOSS_TOL and in fp32 compute
    within REMAT_FP32_RTOL (relative)."""
    import dataclasses
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
        head_loss_sum_count,
        shift_labels,
    )
    from llama_pipeline_parallel_tpu_torch.train import build_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    overrides = TRAIN_OVERRIDES + ["activation_checkpointing=true"]
    run = build_run(load_config(config, overrides + [
        f"output_dir={os.path.join(ROOT, 'build', 'chip_smoke', 'remat')}"]), "cuda")
    log(f"[remat] {config} TRAIN_OVERRIDES + activation_checkpointing=true, policies "
        f"{REMAT_TABLE}")
    batch = next(run.batches())
    params = run.state.params
    targets = shift_labels(batch["labels"])
    count = (targets != llama.IGNORE_INDEX).sum()
    mb = targets.shape[0] // run.num_microbatches
    layers = run.model_cfg.num_hidden_layers

    kept = {}  # policy -> bytes the first microbatch's forward leaves allocated

    def step_one(mcfg, policy: str) -> float:
        """Step 1's forward and backward under `policy`; the loss (grads in
        .grad)."""
        for p in params.values():
            p.grad = None
        total = 0.0
        for i in range(run.num_microbatches):
            rows = slice(i * mb, (i + 1) * mb)
            before = torch.cuda.memory_allocated()
            hn = llama.hidden_states(params, batch["input_ids"][rows],
                                     batch["attention_mask"][rows], batch["position_ids"][rows],
                                     cfg=mcfg, attn_fn=run.attn_fn, remat=True,
                                     remat_policy=policy, kernel_prologue=run.kernel_prologue)
            loss = head_loss_sum_count(params, hn, targets[rows], mcfg, run.head)[0] / count
            if i == 0:
                kept[policy] = torch.cuda.memory_allocated() - before
            loss.backward()
            total += loss.item()
        torch.cuda.synchronize()
        return total

    rows = {}
    for policy in REMAT_TABLE:  # launches, time and memory, with nothing else held
        step_one(run.model_cfg, policy)  # warm-up
        for p in params.values():
            p.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        fa.reset_launch_counts()
        fc.reset_launch_counts()
        fp.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        step_one(run.model_cfg, policy)
        launches = {**fa.launch_counts, **fc.launch_counts, **fp.launch_counts}
        peak = torch.cuda.max_memory_allocated()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            step_one(run.model_cfg, policy)
            times.append(time.perf_counter() - t)
        rows[policy] = {"launches": launches, "peak": peak, "kept": kept[policy],
                        "ms": 1e3 * statistics.median(times)}
        forwards = run.num_microbatches * layers * (1 if policy == "everything_saveable" else 2)
        want = {**{key: run.num_microbatches * layers for key in (*fa.launch_counts,
                                                                  *fp.launch_counts)},
                **{key: run.num_microbatches for key in fc.launch_counts},
                "fwd": forwards, "prologue_fwd": forwards}
        if launches != want:
            raise AssertionError(f"[remat] {policy}: launches {launches}, expected {want}")
    for p in params.values():
        p.grad = None

    fp32 = dataclasses.replace(run.model_cfg, dtype=torch.float32)
    ref = {}
    for mcfg, tag in ((run.model_cfg, "bf16"), (fp32, "fp32")):
        ref_loss = step_one(mcfg, "everything_saveable")
        ref_grads = {k: p.grad.clone() for k, p in params.items()}
        for policy in REMAT_TABLE[:-1]:
            loss = step_one(mcfg, policy)
            rows[policy][tag] = (abs(loss - ref_loss),
                                 rel_diff({k: p.grad for k, p in params.items()}, ref_grads))
        ref[tag] = ref_loss
        del ref_grads
    for p in params.values():
        p.grad = None
    card = card_line()
    log(f"[remat] card {card}: step 1 forward + backward ({run.num_microbatches} microbatches, "
        f"no update) per policy; loss and gradient rel diff against everything_saveable "
        f"(bf16 tol {STEP_LOSS_TOL}, fp32 tol {REMAT_FP32_RTOL} relative)")
    for policy, row in rows.items():
        (l16, g16), (l32, g32) = row.get("bf16", (0.0, 0.0)), row.get("fp32", (0.0, 0.0))
        log(f"  {policy:34s} {row['ms']:8.1f} ms  max_memory_allocated "
            f"{row['peak'] / 2**30:6.2f} GiB, kept by a microbatch's forward "
            f"{row['kept'] / 2**30:6.3f} GiB  flash fwd {row['launches']['fwd']}, prologue fwd "
            f"{row['launches']['prologue_fwd']}; bf16 loss |diff| {l16:.2e}, grads {g16:.2e}; "
            f"fp32 loss |diff| {l32:.2e}, grads {g32:.2e}")
    for policy in REMAT_TABLE[:-1]:
        (l16, g16), (l32, g32) = rows[policy]["bf16"], rows[policy]["fp32"]
        if not (l16 <= STEP_LOSS_TOL and g16 <= STEP_LOSS_TOL
                and l32 <= REMAT_FP32_RTOL * abs(ref["fp32"]) and g32 <= REMAT_FP32_RTOL):
            raise AssertionError(f"[remat] {policy} against everything_saveable: {rows[policy]}")
    peaks = [rows[policy]["peak"] for policy in REMAT_TABLE]
    held = [rows[policy]["kept"] for policy in REMAT_TABLE]
    if peaks != sorted(peaks) or held != sorted(held) or not held[0] < held[-1]:
        raise AssertionError(f"[remat] memory falls as the policy keeps more: peaks {peaks}, "
                             f"kept by the forward {held}")
    del run, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[remat] phase {time.perf_counter() - t0:.1f} s")


def pipeline_launches(us, manifest, accum_chunks: int, remat: bool) -> dict:
    """The launches of each of the nine kernels in one step of the unit
    sequence `us` (parallel/pipeline.Pipeline's rules), per valid cell of
    stage s holding a chunk of k layers:
    - F: k flash and prologue forwards, none on the chunk that owns the loss
      (its output goes nowhere; its B recomputes it);
    - B: a recompute (k forwards, 2k with `remat`), k flash dq and dk/dv and
      prologue dhidden, k prologue dW when fused; on the loss-owning chunk
      one CE forward and dh, and dW when fused. Split (zb1): nothing on
      (stage 0, chunk 0), whose input is the embedding lookup;
    - W: the recompute, k dq, dk/dv, dhidden (the norm weight's gradient)
      and dW; on the loss-owning chunk one CE forward, dh and dW.
    Times `accum_chunks` flushes."""
    from llama_pipeline_parallel_tpu_torch.parallel import schedule as usched

    n = dict.fromkeys(("fwd", "dq", "dkv", "ce_fwd", "ce_dh", "ce_dw", "prologue_fwd",
                       "prologue_dhidden", "prologue_dw"), 0)
    s_total, v = us.num_stages, us.virtual_stages
    for kind, grid in (("F", us.f_unit), ("B", us.b_unit), ("W", us.w_unit)):
        for s in range(s_total):
            for u in grid[:, s][grid[:, s] >= 0]:
                ch = (usched.unit_mb_chunk if kind == "F"
                      else usched.bwd_unit_mb_chunk)(int(u), s_total, v)[1]
                first, last = s == 0 and ch == 0, s == s_total - 1 and ch == v - 1
                k = len(manifest.layers_of_chunk(s, ch))
                if kind == "F":
                    n["fwd"] += 0 if last else k
                    n["prologue_fwd"] += 0 if last else k
                    continue
                if kind == "B" and us.split_backward and first:
                    continue
                weights = kind == "W" or not us.split_backward
                for key in ("fwd", "prologue_fwd"):
                    n[key] += 2 * k if remat else k
                for key in ("dq", "dkv", "prologue_dhidden"):
                    n[key] += k
                n["prologue_dw"] += k if weights else 0
                if last:
                    n["ce_fwd"] += 1
                    n["ce_dh"] += 1
                    n["ce_dw"] += int(weights)
    return {key: c * accum_chunks for key, c in n.items()}


def phase_pipeline() -> None:
    """conf/llama_7b_pp4.yaml at pp 4 on the one card (see the module
    docstring, phase 11): each schedule of PIPE_SCHEDULES through
    run_training with exact launch counts, its numbers beside the
    unpipelined step's, then the parity of step 1 (pipeline_parity)."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
    from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig
    from llama_pipeline_parallel_tpu_torch.train import (
        build_manifest,
        build_model_config,
        build_pipeline_config,
        run_training,
    )
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config
    from llama_pipeline_parallel_tpu_torch.utils.metrics import peak_flops, train_flops_per_token

    t0 = time.perf_counter()
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "pipeline")
    log(f"[pipeline] {config} {' '.join(PIPE_OVERRIDES)}")
    rows = {}
    first_loss = None
    for name, extra in {**PIPE_SCHEDULES, "unpipelined": ["mesh.pp=1",
                                                          "activation_checkpointing=true"]
                        }.items():
        cfg = load_config(config, PIPE_OVERRIDES + extra + [f"output_dir={out_dir}/{name}"])
        mcfg = build_model_config(cfg["model"])
        pp = cfg["mesh"]["pp"]
        steps = cfg["max_steps"]
        if name in PIPE_SCHEDULES:
            if pp != 4:
                raise AssertionError(f"[pipeline] {config} has mesh.pp {pp}, not 4")
            manifest = build_manifest(cfg, mcfg, pp)
            pcfg = build_pipeline_config(cfg, MeshConfig(pp=pp), manifest)
            per_step = pipeline_launches(pl.flush_unit_schedule(pcfg), manifest,
                                         pcfg.accum_chunks, pcfg.remat)
            bubble = pl.bubble_fraction(pcfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for module in (fa, fc, fp):
            module.reset_launch_counts()
        summary = run_training(cfg, device="cuda")
        launches = {**fa.launch_counts, **fc.launch_counts, **fp.launch_counts}
        tensor_core = {**fa.tensor_core_counts, **fc.tensor_core_counts,
                       **fp.tensor_core_counts}
        losses = summary["losses"]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[pipeline] {name}: non-finite loss {losses}")
        step_s = statistics.median(summary["step_times"][1:])
        tokens = summary["tokens_per_step"]
        rows[name] = {"losses": losses, "ms": 1e3 * step_s, "tokens_per_s": tokens / step_s,
                      "mfu": (train_flops_per_token(mcfg, 2048) * tokens / step_s
                              / peak_flops(torch.device("cuda"))),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "bubble": bubble if name in PIPE_SCHEDULES else 0.0}
        del summary
        if name not in PIPE_SCHEDULES:
            continue
        want = {key: c * steps for key, c in per_step.items()}
        log(f"[pipeline] {name}: launches {launches} (expected {want}); per step {per_step}")
        if launches != want:
            raise AssertionError(f"[pipeline] {name}: launches {launches}, expected {want} "
                                 f"(pipeline_launches over the unit grid, x {steps} steps)")
        if tensor_core != want:
            raise AssertionError(f"[pipeline] {name}: calls on the tensor cores {tensor_core}, "
                                 f"expected every launch {want}")
        first_loss = losses[0] if first_loss is None else first_loss
    card = card_line()
    log(f"[pipeline] card {card}: per schedule, {steps} steps at LLaMA-7B width, 8 layers, seq "
        f"2048, 8 microbatches of 1 row; step ms the median of steps 2-{steps}; MFU against "
        f"989 TFLOP/s (PaLM accounting, recompute not counted). All stages run one after "
        f"another on the one card, so the counted bubble costs no wall time here")
    for name, row in rows.items():
        log(f"  {name:17s} step {row['ms']:8.1f} ms  {row['tokens_per_s']:8.0f} tokens/s  MFU "
            f"{row['mfu']:.4f}  max_memory_allocated {row['peak_gib']:6.2f} GiB  bubble "
            f"{row['bubble']:.4f}  losses {[round(x, 5) for x in row['losses']]}  ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    pipeline_parity(config, first_loss)
    log(f"[pipeline] phase {time.perf_counter() - t0:.1f} s")


def zero_first_cotangent(num_stages: int):
    """A planted fault for the pipeline parity: a local transport that hands
    the first B cotangent it delivers over as zeros."""
    import torch

    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl

    class ZeroFirstCotangent(pl.LocalTransport):
        planted = False

        def recv(self, kind, stage):
            t = super().recv(kind, stage)
            if kind == pl.BWD and not self.planted:
                self.planted = True
                return torch.zeros_like(t)
            return t

    return ZeroFirstCotangent(num_stages)


def pipeline_parity(config: str, run_first_loss: float) -> None:
    """Step 1 of the pipeline phase's runs again, on the same params and
    batch (a fresh build of the unpipelined config from the same seed: the
    canonical init every schedule split into its stages): the flat pipeline
    against the unpipelined forward and backward (bf16: step loss within
    STEP_LOSS_TOL, and the run's first loss repeated within RUN_REPEAT_TOL;
    fp32 compute on PIPE_FP32_MICROBATCHES rows: loss within
    FP32_STEP_LOSS_TOL, gradients within GRAD_REL_TOL relative); interleaved
    and zb1 against flat with the same tolerances, whether the gradients
    are bit-equal reported (the unpipelined loss is a sum of Python floats,
    the pipeline's of fp32 tensors, so the losses differ in rounding); a
    zeroed cotangent (zero_first_cotangent) must fail the fp32 gradient check."""
    import dataclasses
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
    from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
        head_loss_sum_count,
        shift_labels,
    )
    from llama_pipeline_parallel_tpu_torch.train import (
        build_manifest,
        build_pipeline_config,
        build_run,
    )
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    run = build_run(load_config(config, PIPE_OVERRIDES + ["mesh.pp=1", (
        f"output_dir={os.path.join(ROOT, 'build', 'chip_smoke', 'pipeline', 'parity')}")]),
        "cuda")
    run.state.optimizer = None  # only the params and the batch are needed here
    gc.collect()
    torch.cuda.empty_cache()
    batch = next(run.batches())
    params = run.state.params

    def unpipelined(mcfg, rows: int):
        """The step's loss and gradients (canonical, cloned), microbatch by
        microbatch on the run's kernels, no update."""
        targets = shift_labels(batch["labels"][:rows])
        count = (targets != llama.IGNORE_INDEX).sum()
        for p in params.values():
            p.grad = None
        total = 0.0
        for i in range(rows):
            r = slice(i, i + 1)
            hn = llama.hidden_states(params, batch["input_ids"][r], batch["attention_mask"][r],
                                     batch["position_ids"][r], cfg=mcfg, attn_fn=run.attn_fn,
                                     kernel_prologue=run.kernel_prologue)
            loss = head_loss_sum_count(params, hn, targets[r], mcfg, run.head)[0] / count
            loss.backward()
            total += loss.item()
        grads = {k: p.grad.clone() for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return total, grads

    def pipelined(mcfg, schedule: str, rows: int, transport=None):
        cfg = load_config(config, PIPE_OVERRIDES + PIPE_SCHEDULES[schedule] + [
            f"gradient_accumulation_steps={rows}"])
        manifest = build_manifest(cfg, mcfg, 4)
        pcfg = build_pipeline_config(cfg, MeshConfig(pp=4), manifest)
        sp = pl.StageParams.from_canonical(params, manifest)
        pipe = pl.Pipeline(mcfg, pcfg, make_mesh(MeshConfig(pp=4)), sp, run.attn_fn,
                           transport=transport)
        loss = pipe.loss_and_grad({k: v[:rows] for k, v in batch.items()}).item()
        grads = sp.to_canonical({k: p.grad for k, p in sp.flat().items()})
        del pipe, sp
        gc.collect()
        torch.cuda.empty_cache()
        return loss, grads

    def same_grads(a, b) -> bool:
        return all(torch.equal(a[1][k], b[1][k]) for k in a[1])

    card = card_line()
    bf16 = run.model_cfg
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    rows = run.num_microbatches
    for mcfg, tag, n in ((bf16, "bf16", rows), (fp32, "fp32", PIPE_FP32_MICROBATCHES)):
        ref = unpipelined(mcfg, n)
        flat = pipelined(mcfg, "1f1b", n)
        loss_diff, grad_rel = abs(flat[0] - ref[0]), rel_diff(flat[1], ref[1])
        held_loss = STEP_LOSS_TOL if tag == "bf16" else FP32_STEP_LOSS_TOL
        log(f"[pipeline] {tag}, {n} microbatches, step 1 on the same params and batch: flat "
            f"pipeline vs unpipelined: loss |diff| {loss_diff:.3e} (tol {held_loss}), gradient "
            f"rel diff {grad_rel:.3e} ({'tol ' + str(GRAD_REL_TOL) if tag == 'fp32' else 'not held'}"
            f"), gradients bit-equal {same_grads(flat, ref)} ({card})")
        if not loss_diff <= held_loss or (tag == "fp32" and not grad_rel <= GRAD_REL_TOL):
            raise AssertionError(f"[pipeline] {tag} flat pipeline vs unpipelined: loss "
                                 f"{flat[0]} vs {ref[0]}, gradient rel diff {grad_rel}")
        if tag == "bf16" and not abs(flat[0] - run_first_loss) <= RUN_REPEAT_TOL:
            raise AssertionError(f"[pipeline] step 1 again gives {flat[0]}, the run gave "
                                 f"{run_first_loss}")
        if tag == "fp32":
            bad = pipelined(mcfg, "1f1b", n, transport=zero_first_cotangent(4))
            bad_rel = rel_diff(bad[1], ref[1])
            log(f"[pipeline] planted fault (one B unit's received cotangent zeroed), fp32: "
                f"gradient rel diff {bad_rel:.3e}, loss |diff| {abs(bad[0] - ref[0]):.3e}")
            if not bad_rel > GRAD_REL_TOL:
                raise AssertionError(f"[pipeline] the gradient check passes a zeroed cotangent "
                                     f"({bad_rel})")
            del bad
        del ref
        for schedule in ("interleaved_1f1b", "zb1"):
            got = pipelined(mcfg, schedule, n)
            d_loss, d_grad = abs(got[0] - flat[0]), rel_diff(got[1], flat[1])
            log(f"[pipeline] {tag}: {schedule} vs flat 1f1b: loss |diff| {d_loss:.3e}, gradient "
                f"rel diff {d_grad:.3e}, gradients bit-equal {same_grads(got, flat)}")
            if not d_loss <= held_loss or (tag == "fp32" and not d_grad <= GRAD_REL_TOL):
                raise AssertionError(f"[pipeline] {tag} {schedule} vs flat: loss |diff| "
                                     f"{d_loss}, gradient rel diff {d_grad}")
            del got
        del flat
        gc.collect()
        torch.cuda.empty_cache()
    del run, params, batch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA "
              "card", file=sys.stderr)
        return 2
    try:
        import llama_pipeline_parallel_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
    phase_build()
    rows = phase_kernels()
    rows.update(phase_ce())
    rows.update(phase_prologue())
    launches, train_losses = phase_trainer()
    losses_a = phase_checkpoint()
    phase_packed()
    phase_eval(train_losses)
    phase_preempt(losses_a)
    phase_remat()
    phase_pipeline()
    for key, row in rows.items():
        row["launches"] = launches[key]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
