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
              prologue forward, dhidden and dW call on the tensor cores; with
              the observability layer on (numerics by default, OBS_OVERRIDES:
              the memory watch, a one-step profile window, the heartbeat):
              spans.jsonl, health.json, numerics.jsonl, memory.jsonl,
              perf.jsonl and the torch.profiler trace parsed and checked
              (check_observability), and the step timed with the numerics
              stats on and off (numerics_cost). Then the observability drills
              at one layer (phase_observability): a grad_nonfinite step
              skipped with the params and moments bit-equal, the halt on a
              nonfinite step after a final checkpoint, the OOM snapshot and
              capture.
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
              virtual_stages 2, zb1 with virtual_stages 2, and the gpipe
              phase: gpipe with activation checkpointing): every loss finite,
              each of the nine kernels launched exactly as the unit grid
              says (pipeline_launches) and every call on the tensor cores;
              step ms, tokens/s, MFU, max_memory_allocated and the counted
              bubble per schedule, beside the unpipelined step at the same
              depth and microbatches with activation checkpointing on; flat
              1f1b with the timeline on (one record a step, the plan's
              segments, the measured bubble: check_timeline). Then
              step 1 again on the same params and batch: the flat pipeline
              against the unpipelined step (bf16 step loss; fp32 compute at
              4 microbatches: loss and gradients), interleaved, zb1 and gpipe
              against flat (the same tolerances; bit-equality reported, and
              required of gpipe's gradients), and
              the flat pipeline with one B unit's received cotangent zeroed
              rejected by the fp32 gradient check.
12. offload -- the host optimizer (optimizer_offload) and the host stash on
              conf/llama_7b_pp4.yaml: (a) the pipeline phase's run at 4
              layers on the host AdamW against the device AdamW (step 1's
              loss and the gradients handed over bit-equal, held to
              OFFLOAD_GRAD_RTOL; masters after 3 steps within the reference's
              optax limits; losses of steps 2-3 within STEP_LOSS_TOL), run
              twice (bit-equal losses: no upload races a step), the working
              copy held bit for bit to the RNE cast of the host masters and a
              wq copy left one step stale rejected by that check; zb1
              (virtual_stages 2, 8 layers) with the W queue and the stage
              inputs in pinned host memory against both on the card (loss and
              gradients bit-equal, peak memory not higher, host bytes beside
              the byte model); launches exact in every run. (b) The config as
              published cut to OFFLOAD_FULL_LAYERS of its 32 layers (or the
              largest depth whose 12 B a parameter the host's MemTotal holds
              with 25 % to spare, the cut printed), a warm-up and 3 steps:
              finite losses, exact launches,
              step ms, tokens/s, MFU, peak device memory, peak host RSS, the
              host phases, the link's GB/s each way and the step's link
              floor. (c) The checkpoint phase's run on the host optimizer:
              an offload_parts checkpoint at step 4, resumed bit for bit for
              steps 5-6; resuming it without offload refused by name.
13. multirank -- pp 2 x dp 2 across 4 processes (this script's
              `--multirank-worker` mode) sharing card 0 over gloo
              (LPT_DIST_BACKEND=gloo: every tensor that crosses processes is
              staged through host memory), launched after the build so that
              no rank compiles a kernel: conf/llama_7b_pp4.yaml at LLaMA-7B
              width, 2 layers (1 a stage), seq 2048, 1 row x 2 microbatches a
              replica, ZeRO-1 moments (MULTI_OVERRIDES). (a) A run that one
              rank gets SIGTERM in: every rank exits 0 at the same step N
              (a multiple of MULTI_CHECK_EVERY) with one checkpoint-N. (b) The
              uninterrupted run to N + 2: step 1's loss and gradients against
              one process running pp 2 in memory on the same global batch
              (bf16 loss STEP_LOSS_TOL, gradients GRAD_REL_TOL relative), the
              ZeRO-1 masters bit-equal to a replicated AdamW fed the same
              gradients, each rank's launches exactly its stage's share of the
              unit grid (all on the tensor cores), step ms, tokens/s, bytes a
              rank and the gloo staging seconds (this one-card mode's cost,
              not an NCCL figure). (c) checkpoint-N resumed at pp 2 x dp 2 (4
              processes) and at pp 1 x dp 1 in this process: steps N+1, N+2
              within RESUME_LOSS_TOL of the uninterrupted run. Process 0's
              numerics.jsonl of (b): one record a step, per-stage vectors of
              length pp, nothing nonfinite.
14. tp    -- pp 2 x tp 2 x dp 2 at LLaMA-65B width across 8 processes
              (`--tp-worker`) sharing card 0 over gloo, launched after the
              build: conf/llama_65b_pp8_tp2_dp2.yaml as published (seq 512, 8
              rows a microbatch, bf16, optimizer_offload with
              optimizer_offload_zero2) with TP_OVERRIDES: 2 of 80 layers, pp 2,
              2 microbatches a replica, TP_STEPS steps, flash attention and
              the prologue kernels. First the prologue and flash kernels at a
              tp rank's shapes (TP_PRO, TP_FLASH: d 8192, 32 local heads)
              against their plain versions, with their readings; then one
              process at pp 2 x tp 1 x dp 1 on the same 32 rows (TP_ONE): its
              step-1 loss and gradients, and bf16's own distance from fp32
              there (TP_BF16_ROWS). The 8 ranks: step 1's loss
              (STEP_LOSS_TOL) and every rank's slices of the dp-reduced
              gradient (TP_BF16_GRAD_REL_TOL relative) against it, the same
              gradients with the prologue's tp all-reduce of dhidden skipped
              (a planted fault, which must read above that limit), one fp32
              step's gradients (GRAD_REL_TOL), the same finite
              losses on every rank, each rank's launches exactly its stage's
              share of the unit grid (no CE kernel: the vocab-parallel head
              is a plain product), all on the tensor cores; step ms,
              tokens/s, max_memory_allocated and peak host RSS (sampled) a rank, the
              gloo staging and collective seconds of the pp, dp and tp groups
              apart, the host AdamW's ms (all of it this one-card gloo mode,
              not a multi-card figure).
15. sp    -- pp 2 x tp 2 x sp 2 at CodeLlama-34B width across 8 processes
              (`--sp-worker`) sharing card 0 over gloo, launched after the
              build: conf/codellama_34b_16k.yaml as published (16,384-token
              rows of 1 row a microbatch, ring attention, flash, bf16,
              optimizer_offload, nothing_saveable remat) with SP_OVERRIDES: 2
              of 48 layers, pp 2, 2 microbatches, SP_STEPS steps, the
              prologue kernels; 8,192-token slabs. First the flash kernels at
              an sp rank's slab (SP_FLASH, real offsets) against their plain
              versions on the ring's three kinds of slab: diagonal, fully
              visible, fully masked (out 0, lse NEG_INF, dq / dk / dv 0,
              exactly), and the prologue kernels at a slab whose positions
              start at 8,192 (SP_PRO); with their readings. Then one process
              at pp 2 x tp 1 x sp 1 on the same rows (SP_ONE): its step-1 loss
              and gradients in bf16 and, at SP_FP32's shorter rows, fp32.
              The 8 ranks: step 1's loss (STEP_LOSS_TOL) and gradients
              (TP_BF16_GRAD_REL_TOL relative) against it, every rank alike;
              the same with every slab's kv_offset 0 (a planted fault: the
              gradient check must reject it); Ulysses in place of the ring on
              the same params and rows under the bf16 gates; an fp32 run's
              step-1 gradients at SP_FP32's shorter rows (GRAD_REL_TOL); each
              rank's launches exactly its stage's share of the
              unit grid times the slab calls of an attention (sp for each
              flash kernel under the ring, 1 under Ulysses; the prologue
              kernels once; no CE kernel), all on the tensor cores; step ms,
              tokens/s, max_memory_allocated and peak host RSS a rank, the
              gloo staging and collective seconds by group (this one-card
              gloo mode, not a multi-card figure).
16. serving -- decode and continuous batching at conf/llama_7b_pp4.yaml's
              model, LLaMA-7B at all 32 layers, bf16 weights drawn on the card
              from SERVE_SEED (13.48 GB): prefill_prompt's last logits against
              the trainer's forward (exact attention) on two 512-token rows,
              one left-padded, in fp32 by the 2^-8 rule and in bf16 within
              SERVE_BF16_NOISE x the trainer's own distance from fp32, the last
              token's rope position shifted by one planted; 8 requests
              (SERVE_REQUESTS: buckets 64-1024, two sampled at temperature 0.8,
              top-k 40, top-p 0.95, four sharing a 512-token prefix, 64 new
              tokens each) through the dense ServeEngine (8 slots x 2048), each
              stream equal to `generate` on its padded prompt and seed; the same
              through paged fp pages (64), chunked prefill (256) and the prefix
              cache (hits counted), each equal to dense; int8 pages (first
              tokens equal; the reference's int8 gate at this size); no launch of
              the nine kernels; readings: prefill ms at 64 / 256 / 1024, the
              decode tick at 1 and 8 active slots (dense, paged fp, paged int8)
              at position 2047, each beside its bound, tokens/s, p50 TTFT and
              TPOT, peak memory and kv bytes; then tools.serve in a subprocess
              on a 2-layer checkpoint written here, SERVE_EP_TRAFFIC streamed
              through serve_traffic's HTTP client and held to the in-process
              engine, exit 0 on SIGTERM.
17. resilience -- the resilience layer, two legs sharing one fleet root.
              The trainer leg: tools.supervisor (--actuate, --fleet-root, the
              ladder RES_LADDER: dp2 on 2 devices, dp1 on 1 with the
              accumulation doubled) over `python -m torch.distributed.run
              -m llama_pipeline_parallel_tpu_torch.cli` on
              conf/llama_7b_pp4.yaml at LLaMA-7B width (RES_OVERRIDES: 2
              layers, seq 2048, the nine kernels, save_steps 2, RES_STEPS
              steps, actions.resize_on_request, the sample ledger), 2 ranks
              over gloo on card 0; after checkpoint-2, tools.fleetd --once
              sees the trainer's step-time alert and tools.fleetctl's
              autoscaler borrows (action.request -> the supervisor ->
              resize.request): both ranks vote and stop at one step (2, or 3
              for a request later than checkpoint-2's save: the dp2 rung
              holds its ranks RES_LATE_HOLD_S before step 3's vote), save,
              ack and exit 0, and the supervisor relaunches one rank at dp1
              (--nproc_per_node 1), which resumes from that checkpoint and
              finishes. Checked: every rank's vote at one step, its
              checkpoint saved and resumed; the ledger's layouts [dp2, dp1],
              resized, clean; the journal's
              borrow done and the ack; the final meta.json's topology (dp 1)
              and consumed_samples; the nine kernels launched in both
              incarnations (perf.jsonl's kernel_launches rows); the sample
              ledger against a straight dp1 run of the same global batch in
              this process, no id twice; the last loss within STEP_LOSS_TOL
              of it; goodput_report's resize. The serving leg: two
              tools.serve replicas of the final checkpoint, each under its
              own supervisor (role serve), tools.gateway over the fleet
              registry, RES_TRAFFIC streamed through it with replica a
              SIGKILLed mid-stream (once a stream on it has the WAL's first
              watermark): every stream equal to `generate` in this
              process on the same checkpoint, one WAL terminal row a request
              and a replay's routed row; a's supervisor relaunches it (its
              device probe held RES_PROBE_STALL_S by a fault-plan stall), the
              fleet aggregator records a's stale-heartbeat edge firing, then
              resolving, and a's relaunch consumes exactly one capture
              trigger; every process exits 0 on SIGTERM. Prints each leg's
              seconds, the resize's wall from dp2's exit to dp1's first step
              beside goodput_report's resize_lost_seconds, the replayed
              tokens and the gateway's TTFT. Checkpoints carry no sha256 digests here
              (res_env).

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
# the trainer phase's observability on the card: numerics (on by default),
# the memory watch, a one-step torch.profiler window on the last step and the
# heartbeat every second; the files the run must write, and the steps the
# cost of the numerics stats is timed over (each on, then off, alternately)
OBS_OVERRIDES = ["memory={enabled: true}", "profile_steps=[3,4]", "health_interval=1"]
OBS_FILES = ("spans.jsonl", "health.json", "numerics.jsonl", "memory.jsonl", "perf.jsonl",
             "metrics.jsonl")
NUMERICS_COST_STEPS = 3
# the observability phase's drills: the slice cut to one layer (the guard,
# the halt's checkpoint of ~5.6 GB, the OOM snapshot)
DRILL_OVERRIDES = TRAIN_OVERRIDES + ["model.num_hidden_layers=1", "logging_steps=1"]
# the packed phase: conf/llama_7b_flan_packed.yaml (max_seq_length 512,
# packing_factor 4, 8 rows a microbatch, loss_vocab_chunks 4) at LLaMA-7B
# width, cut to 2 layers (4 before the sp phase needed the time), 2
# microbatches and one card, 4 steps, on a JSONL of
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
    # the forward wave buffers each stage input, M microbatches of them; B
    # recomputes each chunk from its input, keeping each layer's input
    "gpipe": ["pipeline_schedule=gpipe", "activation_checkpointing=true"],
}
# the fp32 parity runs the first PIPE_FP32_MICROBATCHES rows of the batch (M = S)
PIPE_FP32_MICROBATCHES = 4
# the offload phase. (a) The pipeline phase's run cut to 4 layers (one a
# stage), on the host optimizer against the device AdamW: step 1's gradients
# are the same numbers, handed over in fp32 (held to OFFLOAD_GRAD_RTOL
# relative; expected bit-equal) and its loss bit-equal; losses of steps 2-3
# within STEP_LOSS_TOL (the working copy rounds the norms to bf16, the device
# path reads them in fp32, and the two AdamWs round in another order, so
# later gradients differ); the host masters after 3 steps against a device
# AdamW stepped by the same gradients within the reference's
# test_matches_optax limits (Adam moves a parameter by up to its lr whatever
# the gradient's size, so masters of runs whose gradients differ are not
# held to these). The stash runs at 8 layers, the least zb1 at virtual_stages 2 on 4
# stages takes.
OFFLOAD_PARITY_OVERRIDES = PIPE_OVERRIDES + ["model.num_hidden_layers=4"]
OFFLOAD_STASH_OVERRIDES = PIPE_OVERRIDES + PIPE_SCHEDULES["zb1"]
OFFLOAD_STASH_TIERS = ["offload.wgrad_stash=true", "offload.activations=true"]
OFFLOAD_GRAD_RTOL = 1e-6
OFFLOAD_MASTER_RTOL = 2e-5
OFFLOAD_MASTER_ATOL = 1e-6
# (b) conf/llama_7b_pp4.yaml as published (pp 4 in one process, seq 512, 4 rows
# x 16 microbatches, no remat, dp 1) on the host optimizer with the slice's
# kernels, a warm-up step and 3 more, at OFFLOAD_FULL_LAYERS of its 32 layers:
# the 32-layer cell took ~100 s of the script (16.4-16.8 s a step), and the
# multirank phase needed the room; 8 -> 4 for the sp phase (the script ran
# 1,102.3 s of its 1,200 s with 8 on a 700 W H100; every layer runs the same
# code, so 4 leave no path out, but its step ms and MFU are not those of 8).
# Host memory: 12 bytes a parameter (fp32 master, two moments) plus the pinned
# staging, with OFFLOAD_HOST_SPARE to spare, else the depth is cut further to
# what fits.
OFFLOAD_FULL_LAYERS = 4
OFFLOAD_FULL_OVERRIDES = [
    "optimizer_offload=true", "attention=flash", "kernels.ce=pallas", "loss_vocab_chunks=4",
    "kernels.prologue=pallas", "max_steps=4", "save_steps=0", "save_final=false",
    "resume=false", "logging_steps=1",
]
OFFLOAD_HOST_SPARE = 1.25
# (c) the checkpoint phase's run on the host optimizer: run A saves step 4 in
# the offload_parts layout, run B resumes it and repeats steps 5-6
OFFLOAD_CKPT_RUN_A = ["optimizer_offload=true", "save_steps=4", "save_final=false",
                      "resume=false"]
OFFLOAD_CKPT_RUN_B = ["optimizer_offload=true", "save_steps=0", "save_final=false",
                      "resume=true"]
# the multirank phase: pp 2 x dp 2, 4 ranks on card 0 over gloo; a replica is
# 1 row x MULTI_MICROBATCHES microbatches (4 until the resilience phase needed
# the time), cut to 2 layers (a layer a stage; 4 until the serving phase
# needed the time). MULTI_ONE runs the same global batch in one process (dp
# 1: twice the microbatches), MULTI_ONE_PP1 without the pipeline.
MULTI_MICROBATCHES = 2
MULTI_OVERRIDES = PIPE_OVERRIDES + ["model.num_hidden_layers=2", "mesh.pp=2", "mesh.dp=2",
                                    f"gradient_accumulation_steps={MULTI_MICROBATCHES}",
                                    "total_steps=16"]
MULTI_ONE = PIPE_OVERRIDES + ["model.num_hidden_layers=2", "mesh.pp=2", "total_steps=16",
                              f"gradient_accumulation_steps={2 * MULTI_MICROBATCHES}"]
MULTI_ONE_PP1 = MULTI_ONE + ["mesh.pp=1"]
MULTI_CHECK_EVERY = 2
MULTI_RANKS = 4
# phase 14 (tp): conf/llama_65b_pp8_tp2_dp2.yaml (the run of record: LLaMA-65B
# width, seq 512, 8 rows a microbatch, bf16, optimizer_offload with
# optimizer_offload_zero2, 1F1B without per-layer remat) cut to 2 of 80
# layers, pp 8 -> 2 (a layer a stage), 256 -> TP_MICROBATCHES microbatches a
# replica (4 until the resilience phase needed the time) and TP_STEPS steps
# (step 2's loss reads the parameters after the host ZeRO-2 update), with
# flash attention and the prologue kernels: pp 2 x tp 2 x dp 2 in TP_RANKS
# processes on card 0 over gloo. TP_ONE is the one-process reference on the
# same global batch (the two replicas' rows as twice the microbatches, tp
# 1); it takes no optimizer step, so it holds its optimizer on the card
# (optimizer_offload=false: the same gradients, bit for bit, without the
# host state's allocation).
TP_CONFIG = "llama_65b_pp8_tp2_dp2.yaml"
TP_RANKS = 8
TP_STEPS = 2
TP_MICROBATCHES = 2
TP_OVERRIDES = ["model.num_hidden_layers=2", "mesh.pp=2",
                f"gradient_accumulation_steps={TP_MICROBATCHES}",
                "attention=flash", "kernels.prologue=pallas", "total_steps=500",
                "save_steps=0", "save_final=false", "resume=false", "logging_steps=1"]
TP_ONE = TP_OVERRIDES + ["mesh.tp=1", "mesh.dp=1",
                         f"gradient_accumulation_steps={2 * TP_MICROBATCHES}",
                         "optimizer_offload=false", "optimizer_offload_zero2=false"]
# the tight gradient parity runs in fp32 compute, one step at 4 rows a
# microbatch (fp32 doubles the activations of eight ranks on one card) ...
TP_FP32 = ["model.dtype=float32", "per_device_train_batch_size=4", "max_steps=1"]
# ... and bf16's step-1 gradients are held to the one-process bf16 run more
# loosely: the tp ranks round their partial products to bf16 before summing
# them, which moved the gradient by 2.04e-2 relative on an H100 (bf16's own
# distance from fp32 on TP_FP32's rows, one process, is printed beside it:
# TP_BF16_ROWS). The planted fault (the prologue's dhidden all-reduce over
# tp skipped) must read above the limit.
TP_BF16_GRAD_REL_TOL = 5e-2
TP_BF16_ROWS = ["per_device_train_batch_size=4", "max_steps=1"]
# the kernels at a tp rank's shapes of LLaMA-65B: the prologue at [8 x 512
# tokens, d 8192, 32 + 32 + 32 local heads of 128], flash at 32 local heads
TP_PRO = dict(b=8, s=512, d=8192, h=32, kv=32, pos0=0)
TP_FLASH = dict(b=8, h=32, h_kv=32, s=512, hd=128)


# conf/codellama_34b_16k.yaml (CodeLlama-34B: d 8192, 64 heads of 128, 8 kv
# heads, FFN 22016, vocab 32000, rope theta 1e6; 16,384-token rows, 1 row a
# microbatch, bf16, optimizer_offload, ring attention, flash, nothing_saveable
# remat) cut to 2 of 48 layers, pp 4 -> 2, 32 -> 2 microbatches (4 until the
# resilience phase needed the time) and SP_STEPS steps, with the prologue
# kernels: pp 2 x tp 2 x sp 2 in SP_RANKS processes on card 0 over gloo,
# 8,192-token slabs. SP_ONE
# is the one-process reference on the same rows (pp 2 in memory, tp 1, sp 1),
# its optimizer on the card as TP_ONE's.
SP_CONFIG = "codellama_34b_16k.yaml"
SP_RANKS = 8
SP_STEPS = 2
SP_MICROBATCHES = 2
SP_OVERRIDES = ["model.num_hidden_layers=2", "mesh.pp=2",
                f"gradient_accumulation_steps={SP_MICROBATCHES}",
                "attention=flash", "kernels.prologue=pallas", "total_steps=500",
                "save_steps=0", "save_final=false", "resume=false", "logging_steps=1"]
SP_ONE = SP_OVERRIDES + ["mesh.tp=1", "mesh.sp=1", "optimizer_offload=false"]
# the fp32 gradient parity at 4,096-token rows (2,048-token slabs): fp32
# doubles eight ranks' state on one card, and the fp32 kernels are SIMT
SP_FP32 = ["model.dtype=float32", "dataset.seq_length=4096"]
# the kernels at an sp rank's slab of CodeLlama-34B: flash at 32 local heads
# (kv expanded) on 8,192-token slabs, the prologue at 32 + 4 + 4 local heads
# with positions from 8,192 (sp rank 1's slab)
SP_FLASH = dict(b=1, h=32, s=8192, hd=128)
SP_SLABS = {"diagonal": (8192, 8192), "visible": (8192, 0), "masked": (0, 8192)}
SP_PRO = dict(b=1, s=8192, d=8192, h=32, kv=4, pos0=8192)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def step_label(step_times: list) -> str:
    """What a multi-rank phase's step ms is: the median of the steps after the
    first, or the one step's, warm-up included."""
    if len(step_times) > 1:
        return f"median of steps 2-{len(step_times)}; step 1 {1e3 * step_times[0]:.1f}"
    return "step 1, its warm-up included"


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
    the segment ids read. With no visible pair (a fully masked slab) the
    outputs do not depend on the inputs: only the outputs are written."""
    tensor = b * h * s * hd * elem_bytes
    rows = b * h * s * 4
    pairs = causal_pairs(b, h, s) if pairs is None else pairs
    if pairs == 0:
        work = {"fwd": (tensor + rows, 0), "dq": (tensor, 0), "dkv": (2 * tensor, 0)}
    else:
        work = {  # (bytes moved, operations)
            "fwd": (4 * tensor + rows + seg_bytes, 2 * 2 * hd * pairs),  # q k v in, out + lse
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

    return flash_readings(q, k, v, do, kw, errs, "[kernels]")


def flash_readings(q, k, v, do, kw, errs: dict, tag: str, pairs: int | None = None,
                   library_causal: bool | None = True, label: str = "") -> dict:
    """The flash kernels' rows of the kernels line on (q, k, v, do): each
    kernel's and its plain version's device ms, SDPA's (the one-call
    yardstick: causal, or not with `library_causal` False, or none with
    None), the bound (on every causal pair, or `pairs`), and `errs`
    (kernel_case's); `label` is added to each row's name."""
    import torch
    import torch.nn.functional as F

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa

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
    library = dict.fromkeys(("fwd", "dq", "dkv"))
    if library_causal is not None:
        # yardstick only: one PyTorch call computing the same forward
        causal = library_causal
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            torch.autograd.grad(o, (qg, kg, vg), do)

        sdpa_both = cuda_ms(sdpa_fwd_bwd)
        # its backward alone (dq, dk and dv in one call), the forward run once outside the
        # timing
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True))
        del o, qg, kg, vg
        log(f"{tag} yardstick F.scaled_dot_product_attention (is_causal={causal}): fwd "
            f"{sdpa_fwd:.4f} ms, bwd {sdpa_bwd:.4f} ms, fwd+bwd {sdpa_both:.4f} ms")
        library = {"fwd": sdpa_fwd, "dq": sdpa_bwd, "dkv": sdpa_bwd}

    b, h, s, hd = q.shape
    bound = bounds(b, h, s, hd, 2, pairs)
    source = "llama_pipeline_parallel_tpu_torch/csrc/flash_attention.cu"
    replaces = {"fwd": "llama_pipeline_parallel_tpu/ops/flash_attention.py:194",
                "dq": "llama_pipeline_parallel_tpu/ops/flash_attention.py:343",
                "dkv": "llama_pipeline_parallel_tpu/ops/flash_attention.py:364"}
    names = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}
    rows = {}
    for key in ("fwd", "dq", "dkv"):
        ms, plain_ms = timings[key]
        rows[key] = {"name": names[key] + label, "route": "cuda", "source": source,
                     "replaces": replaces[key], "launches": None,
                     "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
                     **bound[key], "library_ms": library[key]}
        log(f"  {names[key]}{label}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
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
    return prologue_readings(inp, errs, "[prologue]")


def prologue_readings(inp: dict, errs: dict, tag: str) -> dict:
    """The prologue kernels' rows of the kernels line on `inp`
    (prologue_inputs): each kernel's and its plain version's device ms,
    cuBLAS's on the product it computes (the one-call yardstick), the
    bound, and `errs` (prologue_case's)."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.ops.rmsnorm import rms_norm

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
    log(f"{tag} yardsticks (cuBLAS bf16): hidden @ [wq|wk|wv] "
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
    cfg = load_config(config, TRAIN_OVERRIDES + OBS_OVERRIDES + [f"output_dir={out_dir}/flash"])
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
    check_observability(os.path.join(out_dir, "flash"), cfg["max_steps"], 1, "[trainer]")
    del summary
    gc.collect()
    torch.cuda.empty_cache()

    run = build_run(load_config(config, TRAIN_OVERRIDES + [f"output_dir={out_dir}/parity"]),
                    "cuda")
    step_parity(run, (f"last {PLANT_CUT} keys hidden", hide_last_keys), losses[0], "[trainer]")
    numerics_cost(run, "[trainer]")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses


def check_observability(run_dir: str, steps: int, stages: int, tag: str) -> None:
    """The files a run with OBS_OVERRIDES writes, parsed: the spans of the
    loop, health.json's last step and goodput in (0, 1], a numerics record
    a step with per-stage vectors of `stages` and nothing nonfinite, the
    memory watch's first-step record and a sample a step read from the
    card's allocator, the perf rows, goodput on the metrics lines, and the
    profile window's torch.profiler trace with the card's kernels in it."""
    from llama_pipeline_parallel_tpu_torch.tools import trace_summary

    def jsonl(name):
        with open(os.path.join(run_dir, name)) as f:
            return [json.loads(line) for line in f if line.strip()]

    missing = [f for f in OBS_FILES + ("profile",) if not os.path.exists(
        os.path.join(run_dir, f))]
    if missing:
        raise AssertionError(f"{tag} {run_dir} lacks {missing}")
    spans = {r["name"] for r in jsonl("spans.jsonl")}
    want = {"init", "compile_block", "data_wait", "step_dispatch", "device_step"}
    with open(os.path.join(run_dir, "health.json")) as f:
        health = json.load(f)
    numerics = jsonl("numerics.jsonl")
    memory = jsonl("memory.jsonl")
    samples = [r for r in memory if r["kind"] == "sample"]
    first = [r for r in memory if r["kind"] == "compiled"]
    perf_rows = {r["metric"] for r in jsonl("perf.jsonl")}
    goodput = [r["goodput"] for r in jsonl("metrics.jsonl") if "goodput" in r]
    traces = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(run_dir, "profile"))
              for f in fs if f.endswith(".trace.json")]
    kernels = 0
    if traces:
        _, trace = trace_summary.load_latest_trace(os.path.join(run_dir, "profile"))
        kernels = sum(1 for e in trace.get("traceEvents", []) if e.get("cat") == "kernel")
    log(f"{tag} observability: spans {sorted(spans)}; health last_step {health.get('last_step')}"
        f" goodput {health.get('goodput')}; {len(numerics)} numerics records, the last "
        f"{ {k: v for k, v in numerics[-1].items() if k.endswith('_per_stage')} }; first-step "
        f"memory {first}; {len(samples)} samples, device peak "
        f"{samples[-1].get('device_peak_bytes', 0) / 2**30:.2f} GiB; perf rows "
        f"{sorted(perf_rows)}; metrics goodput {goodput}; profile {len(traces)} trace(s), "
        f"{kernels} kernel events")
    if not want <= spans:
        raise AssertionError(f"{tag} spans {sorted(spans)} lack {sorted(want - spans)}")
    if health.get("last_step") != steps or not 0 < health.get("goodput", 0) <= 1:
        raise AssertionError(f"{tag} health.json {health}")
    if (len(numerics) != steps or any(r["nonfinite"] for r in numerics)
            or any(len(r[k]) != stages for r in numerics for k in r if k.endswith("_per_stage"))):
        raise AssertionError(f"{tag} numerics.jsonl {numerics}")
    if (len(first) != 1 or len(samples) != steps
            or not all(r.get("device_peak_bytes") for r in samples)):
        raise AssertionError(f"{tag} memory.jsonl {memory}")
    if "mem_peak_gib" not in perf_rows or not all(0 < g <= 1 for g in goodput[1:]):
        raise AssertionError(f"{tag} perf rows {perf_rows}, goodput {goodput}")
    if len(traces) != 1 or not kernels:
        raise AssertionError(f"{tag} profile window: traces {traces}, {kernels} kernel events")


def numerics_cost(run, tag: str) -> None:
    """The step with the numerics stats on (their nonfinite guard's read
    included) and off, NUMERICS_COST_STEPS steps each, alternately, on `run`
    (synchronised; ms, median of each)."""
    import dataclasses

    import torch

    batches = run.batches()
    times = {True: [], False: []}
    kept = run.numerics
    for _ in range(NUMERICS_COST_STEPS):
        for on in (True, False):
            run.numerics = dataclasses.replace(kept, enabled=on)
            batch = next(batches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = run.step(batch)
            torch.cuda.synchronize()
            times[on].append(1e3 * (time.perf_counter() - t))
            if on and bool(metrics["numerics"]["nonfinite"]):
                raise AssertionError(f"{tag} a finite step read as nonfinite")
    run.numerics = kept
    on_ms, off_ms = statistics.median(times[True]), statistics.median(times[False])
    log(f"{tag} step with numerics on {on_ms:.1f} ms, off {off_ms:.1f} ms (median of "
        f"{NUMERICS_COST_STEPS} each, alternately; {on_ms - off_ms:+.1f} ms, "
        f"{100 * (on_ms / off_ms - 1):+.2f} %) ({card_line()})")


def phase_observability() -> None:
    """The trainer's slice cut to one layer (DRILL_OVERRIDES): (a) a
    `grad_nonfinite` rule at step 2, driven step by step: the params and
    AdamW moments after it bit-equal to those before it, the count held,
    the step counter advanced, the monitor counting 1 nonfinite step; (b)
    with `numerics.halt_on_nonfinite` and the rule at step 1, run_training
    raises NonfiniteHaltError (the CLI's nonzero exit) after a final
    checkpoint of the last step; (c) an `oom` rule with the memory watch
    on: the run raises the allocation failure after a snapshot under oom/
    with the card's allocator reading and an `oom` profiler capture."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import CheckpointManager
    from llama_pipeline_parallel_tpu_torch.train import build_run, run_training
    from llama_pipeline_parallel_tpu_torch.utils import faults, memwatch, numerics
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "observability")
    rule = "fault_plan={faults: [{site: step, op: grad_nonfinite, at_step: %d}]}"
    log(f"[observability] {config} TRAIN_OVERRIDES + "
        f"{DRILL_OVERRIDES[len(TRAIN_OVERRIDES):]}")

    # (a) the guard, step by step
    run = build_run(load_config(config, DRILL_OVERRIDES + [
        rule % 1, "max_steps=3", f"output_dir={out_dir}/drill"]), "cuda")
    monitor = numerics.NumericsMonitor(os.path.join(out_dir, "drill"), run.numerics)
    opt = run.state.optimizer
    batches = run.batches()
    kept = {}
    for step in range(3):
        fault = faults.fire("step", step=step)
        if fault:
            kept = {"params": {k: p.detach().clone() for k, p in run.state.params.items()},
                    "mu": {k: t.clone() for k, t in opt.mu.items()},
                    "nu": {k: t.clone() for k, t in opt.nu.items()}, "count": opt.count,
                    "step": run.state.step}
        metrics = run.step(next(batches), fault)
        monitor.observe(step + 1, metrics["loss"], metrics["grad_norm"], metrics["numerics"])
        if fault:
            torch.cuda.synchronize()
            same = (all(torch.equal(p.detach(), kept["params"][k])
                        for k, p in run.state.params.items())
                    and all(torch.equal(opt.mu[k], kept["mu"][k]) and
                            torch.equal(opt.nu[k], kept["nu"][k]) for k in opt.mu))
            log(f"[observability] (a) {fault} at step {step + 1}: grad_norm "
                f"{float(metrics['grad_norm'])}, params and moments bit-equal to before "
                f"{same}, count {kept['count']} -> {opt.count}, step {kept['step']} -> "
                f"{run.state.step}")
            if not same or opt.count != kept["count"] or run.state.step != kept["step"] + 1:
                raise AssertionError("[observability] the skipped step changed the state")
            kept = {}
    monitor.flush()
    monitor.close()
    faults.configure(None)
    if monitor.nonfinite_steps != 1 or not all(
            torch.isfinite(p).all() for p in run.state.params.values()):
        raise AssertionError(f"[observability] nonfinite_steps {monitor.nonfinite_steps}")
    del run, opt, kept, batches
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the halt
    t_b = time.perf_counter()
    halt_dir = os.path.join(out_dir, "halt")
    try:
        run_training(load_config(config, DRILL_OVERRIDES + [
            rule % 0, "max_steps=2", "numerics={halt_on_nonfinite: true}",
            f"output_dir={halt_dir}"]), "cuda")
        raise AssertionError("[observability] halt_on_nonfinite did not halt")
    except numerics.NonfiniteHaltError as e:
        halted = str(e)
    saved = CheckpointManager(halt_dir).latest_step()
    log(f"[observability] (b) halted: {halted!r}; final checkpoint-{saved} "
        f"({time.perf_counter() - t_b:.1f} s with the save)")
    if saved != 2:
        raise AssertionError(f"[observability] the halt saved checkpoint-{saved}, not 2")
    shutil.rmtree(halt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the OOM drill
    oom_dir = os.path.join(out_dir, "oom")
    try:
        run_training(load_config(config, DRILL_OVERRIDES + [
            "fault_plan={faults: [{site: step, op: oom, at_step: 1}]}", "max_steps=2",
            "memory={enabled: true}", f"output_dir={oom_dir}"]), "cuda")
        raise AssertionError("[observability] the oom rule raised nothing")
    except RuntimeError as e:
        if not memwatch.is_resource_exhausted(e):
            raise
    snaps = memwatch.read_oom_snapshots(oom_dir)
    captures = [d for d in os.listdir(os.path.join(oom_dir, "captures")) if d.endswith("-oom")]
    traces = [f for d in captures for f in os.listdir(os.path.join(oom_dir, "captures", d))
              if f.endswith(".trace.json")]
    log(f"[observability] (c) oom at step 2: {len(snaps)} snapshot(s), live "
        f"{snaps[0]['live'] if snaps else None}, captures {captures} ({len(traces)} trace)")
    if (len(snaps) != 1 or not snaps[0]["live"].get("device_peak_bytes")
            or len(traces) != 1):
        raise AssertionError(f"[observability] oom forensics: {snaps}, {captures}")
    shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[observability] phase {time.perf_counter() - t0:.1f} s")


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

    def cut_last_q_head(x, norm_w, wq, wk, wv, cos, sin, *, eps, head_dim, **kw):
        wq = torch.cat([wq[:, :-head_dim], torch.zeros_like(wq[:, -head_dim:])], dim=1)
        return good(x, norm_w, wq, wk, wv, cos, sin, eps=eps, head_dim=head_dim, **kw)

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


def pipeline_launches(us, manifest, accum_chunks: int, remat: bool,
                      stages: tuple | None = None) -> dict:
    """The launches of each of the nine kernels in one step of the unit
    sequence `us` (parallel/pipeline.Pipeline's rules) on `stages` (default
    every stage), per valid cell of stage s holding a chunk of k layers:
    - F: k flash and prologue forwards, none on the chunk that owns the loss
      (its output goes nowhere; its B recomputes it);
    - B: a recompute (k forwards, 2k with `remat`), k flash dq and dk/dv and
      prologue dhidden, k prologue dW when fused; on the loss-owning chunk
      one CE forward and dh, and dW when fused. Split (zb1): nothing on
      (stage 0, chunk 0), whose input is the embedding lookup;
    - W: the recompute, k dq, dk/dv, dhidden (the norm weight's gradient)
      and dW; on the loss-owning chunk one CE forward, dh and dW.
    gpipe's grid runs by the same rules (its B is a flat 1F1B B).
    Times `accum_chunks` flushes."""
    from llama_pipeline_parallel_tpu_torch.parallel import schedule as usched

    n = dict.fromkeys(("fwd", "dq", "dkv", "ce_fwd", "ce_dh", "ce_dw", "prologue_fwd",
                       "prologue_dhidden", "prologue_dw"), 0)
    s_total, v = us.num_stages, us.virtual_stages
    for kind, grid in (("F", us.f_unit), ("B", us.b_unit), ("W", us.w_unit)):
        for s in range(s_total) if stages is None else stages:
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
        # the schedule observatory on flat 1F1B: its segment marks each step
        timeline = ["timeline={enabled: true}"] if name == "1f1b" else []
        cfg = load_config(config, PIPE_OVERRIDES + extra + timeline
                          + [f"output_dir={out_dir}/{name}"])
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
        if timeline:
            check_timeline(os.path.join(out_dir, name), pcfg, steps)
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


def check_timeline(run_dir: str, pcfg, steps: int) -> None:
    """timeline.jsonl of a pipeline run with the timeline on: one record a
    step, segments named as the plan names them (utils/timeline.SegmentPlan
    of the run's config), a measured bubble beside the analytic one."""
    from llama_pipeline_parallel_tpu_torch.utils import timeline as tl

    plan = tl.SegmentPlan(pcfg)
    labels = {st["label"] for st in plan.stats}
    with open(os.path.join(run_dir, "timeline.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    for r in records:
        log(f"[pipeline] timeline step {r['step']}: wall {r['wall_s']:.4f} s, segments "
            f"{ {k: v['dur_s'] for k, v in r.get('segments', {}).items()} }, optimizer "
            f"{r.get('optimizer_s')} s, bubble measured {r.get('bubble_fraction_measured')} "
            f"(analytic {r['bubble_fraction_analytic']}), stage times {r.get('stage_time_s')} "
            f"({card_line()})")
    if (len(records) != steps or any(set(r.get("segments", {})) != labels for r in records)
            or any(r.get("bubble_fraction_measured") is None for r in records)):
        raise AssertionError(f"[pipeline] timeline.jsonl: {records} (plan labels {labels})")


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
    FP32_STEP_LOSS_TOL, gradients within GRAD_REL_TOL relative); interleaved,
    zb1 and gpipe against flat with the same tolerances, whether the
    gradients are bit-equal reported (required of gpipe's); the unpipelined
    loss is a sum of Python floats, the pipeline's of fp32 tensors, so the
    losses differ in rounding; a zeroed cotangent (zero_first_cotangent)
    must fail the fp32 gradient check."""
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
        for schedule in ("interleaved_1f1b", "zb1", "gpipe"):
            got = pipelined(mcfg, schedule, n)
            d_loss, d_grad = abs(got[0] - flat[0]), rel_diff(got[1], flat[1])
            log(f"[pipeline] {tag}: {schedule} vs flat 1f1b: loss |diff| {d_loss:.3e}, gradient "
                f"rel diff {d_grad:.3e}, gradients bit-equal {same_grads(got, flat)}")
            if not d_loss <= held_loss or (tag == "fp32" and not d_grad <= GRAD_REL_TOL):
                raise AssertionError(f"[pipeline] {tag} {schedule} vs flat: loss |diff| "
                                     f"{d_loss}, gradient rel diff {d_grad}")
            # gpipe's backward wave runs in ascending microbatch order: each
            # parameter folds its microbatches as flat 1F1B does
            if schedule == "gpipe" and not same_grads(got, flat):
                raise AssertionError(f"[gpipe] {tag}: gradients not bit-equal to flat 1f1b "
                                     f"(rel diff {d_grad})")
            del got
        del flat
        gc.collect()
        torch.cuda.empty_cache()
    del run, params, batch
    gc.collect()
    torch.cuda.empty_cache()


def host_memory() -> tuple[int, int]:
    """(MemTotal bytes from /proc/meminfo, CPUs this process may use)."""
    with open("/proc/meminfo") as f:
        kib = next(int(line.split()[1]) for line in f if line.startswith("MemTotal:"))
    return kib * 1024, len(os.sched_getaffinity(0))


def peak_rss_gb() -> float:
    """This process's peak resident set, GB (getrusage's ru_maxrss; a rank
    started by this script may report this script's peak, which Linux
    carries across fork and exec: see rss_gb)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


class PeakRss:
    """The largest resident set of this process (rss_gb) from its start to
    `stop`, sampled every `every` seconds on a thread of its own, GB; None
    where the system does not say. (Not every kernel's /proc has VmHWM,
    and ru_maxrss may carry the parent's peak across exec.)"""

    def __init__(self, every: float = 0.1):
        import threading

        self.peak = rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, args=(every,), daemon=True)
        self._thread.start()

    def _sample(self, every: float) -> None:
        while not self._stop.wait(every):
            now = rss_gb()
            if now is not None and (self.peak is None or now > self.peak):
                self.peak = now

    def stop(self) -> float | None:
        self._stop.set()
        self._thread.join()
        return self.peak


def rss_gb() -> float | None:
    """This process's resident set now, GB (/proc/self/statm), or None
    where the system does not say."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
    except (OSError, ValueError, IndexError):
        return None


def release_host_cache() -> None:
    """Hand freed pinned host blocks (PyTorch keeps them cached) back to the
    system before a run that needs the host's memory."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    empty_host = getattr(torch._C, "_host_emptyCache", None)
    if empty_host is not None:
        empty_host()


def record_optimizer(run, watch: str | None = None):
    """Wrap run.state.optimizer: the wrapper keeps a copy of the gradients
    handed to it at its first step (`grads`) and, with `watch`, of that
    params leaf before each update (`before`: after the run, one step
    stale). Under the host optimizer it also steps `twin`, the device AdamW
    on fp32 masters on the card that start as the host's, by the same
    gradients and norm each step."""
    from llama_pipeline_parallel_tpu_torch.optim.optimizer import AdamW

    inner = run.state.optimizer

    class Recorder:
        grads = None
        before = None
        twin = None
        if run.host is not None:
            twin = {k: p.to(run.device) for k, p in run.host.masters.items()}
            twin_opt = AdamW(twin, run.host.cfg)

        def step(self, params, grads, norm):
            if self.grads is None:
                self.grads = {k: g.detach().clone() for k, g in grads.items()}
            if watch is not None:
                self.before = params[watch].detach().clone()
            if self.twin is not None:
                self.twin_opt.step(self.twin, grads, norm)
            return inner.step(params, grads, norm)

    recorder = Recorder()
    run.state.optimizer = recorder
    return recorder


def working_copy_mismatch(run) -> list:
    """The leaves of an offload run's working copy (what the next step
    reads) that are not, bit for bit, the RNE cast of the host masters."""
    import torch

    return [name for name, w in run.state.params.items()
            if not torch.equal(w.cpu().view(torch.int16),
                               run.host.masters[name].to(torch.bfloat16).view(torch.int16))]


def reset_kernel_counts() -> None:
    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp

    for module in (fa, fc, fp):
        module.reset_launch_counts()


def check_pipeline_launches(tag: str, pipeline, steps: int) -> dict:
    """Every kernel's launches and tensor-core calls since the counts were
    reset equal `steps` times what `pipeline`'s unit grid gives
    (pipeline_launches); returns the per-step counts."""
    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl

    pcfg = pipeline.pcfg
    per_step = pipeline_launches(pl.flush_unit_schedule(pcfg), pipeline.stage_params.manifest,
                                 pcfg.accum_chunks, pcfg.remat)
    want = {key: c * steps for key, c in per_step.items()}
    launches = {**fa.launch_counts, **fc.launch_counts, **fp.launch_counts}
    tensor_core = {**fa.tensor_core_counts, **fc.tensor_core_counts, **fp.tensor_core_counts}
    log(f"[offload] launches {launches} (expected {want}: pipeline_launches x {steps} steps)")
    if launches != want or tensor_core != want:
        raise AssertionError(f"[offload] launches {launches}, on the tensor cores {tensor_core}, "
                             f"expected {want}")
    return per_step


def offload_parity(config: str) -> None:
    """(a) The pipeline phase's run at 4 layers on the device AdamW, then
    twice on the host optimizer (OFFLOAD_PARITY_OVERRIDES; see its comment
    for the limits): launches exact in each; the offload runs repeat each
    other's losses bit for bit (an upload racing a step's reads would not);
    their working copy after the run is the RNE cast of the host masters bit
    for bit, and a planted fault (one layer's wq copy left one step stale)
    is rejected by that check."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.train import build_run, train_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    out_dir = os.path.join(ROOT, "build", "chip_smoke", "offload")
    watch = "s0c0/layers.attn.wq"
    device_run = None
    offload_losses = []
    for tag, offload in (("device AdamW", False), ("host AdamW", True),
                         ("host AdamW again", True)):
        release_host_cache()
        run = build_run(load_config(config, OFFLOAD_PARITY_OVERRIDES + [
            f"optimizer_offload={str(offload).lower()}", f"output_dir={out_dir}/parity"]),
            "cuda")
        recorder = record_optimizer(run, watch if offload else None)
        reset_kernel_counts()
        summary = train_run(run)
        torch.cuda.synchronize()
        check_pipeline_launches(f"[offload] {tag}:", run.pipeline, len(summary["losses"]))
        losses = summary["losses"]
        log(f"[offload] {tag}: losses {losses}, step ms "
            f"{[round(1e3 * t, 1) for t in summary['step_times']]}"
            + (f", host phases of the last step {run.host.last_timings}" if offload else ""))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[offload] {tag}: non-finite loss {losses}")
        if not offload:
            device_run = {"losses": losses, "grads": recorder.grads}
            del run, recorder, summary
            gc.collect()
            torch.cuda.empty_cache()
            continue
        offload_losses.append(losses)
        if len(offload_losses) == 2:
            log(f"[offload] the two host-optimizer runs: losses bit-equal "
                f"{offload_losses[0] == offload_losses[1]}")
            if offload_losses[0] != offload_losses[1]:
                raise AssertionError(f"[offload] two runs of the same config differ: "
                                     f"{offload_losses}")
        else:
            same = [k for k, g in recorder.grads.items() if torch.equal(g, device_run["grads"][k])]
            grad_rel = rel_diff(recorder.grads, device_run["grads"])
            worst = 0.0
            for k, twin in recorder.twin.items():
                want, got = twin.cpu(), run.host.masters[k]
                ratio = ((got - want).abs() / (OFFLOAD_MASTER_RTOL * want.abs()
                                               + OFFLOAD_MASTER_ATOL)).max().item()
                worst = max(worst, ratio)
            later = [abs(a - b) for a, b in zip(losses[1:], device_run["losses"][1:])]
            log(f"[offload] step 1 against the device AdamW: loss {losses[0]!r} vs "
                f"{device_run['losses'][0]!r} (bit-equal {losses[0] == device_run['losses'][0]}); "
                f"gradients handed over: rel diff {grad_rel:.3e} (tol {OFFLOAD_GRAD_RTOL}), "
                f"{len(same)} of {len(recorder.grads)} leaves bit-equal; masters after "
                f"{len(losses)} steps against the device AdamW stepped by the same gradients: "
                f"worst |diff| / (rtol {OFFLOAD_MASTER_RTOL} x |ref| + atol "
                f"{OFFLOAD_MASTER_ATOL}) {worst:.3f}; steps 2-{len(losses)} loss |diff| "
                f"{later} (tol {STEP_LOSS_TOL})")
            if (losses[0] != device_run["losses"][0] or not grad_rel <= OFFLOAD_GRAD_RTOL
                    or not worst <= 1.0 or not max(later) <= STEP_LOSS_TOL):
                raise AssertionError("[offload] the host optimizer's run departs from the "
                                     "device AdamW's")
        stale = working_copy_mismatch(run)
        with torch.no_grad():
            run.state.params[watch].copy_(recorder.before)
        planted = working_copy_mismatch(run)
        log(f"[offload] working copy vs the RNE cast of the host masters: {len(stale)} leaves "
            f"differ; planted fault ({watch} one step stale): {planted} differ")
        if stale or planted != [watch]:
            raise AssertionError(f"[offload] working copy check: {stale}; planted: {planted}")
        del run, recorder, summary
        gc.collect()
        torch.cuda.empty_cache()


def offload_stash(config: str) -> None:
    """(a) The stash: a step of zb1 (virtual_stages 2) at 8 layers with the W
    queue and the stage inputs in pinned host memory, against the same step
    with both on the card, each taken twice on the same params and batch
    (the second timed; the first allocates the rings): loss and gradients
    bit-equal, launches exact, max_memory_allocated not higher (the first
    run's gradients wait in host memory meanwhile); the host rings' bytes
    beside the byte model's."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
    from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llama_pipeline_parallel_tpu_torch.train import (
        build_manifest,
        build_pipeline_config,
        build_run,
    )
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    out = os.path.join(ROOT, "build", "chip_smoke", "offload", "stash")
    run = build_run(load_config(config, OFFLOAD_STASH_OVERRIDES + ["mesh.pp=1",
                                                                    f"output_dir={out}"]), "cuda")
    run.state.optimizer = None  # only the params and the batch are needed here
    batch = next(run.batches())
    mcfg = run.model_cfg
    rows = {}
    for tag, tiers in (("on the card", []), ("in host memory", OFFLOAD_STASH_TIERS)):
        cfg = load_config(config, OFFLOAD_STASH_OVERRIDES + tiers)
        manifest = build_manifest(cfg, mcfg, 4)
        pcfg = build_pipeline_config(cfg, MeshConfig(pp=4), manifest)
        sp = pl.StageParams.from_canonical(run.state.params, manifest)
        pipe = pl.Pipeline(mcfg, pcfg, make_mesh(MeshConfig(pp=4)), sp, run.attn_fn)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        for _ in range(2):
            for p in sp.flat().values():
                p.grad = None
            t0 = time.perf_counter()
            loss = pipe.loss_and_grad(batch).item()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        check_pipeline_launches(f"[offload] zb1 stash {tag}:", pipe, 2)
        model = pl.host_stash_bytes(pcfg, *pl.stash_dims(
            cfg["per_device_train_batch_size"], cfg["max_seq_length"], 1, mcfg.hidden_size,
            mcfg.dtype))
        rows[tag] = {"loss": loss, "grads": {k: g.cpu() for k, g in sp.grads().items()},
                     "peak": torch.cuda.max_memory_allocated(),
                     "host": pipe.host_stash_bytes(), "model": model}
        log(f"[offload] zb1 step, W queue and stage inputs {tag}: {ms:.1f} ms (the second "
            f"step of this pipeline), max_memory_allocated {rows[tag]['peak'] / 2**30:.2f} GiB, "
            f"host rings {rows[tag]['host'] / 2**30:.4f} GiB (byte model: "
            f"{model / 2**30:.4f} GiB a stage x 4 stages = {4 * model / 2**30:.4f} GiB), "
            f"{pl.wgrad_offloaded_units(pcfg)} W pairs a flush over the link")
        del pipe, sp
    off, on = rows["on the card"], rows["in host memory"]
    same = all(torch.equal(on["grads"][k], g) for k, g in off["grads"].items())
    log(f"[offload] stash on vs off: loss bit-equal {on['loss'] == off['loss']}, gradients "
        f"bit-equal {same}, max_memory_allocated {on['peak'] / 2**30:.2f} vs "
        f"{off['peak'] / 2**30:.2f} GiB")
    if on["loss"] != off["loss"] or not same or on["peak"] > off["peak"] or not on["host"]:
        raise AssertionError("[offload] the host stash changed the step or its memory")
    del rows, run, batch
    gc.collect()
    torch.cuda.empty_cache()


def offload_full_depth(config: str) -> None:
    """(b) conf/llama_7b_pp4.yaml at OFFLOAD_FULL_LAYERS of its 32 layers on
    the host optimizer (OFFLOAD_FULL_OVERRIDES), or at the largest depth the
    host's memory holds with OFFLOAD_HOST_SPARE to spare (the cut printed): finite
    losses, exact launches of all nine kernels; step ms, tokens/s, MFU, peak
    device memory, peak host RSS, the host optimizer's phases, the link's
    GB/s both ways and the step's link floor."""
    import dataclasses

    import torch

    from llama_pipeline_parallel_tpu_torch.optim import offload as off
    from llama_pipeline_parallel_tpu_torch.train import build_model_config, build_run, train_run
    from llama_pipeline_parallel_tpu_torch.utils import host_stash
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config
    from llama_pipeline_parallel_tpu_torch.utils.metrics import (
        param_count,
        peak_flops,
        train_flops_per_token,
    )

    card = card_line()
    mem_total, cpus = host_memory()
    published = build_model_config(load_config(config)["model"])

    def need(layers: int) -> int:
        n = param_count(dataclasses.replace(published, num_hidden_layers=layers))
        return 12 * n + 2 * off.SLOTS * off.PIECE * (4 + 2)

    depth = min(published.num_hidden_layers, OFFLOAD_FULL_LAYERS)
    while depth > 1 and OFFLOAD_HOST_SPARE * need(depth) > mem_total:
        depth -= 1
    log(f"[offload] host: MemTotal {mem_total / 1e9:.2f} GB, {cpus} CPUs; "
        f"{published.num_hidden_layers} layers need "
        f"{need(published.num_hidden_layers) / 1e9:.2f} GB of host memory "
        f"(12 B a parameter and the pinned staging), x {OFFLOAD_HOST_SPARE} to spare; the "
        f"cell runs {OFFLOAD_FULL_LAYERS} of them for the script's time: "
        + ("no further cut" if depth == min(published.num_hidden_layers, OFFLOAD_FULL_LAYERS)
           else f"CUT to {depth} layers ({need(depth) / 1e9:.2f} GB)"))
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "offload", "full")
    overrides = OFFLOAD_FULL_OVERRIDES + [f"output_dir={out_dir}"]
    if depth != published.num_hidden_layers:
        overrides.append(f"model.num_hidden_layers={depth}")
    release_host_cache()
    bw = host_stash.measure_transfer_bandwidth(nbytes=1 << 30, reps=3)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = build_run(load_config(config, overrides), "cuda")
    build_s = time.perf_counter() - t0
    host = run.host
    reset_kernel_counts()
    summary = train_run(run)
    torch.cuda.synchronize()
    losses = summary["losses"]
    check_pipeline_launches("[offload] deep cell:", run.pipeline, len(losses))
    # the host phases of each step, from the metrics line (logging_steps=1)
    phases = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[offload] deep cell: non-finite loss {losses}")
    mcfg = run.model_cfg
    n = host.numel()
    steps = summary["step_times"][1:]
    step_s = statistics.median(steps)
    tokens = summary["tokens_per_step"]
    mfu = train_flops_per_token(mcfg, run.seq_length) * tokens / step_s / peak_flops(
        torch.device("cuda"))
    norm_ms = statistics.median(p["norm_ms"] for p in phases[1:])
    stream_ms = statistics.median(p["stream_d2h_update_h2d_ms"] for p in phases[1:])
    down, up = 4 * n, 2 * n  # fp32 gradients down, the bf16 working copy up
    floor_s = down / 1e9 / bw["d2h_gbps"] + up / 1e9 / bw["h2d_gbps"]
    touched = 34 * n  # AdamW reads g, p, m, v and writes p, m, v; the cast reads p, writes bf16
    log(f"[offload] deep cell ({mcfg.num_hidden_layers} layers, {n / 1e9:.3f} B parameters, "
        f"{card}): build_run {build_s:.1f} s (init on the card, masters to the host, working "
        f"copy up); losses {losses}")
    log(f"[offload] deep cell ({card}): step {1e3 * step_s:.1f} ms (median of steps "
        f"2-{len(losses)}: {[round(1e3 * t, 1) for t in steps]}), {tokens / step_s:.0f} tokens/s, "
        f"MFU {mfu:.4f} (989 TFLOP/s, PaLM accounting); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host peak RSS "
        f"{peak_rss_gb():.2f} GB; host AdamW ({host.threads} OpenMP threads, torch "
        f"{torch.get_num_threads()}): norm_ms {norm_ms:.1f}, stream_d2h_update_h2d_ms "
        f"{stream_ms:.1f} ({touched / 1e9:.1f} GB of host memory touched: "
        f"{touched / 1e9 / (stream_ms / 1e3):.1f} GB/s); link (pinned, 1 GiB): d2h "
        f"{bw['d2h_gbps']:.2f} GB/s, h2d {bw['h2d_gbps']:.2f} GB/s; the step's link floor "
        f"{down / 1e9:.2f} GB down + {up / 1e9:.2f} GB up = {1e3 * floor_s:.1f} ms")
    del run, host, summary
    release_host_cache()


def offload_checkpoint(config: str) -> None:
    """(c) The checkpoint phase's run (2 layers) on the host optimizer: run A
    saves step 4 in the offload_parts layout (three files and meta.json's
    opt_layout, opt_step_count), run B resumes it and repeats A's steps 5-6
    bit for bit (losses and final masters); restoring it without offload is
    refused by name."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as ck
    from llama_pipeline_parallel_tpu_torch.train import build_run, train_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke", "offload", "ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def cfg(*overrides):
        return load_config(config, CKPT_OVERRIDES + list(overrides) + [f"output_dir={ckpt_dir}"])

    run_a = build_run(cfg(*OFFLOAD_CKPT_RUN_A), "cuda")
    losses_a = train_run(run_a)["losses"]
    save = dict(run_a.ckpt.last_save)
    meta = json.load(open(os.path.join(ckpt_dir, f"checkpoint-{CKPT_SAVE_STEP}", "meta.json")))
    files = sorted(meta["integrity"]["files"])
    log(f"[offload] checkpoint run A losses {losses_a}; blocking save of checkpoint-"
        f"{CKPT_SAVE_STEP} from host memory: write {gbps(save['bytes'], save['write_s'])}, "
        f"sha256 {gbps(save['bytes'], save['digest_s'])}; files {files}, opt_layout "
        f"{meta.get('opt_layout')}, opt_step_count {meta.get('opt_step_count')}")
    if (files != [ck.OPT_M_FILE, ck.OPT_V_FILE, ck.PARAMS_FILE]
            or meta.get("opt_layout") != ck.OFFLOAD_LAYOUT
            or meta.get("opt_step_count") != CKPT_SAVE_STEP):
        raise AssertionError(f"[offload] checkpoint-{CKPT_SAVE_STEP}: {files}, {meta}")
    os.environ["LPT_CKPT_VERIFY"] = "0"  # the refusal reads meta.json; A's digests hold
    try:
        build_run(cfg("save_steps=0", "save_final=false", "resume=true"), "cuda")
    except ValueError as e:
        log(f"[offload] resuming it without offload is refused: {e}")
        if "opt_layout=offload_parts" not in str(e):
            raise
    else:
        raise AssertionError("[offload] an offload_parts checkpoint resumed without offload")
    finally:
        del os.environ["LPT_CKPT_VERIFY"]
    run_b = build_run(cfg(*OFFLOAD_CKPT_RUN_B), "cuda")
    losses_b = train_run(run_b)["losses"]
    same = [k for k, p in run_a.host.masters.items() if torch.equal(p, run_b.host.masters[k])]
    log(f"[offload] run B from checkpoint-{CKPT_SAVE_STEP}: losses {losses_b} (A's "
        f"{losses_a[CKPT_SAVE_STEP:]}), final masters bit-equal in {len(same)} of "
        f"{len(run_a.host.masters)} leaves")
    if losses_b != losses_a[CKPT_SAVE_STEP:] or len(same) != len(run_a.host.masters):
        raise AssertionError(f"[offload] resume is not bit-equal")
    del run_a, run_b
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    release_host_cache()


def phase_offload() -> None:
    """Host offload (module docstring, phase 12): (a) offload_parity and
    offload_stash, (b) offload_full_depth, (c) offload_checkpoint."""
    t0 = time.perf_counter()
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    log(f"[offload] {config}; card {card_line()}")
    offload_parity(config)
    offload_stash(config)
    offload_full_depth(config)
    offload_checkpoint(config)
    log(f"[offload] phase {time.perf_counter() - t0:.1f} s")


def multirank_worker(mode: str, out_dir: str, max_steps: str, resume_dir: str = "") -> int:
    """One rank of the multirank phase (RANK / WORLD_SIZE / MASTER_* and
    LPT_DIST_BACKEND=gloo in its environment), on conf/llama_7b_pp4.yaml
    with MULTI_OVERRIDES and `output_dir=out_dir`. Modes: "stop" trains
    from scratch until a signal stops it (run_training); "run" trains
    `max_steps` steps uninterrupted, holding step 1 against the one-process
    reference's gradients (`ref_grads.safetensors` in out_dir) and a
    replicated AdamW, with the launch counts set to 0 just before the loop
    and read just after, then resumes `resume_dir`'s checkpoint to
    `max_steps` in the same processes (a second launch would cost ~15 s).
    Writes `<mode>-rank<r>.json` into out_dir."""
    import gc
    import logging

    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.optim.optimizer import AdamW
    from llama_pipeline_parallel_tpu_torch.parallel import distributed
    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
    from llama_pipeline_parallel_tpu_torch.train import build_run, run_training, train_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    distributed.initialize_distributed("cuda")
    rank = distributed.process_index()
    if rank:
        logging.getLogger("llama_pipeline_parallel_tpu_torch").setLevel(logging.WARNING)
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    common = MULTI_OVERRIDES + [f"output_dir={out_dir}", f"max_steps={max_steps}",
                                f"preempt_check_every={MULTI_CHECK_EVERY}"]
    result: dict = {"rank": rank}
    if mode == "stop":
        from llama_pipeline_parallel_tpu_torch import train as trainer

        def build_measured(*args, **kwargs):
            """build_run, its save measured: the card's memory across the
            preemption's save (the pieces go to the host one at a time;
            nothing is gathered on the card)."""
            run = build_run(*args, **kwargs)
            save = run.save

            def measured_save(step, final=False):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t_save = time.perf_counter()
                path = save(step, final)
                result.update(save_s=time.perf_counter() - t_save,
                              save_extra_bytes=torch.cuda.max_memory_allocated() - before,
                              largest_leaf_bytes=max(t.numel() * 4 for t in
                                                     run.pipeline.stage_params.flat().values()))
                return path

            run.save = measured_save
            return run

        trainer.build_run = build_measured  # run_training's own, handlers and all
        summary = run_training(load_config(config, common + ["resume=false"]), "cuda")
    else:
        run = build_run(load_config(config, common + ["resume=false"]), "cuda")
        sp = run.pipeline.stage_params
        inner = run.state.optimizer

        class Parity:
            """Step 1's gradients against the reference's rows of this
            stage, and the ZeRO-1 update against a replicated AdamW fed the
            same gradients and norm, leaf by leaf."""

            def step(self, params, grads, norm):
                if "grad_sq_ref" in result:
                    return inner.step(params, grads, norm)
                with tensor_io.TensorFile(os.path.join(out_dir, "ref_grads.safetensors")) as f:
                    ref = pl.flatten_chunks(pl.chunk_views(
                        {name: f.tensor(name) for name in f.keys()}, run.manifest, sp.stages))
                    diff = total = 0.0
                    for name, g in grads.items():
                        r = ref[name].to(g.device)
                        diff += float((g.double() - r.double()).square().sum())
                        total += float(r.double().square().sum())
                result.update(grad_sq_diff=diff, grad_sq_ref=total)
                before = {k: p.detach().cpu() for k, p in params.items()}
                lr = inner.step(params, grads, norm)
                equal = []
                for name, p in params.items():
                    plain = {name: before.pop(name).to(p.device)}
                    AdamW(plain, inner.cfg).step(plain, {name: grads[name]}, norm)
                    equal.append(torch.equal(plain[name], p))
                    del plain
                result.update(masters_bit_equal=all(equal), leaves=len(equal),
                              moment_bytes=sum(t.numel() * t.element_size() for moment in
                                               (inner.mu, inner.nu) for t in moment.values()),
                              full_moment_bytes=2 * sum(p.numel() * 4
                                                        for p in params.values()),
                              split_leaves=sum(d is not None for d in inner.dims.values()))
                return lr

        run.state.optimizer = Parity()
        for module in (fa, fc, fp):
            module.reset_launch_counts()
        summary = train_run(run)
        run.state.optimizer = inner
        result.update(launches={**fa.launch_counts, **fc.launch_counts, **fp.launch_counts},
                      tensor_core={**fa.tensor_core_counts, **fc.tensor_core_counts,
                                   **fp.tensor_core_counts},
                      stages=list(sp.stages), replica=run.mesh.replica,
                      peak_bytes=torch.cuda.max_memory_allocated(),
                      staging_s=distributed.staging["seconds"],
                      staging_bytes=distributed.staging["bytes"])
        del run, sp, inner
        gc.collect()
        torch.cuda.empty_cache()
        resumed = run_training(load_config(config, MULTI_OVERRIDES + [
            f"output_dir={resume_dir}", f"max_steps={max_steps}", "resume=true"]), "cuda")
        result["resume"] = {k: resumed[k] for k in ("losses", "start_step")}
    result.update({k: summary[k] for k in ("losses", "step_times", "start_step", "preempted_at",
                                            "final_step", "tokens_per_step")})
    with open(os.path.join(out_dir, f"{mode}-rank{rank}.json"), "w") as f:
        json.dump(result, f)
    distributed.shutdown()
    return 0


def launch_ranks(n: int, worker: list, out_dir: str, mode: str, env: dict | None = None
                 ) -> list:
    """`n` processes of this script's `worker` (its flag and arguments) on
    card 0 over gloo, each told the host's process count (LOCAL_WORLD_SIZE:
    a host AdamW takes its share of the CPUs), with `env` added; their
    output goes to rank_log's files."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(n):
        rank_env = {**os.environ, "LPT_DIST_BACKEND": "gloo", "RANK": str(rank),
                    "LOCAL_RANK": str(rank), "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n),
                    "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), **(env or {})}
        with rank_log(out_dir, mode, rank) as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), *worker], cwd=ROOT,
                env=rank_env, stdout=out, stderr=subprocess.STDOUT))
    return procs


def rank_log(out_dir: str, mode: str, rank: int):
    """The file a rank's output goes to (a pipe could fill while the phase
    waits on another rank)."""
    return open(os.path.join(out_dir, f"{mode}-rank{rank}.log"), "w")


def finish_ranks(tag: str, procs: list, out_dir: str, mode: str, timeout: float = 600) -> list:
    """Wait for every rank; all are killed at the deadline or as soon as one
    fails (its peers would wait in a collective). Their result dicts in rank
    order. A rank that fails, or is still running at the deadline, fails the
    phase."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = []
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"{mode}-rank{rank}.log")) as f:
                bad.append((rank, p.returncode, f.read()[-3000:]))
    if bad:
        raise AssertionError(f"[{tag}] ranks failed or were killed at the {timeout:.0f} s "
                             f"deadline: {bad}")
    results = []
    for rank in range(len(procs)):
        with open(os.path.join(out_dir, f"{mode}-rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def phase_multirank() -> None:
    """pp 2 x dp 2 in 4 processes on the one card (module docstring, phase
    13): the one-process reference's step-1 gradients, then (a) the run a
    SIGTERM to rank 1 stops, (b) the uninterrupted run with its step-1
    parity, launches and numbers, (c) the resumes at pp 2 x dp 2 (in (b)'s
    processes) and pp 1 x dp 1."""
    import gc
    import signal

    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import CheckpointManager
    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
    from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig
    from llama_pipeline_parallel_tpu_torch.train import (
        build_manifest,
        build_model_config,
        build_pipeline_config,
        build_run,
        run_training,
    )
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "multirank")
    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    log(f"[multirank] {config} PIPE_OVERRIDES + {MULTI_OVERRIDES[len(PIPE_OVERRIDES):]}, "
        f"{MULTI_RANKS} ranks on card 0 over gloo ({card})")

    # the reference: one process, pp 2 in memory, the same global batch
    run = build_run(load_config(config, MULTI_ONE + [f"output_dir={out_dir}/one"]), "cuda")
    batch = next(run.batches())
    sp = run.pipeline.stage_params
    ref_loss = run.pipeline.loss_and_grad(batch).item()
    run_dir = os.path.join(out_dir, "run")  # the uninterrupted run's, which reads them
    os.makedirs(run_dir)
    tensor_io.write_file(os.path.join(run_dir, "ref_grads.safetensors"),
                         sp.to_canonical(sp.grads()))
    del run, sp, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[multirank] one process, pp 2, step 1: loss {ref_loss:.6f}; gradients written "
        f"({time.perf_counter() - t0:.1f} s)")

    # (a) SIGTERM to one rank
    stop_dir = os.path.join(out_dir, "stopped")
    os.makedirs(stop_dir)
    t_a = time.perf_counter()
    procs = launch_ranks(MULTI_RANKS, ["--multirank-worker", "stop", stop_dir, "16"], stop_dir,
                         "stop")
    metrics = os.path.join(stop_dir, "metrics.jsonl")
    deadline = time.monotonic() + 400
    logged = 0
    while logged < 1 and all(p.poll() is None for p in procs) and time.monotonic() < deadline:
        time.sleep(0.1)
        if os.path.exists(metrics):
            with open(metrics) as f:
                logged = sum(1 for x in f if x.strip())
    t_signal = time.perf_counter()
    procs[1].send_signal(signal.SIGTERM)
    stopped = finish_ranks("stop", procs, stop_dir, "stop")
    stop_s = time.perf_counter() - t_signal
    steps = {r["preempted_at"] for r in stopped}
    saved = sorted(d for d in os.listdir(stop_dir) if d.startswith("checkpoint-"))
    n = steps.pop() if len(steps) == 1 else None
    log(f"[multirank] (a) SIGTERM to rank 1 after {logged} logged step(s): every rank exit 0, "
        f"stopped at steps {[r['preempted_at'] for r in stopped]}, checkpoints {saved}, "
        f"{stop_s:.1f} s from the signal to the last exit (the save written by process 0 "
        f"included; run {time.perf_counter() - t_a:.1f} s)")
    if (n is None or n % MULTI_CHECK_EVERY or saved != [f"checkpoint-{n}"]
            or CheckpointManager(stop_dir).latest_step() != n):
        raise AssertionError(f"[multirank] the stop: steps {[r['preempted_at'] for r in stopped]},"
                             f" checkpoints {saved}")
    for r in stopped:
        log(f"[multirank] (a) rank {r['rank']}: the save {r['save_s']:.1f} s, the card's memory "
            f"{r['save_extra_bytes'] / 2**20:.1f} MiB over what it held before (bound: its "
            f"largest fp32 leaf, {r['largest_leaf_bytes'] / 2**20:.1f} MiB)")
        if not r["save_extra_bytes"] < r["largest_leaf_bytes"]:
            raise AssertionError(f"[multirank] rank {r['rank']}: the save took "
                                 f"{r['save_extra_bytes']} B more on the card, not less than "
                                 f"one leaf ({r['largest_leaf_bytes']} B)")
    end = n + 2

    # (b) the uninterrupted run
    t_b = time.perf_counter()
    ranks = finish_ranks("run", launch_ranks(MULTI_RANKS, [
        "--multirank-worker", "run", run_dir, str(end), stop_dir], run_dir, "run"), run_dir, "run")
    cfg = load_config(config, MULTI_OVERRIDES)
    mcfg = build_model_config(cfg["model"])
    manifest = build_manifest(cfg, mcfg, 2)
    pcfg = build_pipeline_config(cfg, MeshConfig(pp=2, dp=2), manifest)
    us = pl.flush_unit_schedule(pcfg)
    losses = ranks[0]["losses"]
    if any(r["losses"] != losses for r in ranks) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[multirank] losses differ across ranks or are not finite: "
                             f"{[r['losses'] for r in ranks]}")
    replica0 = [r for r in ranks if r["replica"] == 0]
    grad_rel = math.sqrt(sum(r["grad_sq_diff"] for r in replica0)
                         / sum(r["grad_sq_ref"] for r in replica0))
    loss_diff = abs(losses[0] - ref_loss)
    log(f"[multirank] (b) step 1 against one process (pp 2, dp 1, same "
        f"{2 * MULTI_MICROBATCHES} rows): loss "
        f"{losses[0]:.6f} vs {ref_loss:.6f}, |diff| {loss_diff:.3e} (tol {STEP_LOSS_TOL}); "
        f"gradient rel diff {grad_rel:.3e} (tol {GRAD_REL_TOL})")
    if not loss_diff <= STEP_LOSS_TOL or not grad_rel <= GRAD_REL_TOL:
        raise AssertionError(f"[multirank] step 1: loss |diff| {loss_diff}, gradient rel diff "
                             f"{grad_rel}")
    for r in ranks:
        want = {key: c * end for key, c in pipeline_launches(
            us, manifest, pcfg.accum_chunks, pcfg.remat, stages=tuple(r["stages"])).items()}
        log(f"[multirank] rank {r['rank']} (stage {r['stages']}, replica {r['replica']}): ZeRO-1 "
            f"masters bit-equal to a replicated AdamW {r['masters_bit_equal']} ({r['leaves']} "
            f"leaves, {r['split_leaves']} split), moments {r['moment_bytes'] / 1e9:.3f} GB of "
            f"{r['full_moment_bytes'] / 1e9:.3f}; launches {r['launches']} (expected {want}); "
            f"max_memory_allocated {r['peak_bytes'] / 2**30:.2f} GiB; gloo staging "
            f"{r['staging_s']:.2f} s, {r['staging_bytes'] / 1e9:.2f} GB over {end} steps")
        if not r["masters_bit_equal"]:
            raise AssertionError(f"[multirank] rank {r['rank']}: ZeRO-1 masters not bit-equal")
        if r["launches"] != want or r["tensor_core"] != want:
            raise AssertionError(f"[multirank] rank {r['rank']}: launches {r['launches']}, on "
                                 f"the tensor cores {r['tensor_core']}, expected {want}")
    step_s = statistics.median(ranks[0]["step_times"][1:])
    tokens = ranks[0]["tokens_per_step"]
    log(f"[multirank] (b) {end} steps, pp 2 x dp 2 on one card over gloo (this one-card "
        f"mode, not an NCCL figure): step {1e3 * step_s:.1f} ms (median of steps 2-{end}), "
        f"{tokens / step_s:.0f} tokens/s, {tokens} tokens a step; bytes a rank "
        f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]} GiB, "
        f"{sum(r['peak_bytes'] for r in ranks) / 2**30:.2f} GiB in all; gloo staging "
        f"{[round(r['staging_s'] / end, 3) for r in ranks]} s a step a rank; losses "
        f"{[round(x, 5) for x in losses]} ({time.perf_counter() - t_b:.1f} s, {card})")

    # (c) the resumes: in the same 4 processes after (b), and in this one
    t_c = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # the 4 processes' resume verified these files' digests just before
    os.environ["LPT_CKPT_VERIFY"] = "0"
    try:
        one = run_training(load_config(config, MULTI_ONE_PP1 + [
            "resume=true", f"max_steps={end}", f"output_dir={stop_dir}"]), "cuda")
    finally:
        del os.environ["LPT_CKPT_VERIFY"]
    if any(r["resume"] != ranks[0]["resume"] for r in ranks):
        raise AssertionError(f"[multirank] the resume differs across ranks: "
                             f"{[r['resume'] for r in ranks]}")
    for tag, got, start in (("pp 2 x dp 2, 4 processes", ranks[0]["resume"]["losses"],
                             ranks[0]["resume"]["start_step"]),
                            ("pp 1 x dp 1, this process", one["losses"], one["start_step"])):
        diffs = [abs(a - b) for a, b in zip(got, losses[n:])]
        log(f"[multirank] (c) resumed at {tag} from step {start}: losses {got} vs the "
            f"uninterrupted {losses[n:]}, |diff| {diffs} (tol {RESUME_LOSS_TOL})")
        if start != n or len(diffs) != 2 or not max(diffs) <= RESUME_LOSS_TOL:
            raise AssertionError(f"[multirank] resume at {tag}: start {start}, |diff| {diffs}")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[multirank] (c) {time.perf_counter() - t_c:.1f} s in this process (the 4 processes' "
        f"resume is in (b)'s seconds)")
    with open(os.path.join(run_dir, "numerics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    log(f"[multirank] process 0's numerics.jsonl: {len(records)} records, the first "
        f"{ {k: v for k, v in records[0].items() if k.endswith('_per_stage')} }")
    if (len(records) != end or any(r["nonfinite"] for r in records)
            or any(len(r[k]) != 2 for r in records for k in r if k.endswith("_per_stage"))):
        raise AssertionError(f"[multirank] numerics.jsonl: {records}")
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[multirank] phase {time.perf_counter() - t0:.1f} s")


def tp_worker(out_dir: str, steps: str) -> int:
    """One rank of the tp phase (RANK / WORLD_SIZE / MASTER_* and
    LPT_DIST_BACKEND=gloo in its environment): TP_CONFIG with TP_OVERRIDES
    for `steps` steps through build_run / train_run, the launch counts set
    to 0 just before the loop and read just after; then, in the same
    process, one bf16 step with the prologue's dhidden all-reduce over tp
    skipped (the planted fault) and one step in fp32 (TP_FP32). Each run's
    step-1 gradients (this rank's slices of the dp-reduced gradient, as the
    host optimizer receives them) are held against the one-process
    reference's (`ref_grads_<dtype>.safetensors` in out_dir). Writes
    `tp-rank<r>.json`."""
    import gc
    import logging
    import types

    import torch

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.parallel import distributed
    from llama_pipeline_parallel_tpu_torch.train import train_run

    distributed.initialize_distributed("cuda")
    rank = distributed.process_index()
    if rank:
        logging.getLogger("llama_pipeline_parallel_tpu_torch").setLevel(logging.WARNING)
    t0 = time.perf_counter()
    peak_rss = PeakRss()
    run, result = tp_rank_run(out_dir, TP_OVERRIDES + [f"max_steps={steps}"], "bf16")
    result.update(rank=rank, build_s=time.perf_counter() - t0)
    for module in (fa, fc, fp):
        module.reset_launch_counts()
    distributed.staging_by.clear()
    distributed.collective_s.clear()
    summary = train_run(run)
    result.update({k: summary[k] for k in ("losses", "step_times", "tokens_per_step")},
                  launches={**fa.launch_counts, **fc.launch_counts, **fp.launch_counts},
                  tensor_core={**fa.tensor_core_counts, **fc.tensor_core_counts,
                               **fp.tensor_core_counts},
                  peak_bytes=torch.cuda.max_memory_allocated(), rss_gb=rss_gb(),
                  peak_rss_gb=peak_rss.stop(),
                  staging_by=dict(distributed.staging_by),
                  collective_s=dict(distributed.collective_s), host_numel=run.host.numel(),
                  host_dims=sum(d is not None for d in (run.host.dims or {}).values()))
    del run, summary
    gc.collect()
    torch.cuda.empty_cache()
    # the planted fault, on every tp peer alike (the same collectives in the
    # same order): the dhidden of each rank's local columns goes into the
    # norm backward unsummed
    run, planted = tp_rank_run(out_dir, TP_OVERRIDES + ["max_steps=1"], "bf16", "planted")
    fp.distributed = types.SimpleNamespace(all_reduce=lambda t, group=None: t)
    try:
        result["planted"] = {**planted, "losses": train_run(run)["losses"]}
    finally:
        fp.distributed = distributed
    del run
    gc.collect()
    torch.cuda.empty_cache()
    run, fp32 = tp_rank_run(out_dir, TP_OVERRIDES + TP_FP32, "fp32")
    result["fp32"] = {**fp32, "losses": train_run(run)["losses"]}
    with open(os.path.join(out_dir, f"tp-rank{rank}.json"), "w") as f:
        json.dump(result, f)
    del run
    distributed.shutdown()
    return 0


def tp_rank_run(out_dir: str, overrides: list, tag: str, name: str = "",
                config: str = TP_CONFIG) -> tuple:
    """A rank's run of `config` with `overrides` (in out_dir's
    `run-<tag><name>`), its optimizer wrapped: step 1's gradients against
    `ref_grads_<tag>.safetensors`'s slices of this rank (sums of squares of
    the difference and of the reference, split and replicated leaves apart),
    then the host optimizer, whose phases each step records. Returns (run,
    the record)."""
    from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
    from llama_pipeline_parallel_tpu_torch.parallel.tp import tp_dim
    from llama_pipeline_parallel_tpu_torch.train import build_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    run = build_run(load_config(os.path.join(ROOT, "conf", config), overrides + [
        f"output_dir={out_dir}/run-{tag}{name}"]), "cuda")
    mesh, host = run.mesh, run.host
    # grad_sq is filled in place: callers may copy the record before its step
    result: dict = {"stages": list(mesh.stages), "replica": mesh.replica,
                    "tp_rank": mesh.tp_rank, "sp_rank": mesh.sp_rank, "host_ms": [],
                    "grad_sq": {}}

    class Parity:
        def step(self, params, grads, norm):
            if not result["host_ms"]:
                result["grad_sq"].update(grad_sq(out_dir, tag, run, grads))
            lr = host.step(params, grads, norm)
            result["host_ms"].append(dict(host.last_timings))
            return lr

    run.state.optimizer = Parity()
    return run, result


def grad_sq(out_dir: str, tag: str, run, grads: dict) -> dict:
    """A rank's gradients (its stage's chunks and tp slices, named as the
    optimizer names them) against `ref_grads_<tag>.safetensors`'s pieces of
    this rank: sums of squares of the difference and of the reference,
    split and replicated leaves apart."""
    from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
    from llama_pipeline_parallel_tpu_torch.parallel.tp import tp_dim

    mesh = run.mesh
    out = {"split": [0.0, 0.0], "whole": [0.0, 0.0]}
    with tensor_io.TensorFile(os.path.join(out_dir, f"ref_grads_{tag}.safetensors")) as f:
        ref = pl.flatten_chunks(pl.chunk_views(
            {name: f.tensor(name) for name in f.keys()}, run.manifest,
            run.pipeline.stage_params.stages, mesh.tp_rank, mesh.tp))
        for name, g in grads.items():
            # in pieces: eight ranks share the card
            r = ref[name].contiguous().view(-1)
            kind = "whole" if tp_dim(name, g.dim()) is None else "split"
            for a in range(0, r.numel(), 1 << 24):
                rc = r[a:a + (1 << 24)].to(g.device).double()
                gc = g.reshape(-1)[a:a + (1 << 24)].double()
                out[kind][0] += float((gc - rc).square().sum())
                out[kind][1] += float(rc.square().sum())
            del r, rc, gc
    return out


def tp_kernels() -> dict:
    """The prologue and flash kernels at a tp rank's LLaMA-65B shapes
    (TP_PRO, TP_FLASH) held to their plain versions at PERF.md section 2's
    limits, and their readings (ms, plain, yardstick, bound)."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp

    c = TP_PRO
    log(f"[tp] prologue kernels at a tp rank's shapes: {c['b'] * c['s']} tokens, d={c['d']}, "
        f"{c['h']} + {c['kv']} + {c['kv']} local heads of 128, bf16, vs the plain version")
    inp = prologue_inputs(**c, dtype=torch.bfloat16, seed=14)
    rows = prologue_readings(inp, prologue_case(inp, fp32=False, route=fp.TENSOR_CORE),
                             "[tp]")
    del inp
    torch.cuda.empty_cache()
    c = TP_FLASH
    log(f"[tp] flash kernels at a tp rank's shapes: b={c['b']} h={c['h']} s={c['s']} "
        f"hd={c['hd']} bf16 causal vs the plain version in fp32")
    q, k, v, do = make_inputs(c["b"], c["h"], c["h_kv"], c["s"], c["s"], c["hd"],
                              torch.bfloat16, 15)
    kw = dict(causal=True, scale=c["hd"] ** -0.5, q_offset=0, kv_offset=0,
              segments_q=None, segments_kv=None)
    errs = kernel_case(fa, q, k, v, do, kw, fp32=False, route=fa.TENSOR_CORE)
    rows.update(flash_readings(q, k, v, do, kw, errs, "[tp]"))
    del q, k, v, do
    torch.cuda.empty_cache()
    return rows


def phase_tp() -> None:
    """pp 2 x tp 2 x dp 2 at LLaMA-65B width in 8 processes on the one card
    (module docstring, phase 14): the kernels at a tp rank's shapes, the
    one-process reference's step 1, then the 8 ranks: step 1 against it,
    launches, and the one-card gloo mode's numbers."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
    from llama_pipeline_parallel_tpu_torch.train import build_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    card = card_line()
    config = os.path.join(ROOT, "conf", TP_CONFIG)
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "tp")
    os.makedirs(out_dir, exist_ok=True)
    rows = tp_kernels()
    log(f"[tp] kernel readings at a tp rank's LLaMA-65B shapes ({card}): "
        + json.dumps(list(rows.values())))

    # the reference: one process, pp 2 in memory, tp 1, the same global batch,
    # in bf16 and in fp32
    ref = {}
    for tag, extra in (("bf16", []), ("fp32", TP_FP32)):
        t_ref = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run = build_run(load_config(config, TP_ONE + extra + [f"output_dir={out_dir}/one"]),
                        "cuda")
        batch = next(run.batches())
        sp = run.pipeline.stage_params
        ref[tag] = run.pipeline.loss_and_grad(batch).item()
        ref_peak, ref_rss = torch.cuda.max_memory_allocated(), rss_gb()
        tensor_io.write_file(os.path.join(out_dir, f"ref_grads_{tag}.safetensors"),
                             sp.to_canonical(sp.grads()))
        del run, sp, batch
        release_host_cache()
        log(f"[tp] one process, pp 2 x tp 1 x dp 1, {2 * TP_MICROBATCHES} microbatches, {tag}, "
            f"step 1: loss "
            f"{ref[tag]:.6f}; gradients written; max_memory_allocated "
            f"{ref_peak / 2**30:.2f} GiB, host RSS {ref_rss and round(ref_rss, 2)} GB after the "
            f"step "
            f"({time.perf_counter() - t_ref:.1f} s)")
    # how far bf16 alone moves this model's gradient: one process in bf16 on
    # the fp32 reference's rows against it
    t_ref = time.perf_counter()
    run = build_run(load_config(config, TP_ONE + TP_BF16_ROWS + [f"output_dir={out_dir}/one"]),
                    "cuda")
    sp = run.pipeline.stage_params
    run.pipeline.loss_and_grad(next(run.batches()))
    grads = sp.to_canonical(sp.grads())
    with tensor_io.TensorFile(os.path.join(out_dir, "ref_grads_fp32.safetensors")) as f:
        sq = [0.0, 0.0]
        for name in f.keys():
            want = f.tensor(name).to(grads[name].device).double()
            sq[0] += float((grads[name].double() - want).square().sum())
            sq[1] += float(want.square().sum())
            del want
    bf16_noise = math.sqrt(sq[0] / sq[1])
    del run, sp, grads
    release_host_cache()
    log(f"[tp] one process, tp 1, bf16 against fp32 on the fp32 step's rows (4 a "
        f"microbatch): gradient rel diff {bf16_noise:.3e}, bf16's own distance from fp32 "
        f"without tp ({time.perf_counter() - t_ref:.1f} s)")

    t_ranks = time.perf_counter()
    # expandable segments: eight ranks' caching allocators share 80 GB
    procs = launch_ranks(TP_RANKS, ["--tp-worker", out_dir, str(TP_STEPS)], out_dir, "tp",
                         {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks = finish_ranks("tp", procs, out_dir, "tp", timeout=900)
    losses = ranks[0]["losses"]
    if any(r["losses"] != losses for r in ranks) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[tp] losses differ across ranks or are not finite: "
                             f"{[r['losses'] for r in ranks]}")
    replica0 = [r for r in ranks if r["replica"] == 0]

    def grad_rel(key):
        """Every rank's slices of every gradient against the reference's:
        the split leaves of every replica-0 rank, the replicated ones once."""
        recs = [r if key == "bf16" else r[key] for r in replica0]
        diff = sum(x["grad_sq"]["split"][0] for x in recs) + sum(
            x["grad_sq"]["whole"][0] for x in recs if x["tp_rank"] == 0)
        total = sum(x["grad_sq"]["split"][1] for x in recs) + sum(
            x["grad_sq"]["whole"][1] for x in recs if x["tp_rank"] == 0)
        return math.sqrt(diff / total)

    fp32_losses = ranks[0]["fp32"]["losses"]
    if any(r["fp32"]["losses"] != fp32_losses for r in ranks):
        raise AssertionError(f"[tp] fp32 losses differ across ranks: "
                             f"{[r['fp32']['losses'] for r in ranks]}")
    loss_diff = abs(losses[0] - ref["bf16"])
    fp32_diff = abs(fp32_losses[0] - ref["fp32"])
    rel = {tag: grad_rel(tag) for tag in ("bf16", "planted", "fp32")}
    log(f"[tp] step 1 against one process (pp 2, tp 1, dp 1, the same rows): bf16 loss "
        f"{losses[0]:.6f} vs {ref['bf16']:.6f}, |diff| {loss_diff:.3e} (tol "
        f"{STEP_LOSS_TOL}); fp32 (4 rows a microbatch) loss {fp32_losses[0]:.6f} vs "
        f"{ref['fp32']:.6f}, |diff| {fp32_diff:.3e} (tol {FP32_STEP_LOSS_TOL}), gradient rel "
        f"diff "
        f"{rel['fp32']:.3e} (tol {GRAD_REL_TOL}) over every rank's slices; bf16 gradient rel "
        f"diff {rel['bf16']:.3e} (tol {TP_BF16_GRAD_REL_TOL}; bf16 against fp32 in one "
        f"process {bf16_noise:.3e}); planted fault (dhidden not summed over tp), bf16: loss "
        f"{ranks[0]['planted']['losses'][0]:.6f}, gradient rel diff {rel['planted']:.3e}")
    if not (loss_diff <= STEP_LOSS_TOL and fp32_diff <= FP32_STEP_LOSS_TOL
            and rel["fp32"] <= GRAD_REL_TOL and rel["bf16"] <= TP_BF16_GRAD_REL_TOL):
        raise AssertionError(f"[tp] step 1: bf16 loss |diff| {loss_diff}, fp32 loss |diff| "
                             f"{fp32_diff}, fp32 gradient rel diff {rel['fp32']}, bf16 "
                             f"gradient rel diff {rel['bf16']}")
    if not rel["planted"] > TP_BF16_GRAD_REL_TOL:
        raise AssertionError(f"[tp] the bf16 gradient check passes a planted fault "
                             f"({rel['planted']})")
    cfg = load_config(config, TP_OVERRIDES)
    from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig
    from llama_pipeline_parallel_tpu_torch.train import (
        build_manifest,
        build_model_config,
        build_pipeline_config,
    )

    manifest = build_manifest(cfg, build_model_config(cfg["model"]), 2)
    pcfg = build_pipeline_config(cfg, MeshConfig(pp=2, dp=2, tp=2), manifest)
    us = pl.flush_unit_schedule(pcfg)
    steps = len(losses)
    for r in ranks:
        per_step = pipeline_launches(us, manifest, pcfg.accum_chunks, pcfg.remat,
                                     stages=tuple(r["stages"]))
        # the vocab-parallel CE head is a plain product: no CE kernel under tp
        want = {key: 0 if key.startswith("ce_") else c * steps for key, c in per_step.items()}
        staged = {k: round(v["seconds"] / steps, 3) for k, v in r["staging_by"].items()}
        walls = {k: round(v / steps, 3) for k, v in r["collective_s"].items()}
        host_ms = [round(sum(h.values()), 1) for h in r["host_ms"]]
        log(f"[tp] rank {r['rank']} (stage {r['stages']}, replica {r['replica']}, tp rank "
            f"{r['tp_rank']}): launches {r['launches']} (expected {want}); "
            f"max_memory_allocated {r['peak_bytes'] / 2**30:.2f} GiB; host RSS after the steps "
            f"{r['rss_gb'] and round(r['rss_gb'], 2)} GB, peak (sampled "
            f"every 0.1 s) {r['peak_rss_gb'] and round(r['peak_rss_gb'], 2)} GB; host masters {r['host_numel'] / 1e6:.1f} M elements "
            f"({r['host_dims']} leaves split over dp); gloo staging s a step by group {staged}, "
            f"collective wall s a step {walls}; host AdamW ms {host_ms}; build "
            f"{r['build_s']:.1f} s")
        if r["launches"] != want or r["tensor_core"] != want:
            raise AssertionError(f"[tp] rank {r['rank']}: launches {r['launches']}, on the "
                                 f"tensor cores {r['tensor_core']}, expected {want}")
    step_s = statistics.median(ranks[0]["step_times"][1:] or ranks[0]["step_times"])
    tokens = ranks[0]["tokens_per_step"]
    log(f"[tp] {steps} steps, pp 2 x tp 2 x dp 2 in {TP_RANKS} processes sharing one card over "
        f"gloo (this one-card gloo mode, not a multi-card figure): step "
        f"{1e3 * step_s:.1f} ms ({step_label(ranks[0]['step_times'])}), "
        f"{tokens / step_s:.0f} tokens/s, {tokens} "
        f"tokens a step; max_memory_allocated a rank "
        f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]} GiB, "
        f"{sum(r['peak_bytes'] for r in ranks) / 2**30:.2f} GiB in all; host RSS a rank after "
        f"the steps {[r['rss_gb'] and round(r['rss_gb'], 2) for r in ranks]} GB, peak (sampled every "
        f"0.1 s) {[r['peak_rss_gb'] and round(r['peak_rss_gb'], 2) for r in ranks]} GB; "
        f"losses "
        f"{[round(x, 5) for x in losses]} (ranks {time.perf_counter() - t_ranks:.1f} s, "
        f"{card})")
    shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    log(f"[tp] phase {time.perf_counter() - t0:.1f} s")


def sp_worker(out_dir: str, steps: str) -> int:
    """One rank of the sp phase (RANK / WORLD_SIZE / MASTER_* and
    LPT_DIST_BACKEND=gloo in its environment): SP_CONFIG with SP_OVERRIDES
    built once; on its first batch, the pipeline's loss and gradients with
    every slab's kv_offset 0 (the planted fault) and with Ulysses in place
    of the ring (its launches counted); then `steps` steps through
    train_run, the launch counts set to 0 just before the loop and read just
    after; then an fp32 run's (SP_FP32) pipeline loss and gradients on its
    first batch. Each step-1
    gradient (this rank's pieces of the (dp, sp)-reduced gradient, as the
    host optimizer receives them) is held against the one-process
    reference's (`ref_grads_<dtype>.safetensors` in out_dir). Writes
    `sp-rank<r>.json`."""
    import gc
    import logging

    import torch

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.parallel import distributed
    from llama_pipeline_parallel_tpu_torch.ops.flash_attention import flash_attention
    from llama_pipeline_parallel_tpu_torch.parallel import ring_attention as ra
    from llama_pipeline_parallel_tpu_torch.parallel.mesh import sp_slab
    from llama_pipeline_parallel_tpu_torch.parallel.sp import make_sp_attention
    from llama_pipeline_parallel_tpu_torch.train import train_run

    distributed.initialize_distributed("cuda")
    rank = distributed.process_index()
    if rank:
        logging.getLogger("llama_pipeline_parallel_tpu_torch").setLevel(logging.WARNING)

    def counts() -> dict:
        return {"launches": {**fa.launch_counts, **fc.launch_counts, **fp.launch_counts},
                "tensor_core": {**fa.tensor_core_counts, **fc.tensor_core_counts,
                                **fp.tensor_core_counts}}

    def released():
        gc.collect()
        release_host_cache()

    def direct_step(run, batch, what: str, tag: str = "bf16") -> dict:
        """Step 1's loss and gradients by the pipeline alone (no optimizer
        step), against the `tag` reference; the gradients zeroed after."""
        loss = run.pipeline.loss_and_grad(sp_slab(batch, run.mesh)).item()
        grads = run.pipeline.stage_params.grads()
        out = {"losses": [loss], "grad_sq": grad_sq(out_dir, tag, run, grads)}
        for g in grads.values():
            g.zero_()
        log(f"[sp] rank {rank} {what}: loss {loss:.6f}")
        return out

    t0 = time.perf_counter()
    peak_rss = PeakRss()
    run, result = tp_rank_run(out_dir, SP_OVERRIDES + [f"max_steps={steps}"], "bf16",
                              config=SP_CONFIG)
    result.update(rank=rank, build_s=time.perf_counter() - t0)
    batch = next(run.batches())  # the first batch of the run's own stream
    # the planted fault, on every rank alike: each slab's keys taken to start
    # at position 0 (the forward and backward calls of every slab)
    slab_fwd, slab_bwd = ra._slab_fwd, ra._slab_bwd
    ra._slab_fwd = lambda *a, **kw: slab_fwd(*a, **{**kw, "kv_offset": 0})
    ra._slab_bwd = lambda *a, **kw: slab_bwd(*a, **{**kw, "kv_offset": 0})
    try:
        result["planted"] = direct_step(run, batch, "planted fault (kv_offset 0)")
    finally:
        ra._slab_fwd, ra._slab_bwd = slab_fwd, slab_bwd
    # Ulysses on the same params and rows: the pipeline's attention re-wrapped
    ring_attn = run.pipeline.attn_fn
    run.pipeline.attn_fn = make_sp_attention("ulysses", flash_attention, run.mesh.sp_group)
    reset_kernel_counts()
    try:
        result["ulysses"] = {**direct_step(run, batch, "Ulysses"), **counts()}
    finally:
        run.pipeline.attn_fn = ring_attn
    del batch
    released()
    reset_kernel_counts()
    distributed.staging_by.clear()
    distributed.collective_s.clear()
    summary = train_run(run)
    result.update({k: summary[k] for k in ("losses", "step_times", "tokens_per_step")},
                  **counts(), peak_bytes=torch.cuda.max_memory_allocated(), rss_gb=rss_gb(),
                  peak_rss_gb=peak_rss.stop(), staging_by=dict(distributed.staging_by),
                  collective_s=dict(distributed.collective_s), host_numel=run.host.numel())
    del run, summary
    released()
    run = tp_rank_run(out_dir, SP_OVERRIDES + SP_FP32, "fp32", config=SP_CONFIG)[0]
    result["fp32"] = direct_step(run, next(run.batches()), "fp32", "fp32")
    with open(os.path.join(out_dir, f"sp-rank{rank}.json"), "w") as f:
        json.dump(result, f)
    del run
    distributed.shutdown()
    return 0


def sp_masked_slab(fa, q, k, v, do, kw: dict, lse) -> dict:
    """The fully masked slab (every key after every query): out 0 and lse
    NEG_INF from the forward, and dq, dk, dv 0 from the backward given the
    row's global lse (finite, from another slab, as the ring gives it), each
    exactly and equal to the plain version's; returns the kernels' ms."""
    import torch

    out, lse_slab = fa._fwd_cuda(q, k, v, **kw)
    ref_out, ref_lse = fa._fwd_plain(q.float(), k.float(), v.float(), **kw)
    delta = (do.float() * torch.randn_like(do, dtype=torch.float32)).sum(-1, keepdim=True)
    dq = fa._bwd_dq_cuda(q, k, v, delta, lse, do, **kw)
    dk, dv = fa._bwd_dkv_cuda(q, k, v, delta, lse, do, **kw)
    ref_dq = fa._bwd_dq_plain(q, k, v, delta, lse, do, **kw)
    ref_dk, ref_dv = fa._bwd_dkv_plain(q, k, v, delta, lse, do, **kw)
    exact = {"out": (out, ref_out.to(out.dtype)), "lse": (lse_slab, ref_lse), "dq": (dq, ref_dq),
             "dk": (dk, ref_dk), "dv": (dv, ref_dv)}
    for name, (got, ref) in exact.items():
        want_value = fa.NEG_INF if name == "lse" else 0.0
        if not (torch.equal(got, ref) and bool((got == want_value).all())):
            raise AssertionError(f"[sp] fully masked slab: {name} is not {want_value} "
                                 f"everywhere (max |x| {got.float().abs().max().item()})")
    log(f"  fully masked slab: out 0, lse {fa.NEG_INF}, dq / dk / dv 0, exactly, as the plain "
        f"version")
    return {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}


def sp_kernels() -> dict:
    """The flash kernels at an sp rank's slab (SP_FLASH) on the ring's three
    kinds of slab (SP_SLABS: q and kv offsets) and the prologue kernels at a
    slab whose positions start at SP_PRO's pos0, held to their plain
    versions at PERF.md section 2's limits (the masked slab exactly), with
    their readings (ms, plain, yardstick, bound)."""
    import torch

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp

    c = SP_PRO
    log(f"[sp] prologue kernels at an sp rank's slab: {c['b'] * c['s']} tokens at positions "
        f"{c['pos0']}.., d={c['d']}, {c['h']} + {c['kv']} + {c['kv']} local heads of 128, bf16, "
        f"vs the plain version")
    inp = prologue_inputs(**c, dtype=torch.bfloat16, seed=16)
    rows = prologue_readings(inp, prologue_case(inp, fp32=False, route=fp.TENSOR_CORE), "[sp]")
    del inp
    torch.cuda.empty_cache()
    c = SP_FLASH
    q, k, v, do = make_inputs(c["b"], c["h"], c["h"], c["s"], c["s"], c["hd"], torch.bfloat16,
                              17)
    lse_global = None
    for kind, (q_off, kv_off) in SP_SLABS.items():
        log(f"[sp] flash kernels on a {kind} slab: b={c['b']} h={c['h']} sq=skv={c['s']} "
            f"hd={c['hd']} bf16 causal, q_offset={q_off} kv_offset={kv_off}, vs the plain "
            f"version in fp32")
        kw = dict(causal=True, scale=c["hd"] ** -0.5, q_offset=q_off, kv_offset=kv_off,
                  segments_q=None, segments_kv=None)
        if kind == "masked":
            errs = sp_masked_slab(fa, q, k, v, do, kw, lse_global)
            pairs, library = 0, None
        else:
            errs = kernel_case(fa, q, k, v, do, kw, fp32=False, route=fa.TENSOR_CORE)
            pairs = causal_pairs(c["b"], c["h"], c["s"]) if q_off == kv_off else \
                c["b"] * c["h"] * c["s"] * c["s"]
            library = q_off == kv_off
            if lse_global is None:
                lse_global = fa._fwd_cuda(q, k, v, **kw)[1]
        rows.update({f"{key}-{kind}": row for key, row in flash_readings(
            q, k, v, do, kw, errs, "[sp]", pairs=pairs, library_causal=library,
            label=f" ({kind} slab)").items()})
    del q, k, v, do, lse_global
    torch.cuda.empty_cache()
    return rows


def sp_grad_rel(ranks: list, key: str) -> float:
    """Every rank's pieces of every gradient against the reference's: the
    split leaves of each (replica 0, sp rank 0) rank, the replicated ones
    once (tp rank 0); sp peers hold the same sums (checked)."""
    recs = [r if key == "bf16" else r[key] for r in ranks]
    by_cell = {}
    for r, x in zip(ranks, recs):
        cell = (tuple(r["stages"]), r["replica"], r["tp_rank"])
        if cell in by_cell and by_cell[cell]["grad_sq"] != x["grad_sq"]:
            raise AssertionError(f"[sp] {key}: sp peers of {cell} hold different gradients: "
                                 f"{by_cell[cell]['grad_sq']} vs {x['grad_sq']}")
        by_cell.setdefault(cell, x)
    first = [(t, x["grad_sq"]) for (_, replica, t), x in by_cell.items() if replica == 0]
    diff = sum(sq["split"][0] for _, sq in first) + sum(
        sq["whole"][0] for t, sq in first if t == 0)
    total = sum(sq["split"][1] for _, sq in first) + sum(
        sq["whole"][1] for t, sq in first if t == 0)
    return math.sqrt(diff / total)


def phase_sp() -> None:
    """pp 2 x tp 2 x sp 2 at CodeLlama-34B width in 8 processes on the one
    card (module docstring, phase 15): the kernels at an sp rank's slab, the
    one-process reference's step 1, then the 8 ranks: step 1 against it,
    the planted fault, Ulysses, fp32, launches, and the one-card gloo
    mode's numbers."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
    from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
    from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig
    from llama_pipeline_parallel_tpu_torch.train import (
        build_manifest,
        build_model_config,
        build_pipeline_config,
        build_run,
    )
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    card = card_line()
    config = os.path.join(ROOT, "conf", SP_CONFIG)
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "sp")
    os.makedirs(out_dir, exist_ok=True)
    rows = sp_kernels()
    log(f"[sp] kernel readings at an sp rank's slab of CodeLlama-34B ({card}): "
        + json.dumps(list(rows.values())))

    # the reference: one process, pp 2 in memory, tp 1, sp 1, the same rows, in
    # bf16 and (at SP_FP32's rows) fp32
    ref = {}
    for tag, extra in (("bf16", []), ("fp32", SP_FP32)):
        t_ref = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run = build_run(load_config(config, SP_ONE + extra + [f"output_dir={out_dir}/one"]),
                        "cuda")
        batch = next(run.batches())
        sp = run.pipeline.stage_params
        ref[tag] = run.pipeline.loss_and_grad(batch).item()
        ref_peak, ref_rss = torch.cuda.max_memory_allocated(), rss_gb()
        tensor_io.write_file(os.path.join(out_dir, f"ref_grads_{tag}.safetensors"),
                             sp.to_canonical(sp.grads()))
        del run, sp, batch
        release_host_cache()
        log(f"[sp] one process, pp 2 x tp 1 x sp 1, {SP_MICROBATCHES} microbatches, {tag}, "
            f"step 1: loss "
            f"{ref[tag]:.6f}; gradients written; max_memory_allocated "
            f"{ref_peak / 2**30:.2f} GiB, host RSS {ref_rss and round(ref_rss, 2)} GB after the "
            f"step ({time.perf_counter() - t_ref:.1f} s)")

    t_ranks = time.perf_counter()
    procs = launch_ranks(SP_RANKS, ["--sp-worker", out_dir, str(SP_STEPS)], out_dir, "sp",
                         {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks = finish_ranks("sp", procs, out_dir, "sp", timeout=900)
    for key in ("bf16", "planted", "ulysses", "fp32"):
        got = [r["losses"] if key == "bf16" else r[key]["losses"] for r in ranks]
        if any(x != got[0] for x in got) or not all(math.isfinite(x) for x in got[0]):
            raise AssertionError(f"[sp] {key} losses differ across ranks or are not finite: "
                                 f"{got}")
    losses = ranks[0]["losses"]
    diffs = {"bf16": abs(losses[0] - ref["bf16"]),
             "ulysses": abs(ranks[0]["ulysses"]["losses"][0] - ref["bf16"]),
             "fp32": abs(ranks[0]["fp32"]["losses"][0] - ref["fp32"])}
    rel = {key: sp_grad_rel(ranks, key) for key in ("bf16", "planted", "ulysses", "fp32")}
    log(f"[sp] step 1 against one process (pp 2, tp 1, sp 1, the same rows): bf16 loss "
        f"{losses[0]:.6f} vs {ref['bf16']:.6f}, |diff| {diffs['bf16']:.3e} (tol "
        f"{STEP_LOSS_TOL}), gradient rel diff {rel['bf16']:.3e} (tol {TP_BF16_GRAD_REL_TOL}); "
        f"Ulysses bf16 loss |diff| {diffs['ulysses']:.3e}, gradient rel diff "
        f"{rel['ulysses']:.3e}; fp32 (4,096-token rows) loss {ranks[0]['fp32']['losses'][0]:.6f}"
        f" vs {ref['fp32']:.6f}, |diff| {diffs['fp32']:.3e} (tol {FP32_STEP_LOSS_TOL}), "
        f"gradient rel diff {rel['fp32']:.3e} (tol {GRAD_REL_TOL}); planted fault (every "
        f"slab's kv_offset 0), bf16: loss {ranks[0]['planted']['losses'][0]:.6f}, gradient "
        f"rel diff {rel['planted']:.3e}")
    if not (diffs["bf16"] <= STEP_LOSS_TOL and diffs["ulysses"] <= STEP_LOSS_TOL
            and diffs["fp32"] <= FP32_STEP_LOSS_TOL and rel["fp32"] <= GRAD_REL_TOL
            and rel["bf16"] <= TP_BF16_GRAD_REL_TOL
            and rel["ulysses"] <= TP_BF16_GRAD_REL_TOL):
        raise AssertionError(f"[sp] step 1: loss |diff| {diffs}, gradient rel diff {rel}")
    if not rel["planted"] > TP_BF16_GRAD_REL_TOL:
        raise AssertionError(f"[sp] the bf16 gradient check passes a planted fault "
                             f"({rel['planted']})")
    cfg = load_config(config, SP_OVERRIDES)
    manifest = build_manifest(cfg, build_model_config(cfg["model"]), 2)
    pcfg = build_pipeline_config(cfg, MeshConfig(pp=2, tp=2, sp=2), manifest)
    us = pl.flush_unit_schedule(pcfg)
    steps = len(losses)
    n_slabs = int(cfg["mesh"]["sp"])
    for r in ranks:
        per_step = pipeline_launches(us, manifest, pcfg.accum_chunks, pcfg.remat,
                                     stages=tuple(r["stages"]))
        # the vocab-parallel CE head is a plain product: no CE kernel under tp;
        # the ring calls each flash kernel once a slab (sp times an attention)
        want = {key: 0 if key.startswith("ce_")
                else c * steps * (n_slabs if key in ("fwd", "dq", "dkv") else 1)
                for key, c in per_step.items()}
        want_uly = {key: 0 if key.startswith("ce_") else c for key, c in per_step.items()}
        staged = {k: round(v["seconds"] / steps, 3) for k, v in r["staging_by"].items()}
        walls = {k: round(v / steps, 3) for k, v in r["collective_s"].items()}
        host_ms = [round(sum(h.values()), 1) for h in r["host_ms"]]
        log(f"[sp] rank {r['rank']} (stage {r['stages']}, tp rank {r['tp_rank']}, sp rank "
            f"{r['sp_rank']}): launches {r['launches']} (expected {want}); Ulysses "
            f"{r['ulysses']['launches']} (expected {want_uly}); max_memory_allocated "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; host RSS after the steps "
            f"{r['rss_gb'] and round(r['rss_gb'], 2)} GB, peak (sampled every 0.1 s) "
            f"{r['peak_rss_gb'] and round(r['peak_rss_gb'], 2)} GB; host masters "
            f"{r['host_numel'] / 1e6:.1f} M elements; gloo staging s a step by group {staged}, "
            f"collective wall s a step {walls}; host AdamW ms {host_ms}; build "
            f"{r['build_s']:.1f} s")
        for got, expected, tag in ((r, want, "ring"), (r["ulysses"], want_uly, "ulysses")):
            if got["launches"] != expected or got["tensor_core"] != expected:
                raise AssertionError(f"[sp] rank {r['rank']} {tag}: launches "
                                     f"{got['launches']}, on the tensor cores "
                                     f"{got['tensor_core']}, expected {expected}")
    step_s = statistics.median(ranks[0]["step_times"][1:] or ranks[0]["step_times"])
    tokens = ranks[0]["tokens_per_step"]
    log(f"[sp] {steps} steps, pp 2 x tp 2 x sp 2 in {SP_RANKS} processes sharing one card over "
        f"gloo (this one-card gloo mode, not a multi-card figure): step "
        f"{1e3 * step_s:.1f} ms ({step_label(ranks[0]['step_times'])}), "
        f"{tokens / step_s:.0f} tokens/s, {tokens} "
        f"tokens a step; max_memory_allocated a rank "
        f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]} GiB, "
        f"{sum(r['peak_bytes'] for r in ranks) / 2**30:.2f} GiB in all; host RSS a rank after "
        f"the steps {[r['rss_gb'] and round(r['rss_gb'], 2) for r in ranks]} GB, peak (sampled "
        f"every 0.1 s) {[r['peak_rss_gb'] and round(r['peak_rss_gb'], 2) for r in ranks]} GB; "
        f"losses {[round(x, 5) for x in losses]} (ranks {time.perf_counter() - t_ranks:.1f} s, "
        f"{card})")
    shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    log(f"[sp] phase {time.perf_counter() - t0:.1f} s")


# -- serving (phase 16) --------------------------------------------------------

SERVE_CONFIG = "llama_7b_pp4.yaml"   # its model: LLaMA-7B, bf16, all 32 layers
SERVE_DEVICE = "cuda"                # where the phase runs (a CPU rehearsal sets "cpu")
SERVE_SEED = 18
SERVE_SLOTS = 8
SERVE_MAX_LEN = 2048
SERVE_BUCKETS = (64, 128, 256, 512, 1024)
SERVE_NEW = 64                       # new tokens a request
SERVE_PAGE = 64
SERVE_CHUNK = 256                    # prefill_chunk_tokens of the chunked variant
SERVE_PREFIX = 512                   # the prefix the 900-token requests share
# (prompt tokens, sampled) of the 8 requests: buckets 64, 128, 256, 512 and
# four of 1024 whose prompts open with the same SERVE_PREFIX tokens
SERVE_REQUESTS = ((40, False), (120, True), (250, False), (400, False),
                  (900, False), (900, False), (900, True), (900, False))
SERVE_SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
SERVE_PARITY = dict(rows=2, bucket=512, pad=100)   # decode vs the trainer's forward
SERVE_BF16_NOISE = 2.0               # bf16 decode's distance from fp32 / the bf16 trainer's
SERVE_INT8_TICKS = 6                 # the reference's int8 gate: forced-stream greedy ticks
SERVE_INT8_NOISE = 3.0               # int8's logit perturbation / bf16's (serve_parity)
# |dequant(quant(x)) - x| <= INT8_HALF_CODE codes of scale / 127: half a code,
# plus the fp32 roundings of x * (127 / scale) (<= 2 ulp of <= 127 codes) and
# of q * (scale / 127) (<= 2 ulp): 0.5 + 4 * 127 * 2^-24 < 0.50004. (The
# reference's test states 0.5000001, below its own fp32 rounding.)
INT8_HALF_CODE = 0.50004
SERVE_TICK_POS = SERVE_MAX_LEN - 1   # decode-tick readings: every row's full 2048 positions
SERVE_EP_LAYERS = 2                  # the entry point's checkpoint
SERVE_EP_TRAFFIC = dict(seed=5, rate=200.0, n=4, prompt="100:0.5,300:0.5", output="16:1.0")


def serve_model(cfg, seed: int, device: str) -> dict:
    """Serving params at cfg's width and depth: each leaf drawn by the
    trainer's init (`init_leaf`) on `device` and cast to the compute dtype at
    once (decode.compute_params), so the fp32 masters never sit there whole."""
    from llama_pipeline_parallel_tpu_torch.models.llama import decode
    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama

    out = {}
    for name in llama.param_shapes(cfg):
        out.update(decode.compute_params({name: llama.init_leaf(cfg, name, seed,
                                                                device=device)}, cfg))
    return out


def serve_requests(vocab: int) -> list:
    """SERVE_REQUESTS as (prompt ids, GenerationConfig, seed), from SERVE_SEED."""
    import numpy as np

    from llama_pipeline_parallel_tpu_torch.models.llama.decode import GenerationConfig

    rs = np.random.RandomState(SERVE_SEED)
    prefix = rs.randint(3, vocab, SERVE_PREFIX).tolist()
    out = []
    for i, (n, sampled) in enumerate(SERVE_REQUESTS):
        ids = (prefix + rs.randint(3, vocab, n - SERVE_PREFIX).tolist() if n > SERVE_PREFIX
               else rs.randint(3, vocab, n).tolist())
        gen = GenerationConfig(max_new_tokens=SERVE_NEW, **(SERVE_SAMPLED if sampled else {}))
        out.append((ids, gen, SERVE_SEED + i))
    return out


def padded(ids: list, bucket: int):
    import numpy as np

    pad = bucket - len(ids)
    return (np.asarray([[0] * pad + ids], np.int64), np.asarray([[0] * pad + [1] * len(ids)],
                                                               np.int32))


def serve_run(params, cfg, reqs, device: str, staged: bool = False, **kw) -> dict:
    """The requests through one ServeEngine (SERVE_SLOTS x SERVE_MAX_LEN,
    SERVE_BUCKETS, `kw` the cache's keys): all submitted at once, or with
    `staged` the first prefix request alone until its prefill is done (so
    its pages are in the prefix index), then the rest. Returns the tokens,
    the wall seconds, the metrics snapshot and each handle's cached tokens."""
    from llama_pipeline_parallel_tpu_torch.serve import ServeConfig, ServeEngine, ServeRequest

    engine = ServeEngine(params, cfg, ServeConfig(
        max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prompt_buckets=SERVE_BUCKETS,
        max_queue=2 * len(reqs), **kw), device=device)
    order = list(range(len(reqs)))
    first = next(i for i, (ids, _, _) in enumerate(reqs) if len(ids) > SERVE_PREFIX)
    if staged:
        order = [first] + [i for i in order if i != first]
    t0 = time.perf_counter()
    handles = {}
    for i in order:
        ids, gen, seed = reqs[i]
        handles[i] = engine.submit(ServeRequest(input_ids=ids, gen=gen, seed=seed))
        if staged and i == first:
            while not handles[i].tokens_out:
                engine.step()
    engine.drain(timeout_s=600)
    wall = time.perf_counter() - t0
    out = {"tokens": [handles[i].result(timeout=1) for i in range(len(reqs))], "wall": wall,
           "snap": engine.metrics_snapshot(),
           "cached": [handles[i].prefix_cached_tokens for i in range(len(reqs))]}
    engine.shutdown()
    return out


def first_difference(a: list, b: list) -> str:
    for r, (x, y) in enumerate(zip(a, b)):
        if x != y:
            t = next((j for j, (u, v) in enumerate(zip(x, y)) if u != v), min(len(x), len(y)))
            return f"request {r}, token {t}: {x[t:t + 4]} vs {y[t:t + 4]}"
    return "none"


def expect_tokens(name: str, got: list, want: list) -> None:
    if got != want:
        raise AssertionError(f"{name}: tokens differ, first at {first_difference(got, want)}")
    log(f"  {name}: {sum(len(t) for t in got)} tokens of {len(got)} requests equal")


def reference_tokens(params, cfg, reqs, buckets) -> list:
    """Each request's tokens from `generate` on its prompt left-padded to its
    bucket and a generator seeded with its seed; requests of one bucket and
    one GenerationConfig share a call (a row's tokens do not depend on its
    batch: models/llama/decode.py, "Row invariance")."""
    import numpy as np
    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import decode

    dev = decode._device(params)
    groups: dict = {}
    for i, (ids, gen, seed) in enumerate(reqs):
        bucket = next(b for b in buckets if b >= len(ids))
        groups.setdefault((bucket, gen), []).append(i)
    out = [None] * len(reqs)
    for (bucket, gen), idx in groups.items():
        rows = [padded(reqs[i][0], bucket) for i in idx]
        gens = [torch.Generator(device=dev).manual_seed(reqs[i][2]) for i in idx]
        res = decode.generate(params, np.concatenate([r[0] for r in rows]),
                              np.concatenate([r[1] for r in rows]), cfg, gen, generator=gens)
        for i, row in zip(idx, res["tokens"].tolist()):
            out[i] = row
    return out


def serve_parity(params, cfg, vocab: int, device: str) -> float:
    """(2) prefill_prompt's last-position logits against the trainer's
    forward (exact attention) on the same rows, one of them left-padded.
    Gated in fp32 compute on the same (upcast) weights, by the 2^-8 rule:
    there the two differ by their summation orders alone. In bf16 both are
    far from fp32 (bf16 rounding through every layer of a random model), so
    the bf16 gate is relative: decode's distance from the fp32 forward at
    most SERVE_BF16_NOISE times the trainer's own. The last token's rope
    position shifted by one is planted (a uniform shift would be invisible:
    RoPE scores see position differences only). Returns the bf16 noise
    floor: max |bf16 trainer - fp32 trainer| over the logits."""
    import dataclasses

    import numpy as np
    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import decode
    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama

    p = SERVE_PARITY
    rs = np.random.RandomState(SERVE_SEED + 100)
    ids = rs.randint(3, vocab, (p["rows"], p["bucket"]))
    mask = np.ones_like(ids, dtype=np.int32)
    mask[1, :p["pad"]] = 0
    ids[1, :p["pad"]] = 0
    ids_t = torch.as_tensor(ids, device=device)
    mask_t = torch.as_tensor(mask, device=device)
    pos = (mask_t.cumsum(1) - 1).clamp_min(0)
    shifted = pos.clone()
    shifted[:, -1] += 1
    rows = f"{p['rows']} x {p['bucket']} (row 1 left-padded by {p['pad']})"
    out = {}
    for tag, dt in (("bf16", cfg.dtype), ("fp32", torch.float32)):
        c = dataclasses.replace(cfg, dtype=dt)
        w = params if dt == cfg.dtype else {n: t.to(dt) for n, t in params.items()}
        with torch.no_grad():
            ref = llama.forward(w, ids_t, mask_t, pos, cfg=c)[:, -1]
            got = decode.prefill_prompt(w, ids, mask, c, p["bucket"])["logits"]
            cache = decode.init_kv_cache(c, p["rows"], p["bucket"], device=device)
            planted = decode._head(w, decode._prefill_dense(w, c, ids_t, shifted, cache,
                                                            mask_t.clone())[:, -1], c)
        out[tag] = (ref, got, planted)
        del w
    ref32, got32, planted32 = out["fp32"]
    tol = tolerance(ref32, False)
    check(f"prefill_prompt vs the trainer's forward, fp32, {rows}, last-position logits",
          got32, ref32, tol)
    expect_rejected("the last token's rope position shifted by one (fp32)", planted32, ref32,
                    tol)
    ref16, got16, planted16 = out["bf16"]
    floor = (ref16.float() - ref32).abs().max().item()
    dist = (got16.float() - ref32).abs().max().item()
    planted = (planted16.float() - ref32).abs().max().item()
    log(f"  bf16: max |trainer - fp32 trainer| {floor:.4f}, max |decode - fp32 trainer| "
        f"{dist:.4f} (limit {SERVE_BF16_NOISE} x the first), max |decode - bf16 trainer| "
        f"{(got16 - ref16).abs().max().item():.4f}; planted {planted:.4f}")
    if not dist <= SERVE_BF16_NOISE * floor:
        raise AssertionError(f"bf16 decode is {dist} from the fp32 forward, more than "
                             f"{SERVE_BF16_NOISE} x the bf16 trainer's {floor}")
    if not planted > SERVE_BF16_NOISE * floor:
        raise AssertionError(f"the bf16 check passes the planted fault ({planted})")
    return floor


def int8_gate(params, cfg, reqs, device: str, noise: float) -> None:
    """(5) the reference's int8 gate (tests/test_paged_serving.py:459-525)
    at this size: one request's prompt pages within the per-page bound of
    the fp pool's (INT8_HALF_CODE: half a code and fp32's rounding), and
    SERVE_INT8_TICKS greedy ticks with the fp and int8 pools fed the same
    (fp) stream. The reference asks the tokens to agree; at 32 random
    layers fp's top two logits can sit closer than any quantization keeps
    them, so a tick passes when the tokens agree or fp's logit of int8's
    token is within int8's perturbation of that tick (max |int8 - fp
    logits|), and every perturbation must stay within SERVE_INT8_NOISE x
    `noise` (bf16's own distance from fp32, serve_parity). Planted: every
    key page read at twice its scale, which the perturbation bound must
    reject."""
    import numpy as np
    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import decode
    from llama_pipeline_parallel_tpu_torch.serve import PagedKVCache

    ids, _, _ = reqs[3]
    bucket = next(b for b in SERVE_BUCKETS if b >= len(ids))
    row_ids, row_mask = padded(ids, bucket)
    caches = {}
    for quant in ("fp", "int8", "planted"):
        c = PagedKVCache(cfg, 2, SERVE_MAX_LEN, SERVE_PAGE, 2 * SERVE_MAX_LEN // SERVE_PAGE,
                         "fp" if quant == "fp" else "int8", device=device)
        c.acquire("r", c.demand_pages(bucket, SERVE_INT8_TICKS + 1))
        out = decode.prefill_prompt(params, row_ids, row_mask, cfg, bucket)
        c.admit(0, out)
        caches[quant] = (c, out)
    (fp_c, fp_out), (q_c, _), (bad_c, _) = caches["fp"], caches["int8"], caches["planted"]
    bad_c.pool["k_scale"] *= 2.0
    n = bucket // SERVE_PAGE
    fp_pages = torch.as_tensor(fp_c.page_table[0, :n], device=device)
    q_pages = torch.as_tensor(q_c.page_table[0, :n], device=device)
    valid = torch.as_tensor(row_mask[0], device=device).bool().view(n, SERVE_PAGE)
    worst = 0.0
    for name in ("k", "v"):   # pools [L, kv_h, pages, page, hd], scales [L, pages, kv_h]
        fp_kv = fp_c.pool[name][:, :, fp_pages].float()
        sk = q_c.pool[f"{name}_scale"][:, q_pages].transpose(1, 2)[..., None, None]
        deq = q_c.pool[name][:, :, q_pages].float() * (sk / 127.0)
        bound = sk / 127.0 * INT8_HALF_CODE + 1e-7
        ratio = ((deq - fp_kv).abs() / bound)[:, :, valid]
        worst = max(worst, ratio.max().item())
    log(f"  int8 prompt pages ({bucket}-token bucket, {int(valid.sum())} real positions): "
        f"worst |dequant - fp| {worst * INT8_HALF_CODE:.7f} codes (limit {INT8_HALF_CODE})")
    if not worst <= 1.0:
        raise AssertionError(f"int8 pages exceed the per-page quantization bound ({worst})")

    def tick(c, tok, pos, wp):
        c.ensure_capacity(0, wp + 1)
        out = decode.paged_decode_step(params, [tok, 0], c.pool, c.page_table, [pos, 0],
                                       [wp, 0], c.kv_mask, [1, 0], [None, None], [0.0, 0.0],
                                       [0, 0], [1.0, 1.0], cfg)
        c.update_from_step(out)
        return int(out["token"][0]), out["logits"][0]

    tok = int(fp_out["logits"][0].argmax())
    pos, wp = int(fp_out["next_pos"][0]), bucket
    limit = SERVE_INT8_NOISE * noise
    toks, worst_bad = [], 0.0
    for t in range(SERVE_INT8_TICKS):
        nf, lf = tick(fp_c, tok, pos, wp)
        nq, lq = tick(q_c, tok, pos, wp)
        _, lb = tick(bad_c, tok, pos, wp)
        d = (lq - lf).abs().max().item()
        worst_bad = max(worst_bad, (lb - lf).abs().max().item())
        top2 = lf.topk(2).values
        lead = (lf[nf] - lf[nq]).item()
        log(f"    tick {t}: fp {nf}, int8 {nq}; fp's top-2 gap {(top2[0] - top2[1]).item():.4f}, "
            f"fp's lead over int8's token {lead:.4f}, max |int8 - fp logits| {d:.4f} "
            f"(limit {limit:.4f})")
        if not d <= limit:
            raise AssertionError(f"int8 moves tick {t}'s logits by {d}, above {limit}")
        if nq != nf and not lead <= d:
            raise AssertionError(f"tick {t}: int8 picks {nq}, which fp ranks {lead} below its "
                                 f"{nf}: more than int8's perturbation {d}")
        toks.append((nf, nq))
        tok, pos, wp = nf, pos + 1, wp + 1
    log(f"  int8 forced-stream ticks (fp, int8): {toks}; planted (key scales doubled): max "
        f"|planted - fp logits| {worst_bad:.4f} (must exceed {limit:.4f})")
    if not worst_bad > limit:
        raise AssertionError(f"the int8 gate passes the planted fault ({worst_bad})")


def kernel_launch_totals() -> dict:
    """Launches of the nine kernels since the last reset_kernel_counts()."""
    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp

    return {**fa.launch_counts, **fc.launch_counts, **fp.launch_counts}


def weight_bytes(params: dict) -> int:
    """Bytes a decode tick reads of the weights: every leaf but the
    embedding (a gather of one row a token)."""
    return sum(t.numel() * t.element_size() for n, t in params.items()
               if n != "embed.embedding")


def kv_bytes_per_position(cfg, quant: str) -> int:
    elem = 1 if quant == "int8" else 2
    return 2 * cfg.num_hidden_layers * cfg.kv_heads * cfg.head_dim * elem


def prefill_reading(params, cfg, bucket: int, vocab: int) -> dict:
    """prefill_prompt at one bucket (one row, no padding): ms beside the bound
    max(weights / memory rate, flops / peak bf16 rate)."""
    import numpy as np

    from llama_pipeline_parallel_tpu_torch.models.llama import decode
    from llama_pipeline_parallel_tpu_torch.utils.metrics import param_count

    ids = np.random.RandomState(bucket).randint(3, vocab, (1, bucket))
    mask = np.ones((1, bucket), np.int32)
    ms = cuda_ms(lambda: decode.prefill_prompt(params, ids, mask, cfg, bucket), reps=3)
    d, v = cfg.hidden_size, cfg.vocab_size
    layer_params = param_count(cfg) - 2 * v * d - d
    # the layers on every token, the head on the last, causal attention
    flops = (2 * layer_params * bucket + 2 * d * v
             + 4 * cfg.num_hidden_layers * d * bucket * (bucket + 1) // 2)
    bound = 1e3 * max(weight_bytes(params) / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
    return {"bucket": bucket, "ms": round(ms, 3), "bound_ms": round(bound, 3),
            "tokens_per_s": round(bucket / ms * 1e3, 1)}


def tick_reading(params, cfg, kind: str, active: int) -> dict:
    """One decode tick over SERVE_SLOTS rows with `active` of them decoding
    at position SERVE_TICK_POS (every earlier position visible): ms beside
    the bound (weights + the active rows' kv) / memory rate, as the engine
    runs it (the forward replayed as a CUDA graph) and eager, and whether
    the two give the same logits bit for bit (a tick's writes are its own,
    so repeating it changes nothing)."""
    import numpy as np
    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import decode
    from llama_pipeline_parallel_tpu_torch.serve.pages import dense_kv_cache_bytes, \
        paged_pool_bytes

    s, lm, dev = SERVE_SLOTS, SERVE_MAX_LEN, SERVE_DEVICE
    wp = np.zeros(s, np.int64)
    wp[:active] = SERVE_TICK_POS
    mask = torch.zeros((s, lm), dtype=torch.int32, device=dev)
    mask[:active] = 1
    knobs = ([None] * s, np.zeros(s), np.zeros(s, np.int64), np.ones(s))
    tok = np.zeros(s, np.int64)
    quant = "int8" if kind == "paged int8" else "fp"
    if kind == "dense":
        cache = decode.init_kv_cache(cfg, s, lm, device=dev)
        resident = dense_kv_cache_bytes(cfg, s, lm)

        def fn():
            return decode.decode_step(params, tok, cache, wp, wp, mask, *knobs, cfg)["logits"]
    else:
        per = lm // SERVE_PAGE
        pool = decode.init_page_pool(cfg, s * per, SERVE_PAGE, quant, device=dev)
        table = np.full((s, per), s * per, np.int64)
        table[:active] = np.arange(active * per).reshape(active, per)
        act = (np.arange(s) < active).astype(np.int64)
        resident = paged_pool_bytes(cfg, s * per, SERVE_PAGE, quant)

        def fn():
            return decode.paged_decode_step(params, tok, pool, table, wp, wp, mask, act, *knobs,
                                            cfg)["logits"]
    ms = cuda_ms(fn, reps=5)
    graphed = fn()
    decode.CUDA_GRAPHS = False
    try:
        eager_ms = cuda_ms(fn, reps=3)
        same = torch.equal(graphed, fn())
    finally:
        decode.CUDA_GRAPHS = True
    kv_read = active * (SERVE_TICK_POS + 1) * kv_bytes_per_position(cfg, quant)
    bound = 1e3 * (weight_bytes(params) + kv_read) / PEAK_BYTES_PER_S
    return {"kv": kind, "active": active, "ms": round(ms, 3), "bound_ms": round(bound, 3),
            "eager_ms": round(eager_ms, 3), "graph_bits_equal_eager": same,
            "kv_read_gb": round(kv_read / 1e9, 3), "kv_resident_gb": round(resident / 1e9, 3)}


def start_entry_point(cfg, out_dir: str) -> dict:
    """(6), first half: a checkpoint of SERVE_EP_LAYERS layers at LLaMA-7B
    width written here (init_params, fp32 masters), then tools.serve
    started on it in a subprocess, which loads while the phase goes on."""
    import dataclasses

    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import CheckpointManager
    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
    from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest

    t0 = time.perf_counter()
    ecfg = dataclasses.replace(cfg, num_hidden_layers=SERVE_EP_LAYERS)
    ckpt_dir = os.path.join(out_dir, "ckpt")
    params = llama.init_params(ecfg, SERVE_SEED, device=SERVE_DEVICE)
    CheckpointManager(ckpt_dir).save(0, params, StageManifest(num_layers=SERVE_EP_LAYERS,
                                                              num_stages=1), ecfg)
    del params
    torch.cuda.empty_cache()
    t_save = time.perf_counter() - t0
    cmd = [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.serve",
           "--checkpoint_dir", ckpt_dir, "--output_dir", os.path.join(out_dir, "replica"),
           "--max_slots", str(SERVE_SLOTS), "--max_len", str(SERVE_MAX_LEN),
           "--buckets", ",".join(map(str, SERVE_BUCKETS)), "--health_interval", "1"]
    log_path = os.path.join(out_dir, "serve.log")
    shutil.rmtree(os.path.join(out_dir, "replica"), ignore_errors=True)
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
    log(f"  tools.serve started on a {SERVE_EP_LAYERS}-layer checkpoint written in "
        f"{t_save:.1f} s")
    return {"proc": proc, "cfg": ecfg, "ckpt_dir": ckpt_dir, "log": log_path,
            "serve_json": os.path.join(out_dir, "replica", "serve.json")}


def finish_entry_point(ep: dict) -> None:
    """(6), second half: SERVE_EP_TRAFFIC's requests through serve_traffic's
    streaming HTTP client against tools.serve, their tokens against an
    in-process engine on the same checkpoint; SIGTERM -> exit 0."""
    import signal

    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import load_module_checkpoint
    from llama_pipeline_parallel_tpu_torch.serve import ServeConfig, ServeEngine
    from llama_pipeline_parallel_tpu_torch.tools import serve_traffic as st

    t0 = time.perf_counter()
    proc, ecfg = ep["proc"], ep["cfg"]
    tr = SERVE_EP_TRAFFIC
    trace = st.poisson_trace(tr["seed"], tr["rate"], tr["n"], st.parse_mix(tr["prompt"]),
                             st.parse_mix(tr["output"]))
    eparams, _, _, _ = load_module_checkpoint(ep["ckpt_dir"], device="cpu")
    engine = ServeEngine(eparams, ecfg, ServeConfig(
        max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prompt_buckets=SERVE_BUCKETS),
        device=SERVE_DEVICE)
    del eparams
    local = st.run_trace(engine, trace, collect_tokens=True)
    engine.shutdown()
    del engine
    deadline = time.monotonic() + 300
    while not os.path.exists(ep["serve_json"]):
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"tools.serve did not come up (rc {proc.poll()}); "
                                 f"log {ep['log']}")
        time.sleep(0.2)
    with open(ep["serve_json"]) as f:
        port = json.load(f)["port"]
    t_http = time.perf_counter()
    remote = st.run_trace_gateway(f"http://127.0.0.1:{port}", trace, ecfg.vocab_size,
                                  collect_tokens=True)
    t_http = time.perf_counter() - t_http
    if remote["completed"] != tr["n"]:
        raise AssertionError(f"tools.serve completed {remote['completed']} of {tr['n']} "
                             f"requests: {remote}")
    expect_tokens(f"tools.serve over HTTP (streamed) vs the in-process engine, "
                  f"{SERVE_EP_LAYERS} layers", remote["tokens"], local["tokens"])
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120)
    if rc != 0:
        raise AssertionError(f"tools.serve exited {rc} on SIGTERM; log {ep['log']}")
    log(f"  tools.serve: {tr['n']} streamed requests in {t_http:.2f} s, exit 0 on SIGTERM "
        f"({time.perf_counter() - t0:.1f} s after the rest of the phase)")


def phase_serving() -> None:
    """Decode and continuous-batching serving at LLaMA-7B width and all 32
    layers (module docstring, phase 16)."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.train import build_model_config
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    card = card_line()
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "serving")
    os.makedirs(out_dir, exist_ok=True)
    cfg = build_model_config(load_config(os.path.join(ROOT, "conf", SERVE_CONFIG))["model"])
    gc.collect()
    torch.cuda.empty_cache()
    ep = start_entry_point(cfg, out_dir)
    try:
        serve_checks(cfg, out_dir, card, t0)
        finish_entry_point(ep)
    finally:
        if ep["proc"].poll() is None:
            ep["proc"].kill()
            ep["proc"].wait()
    shutil.rmtree(os.path.join(out_dir, "ckpt"), ignore_errors=True)
    log(f"[serving] ok ({time.perf_counter() - t0:.1f} s)")


def serve_checks(cfg, out_dir: str, card: str, t0: float) -> None:
    """Steps (1)-(5) and the readings (7) of phase_serving."""
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.serve.pages import dense_kv_cache_bytes

    vocab = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()

    # (1) the model
    params = serve_model(cfg, SERVE_SEED, SERVE_DEVICE)
    log(f"[serving] {SERVE_CONFIG}'s model: d {cfg.hidden_size}, {cfg.num_hidden_layers} "
        f"layers, {cfg.num_attention_heads} heads, ffn {cfg.intermediate_size}, vocab {vocab}, "
        f"{cfg.dtype}; {sum(t.numel() * t.element_size() for t in params.values()) / 1e9:.2f} "
        f"GB of compute weights ({time.perf_counter() - t0:.1f} s)")

    # (2) decode against the trainer's forward
    noise = serve_parity(params, cfg, vocab, SERVE_DEVICE)

    # (3) the dense engine against generate
    reqs = serve_requests(vocab)
    dense = serve_run(params, cfg, reqs, SERVE_DEVICE)
    snap = dense["snap"]
    expect_tokens("dense engine vs generate", dense["tokens"],
                  reference_tokens(params, cfg, reqs, SERVE_BUCKETS))

    # (4) the paged variants against the dense run
    variants = {"paged fp": dict(kv_cache="paged", page_size=SERVE_PAGE),
                "paged fp, chunked prefill": dict(kv_cache="paged", page_size=SERVE_PAGE,
                                                  prefill_chunk_tokens=SERVE_CHUNK),
                "paged fp, prefix cache": dict(kv_cache="paged", page_size=SERVE_PAGE,
                                               prefix_cache=True)}
    runs = {}
    for name, kw in variants.items():
        runs[name] = serve_run(params, cfg, reqs, SERVE_DEVICE, staged="prefix" in name, **kw)
        expect_tokens(f"{name} vs dense", runs[name]["tokens"], dense["tokens"])
    psnap = runs["paged fp, prefix cache"]["snap"]
    cached = runs["paged fp, prefix cache"]["cached"]
    sharing = [i for i, (ids, _, _) in enumerate(reqs) if len(ids) > SERVE_PREFIX]
    log(f"  prefix cache: hits {psnap.get('prefix_hits')}, cached tokens a request {cached}, "
        f"shared pages {psnap.get('prefix_shared_pages')}, cow forks "
        f"{psnap.get('prefix_cow_forks')}")
    if psnap.get("prefix_hits", 0) < len(sharing) - 1 or \
            any(cached[i] < SERVE_PREFIX for i in sharing[1:]):
        raise AssertionError(f"the prefix-sharing requests {sharing[1:]} did not hit the "
                             f"cache: {cached}, {psnap}")
    chunks = runs["paged fp, chunked prefill"]["snap"]["prefill_chunks_total"]
    log(f"  chunked prefill: {chunks} prefill units")

    # (5) int8 pages
    q = serve_run(params, cfg, reqs, SERVE_DEVICE, kv_cache="paged", page_size=SERVE_PAGE,
                  kv_quant="int8")
    firsts = [t[0] for t in q["tokens"]], [t[0] for t in dense["tokens"]]
    if firsts[0] != firsts[1]:
        raise AssertionError(f"int8 first tokens {firsts[0]} differ from fp's {firsts[1]}")
    agree = sum(a == b for x, y in zip(q["tokens"], dense["tokens"]) for a, b in zip(x, y))
    log(f"  paged int8: first tokens equal fp's; {agree} of {SERVE_NEW * len(reqs)} tokens "
        f"equal the fp stream's")
    int8_gate(params, cfg, reqs, SERVE_DEVICE, noise)

    counts = kernel_launch_totals()
    if any(counts.values()):
        raise AssertionError(f"the serving path launched a kernel of the nine: {counts}")
    log("  the serving path launched none of the nine kernels (counts 0), as the JAX "
        "package's decode reaches none of its Pallas kernels")

    # (7) readings
    readings = {"card": card, "prefill": [prefill_reading(params, cfg, b, vocab)
                                          for b in (64, 256, 1024)]}
    readings["decode_tick"] = [tick_reading(params, cfg, kind, active)
                               for kind in ("dense", "paged fp", "paged int8")
                               for active in (1, SERVE_SLOTS)]
    readings["engine"] = {
        "tokens_per_s": round(snap["tokens_generated"] / dense["wall"], 1),
        "wall_s": round(dense["wall"], 3), "ttft_p50_ms": snap.get("ttft_p50_ms"),
        "tpot_p50_ms": snap.get("tpot_p50_ms"), "decode_steps": snap["decode_steps"],
        "paged_tokens_per_s": {n: round(r["snap"]["tokens_generated"] / r["wall"], 1)
                               for n, r in runs.items()}}
    readings["memory"] = {
        "max_memory_allocated_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "dense_kv_gb": round(dense_kv_cache_bytes(cfg, SERVE_SLOTS, SERVE_MAX_LEN) / 1e9, 3),
        "weights_gb": round(weight_bytes(params) / 1e9, 3)}
    for key in ("prefill", "decode_tick"):
        for r in readings[key]:
            log(f"  {key} {json.dumps(r)}")
    log(f"  engine {json.dumps(readings['engine'])}")
    log(f"  memory {json.dumps(readings['memory'])}")
    with open(os.path.join(out_dir, "readings.json"), "w") as f:
        json.dump(readings, f, indent=1)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 17. resilience: the supervised resize and the gateway's failover
# ---------------------------------------------------------------------------

# the trainer leg: conf/llama_7b_pp4.yaml at LLaMA-7B width, 2 layers, seq
# 2048, 1 row a microbatch, the nine kernels; dp 2 in 2 ranks over gloo on
# card 0, then dp 1 in one rank with the accumulation doubled (the same
# global batch of 2 rows)
RES_DEVICE = "cuda"                  # where the phase runs (a CPU rehearsal sets "cpu")
RES_STEPS = 4
RES_OVERRIDES = [
    "mesh.pp=1", "mesh.dp=2", "model.num_hidden_layers=2", "dataset.seq_length=2048",
    "max_seq_length=2048", "per_device_train_batch_size=1", "gradient_accumulation_steps=1",
    f"max_steps={RES_STEPS}", "total_steps=500", "warmup_steps=1", "attention=flash",
    "activation_checkpointing=false", "kernels.ce=pallas", "loss_vocab_chunks=4",
    "kernels.prologue=pallas", "save_steps=2", "save_final=true", "async_save=false",
    "logging_steps=1", "preempt_check_every=1", "data.log_sample_ids=true",
    "actions={resize_on_request: true}",
]
# the dp2 rung holds its ranks RES_LATE_HOLD_S at the top of step 3 before
# that step's vote: a request that missed step 2's vote (it lands while the
# ranks write checkpoint-2, so only a round trip longer than that save misses
# it) is then voted at step 3, and the dp1 rung still trains step 4
RES_LATE_HOLD_S = 30.0
RES_LADDER = [{"name": "dp2", "devices": 2, "overrides": [
                  "fault_plan={faults: [{site: step, op: stall, at_step: 3, seconds: "
                  f"{RES_LATE_HOLD_S}}}]}}"]},
              {"name": "dp1", "devices": 1,
               "overrides": ["mesh.dp=1", "gradient_accumulation_steps=2"]}]
RES_KERNELS = ("fwd", "dq", "dkv", "ce_fwd", "ce_dh", "ce_dw", "prologue_fwd",
               "prologue_dhidden", "prologue_dw")
# the serving leg: two replicas of the trainer leg's final checkpoint, each
# under its own supervisor; replica a's decode stretched so the SIGKILL lands
# mid-stream (it is killed once a stream routed to it has the gateway's first
# delivered-token watermark, 8 of 32 tokens); RES_TRAFFIC through
# tools.gateway; the relaunch's device probe
# held RES_PROBE_STALL_S (a fault-plan stall) so a's stale heartbeat shows
RES_SERVE = ["--max_slots", "4", "--max_len", "256", "--buckets", "64", "--metrics_every", "1",
             "--health_interval", "0.25", "--drain_s", "10"]
RES_TRAFFIC = dict(seed=19, rate=8.0, n=4, prompt="16", output="32")
RES_STEP_DELAY_S = 0.05
RES_STALE_S = 1.0
RES_PROBE_STALL_S = 2.0


def phase_resilience() -> None:
    """The supervisor's actuated elastic resize over torch.distributed.run,
    then the gateway's failover across a replica's SIGKILL (module
    docstring, phase 17)."""
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "resilience")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    gc_cuda()
    trained = resilience_trainer(out_dir)
    t_train = time.perf_counter() - t0
    resilience_serving(out_dir, trained)
    t_serve = time.perf_counter() - t0 - t_train
    log(f"[resilience] legs: trainer {t_train:.1f} s, serving {t_serve:.1f} s")
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[resilience] ok ({time.perf_counter() - t0:.1f} s)")


def res_env(**extra) -> dict:
    """The phase's processes: ranks over gloo on card 0, and checkpoints
    without sha256 digests (LPT_CKPT_DIGESTS=0; the checkpoint phase holds
    the digests and the quarantine: here three 8 GB saves and four loads
    would spend ~60 s on sha256 at 0.88 GB/s)."""
    return {**os.environ, "PYTHONPATH": ROOT, "LPT_DIST_BACKEND": "gloo",
            "OMP_NUM_THREADS": "4", "LPT_CKPT_DIGESTS": "0", **extra}


def res_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def res_lines(path: str) -> int:
    """Whole lines of a JSONL file (0 while it does not exist)."""
    try:
        with open(path) as f:
            return sum(1 for line in f if line.endswith("\n"))
    except OSError:
        return 0


def res_ledger(path: str) -> dict:
    """{(epoch, batch): sorted ids} of the trained batches of a sample
    ledger, the last row of a batch winning (a resumed incarnation re-trains
    the batches after its checkpoint; the prefetcher's rows past the last
    step were never trained)."""
    return {(r["epoch"], r["batch"]): sorted(r["indices"]) for r in res_jsonl(path)
            if r["epoch"] == 0 and r["batch"] < RES_STEPS}


def res_launch_blocks(run_dir: str) -> list:
    """Each incarnation's launches of the nine kernels: its process 0 appends
    one `kernel_launches` row a kernel to perf.jsonl when its loop ends."""
    blocks, block = [], {}
    for row in res_jsonl(os.path.join(run_dir, "perf.jsonl")):
        if row.get("metric") != "kernel_launches":
            continue
        name = row["context"]["kernel"]
        if name in block:
            blocks.append(block)
            block = {}
        block[name] = int(row["measured"])
    return blocks + [block]


def resilience_trainer(out_dir: str) -> str:
    """The trainer leg. Returns the run's directory (its final checkpoint
    is the serving leg's)."""
    import re
    import socket

    from llama_pipeline_parallel_tpu_torch.tools import fleetctl, fleetd, goodput_report
    from llama_pipeline_parallel_tpu_torch.train import run_training
    from llama_pipeline_parallel_tpu_torch.utils import actions
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    run_dir, fleet_root = os.path.join(out_dir, "train"), os.path.join(out_dir, "fleet")
    config = os.path.join(ROOT, "conf", "llama_7b_pp4.yaml")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.supervisor",
           "--output-dir", run_dir, "--fleet-root", fleet_root, "--actuate", "--poll-s", "0.2",
           "--hang-timeout-s", "600", "--max-restarts", "2",
           "--layout-ladder", json.dumps(RES_LADDER), "--",
           sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(port), "-m", "llama_pipeline_parallel_tpu_torch.cli",
           "--config", config, "--device", RES_DEVICE, *RES_OVERRIDES, f"output_dir={run_dir}"]
    log_path = os.path.join(out_dir, "trainer.log")
    res_mark("the supervisor starts")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        sup = subprocess.Popen(cmd, cwd=ROOT, env=res_env(LPT_DEVICE_COUNT="2"), stdout=logf,
                               stderr=subprocess.STDOUT)
    try:
        # a straight dp1 run of the same global batch, in this process while
        # the ranks start (they only import and build for its ~10 s)
        straight_dir = os.path.join(out_dir, "straight")
        summary = run_training(load_config(config, [
            *RES_OVERRIDES, *RES_LADDER[1]["overrides"], "save_steps=0", "save_final=false",
            f"output_dir={straight_dir}"]), device=RES_DEVICE)
        gc_cuda()
        # step 2's metrics line: the ranks are writing checkpoint-2, and the
        # request lands before the vote at step 2 that follows the save
        deadline = time.monotonic() + 600
        metrics = os.path.join(run_dir, "metrics.jsonl")
        while not (os.path.exists(metrics)
                   and any(r.get("step") == 2 for r in res_jsonl(metrics))):
            if sup.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"no step 2 (supervisor rc {sup.poll()}); log {log_path}")
            time.sleep(0.1)
        t_step2 = time.perf_counter() - t0
        # the fleet sees the trainer's step-time breach (a threshold every
        # step exceeds) and fleetctl's autoscaler borrows: dp1
        with open(os.devnull, "w") as quiet:
            saved, sys.stdout = sys.stdout, quiet
            try:
                fleetd.main(["--fleet-root", fleet_root, "--once", "--no-capture",
                             "--alerts", json.dumps({"step_time_p95_s": 1e-6})])
            finally:
                sys.stdout = saved
        if fleetctl.main(["--fleet-root", fleet_root, "--once", "--actions", json.dumps(
                {"autoscale": {"trainer_dir": run_dir, "borrow_rung": "dp1",
                               "restore_rung": "dp2", "breach_alerts": ["step_time_p95"]}})]):
            raise AssertionError("fleetctl --once failed")
        t_request = time.perf_counter() - t0
        # the resize's wall: from the dp2 incarnation's end (its ledger row)
        # to the dp1 incarnation's first metrics line (relaunch, build,
        # restore and the first step; goodput_report's resize_lost_seconds
        # counts only the probe and relaunch gap before the launch)
        ledger_path, resize_wall = os.path.join(run_dir, "incarnations.jsonl"), None
        while sup.poll() is None and time.monotonic() < deadline and \
                res_lines(ledger_path) == 0:
            time.sleep(0.05)
        if sup.poll() is None:
            ended = res_jsonl(ledger_path)[0]["end"]
            logged = res_lines(metrics)
            while sup.poll() is None and time.monotonic() < deadline and \
                    res_lines(metrics) == logged:
                time.sleep(0.05)
            resize_wall = time.time() - ended
        rc = sup.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        if sup.poll() is None:
            res_kill_tree(sup)
    wall = time.perf_counter() - t0
    res_timeline(log_path)
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"the supervisor exited {rc}; log {log_path}: {text[-3000:]}")
    # the first vote's step N (2, or 3 for a late request): every rank voted
    # at N, checkpoint-N was saved, and the dp1 incarnation resumed from it
    voted = [int(n) for n in re.findall(r"resize request; checkpointing at step (\d+)", text)]
    vote_step = voted[0] if voted else None
    saves = text.count(f"saved checkpoint-{vote_step} ")
    resumed = re.search(r"resumed full state from checkpoint-(\d+)", text)
    ledger = res_jsonl(os.path.join(run_dir, "incarnations.jsonl"))
    layouts = [r.get("layout") for r in ledger]
    if voted != [vote_step, vote_step] or not 2 <= vote_step < RES_STEPS or saves < 1 or (
            resumed is None or int(resumed.group(1)) != vote_step) or layouts != [
            "dp2", "dp1"] or [r["outcome"] for r in ledger] != ["clean", "clean"] or not \
            ledger[1].get("resized"):
        raise AssertionError(f"the resize: rank votes at steps {voted}, checkpoint-{vote_step} "
                             f"logged {saves} time(s), resumed "
                             f"{resumed and resumed.group(0)}, ledger {ledger}")
    history = actions.ActionJournal(fleet_root).history()
    if [(h["kind"], (h.get("result") or {}).get("outcome")) for h in history] != [
            ("borrow", "done")]:
        raise AssertionError(f"the action journal: {history}")
    with open(os.path.join(run_dir, "resize.request.ack")) as f:
        if json.load(f).get("id") != history[0]["id"]:
            raise AssertionError("the trainer's ack names another action")
    with open(os.path.join(run_dir, f"checkpoint-{RES_STEPS}", "meta.json")) as f:
        meta = json.load(f)
    global_batch = 2
    if meta["topology"]["dp"] != 1 or \
            meta["data_state"]["consumed_samples"] != RES_STEPS * global_batch:
        raise AssertionError(f"checkpoint-{RES_STEPS}: topology {meta['topology']}, data "
                             f"state {meta['data_state']}")
    blocks = res_launch_blocks(run_dir)
    if len(blocks) != 2 or any(b.get(k, 0) <= 0 for b in blocks for k in RES_KERNELS):
        raise AssertionError(f"the nine kernels' launches by incarnation: {blocks}")
    log(f"  trainer leg: {RES_STEPS} steps of LLaMA-7B width, 2 layers, seq 2048, dp 2 in 2 "
        f"ranks over gloo then dp 1 in one; step 2 logged at {t_step2:.1f} s, the resize "
        f"request (fleetd -> fleetctl -> supervisor) at {t_request:.1f} s; both ranks voted "
        f"at step {vote_step} and stopped on checkpoint-"
        f"{vote_step}, the dp1 incarnation resumed from it, "
        f"incarnations {layouts} clean; launches by incarnation {blocks}")

    got, want = (res_ledger(os.path.join(d, "samples.jsonl")) for d in (run_dir, straight_dir))
    ids = [i for v in got.values() for i in v]
    if got != want or len(ids) != len(set(ids)) or len(ids) != RES_STEPS * global_batch:
        raise AssertionError(f"the sample ledger differs from the straight run's: {got} vs "
                             f"{want}")
    last = {r["step"]: r["loss"] for r in res_jsonl(os.path.join(run_dir, "metrics.jsonl"))
            if "loss" in r}[RES_STEPS]
    diff = abs(last - summary["losses"][-1])
    if not math.isfinite(last) or diff > STEP_LOSS_TOL:
        raise AssertionError(f"step {RES_STEPS}'s loss {last} vs the straight run's "
                             f"{summary['losses'][-1]}")
    inc = goodput_report.incarnation_summary(run_dir)
    if inc["resize_events"] != 1:
        raise AssertionError(f"goodput_report: {inc}")
    log(f"  the sample ledger equals the straight dp1 run's ({len(ids)} ids, none twice); "
        f"step {RES_STEPS}'s loss {last:.6f} vs {summary['losses'][-1]:.6f} ({diff:.2e}, "
        f"limit {STEP_LOSS_TOL}); goodput_report: {inc['resize_events']} resize, "
        f"resize_lost_seconds {inc['resize_lost_seconds']} (the probe and relaunch gap), "
        f"lost_seconds {inc['lost_seconds']}; the resize's wall from dp2's exit to dp1's "
        f"first step {resize_wall and round(resize_wall, 1)} s; the leg's wall {wall:.1f} s")
    return run_dir


def resilience_serving(out_dir: str, ckpt_dir: str) -> None:
    """The serving leg: two supervised tools.serve replicas of `ckpt_dir`,
    tools.gateway over the fleet registry, RES_TRAFFIC streamed with replica
    a SIGKILLed mid-stream."""
    import glob
    import signal
    import threading

    import numpy as np
    import torch

    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import load_module_checkpoint
    from llama_pipeline_parallel_tpu_torch.models.llama import decode
    from llama_pipeline_parallel_tpu_torch.serve import gateway
    from llama_pipeline_parallel_tpu_torch.tools import serve_traffic as st
    from llama_pipeline_parallel_tpu_torch.utils import fleet

    t0 = time.perf_counter()
    fleet_root = os.path.join(out_dir, "fleet")
    reps = {n: os.path.join(out_dir, f"serve_{n}") for n in ("a", "b")}
    gw_dir = os.path.join(out_dir, "gateway")
    procs, logs = {}, {}

    def wait_json(path, changed_from=None, timeout_s=300.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    data = json.load(f)
                if changed_from is None or data.get("pid") != changed_from:
                    return data
            except (OSError, ValueError):
                pass
            if any(p.poll() is not None for p in procs.values()):
                raise AssertionError(f"a process of the serving leg exited: "
                                     f"{ {k: p.poll() for k, p in procs.items()} }; logs {logs}")
            time.sleep(0.1)
        raise AssertionError(f"{path} did not appear; logs {logs}")

    def refresh_until(agg, pred, what, timeout_s=120.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = agg.refresh()
            if pred(status):
                return status
            time.sleep(0.1)
        raise AssertionError(f"the fleet never showed {what}; logs {logs}")

    plan = {"faults": [{"site": "device_probe", "op": "stall", "seconds": RES_PROBE_STALL_S,
                        "after": 1}]}
    try:
        for name, rep in reps.items():
            logs[name] = os.path.join(out_dir, f"serve_{name}.log")
            env = res_env(LPT_DEVICE_COUNT="1", LPT_FAULT_PLAN=json.dumps(plan),
                          LPT_SERVE_STEP_DELAY_S=str(RES_STEP_DELAY_S) if name == "a" else "0")
            with open(logs[name], "w") as logf:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.supervisor",
                     "--output-dir", rep, "--fleet-root", fleet_root, "--role", "serve",
                     "--replica", name, "--poll-s", "0.1", "--hang-timeout-s", "600",
                     "--layout-ladder", json.dumps([{"name": "card", "devices": 1}]), "--",
                     sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.serve",
                     "--device", RES_DEVICE, "--checkpoint_dir", ckpt_dir, "--output_dir", rep,
                     "--port", "0", *RES_SERVE], cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
        logs["gateway"] = os.path.join(out_dir, "gateway.log")
        with open(logs["gateway"], "w") as logf:
            procs["gateway"] = subprocess.Popen(
                [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.gateway",
                 "--output_dir", gw_dir, "--fleet_root", fleet_root, "--stale_s", "60",
                 "--retry_attempts", "6", "--retry_base_delay_s", "0.05",
                 "--metrics_every_s", "0.5"], cwd=ROOT, env=res_env(), stdout=logf,
                stderr=subprocess.STDOUT)

        res_mark('started')
        # the reference: generate in this process on the same checkpoint
        params, cfg, _, step = load_module_checkpoint(ckpt_dir, device=RES_DEVICE)
        cparams = decode.compute_params(params, cfg)
        del params
        trace = st.poisson_trace(RES_TRAFFIC["seed"], RES_TRAFFIC["rate"], RES_TRAFFIC["n"],
                                 st.parse_mix(RES_TRAFFIC["prompt"]),
                                 st.parse_mix(RES_TRAFFIC["output"]))
        reqs = [(np.random.RandomState(r.seed).randint(3, cfg.vocab_size,
                                                        size=r.prompt_len).tolist(),
                 decode.GenerationConfig(max_new_tokens=r.max_new_tokens), r.seed)
                for r in trace]
        want = reference_tokens(cparams, cfg, reqs, (64,))
        del cparams
        gc_cuda()

        res_mark('reference generated')
        info = {n: wait_json(os.path.join(rep, "serve.json")) for n, rep in reps.items()}
        for rep in reps.values():
            wait_json(os.path.join(rep, "health.json"))
        # one request straight to each replica first: its first ticks (the
        # CUDA graphs' capture) are done before the kill is timed
        for name in reps:
            res_post(info[name]["port"], {"input_ids": reqs[0][0], "seed": 0,
                                          "max_new_tokens": 4})
        gw_port = wait_json(os.path.join(gw_dir, gateway.GATEWAY_JSON_NAME))["port"]
        res_mark('replicas, warm-up and gateway up')
        agg = fleet.FleetAggregator(fleet_root, fleet.AlertRules(heartbeat_stale_s=RES_STALE_S))
        if "heartbeat_stale:serve:a" in agg.refresh()["pod"]["alerts_firing"]:
            raise AssertionError("replica a is stale before the kill")
        t_up = time.perf_counter() - t0
        t_traffic = time.perf_counter()
        stop, killed = threading.Event(), []
        killer = threading.Thread(target=res_kill_mid_stream, daemon=True, args=(
            os.path.join(gw_dir, gateway.JOURNAL_NAME), reps["a"], "a", stop, killed))
        killer.start()
        try:
            summary = st.run_trace_gateway(f"http://127.0.0.1:{gw_port}", trace,
                                           cfg.vocab_size, collect_tokens=True,
                                           result_timeout_s=300.0)
        finally:
            stop.set()
            killer.join()
        t_traffic = time.perf_counter() - t_traffic
        if not killed or killed[0] != info["a"]["pid"]:
            raise AssertionError(f"replica a was not killed mid-stream: {killed}, {summary}")
        res_mark('traffic done')
        refresh_until(agg, lambda s: "heartbeat_stale:serve:a" in s["pod"]["alerts_firing"],
                      "a's stale heartbeat")
        if summary["completed"] != RES_TRAFFIC["n"] or summary["replayed"] < 1:
            raise AssertionError(f"the gateway's traffic: {summary}")
        expect_tokens(f"the gateway's streams across replica a's SIGKILL vs generate on "
                      f"checkpoint-{step}", summary["tokens"], want)
        rows = res_jsonl(os.path.join(gw_dir, gateway.JOURNAL_NAME))
        terminals = [r for r in rows if r["kind"] == "terminal"]
        intents = [r for r in rows if r["kind"] == "intent"]
        replay_rows = [r for r in rows if r["kind"] == "routed" and r["attempt"] > 1]
        if sorted(r["gid"] for r in terminals) != sorted(r["gid"] for r in intents) or \
                any(r["outcome"] != "completed" for r in terminals) or not replay_rows:
            raise AssertionError(f"the WAL: {rows}")

        res_mark('stale alert fired; checks of the traffic done')
        wait_json(os.path.join(reps["a"], "serve.json"), changed_from=info["a"]["pid"])
        refresh_until(agg, lambda s: "heartbeat_stale:serve:a" not in s["pod"]["alerts_firing"],
                      "a's stale heartbeat resolve")
        res_mark('a relaunched, alert resolved')
        captures = os.path.join(reps["a"], "captures", "*")
        deadline = time.monotonic() + 120
        while not glob.glob(captures) and time.monotonic() < deadline:
            time.sleep(0.2)
        edges = [e["state"] for e in fleet.read_alerts(fleet_root)
                 if e["alert"] == "heartbeat_stale" and e["member"] == "serve:a"]
        trigger_left = os.path.exists(os.path.join(reps["a"], fleet.CAPTURE_TRIGGER_NAME))
        if len(glob.glob(captures)) != 1 or trigger_left or edges != ["firing", "resolved"]:
            raise AssertionError(f"captures {glob.glob(captures)}, trigger left {trigger_left}, "
                                 f"edges {edges}")
        res_mark('capture seen')
        a_ledger = res_jsonl(os.path.join(reps["a"], "incarnations.jsonl"))
        if [r["outcome"] for r in a_ledger] != ["crash"]:
            raise AssertionError(f"replica a's ledger: {a_ledger}")
        gw = summary.get("gateway", {})
        log(f"  serving leg: 2 replicas of checkpoint-{step} and the gateway up in {t_up:.1f} s; "
            f"{summary['completed']} of {RES_TRAFFIC['n']} requests complete in "
            f"{t_traffic:.1f} s, {summary['replayed']} replayed ({summary['attempts_total']} "
            f"attempts), replayed tokens skipped {gw.get('replay_skipped_tokens')}, TTFT p50 "
            f"{gw.get('ttft_p50_ms')} ms p95 {gw.get('ttft_p95_ms')} ms; the WAL: "
            f"{len(terminals)} terminal rows, {len(replay_rows)} replay routed row(s); replica a "
            f"relaunched, its stale-heartbeat edges {edges}, one capture consumed")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for name, proc in procs.items():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                res_kill_tree(proc)
    bad = {n: p.returncode for n, p in procs.items() if p.returncode != 0}
    if bad:
        raise AssertionError(f"exit codes after SIGTERM: {bad}; logs {logs}")


def res_kill_mid_stream(journal: str, replica_dir: str, replica: str, stop, killed: list) -> None:
    """SIGKILL `replica` (its serve.json pid) once a stream routed to it has
    a delivered-token watermark in the gateway's WAL, so the kill lands
    mid-stream whatever the host's speed; the pid goes to `killed`."""
    from llama_pipeline_parallel_tpu_torch.tools import serve_traffic

    on = {}
    while not stop.is_set():
        try:
            rows = res_jsonl(journal)
        except (OSError, ValueError):  # not there yet, or a row half written
            rows = []
        for r in rows:
            if r["kind"] == "routed":
                on[r["gid"]] = r["replica"]
            elif r["kind"] == "watermark" and on.get(r["gid"]) == replica:
                killed.append(serve_traffic.kill_replica(replica_dir))
                return
        time.sleep(0.01)


def res_post(port: int, body: dict, timeout_s: float = 300.0) -> list:
    """One non-streamed POST to a replica's /v1/generate; its tokens."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps(dict(body, stream=False)).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read())["tokens"]


def res_kill_tree(proc) -> None:
    """SIGKILL a supervisor and every process below it (its child runs in
    a session of its own, so the supervisor's death would strand it)."""
    import signal

    from llama_pipeline_parallel_tpu_torch.tools import supervisor

    below = supervisor._descendants(proc.pid)
    proc.kill()
    proc.wait()
    for pid, start in below:
        if supervisor._alive(pid, start):
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


def res_mark(what: str) -> None:
    log(f"    | {time.strftime('%H:%M:%S')} {what}")


def res_timeline(log_path: str) -> None:
    """The trainer leg's log lines that place its time: launches, resumes,
    saves, the vote."""
    import re

    keep = re.compile(r"\[supervisor\]|^\d\d:\d\d:\d\d ")
    with open(log_path) as f:
        for line in f:
            if keep.search(line):
                log(f"    | {line.rstrip()[:200]}")


def gc_cuda() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
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
    seconds = {}

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t, 1)
        return out

    timed(phase_build)
    rows = timed(phase_kernels)
    rows.update(timed(phase_ce))
    rows.update(timed(phase_prologue))
    launches, train_losses = timed(phase_trainer)
    timed(phase_observability)
    losses_a = timed(phase_checkpoint)
    timed(phase_packed)
    timed(phase_eval, train_losses)
    timed(phase_preempt, losses_a)
    timed(phase_remat)
    timed(phase_pipeline)
    timed(phase_offload)
    timed(phase_multirank)
    timed(phase_tp)
    timed(phase_sp)
    timed(phase_serving)
    timed(phase_resilience)
    for key, row in rows.items():
        row["launches"] = launches[key]
    log(f"[done] {time.perf_counter() - t0:.1f} s; seconds by phase {seconds}")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multirank-worker"]:
        sys.exit(multirank_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--sp-worker"]:
        sys.exit(sp_worker(*sys.argv[2:]))
    sys.exit(main())
