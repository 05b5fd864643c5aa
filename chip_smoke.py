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
              kernels.ce=pallas, loss_vocab_chunks=4, kernels.prologue=pallas:
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
    "loss_vocab_chunks=4", "kernels.prologue=pallas",
]
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


def bounds(b, h, s, hd, elem_bytes) -> dict:
    """Least time of each kernel on the card: the larger of its bytes (each
    input read once, each output written once) over the memory rate and its
    operations (the causal pairs this run needs) over the bf16 peak."""
    tensor = b * h * s * hd * elem_bytes
    rows = b * h * s * 4
    pairs = causal_pairs(b, h, s)
    work = {  # (bytes moved, operations)
        "fwd": (4 * tensor + rows, 2 * 2 * hd * pairs),                # q k v in, out + lse
        "dq": (5 * tensor + 2 * rows, 3 * 2 * hd * pairs),             # q k v dO lse delta, dq
        "dkv": (6 * tensor + 2 * rows, 4 * 2 * hd * pairs),            # ..., dk dv
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


def phase_trainer() -> dict:
    import gc

    import torch

    from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
    from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
    from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
    from llama_pipeline_parallel_tpu_torch.train import build_model_config, run_training
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

    attention_parity(config, out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    ce_parity(config, out_dir, losses[0])
    gc.collect()
    torch.cuda.empty_cache()
    prologue_parity(config, out_dir)
    return launches


def attention_parity(config: str, out_dir: str) -> None:
    """Step 1 of the slice again, on the params and batch the trainer's run
    started from (build_run, same seed), on the run's prologue, with flash and
    with exact attention:
    in bf16 the step loss; in fp32 compute the per-token losses and the
    gradients, which attention decides (the mean loss at random init barely
    depends on it). A planted fault -- flash attention that hides the last
    PLANT_CUT keys, so the last q block loses its diagonal tile -- must fail
    the per-token check."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
    from llama_pipeline_parallel_tpu_torch.ops.attention import attention
    from llama_pipeline_parallel_tpu_torch.ops.flash_attention import flash_attention
    from llama_pipeline_parallel_tpu_torch.parallel.train_step import shift_labels
    from llama_pipeline_parallel_tpu_torch.train import build_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    run = build_run(load_config(config, TRAIN_OVERRIDES + [f"output_dir={out_dir}/parity"]),
                    "cuda")
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
    log(f"[trainer] step 1 on the same params and batch, flash vs exact attention: bf16 "
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

    def hide_last_keys(q, k, v, padding_mask=None, *, causal=True):
        return flash_attention(q, k[:, :-PLANT_CUT], v[:, :-PLANT_CUT], None, causal=causal)

    bad_tok, _ = step_one(hide_last_keys, fp32, grad=False)
    bad_diff = (bad_tok - exact_tok).abs().max().item()
    log(f"[trainer] planted fault (last {PLANT_CUT} keys hidden), fp32: per-token loss "
        f"max |diff| {bad_diff:.3e}, step loss |diff| {abs(mean(bad_tok) - mean(exact_tok)):.3e}")
    if not bad_diff > TOKEN_LOSS_TOL:
        raise AssertionError(f"the per-token check passes a planted fault ({bad_diff})")


def rel_diff(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over all the tensors of two gradient dicts."""
    sq_diff = sum((a[k] - g).square().sum() for k, g in b.items())
    return (sq_diff / sum(g.square().sum() for g in b.values())).sqrt().item()


def first_step(config: str, out_dir: str):
    """(run, step_one): a fresh build of the slice's run -- the params and the
    first batch the trainer's run started from -- and step_one(mcfg, grad,
    head=None, kernel_prologue=None) -> (step 1's mean loss, its gradients
    with `grad`), on the loss head `head` ((hn, targets, mcfg) -> loss sum;
    None: the run's) and the prologue `kernel_prologue` (None: the run's)."""
    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
    from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
        head_loss_sum_count,
        shift_labels,
    )
    from llama_pipeline_parallel_tpu_torch.train import build_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    run = build_run(load_config(config, TRAIN_OVERRIDES + [f"output_dir={out_dir}"]), "cuda")
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

    return run, step_one


def ce_parity(config: str, out_dir: str, run_loss: float) -> None:
    """Step 1 of the slice again, on the params and batch the trainer's run
    started from, on the run's prologue, with the CE kernel head (the run's)
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

    run, step_one = first_step(config, f"{out_dir}/ce")
    if not run.head.kernel_ce:
        raise AssertionError(f"the slice's run does not take the CE kernel head: {run.head}")
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
    log(f"[trainer] step 1 on the same params and batch, CE kernel head vs dense head: "
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
    log(f"[trainer] planted CE fault (last {PLANT_CUT} vocab columns hidden), fp32: step "
        f"loss |diff| {bad_diff:.3e}, gradient rel diff {bad_rel:.3e}")
    if bad_diff <= FP32_STEP_LOSS_TOL and bad_rel <= GRAD_REL_TOL:
        raise AssertionError(f"the CE head check passes a planted fault ({bad_diff}, "
                             f"{bad_rel})")


def prologue_parity(config: str, out_dir: str) -> None:
    """Step 1 of the slice again, on the params and batch the trainer's run
    started from, with the prologue kernels (the run's) and the composed
    prologue (rms_norm, the three matmuls, apply_rope), each with the run's
    attention and loss head: in bf16 the step loss; in fp32 compute the step
    loss and the gradients, where only summation order separates the two. A
    planted fault -- the prologue kernels on wq without its last head's
    columns -- must fail the fp32 check."""
    import dataclasses

    import torch

    from llama_pipeline_parallel_tpu_torch.models.llama import model as llama

    run, step_one = first_step(config, f"{out_dir}/prologue")
    if not run.kernel_prologue:
        raise AssertionError("the slice's run does not take the prologue kernels")
    bf16 = run.model_cfg
    step_diff = abs(step_one(bf16, grad=False)[0]
                    - step_one(bf16, grad=False, kernel_prologue=False)[0])
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    kernel_loss, kernel_grads = step_one(fp32, grad=True)
    composed_loss, composed_grads = step_one(fp32, grad=True, kernel_prologue=False)
    loss_diff = abs(kernel_loss - composed_loss)
    grad_rel = rel_diff(kernel_grads, composed_grads)
    del kernel_grads
    log(f"[trainer] step 1 on the same params and batch, prologue kernels vs composed "
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
    log(f"[trainer] planted prologue fault (wq without its last head's columns), fp32: step "
        f"loss |diff| {bad_diff:.3e}, gradient rel diff {bad_rel:.3e}")
    if bad_diff <= FP32_STEP_LOSS_TOL and bad_rel <= GRAD_REL_TOL:
        raise AssertionError(f"the prologue check passes a planted fault ({bad_diff}, "
                             f"{bad_rel})")


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
    phase_build()
    rows = phase_kernels()
    rows.update(phase_ce())
    rows.update(phase_prologue())
    launches = phase_trainer()
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
