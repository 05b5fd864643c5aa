"""The yardstick: peaks, kernel families, and the work a step needs, counted from its shapes.

Peaks are one H100 SXM's published dense rates (NVIDIA's data sheet, 700 W):
989 TFLOP/s in bf16, 3.35 TB/s of HBM. A kernel family's least time is the
sum over its calls of max(operations / peak, bytes / bandwidth), each input
byte read once and each output byte written once, for the work these inputs
need: attention counts only the causal pairs inside a document, the head only
the kept targets, and nothing is counted twice for recomputation. The
families are `tools/torch_step_profile.FAMILIES`, copied.

A step's shape (`StepShape`) is read from the batches the program was fed:
each row's document lengths (segment ids, 0 = pad) and each microbatch's
kept targets.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2
FP32 = 4
IGNORE_INDEX = -100

FAMILIES = (  # (family, substrings of kernel names), first match wins
    ("prologue", ("prologue_rstd_kernel", "prologue_fwd_kernel", "prologue_dhidden_kernel",
                  "prologue_dw_kernel", "prologue_unrope_kernel", "prologue_dhidden_tc_kernel",
                  "prologue_norm_kernel", "prologue_fwd_tc_kernel", "prologue_dw_tc_kernel")),
    ("ce_head", ("ce_stats_kernel", "ce_lse_kernel", "ce_grad_kernel", "ce_dh_kernel",
                 "ce_dw_kernel", "ce_stats_tc_kernel", "ce_grad_tc_kernel", "ce_dh_tc_kernel",
                 "ce_dw_tc_kernel")),
    ("flash_attention", ("fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel", "fwd_tc_kernel",
                         "bwd_dq_tc_kernel", "bwd_dkv_tc_kernel")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")),
    ("copy", ("Memcpy", "Memset", "copy_")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other_pytorch"


@dataclasses.dataclass
class StepShape:
    docs: list[list[list[int]]]  # [microbatch][row] -> document lengths
    targets: list[int]           # kept targets a microbatch

    @classmethod
    def of(cls, segments: np.ndarray, labels: np.ndarray, microbatches: int) -> "StepShape":
        """From a step's segment ids and labels [rows, seq]."""
        rows = segments.shape[0] // microbatches
        shifted = np.full_like(labels, IGNORE_INDEX)
        shifted[:, :-1] = labels[:, 1:]
        docs, targets = [], []
        for m in range(microbatches):
            part = slice(m * rows, (m + 1) * rows)
            docs.append([_lengths(row) for row in segments[part]])
            targets.append(int((shifted[part] != IGNORE_INDEX).sum()))
        return cls(docs, targets)

    @property
    def tokens(self) -> int:
        return sum(sum(sum(row) for row in mb) for mb in self.docs)


def _lengths(row: np.ndarray) -> list[int]:
    """Lengths of the runs of equal non-zero segment ids in a row."""
    edges = np.flatnonzero(np.diff(row)) + 1
    return [len(run) for run in np.split(row, edges) if run[0] != 0]


def pairs(lengths) -> int:
    """Causal (query, key) pairs inside documents of these lengths."""
    return sum(n * (n + 1) // 2 for n in lengths)


def _widths(model: dict) -> tuple[int, int, int, int, int, int, int]:
    d, heads = model["hidden_size"], model["num_attention_heads"]
    hd = d // heads
    return (model["num_hidden_layers"], d, model["intermediate_size"], model["vocab_size"],
            heads, model["num_key_value_heads"], hd)


def matmul_params(model: dict) -> int:
    """N_mm: the layers' q, k, v, o, gate, up and down, and the head."""
    layers, d, f, v, heads, kv, hd = _widths(model)
    per_layer = d * heads * hd + 2 * d * kv * hd + heads * hd * d + 3 * d * f
    return layers * per_layer + d * v


def model_flops(model: dict, shape: StepShape) -> float:
    """6 N_mm a token plus the causal half of PaLM's attention term, summed
    over each document: 12 L (heads * hd) a visible pair."""
    layers, d, f, v, heads, kv, hd = _widths(model)
    visible = sum(pairs(row) for mb in shape.docs for row in mb)
    return 6.0 * matmul_params(model) * shape.tokens + 12.0 * layers * heads * hd * visible


def _least(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def flash_least_s(model: dict, shape: StepShape, segmented: bool) -> float:
    """Forward (2 products) and backward (4 products: dV, dP, dQ, dK) of every
    layer and microbatch; q, k, v, out and lse in bf16 / fp32."""
    layers, d, f, v, heads, kv, hd = _widths(model)
    total = 0.0
    for mb in shape.docs:
        n = sum(sum(row) for row in mb)
        p = sum(pairs(row) for row in mb)
        q, k, lse = n * heads * hd * BF16, n * kv * hd * BF16, n * heads * FP32
        seg = n * FP32 if segmented else 0
        fwd = _least(2 * 2 * hd * heads * p, q + 2 * k + q + lse + seg)
        bwd = _least(4 * 2 * hd * heads * p, 3 * q + 2 * k + lse + seg + q + 2 * k)
        total += layers * (fwd + bwd)
    return total


def ce_least_s(model: dict, shape: StepShape) -> float:
    """The head's product over each microbatch's kept targets: forward once
    (lse, target logit), backward twice (dh fp32, dW)."""
    layers, d, f, v, heads, kv, hd = _widths(model)
    total = 0.0
    for n in shape.targets:
        h, w, t = n * d * BF16, d * v * BF16, n * FP32
        total += _least(2 * n * d * v, h + w + t + 2 * n * FP32)
        total += _least(4 * n * d * v, h + w + t + n * FP32 + n * d * FP32 + w)
    return total


def prologue_least_s(model: dict, shape: StepShape) -> float:
    """norm -> q | k | v -> RoPE of every layer and microbatch: the forward,
    dhidden and dW products, each 2 n d width."""
    layers, d, f, v, heads, kv, hd = _widths(model)
    width = (heads + 2 * kv) * hd
    total = 0.0
    for mb in shape.docs:
        n = sum(sum(row) for row in mb)
        x, nw, w = n * d * BF16, d * FP32, d * width * BF16
        trig, qkv = 2 * n * hd * BF16, n * width * BF16
        ops = 2 * n * d * width
        total += layers * (_least(ops, x + nw + w + trig + qkv)
                           + _least(ops, qkv + w + trig + n * d * FP32)
                           + _least(ops, x + nw + qkv + trig + w))
    return total
