"""The LLaMA-family decoder as published (Mistral-7B and DeepSeek-LLM-7B share it).

embedding -> per layer: RMSNorm, q/k/v projections, rotary embedding
(`rotate_half`, angles in fp32 as Hugging Face computes them), exact causal
attention over each document (grouped kv heads where the config has fewer),
output projection and residual; RMSNorm, SwiGLU MLP and residual -> final
RMSNorm -> untied head -> next-token cross-entropy summed over kept targets.

`quant="fp8"` is the precision control: every projection's operands are
rounded to float8 (e4m3, one scale a tensor) and, in the backward, its
incoming gradient to e5m2, then multiplied in fp32: the fp8 products a
faster step could be tempted to use. Attention, norms and the loss stay fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_port.reference.attention import attention

IGNORE_INDEX = -100
HEAD_TOKENS = 2048  # tokens a head chunk: its fp32 logits are recomputed in the backward
_FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(t: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / _FP8[fmt]
    return (t / scale).to(fmt).float() * scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _round(x, torch.float8_e4m3fn), _round(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dq = _round(dy, torch.float8_e5m2)
        dw = xq.reshape(-1, xq.shape[-1]).T @ dq.reshape(-1, dq.shape[-1])
        return dq @ wq.T, dw


def linear(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant is None:
        return x @ w
    if quant == "fp8":
        return _Fp8Product.apply(x, w)
    raise ValueError(f"unknown quant {quant!r}")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin [b, 1, s, hd] of the rotary embedding at `positions` [b, s]."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, device=positions.device,
                                       dtype=torch.float32) / head_dim)
    angles = positions.float()[..., None] * inv
    angles = torch.cat([angles, angles], dim=-1)[:, None]
    return angles.cos(), angles.sin()


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def layer(x, w: dict, seg, cos, sin, model: dict, quant):
    b, s, d = x.shape
    heads, kv = model["num_attention_heads"], model["num_key_value_heads"]
    hd, eps = d // heads, model["rms_norm_eps"]
    h = rms_norm(x, w["input_norm"], eps)
    q = linear(h, w["attn.wq"], quant).view(b, s, heads, hd).transpose(1, 2)
    k = linear(h, w["attn.wk"], quant).view(b, s, kv, hd).transpose(1, 2)
    v = linear(h, w["attn.wv"], quant).view(b, s, kv, hd).transpose(1, 2)
    o = attention(_rotate(q, cos, sin), _rotate(k, cos, sin), v.contiguous(), seg)
    x = x + linear(o.transpose(1, 2).reshape(b, s, heads * hd), w["attn.wo"], quant)
    h = rms_norm(x, w["post_norm"], eps)
    gate = F.silu(linear(h, w["mlp.gate"], quant))
    return x + linear(gate * linear(h, w["mlp.up"], quant), w["mlp.down"], quant)


def _head_sum(h, w, targets, quant):
    logits = linear(h, w, quant)
    return F.cross_entropy(logits, targets, ignore_index=IGNORE_INDEX, reduction="sum")


def loss_sum(params: dict, ids, seg, positions, targets, model: dict, quant=None,
             remat: bool = False) -> torch.Tensor:
    """Summed next-token loss of rows `ids` [b, s] (targets already shifted).
    `remat` recomputes each layer in the backward (memory, not arithmetic)."""
    x = F.embedding(ids, params["embed.embedding"])
    cos, sin = rope(positions, model["hidden_size"] // model["num_attention_heads"],
                    model["rope_theta"])
    layers = {name[len("layers."):]: leaf for name, leaf in params.items()
              if name.startswith("layers.")}
    for i in range(model["num_hidden_layers"]):
        w = {name: leaf[i] for name, leaf in layers.items()}
        if remat:
            x = checkpoint(layer, x, w, seg, cos, sin, model, quant, use_reentrant=False)
        else:
            x = layer(x, w, seg, cos, sin, model, quant)
    h = rms_norm(x, params["norm"], model["rms_norm_eps"]).reshape(-1, x.shape[-1])
    t = targets.reshape(-1)
    total = h.new_zeros(())
    for c in range(0, h.shape[0], HEAD_TOKENS):
        total = total + checkpoint(_head_sum, h[c:c + HEAD_TOKENS], params["lm_head"],
                                   t[c:c + HEAD_TOKENS], quant, use_reentrant=False)
    return total
