"""Exact attention: softmax attention with the causal predicate and the
segment mask built from index comparisons — never a materialised [L, L] mask
in the batch. The reference path the flash kernels are held to."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, kv_heads, hd] -> [b, s, kv_heads * n_rep, hd] (GQA expansion)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: torch.Tensor | None = None,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Exact attention. q: [b, sq, h, hd]; k/v: [b, skv, h_kv, hd].

    padding_mask: [b, skv] SEGMENT IDS: 0 = pad, nonzero = real token. In
    self-attention (sq == skv) pairs from different segments are masked too,
    so packed examples never attend across their boundaries; with a 0/1 mask
    that test is vacuous on real-real pairs.
    q_offset/kv_offset: global positions of the local q/kv blocks.
    """
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    n_rep = h // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)

    scale = hd ** -0.5
    # operands rounded to the compute dtype, products accumulated and kept in
    # fp32 (what the reference's preferred_element_type=float32 gives)
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())

    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        kv_pos = kv_offset + torch.arange(skv, device=q.device)
        causal_ok = q_pos[:, None] >= kv_pos[None, :]  # [sq, skv]
        scores = torch.where(causal_ok[None, None], scores, NEG_INF)
    if padding_mask is not None:
        ok = padding_mask[:, None, None, :].bool()  # kv is not pad
        if sq == skv:
            seg = padding_mask.to(torch.int32)
            ok = ok & (seg[:, None, :, None] == seg[:, None, None, :])
        scores = torch.where(ok, scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)
