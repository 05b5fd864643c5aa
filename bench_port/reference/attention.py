"""Exact causal attention with segments, in blocks of query rows, with its own backward.

Scores are formed a block of query rows at a time against the keys up to the
block's end, so a 32,768-token row never holds its whole score matrix; the
backward recomputes each block's probabilities from the saved log-sum-exp.
A key is visible to a query when it is not later, lies in the same segment,
and is not padding (segment 0); a row that sees no key gives 0. Grouped kv
heads are broadcast, never copied.
"""

from __future__ import annotations

import torch

BLOCK_BYTES = 1 << 30  # fp32 scores of one block


def _block(b: int, heads: int, s: int) -> int:
    rows = max(BLOCK_BYTES // (4 * b * heads * s), 16)
    return 1 << (rows.bit_length() - 1)


def _visible(seg: torch.Tensor, i0: int, i1: int) -> torch.Tensor:
    """[b, 1, 1, i1 - i0, i1] bool."""
    q = torch.arange(i0, i1, device=seg.device)[:, None]
    k = torch.arange(i1, device=seg.device)[None, :]
    same = seg[:, i0:i1, None] == seg[:, None, :i1]
    return ((k <= q)[None] & same & (seg[:, None, :i1] != 0))[:, None, None]


class BlockedAttention(torch.autograd.Function):
    """q [b, h, s, hd], k and v [b, h_kv, s, hd], seg [b, s] -> out [b, h, s, hd]."""

    @staticmethod
    def forward(ctx, q, k, v, seg):
        b, h, s, hd = q.shape
        h_kv = k.shape[1]
        g = h // h_kv
        scale = hd ** -0.5
        qg = q.view(b, h_kv, g, s, hd)
        out = torch.empty_like(qg)
        lse = torch.empty(b, h_kv, g, s, 1, dtype=q.dtype, device=q.device)
        kb, vb = k[:, :, None], v[:, :, None]
        step = _block(b, h, s)
        for i0 in range(0, s, step):
            i1 = min(i0 + step, s)
            sc = (qg[:, :, :, i0:i1] @ kb[..., :i1, :].transpose(-1, -2)) * scale
            sc = sc.masked_fill(~_visible(seg, i0, i1), float("-inf"))
            m = sc.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            p = torch.exp(sc - m)
            l = p.sum(dim=-1, keepdim=True)
            out[:, :, :, i0:i1] = (p @ vb[..., :i1, :]) / torch.where(l > 0, l, 1.0)
            lse[:, :, :, i0:i1] = torch.where(l > 0, m + torch.log(l), float("-inf"))
        ctx.save_for_backward(q, k, v, seg, out, lse)
        return out.view(b, h, s, hd)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        b, h, s, hd = q.shape
        h_kv = k.shape[1]
        g = h // h_kv
        scale = hd ** -0.5
        qg = q.view(b, h_kv, g, s, hd)
        do = dout.contiguous().view(b, h_kv, g, s, hd)
        delta = (do * out).sum(dim=-1, keepdim=True)
        lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
        dq = torch.zeros_like(qg)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        kb, vb = k[:, :, None], v[:, :, None]
        step = _block(b, h, s)
        for i0 in range(0, s, step):
            i1 = min(i0 + step, s)
            qs, dos = qg[:, :, :, i0:i1], do[:, :, :, i0:i1]
            sc = (qs @ kb[..., :i1, :].transpose(-1, -2)) * scale
            p = torch.where(_visible(seg, i0, i1), torch.exp(sc - lse_safe[:, :, :, i0:i1]),
                            torch.zeros_like(sc))
            dv[:, :, :i1] += (p.transpose(-1, -2) @ dos).sum(dim=2)
            ds = p * (dos @ vb[..., :i1, :].transpose(-1, -2) - delta[:, :, :, i0:i1])
            dq[:, :, :, i0:i1] = (ds @ kb[..., :i1, :]) * scale
            dk[:, :, :i1] += (ds.transpose(-1, -2) @ qs).sum(dim=2) * scale
        return dq.view(b, h, s, hd), dk, dv, None


def attention(q, k, v, seg):
    return BlockedAttention.apply(q, k, v, seg)
