"""Fused lm-head + cross-entropy, vocab-chunked.

The counterpart of llama_pipeline_parallel_tpu/ops/cross_entropy.py (XLA code
there, plain PyTorch here). The op never builds the full [tokens, V] logits:
it walks vocab chunks with an online logsumexp, saves only [tokens]-sized
statistics, and recomputes each chunk's logits in the backward to form
dh / dW chunk by chunk. An autograd.Function because autograd through the
chunk loop would save every chunk's logits.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def _chunks(w: torch.Tensor, num_chunks: int):
    v = w.shape[1]
    if v % num_chunks:
        raise ValueError(f"vocab {v} not divisible by num_chunks={num_chunks}")
    vc = v // num_chunks
    return vc, [(c * vc, w[:, c * vc:(c + 1) * vc]) for c in range(num_chunks)]


def _chunk_logits(h: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    return (h @ wc).float()


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, targets, num_chunks):
        hN = h.reshape(-1, h.shape[-1])
        tN = targets.reshape(-1)
        valid = tN != IGNORE_INDEX
        safe_t = torch.where(valid, tN, 0)
        n = hN.shape[0]
        vc, chunks = _chunks(w, num_chunks)
        m = torch.full((n,), float("-inf"), device=h.device)
        z = torch.zeros((n,), device=h.device)
        tgt = torch.zeros((n,), device=h.device)
        for off, wc in chunks:
            logits = _chunk_logits(hN, wc)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            z = z * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            li = safe_t - off
            owned = (li >= 0) & (li < vc)
            picked = logits.gather(1, li.clamp(0, vc - 1)[:, None])[:, 0]
            tgt = torch.where(owned, picked, tgt)
            m = m_new
        lse = m + torch.log(z)
        loss_sum = torch.where(valid, lse - tgt, 0.0).sum()
        ctx.save_for_backward(h, w, safe_t, lse, valid)
        ctx.num_chunks = num_chunks
        ctx.mark_non_differentiable(valid)
        return loss_sum, valid.sum()

    @staticmethod
    def backward(ctx, ct_loss, _ct_count):
        h, w, safe_t, lse, valid = ctx.saved_tensors
        hN = h.reshape(-1, h.shape[-1])
        vc, chunks = _chunks(w, ctx.num_chunks)
        # d(loss_sum)/d(logits) = softmax - onehot, on valid tokens
        scale = (valid.float() * ct_loss)[:, None]
        dh = torch.zeros(hN.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        cols = torch.arange(vc, device=h.device)
        for off, wc in chunks:
            p = torch.exp(_chunk_logits(hN, wc) - lse[:, None])
            li = safe_t - off
            onehot = (cols[None, :] == li[:, None]) & ((li >= 0) & (li < vc))[:, None]
            g = ((p - onehot.float()) * scale).to(h.dtype)
            dh += (g @ wc.transpose(0, 1)).float()
            dw[:, off:off + vc] = (hN.transpose(0, 1) @ g).to(w.dtype)
        return dh.to(h.dtype).reshape(h.shape), dw, None, None


def fused_ce_sum_count(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                       num_chunks: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss_sum fp32, valid count) of a fused h @ w classifier.

    h: [..., d] hidden states (compute dtype); w: [d, V]; targets: [...] int
    labels aligned with h (IGNORE_INDEX = no target). V % num_chunks == 0.
    """
    return _FusedCE.apply(h, w, targets, num_chunks)
