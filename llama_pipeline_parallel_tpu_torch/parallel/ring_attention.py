"""Ring attention: exact causal attention over the sequence slabs of an sp group.

The counterpart of llama_pipeline_parallel_tpu/parallel/ring_attention.py.
Each process of the sp group (parallel/mesh.py) holds a contiguous slab of
the sequence's q / k / v; the k / v slabs rotate around the group
(`distributed.ring_shift`: to the next process, from the previous), and the
per-slab results merge through a streaming log-sum-exp combine in which a
slab that no score of a row survives weighs exactly 0. Memory a process is
O(L / n), and the attention stays exact.

`_Ring` is a `torch.autograd.Function`, the reference's custom VJP at the
ring level: its backward recomputes each slab's probabilities from the
global row lse and delta, re-rotates k / v, and carries fp32 dk / dv
accumulators with their slab until they are home after n rotations, instead
of keeping every visiting slab for autograd.

The per-slab math shares the flash kernels' offset contract (`q_offset` /
`kv_offset` are the slabs' global first positions, from the sp rank):
- "flash": ops/flash_attention's `_fwd` / `_bwd` (the CUDA kernels on the
  card, their plain tiles on the CPU), with the q slab's and the visiting kv
  slab's segment ids apart;
- "exact": `_slab_fwd_exact` / `_slab_bwd_exact`, fp32 einsums, which run
  anywhere; the plain twins the kernels' slab calls are held to.

Layout: [b, h, s, hd] inside, k / v expanded to the q heads (every slab
rotates at one shape); segment ids [b, s] int32 (0 = pad).
"""

from __future__ import annotations

from typing import Any

import torch

from llama_pipeline_parallel_tpu_torch.ops import flash_attention as fa
from llama_pipeline_parallel_tpu_torch.parallel import distributed

NEG_INF = fa.NEG_INF


# ---------------------------------------------------------------------------
# Per-slab forward/backward (exact backend)
# ---------------------------------------------------------------------------

def _seg_mask_exact(s: torch.Tensor, seg_q: torch.Tensor, seg_kv: torch.Tensor) -> torch.Tensor:
    """Cross-segment masking for packed rows (the flash kernels' rule): a
    score survives only where q and kv carry the SAME nonzero segment id."""
    q_ids = seg_q[:, None, :, None]
    k_ids = seg_kv[:, None, None, :]
    return torch.where((q_ids == k_ids) & (k_ids != 0), s, NEG_INF)


def _scores(q, k, *, causal, scale, q_offset, kv_offset, seg_q, seg_kv):
    """fp32 scores of q against a kv slab, masked causally on global
    positions and across segments; (scaled fp32 q, fp32 k, scores)."""
    qf = q.float() * scale
    kf = k.float()
    s = qf @ kf.transpose(-1, -2)
    if causal:
        qpos = q_offset + torch.arange(q.shape[2], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[2], device=q.device)
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s, NEG_INF)
    if seg_q is not None:
        s = _seg_mask_exact(s, seg_q, seg_kv)
    return qf, kf, s


def _slab_fwd_exact(q, k, v, *, causal, scale, q_offset, kv_offset, seg_q=None, seg_kv=None):
    """-> (out [b,h,sq,hd] f32, lse [b,h,sq,1] f32); empty rows -> (0, NEG_INF)."""
    _, _, s = _scores(q, k, causal=causal, scale=scale, q_offset=q_offset,
                      kv_offset=kv_offset, seg_q=seg_q, seg_kv=seg_kv)
    m = s.amax(dim=-1, keepdim=True)
    nonempty = m > NEG_INF / 2
    p = torch.where(nonempty, torch.exp(s - torch.where(nonempty, m, 0.0)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = p @ v.float()
    safe_l = torch.where(l > 0.0, l, 1.0)
    out = torch.where(l > 0.0, out / safe_l, 0.0)
    lse = torch.where(l > 0.0, m + torch.log(safe_l), NEG_INF)
    return out, lse


def _slab_bwd_exact(q, k, v, do, lse, delta, *, causal, scale, q_offset, kv_offset,
                    seg_q=None, seg_kv=None):
    """A slab's (dq, dk, dv) in fp32 given the GLOBAL row lse and delta
    (FlashAttention-2 recompute)."""
    qf, kf, s = _scores(q, k, causal=causal, scale=scale, q_offset=q_offset,
                        kv_offset=kv_offset, seg_q=seg_q, seg_kv=seg_kv)
    p = torch.where(lse > NEG_INF / 2, torch.exp(s - lse), 0.0)
    dof = do.float()
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ v.float().transpose(-1, -2) - delta)
    dq = scale * (ds @ kf)
    dk = ds.transpose(-1, -2) @ qf  # qf carries the scale
    return dq, dk, dv


def _slab_fwd(backend: str, q, k, v, *, seg_q=None, seg_kv=None, **kw):
    if backend == "flash":
        return fa._fwd(q, k, v, segments_q=seg_q, segments_kv=seg_kv, **kw)
    return _slab_fwd_exact(q, k, v, seg_q=seg_q, seg_kv=seg_kv, **kw)


def _slab_bwd(backend: str, q, k, v, do, lse, delta, *, seg_q=None, seg_kv=None, **kw):
    if backend == "flash":
        return fa._bwd(q, k, v, delta, lse, do, segments_q=seg_q, segments_kv=seg_kv, **kw)
    return _slab_bwd_exact(q, k, v, do, lse, delta, seg_q=seg_q, seg_kv=seg_kv, **kw)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------

def _present(*tensors) -> list[torch.Tensor]:
    return [t for t in tensors if t is not None]


def _ring_fwd_impl(q, k, v, seg, causal, scale, group, backend):
    """(out in q's dtype, lse fp32). `seg`: this process's [b, s_local]
    segment ids or None; the kv copy rotates with its k / v slabs, so the
    cross-segment test always pairs positions of the slab visiting; the q
    copy stays home. The last rotation, which would only bring k / v home,
    is skipped."""
    rank, n = distributed.group_place(group)
    s_local = q.shape[2]
    q_off = rank * s_local if causal else 0
    b, h, sq, hd = q.shape
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    w = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    z = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    k_t, v_t, seg_t = k, v, seg
    for t in range(n):
        src = (rank - t) % n
        o_t, lse_t = _slab_fwd(backend, q, k_t, v_t, causal=causal, scale=scale,
                               q_offset=q_off, kv_offset=src * s_local if causal else 0,
                               seg_q=seg, seg_kv=seg_t)
        m_new = torch.maximum(m, lse_t)
        # a slab no score of the row survives has lse_t == NEG_INF: weight 0
        alpha = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 0.0)
        beta = torch.where(lse_t > NEG_INF / 2, torch.exp(lse_t - m_new), 0.0)
        w = w * alpha + o_t.float() * beta
        z = z * alpha + beta
        m = m_new
        if t < n - 1:
            moved = distributed.ring_shift(_present(k_t, v_t, seg_t), group)
            k_t, v_t = moved[0], moved[1]
            seg_t = moved[2] if seg is not None else None
    safe_z = torch.where(z > 0.0, z, 1.0)
    out = torch.where(z > 0.0, w / safe_z, 0.0).to(q.dtype)
    lse = torch.where(z > 0.0, m + torch.log(safe_z), NEG_INF)
    return out, lse


class _Ring(torch.autograd.Function):
    """Ring attention with the reference's ring-level VJP."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, scale, group, backend):
        out, lse = _ring_fwd_impl(q, k, v, seg, causal, scale, group, backend)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.args = (causal, scale, group, backend)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        causal, scale, group, backend = ctx.args
        rank, n = distributed.group_place(group)
        s_local = q.shape[2]
        q_off = rank * s_local if causal else 0
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_t = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv_t = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_t, v_t, seg_t = k, v, seg
        for t in range(n):
            src = (rank - t) % n
            dq_b, dk_b, dv_b = _slab_bwd(
                backend, q, k_t, v_t, dout, lse, delta, causal=causal, scale=scale,
                q_offset=q_off, kv_offset=src * s_local if causal else 0, seg_q=seg,
                seg_kv=seg_t)
            dq += dq_b
            dk_t += dk_b
            dv_t += dv_b
            # dk / dv travel WITH their kv slab: after the n-th rotation every
            # slab's finished gradient is home (k / v themselves need not
            # make that last trip)
            if t < n - 1:
                moved = distributed.ring_shift(_present(k_t, v_t, dk_t, dv_t, seg_t), group)
                k_t, v_t, dk_t, dv_t = moved[:4]
                seg_t = moved[4] if seg is not None else None
            else:
                dk_t, dv_t = distributed.ring_shift([dk_t, dv_t], group)
        return dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype), None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   padding_mask: Any = None, *, causal: bool = True, group: Any = None,
                   backend: str = "exact") -> torch.Tensor:
    """Sequence-parallel exact attention over the slabs of `group` (the sp
    group; None: one slab).

    Takes / returns [b, s_local, h, hd] (the model's layout). `padding_mask`
    carries SEGMENT IDS for this process's slab ([b, s_local] int32, 0 =
    pad, packed examples numbered 1..k: the flash kernels' contract): when
    given, the kv segment slab rotates with its k / v so packed examples
    never attend across their boundaries. Plain right-padded causal batches
    pass None: causal masking already keeps pad keys from real queries. GQA
    callers expand the kv heads first (slabs rotate at one shape). The q and
    kv offsets of each slab come from the sp ranks."""
    if k.shape[2] != q.shape[2]:
        raise ValueError("ring_attention requires expanded kv heads (GQA: "
                         "repeat kv to q heads before the call)")
    if backend not in ("flash", "exact"):
        raise ValueError(f"unknown ring backend {backend!r} (flash | exact)")
    scale = q.shape[-1] ** -0.5
    seg = (None if padding_mask is None
           else torch.as_tensor(padding_mask, device=q.device).to(torch.int32).contiguous())
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = _Ring.apply(qt, kt, vt, seg, causal, scale, group, backend)
    return out.transpose(1, 2)
