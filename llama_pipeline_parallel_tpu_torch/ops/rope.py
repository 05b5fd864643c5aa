"""Rotary position embeddings, HF-LLaMA `rotate_half` convention."""

from __future__ import annotations

import torch


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float = 10000.0,
                 dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions.

    position_ids: [batch, seq] int -> cos, sin: [batch, seq, head_dim] in `dtype`.
    """
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=position_ids.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = position_ids.float()[..., None] * inv_freq  # [b, s, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [b, s, hd]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: [b, s, n_heads, hd], k: [b, s, n_kv_heads, hd], cos/sin: [b, s, hd]."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    q_rot = q * cos + _rotate_half(q) * sin
    k_rot = k * cos + _rotate_half(k) * sin
    return q_rot.to(q.dtype), k_rot.to(k.dtype)
