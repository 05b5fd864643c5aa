"""RMSNorm with `transformers`' LlamaRMSNorm numerics: variance in fp32,
result cast back to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    variance = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(variance + eps)
    return (weight.float() * xf).to(x.dtype)
