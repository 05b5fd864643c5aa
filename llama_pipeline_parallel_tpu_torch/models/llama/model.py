"""LLaMA with stacked layer parameters, as plain functions on a parameter dict.

The counterpart of llama_pipeline_parallel_tpu/models/llama/model.py, with the
same parameter tree flattened to dotted names:

    embed.embedding          [V, d]
    layers.attn.wq / wo      [n, d, d]
    layers.attn.wk / wv      [n, d, kv_heads * hd]
    layers.mlp.gate / up     [n, d, f]
    layers.mlp.down          [n, f, d]
    layers.input_norm / post_norm  [n, d]
    norm                     [d]
    lm_head                  [d, V]

Weights keep the JAX `[in, out]` layout (x @ w), so carrying parameters
across (convert.py) is a copy. Layer leaves carry a leading `num_hidden_layers`
axis; `run_layers` walks it. Params are fp32 masters, cast to `cfg.dtype`
(bf16) where they are used; logits come out fp32.

`LlamaForCausalLM` is the nn.Module that owns such a dict: its
`state_dict()` keys are the dotted names above.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.ops.fused_prologue import fused_prologue
from llama_pipeline_parallel_tpu_torch.ops.rmsnorm import rms_norm
from llama_pipeline_parallel_tpu_torch.ops.rope import apply_rope, rope_cos_sin

Params = dict[str, torch.Tensor]
AttnFn = Callable[..., torch.Tensor]

IGNORE_INDEX = -100  # label value excluded from the loss


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def param_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    n, d, f, v = (cfg.num_hidden_layers, cfg.hidden_size,
                  cfg.intermediate_size, cfg.vocab_size)
    kv_dim = cfg.kv_heads * cfg.head_dim
    return {
        "embed.embedding": (v, d),
        "layers.attn.wq": (n, d, d),
        "layers.attn.wk": (n, d, kv_dim),
        "layers.attn.wv": (n, d, kv_dim),
        "layers.attn.wo": (n, d, d),
        "layers.mlp.gate": (n, d, f),
        "layers.mlp.up": (n, d, f),
        "layers.mlp.down": (n, f, d),
        "layers.input_norm": (n, d),
        "layers.post_norm": (n, d),
        "norm": (d,),
        "lm_head": (d, v),
    }


def init_params(cfg: LlamaConfig, *, device: str | torch.device = "cuda",
                generator: torch.Generator | None = None) -> Params:
    """Random init (normal 0.02, HF default; norms at one) in param_dtype."""
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("norm"):
            params[name] = torch.ones(shape, dtype=cfg.param_dtype, device=device)
        else:
            params[name] = (torch.randn(shape, generator=generator, device=device)
                            * 0.02).to(cfg.param_dtype)
    return params


class LlamaForCausalLM(nn.Module):
    """Owns a parameter dict as nn.Parameters; `forward` is `forward` below."""

    def __init__(self, cfg: LlamaConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        for name, tensor in params.items():
            *path, leaf = name.split(".")
            module = self
            for part in path:
                if part not in module._modules:
                    module.add_module(part, nn.Module())
                module = module._modules[part]
            module.register_parameter(leaf, nn.Parameter(tensor))

    def params(self) -> Params:
        return dict(self.named_parameters())

    def forward(self, input_ids, attention_mask=None, position_ids=None, *,
                attn_fn: AttnFn = attention, remat: bool = False,
                kernel_prologue: bool = False) -> torch.Tensor:
        return forward(self.params(), input_ids, attention_mask, position_ids,
                       cfg=self.cfg, attn_fn=attn_fn, remat=remat,
                       kernel_prologue=kernel_prologue)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def embed(params: Params, input_ids: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Token embedding (gather, then cast: the same values as casting first)."""
    return F.embedding(input_ids, params["embed.embedding"]).to(cfg.dtype)


def decoder_layer(
    layer: Params,
    x: torch.Tensor,
    padding_mask: torch.Tensor | None,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: LlamaConfig,
    attn_fn: AttnFn = attention,
    kernel_prologue: bool = False,
) -> torch.Tensor:
    """One transformer block; `layer` holds one layer's leaves under the
    names without the `layers.` prefix (`attn.wq`, ..., `post_norm`).

    `kernel_prologue` (config `kernels.prologue: pallas`) runs rms_norm ->
    q/k/v -> RoPE through the fused prologue kernels (ops/fused_prologue.py);
    otherwise the composed ops run."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = cfg.dtype
    if kernel_prologue:
        q, k, v = fused_prologue(x, layer["input_norm"], layer["attn.wq"].to(dt),
                                 layer["attn.wk"].to(dt), layer["attn.wv"].to(dt), cos, sin,
                                 eps=cfg.rms_norm_eps, head_dim=hd)
    else:
        hidden = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps)
        q = (hidden @ layer["attn.wq"].to(dt)).view(b, s, -1, hd)
        k = (hidden @ layer["attn.wk"].to(dt)).view(b, s, -1, hd)
        v = (hidden @ layer["attn.wv"].to(dt)).view(b, s, -1, hd)
        q, k = apply_rope(q, k, cos, sin)
    attn_out = attn_fn(q, k, v, padding_mask, causal=True)
    x = x + attn_out.reshape(b, s, -1) @ layer["attn.wo"].to(dt)
    return mlp_block(layer, x, cfg)


def mlp_block(layer: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Post-norm SwiGLU half of a decoder block."""
    dt = cfg.dtype
    hidden = rms_norm(x, layer["post_norm"], cfg.rms_norm_eps)
    gate = F.silu(hidden @ layer["mlp.gate"].to(dt))
    up = hidden @ layer["mlp.up"].to(dt)
    return x + (gate * up) @ layer["mlp.down"].to(dt)


def run_layers(
    layers: Params,
    x: torch.Tensor,
    padding_mask: torch.Tensor | None,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: LlamaConfig,
    attn_fn: AttnFn = attention,
    remat: bool = False,
    kernel_prologue: bool = False,
) -> torch.Tensor:
    """Apply a stack of layers (leading layer axis on every leaf; names
    without the `layers.` prefix). `remat=True` recomputes each layer in the
    backward (torch.utils.checkpoint) instead of keeping its activations.

    The leaves are unbound once, so the backward stacks each leaf's per-layer
    gradients in one allocation instead of one full-size gradient per layer."""
    per_layer = {name: leaf.unbind(0) for name, leaf in layers.items()}
    for i in range(len(next(iter(per_layer.values())))):
        layer = {name: leaves[i] for name, leaves in per_layer.items()}
        if remat:
            x = checkpoint(decoder_layer, layer, x, padding_mask, cos, sin, cfg,
                           attn_fn, kernel_prologue, use_reentrant=False)
        else:
            x = decoder_layer(layer, x, padding_mask, cos, sin, cfg, attn_fn, kernel_prologue)
    return x


def final_norm(params: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


def lm_head(params: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Logits projection; fp32 logits for a stable softmax-CE."""
    return (x @ params["lm_head"].to(cfg.dtype)).float()


def hidden_states(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    position_ids: torch.Tensor | None = None,
    *,
    cfg: LlamaConfig,
    attn_fn: AttnFn = attention,
    remat: bool = False,
    kernel_prologue: bool = False,
) -> torch.Tensor:
    """Single-device forward up to and including the final norm -> [b, s, d]
    in `cfg.dtype`: what the loss head takes.

    `attention_mask` is per-token [b, s] SEGMENT IDS (0 = pad; packed batches
    number each example 1..k), never a materialised [b, 1, L, L] tensor."""
    b, s = input_ids.shape
    if position_ids is None:
        position_ids = torch.arange(s, device=input_ids.device).expand(b, s)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, dtype=cfg.dtype)
    x = embed(params, input_ids, cfg)
    layers = {name[len("layers."):]: leaf for name, leaf in params.items()
              if name.startswith("layers.")}
    x = run_layers(layers, x, attention_mask, cos, sin, cfg, attn_fn, remat, kernel_prologue)
    return final_norm(params, x, cfg)


def forward(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    position_ids: torch.Tensor | None = None,
    *,
    cfg: LlamaConfig,
    attn_fn: AttnFn = attention,
    remat: bool = False,
    kernel_prologue: bool = False,
) -> torch.Tensor:
    """Single-device full forward -> fp32 logits [b, s, V] (`hidden_states`,
    then `lm_head`)."""
    x = hidden_states(params, input_ids, attention_mask, position_ids, cfg=cfg,
                      attn_fn=attn_fn, remat=remat, kernel_prologue=kernel_prologue)
    return lm_head(params, x, cfg)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def token_loss_sum_and_count_preshifted(
    logits: torch.Tensor, target_labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """CE where `target_labels[:, i]` is already the next-token target for
    `logits[:, i]` (positions with no target carry IGNORE_INDEX)."""
    loss_sum = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               target_labels.reshape(-1).long(),
                               ignore_index=IGNORE_INDEX, reduction="sum")
    return loss_sum, (target_labels != IGNORE_INDEX).sum()


def token_loss_sum_and_count(logits: torch.Tensor, labels: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shifted causal-LM cross-entropy: (sum of token losses, valid-token count)."""
    return token_loss_sum_and_count_preshifted(logits[:, :-1, :], labels[:, 1:])


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean shifted cross-entropy with IGNORE_INDEX masking."""
    loss_sum, count = token_loss_sum_and_count(logits, labels)
    return loss_sum / count.clamp(min=1)
