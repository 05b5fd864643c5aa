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
across (convert.py) is a copy. Under tensor parallelism (`tp_group`) a layer
holds its tp rank's columns of q/k/v/gate/up and rows of wo/down
(parallel/tp.py), and its head counts come from those local widths. Layer leaves carry a leading `num_hidden_layers`
axis; `run_layers` walks it. Params are fp32 masters, cast to `cfg.dtype`
(bf16) where they are used; logits come out fp32.

`LlamaForCausalLM` is the nn.Module that owns such a dict: its
`state_dict()` keys are the dotted names above.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.ops.fused_prologue import fused_prologue
from llama_pipeline_parallel_tpu_torch.ops.rmsnorm import rms_norm
from llama_pipeline_parallel_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from llama_pipeline_parallel_tpu_torch.parallel.tp import tp_copy, tp_reduce

Params = dict[str, torch.Tensor]
AttnFn = Callable[..., torch.Tensor]

IGNORE_INDEX = -100  # label value excluded from the loss

# The JAX trainer's activation-checkpointing policies, by their jax.checkpoint
# names (aliases included).
REMAT_POLICIES = ("nothing_saveable", "everything_saveable", "dots_saveable", "checkpoint_dots",
                  "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims")
_aten = torch.ops.aten
# What each dot-saving policy keeps from a layer's forward: the outputs of the
# aten products. A projection `x @ W` reaches aten as `mm` (after a view); a
# product with batch dims (the exact attention's einsums) as `bmm`. A kernel's
# output is not a product, so the CUDA kernels run again in the backward.
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default)
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
_SAVED_PRODUCTS = {"dots_saveable": _DOTS, "checkpoint_dots": _DOTS,
                   "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
                   "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS}


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


def init_params(cfg: LlamaConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> Params:
    """The trainer's init of the whole tree, every leaf drawn by `init_leaf`
    (normal 0.02, HF default; norms at one) in param_dtype."""
    return {n: init_leaf(cfg, n, seed, device=device) for n in param_shapes(cfg)}


def init_leaf(cfg: LlamaConfig, name: str, seed: int, layers: range | None = None, *,
              device: str | torch.device = "cuda",
              cut: Callable[[torch.Tensor], torch.Tensor] | None = None) -> torch.Tensor:
    """One leaf of the trainer's init (normal 0.02; norms at one) in
    param_dtype: rows `layers` of a layer leaf (all of them by default) or
    the whole of another, each row (or the other leaf) drawn whole on
    `device` from a generator of its own, seeded by (seed, the leaf, the
    layer), and kept only as far as `cut` keeps it (a tp slice). Every
    layout of a run therefore draws the same canonical values: joined, the
    pieces are one process's init."""
    shape = param_shapes(cfg)[name]
    layer_leaf = name.startswith("layers.")
    rows = (layers if layers is not None else range(shape[0])) if layer_leaf else [None]
    leaf_id = sorted(param_shapes(cfg)).index(name)
    cut = cut or (lambda t: t)
    out = None
    for i, row in enumerate(rows):
        one = shape[1:] if layer_leaf else shape
        if name.endswith("norm"):
            t = torch.ones(one, dtype=torch.float32, device=device)
        else:
            key = np.random.SeedSequence([seed, leaf_id, 0 if row is None else row + 1])
            g = torch.Generator(device=device).manual_seed(int(key.generate_state(1)[0]))
            t = torch.randn(one, generator=g, device=device) * 0.02
        if not layer_leaf:
            return cut(t).to(cfg.param_dtype).clone()
        kept = cut(t[None])
        if out is None:  # filled row by row: no second copy of the leaf
            out = torch.empty((len(rows),) + tuple(kept.shape[1:]), dtype=cfg.param_dtype,
                              device=device)
        out[i] = kept[0]
    return out


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
                kernel_prologue: bool = False,
                remat_policy: str = "nothing_saveable") -> torch.Tensor:
        return forward(self.params(), input_ids, attention_mask, position_ids,
                       cfg=self.cfg, attn_fn=attn_fn, remat=remat,
                       kernel_prologue=kernel_prologue, remat_policy=remat_policy)


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
    tp_group=None,
) -> torch.Tensor:
    """One transformer block; `layer` holds one layer's leaves under the
    names without the `layers.` prefix (`attn.wq`, ..., `post_norm`).

    `kernel_prologue` (config `kernels.prologue: pallas`) runs rms_norm ->
    q/k/v -> RoPE through the fused prologue kernels (ops/fused_prologue.py);
    otherwise the composed ops run. `tp_group`: column-parallel q/k/v and
    row-parallel wo over that group, with tp_copy after the norm (inside the
    fused prologue's backward on the kernel path) and tp_reduce after wo,
    where the reference places them."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = cfg.dtype
    if kernel_prologue:
        q, k, v = fused_prologue(x, layer["input_norm"], layer["attn.wq"].to(dt),
                                 layer["attn.wk"].to(dt), layer["attn.wv"].to(dt), cos, sin,
                                 eps=cfg.rms_norm_eps, head_dim=hd, tp_group=tp_group)
    else:
        hidden = tp_copy(rms_norm(x, layer["input_norm"], cfg.rms_norm_eps), tp_group)
        q = (hidden @ layer["attn.wq"].to(dt)).view(b, s, -1, hd)
        k = (hidden @ layer["attn.wk"].to(dt)).view(b, s, -1, hd)
        v = (hidden @ layer["attn.wv"].to(dt)).view(b, s, -1, hd)
        q, k = apply_rope(q, k, cos, sin)
    attn_out = attn_fn(q, k, v, padding_mask, causal=True)
    x = x + tp_reduce(attn_out.reshape(b, s, -1) @ layer["attn.wo"].to(dt), tp_group)
    return mlp_block(layer, x, cfg, tp_group)


def mlp_block(layer: Params, x: torch.Tensor, cfg: LlamaConfig, tp_group=None) -> torch.Tensor:
    """Post-norm SwiGLU half of a decoder block (column-parallel gate / up,
    row-parallel down under `tp_group`)."""
    dt = cfg.dtype
    hidden = tp_copy(rms_norm(x, layer["post_norm"], cfg.rms_norm_eps), tp_group)
    gate = F.silu(hidden @ layer["mlp.gate"].to(dt))
    up = hidden @ layer["mlp.up"].to(dt)
    return x + tp_reduce((gate * up) @ layer["mlp.down"].to(dt), tp_group)


def remat_layer(fn: Callable, policy: str = "nothing_saveable") -> Callable:
    """`fn` recomputed in the backward under the JAX remat policy `policy`
    (reference: models/llama/model.py's `resolve_remat_policy`):
    `nothing_saveable` keeps nothing (torch.utils.checkpoint);
    `everything_saveable` keeps everything, which is `fn` itself; the dot
    policies keep the outputs of the aten products in _SAVED_PRODUCTS
    (selective checkpointing) and recompute the rest."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; choose one of {REMAT_POLICIES}")
    if policy == "everything_saveable":
        return fn
    kw = {}
    saved = _SAVED_PRODUCTS.get(policy)
    if saved is not None:
        def keep_products(ctx, op, *args, **kwargs):
            return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             keep_products)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


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
    remat_policy: str = "nothing_saveable",
    tp_group=None,
) -> torch.Tensor:
    """Apply a stack of layers (leading layer axis on every leaf; names
    without the `layers.` prefix). `remat=True` recomputes each layer in the
    backward under `remat_policy` (remat_layer) instead of keeping its
    activations.

    The leaves are unbound once, so the backward stacks each leaf's per-layer
    gradients in one allocation instead of one full-size gradient per layer."""
    layer_fn = remat_layer(decoder_layer, remat_policy) if remat else decoder_layer
    per_layer = {name: leaf.unbind(0) for name, leaf in layers.items()}
    for i in range(len(next(iter(per_layer.values())))):
        layer = {name: leaves[i] for name, leaves in per_layer.items()}
        x = layer_fn(layer, x, padding_mask, cos, sin, cfg, attn_fn, kernel_prologue, tp_group)
    return x


def final_norm(params: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


def lm_head(params: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Logits projection; fp32 logits for a stable softmax-CE."""
    return (x @ params["lm_head"].to(cfg.dtype)).float()


def rope_tables(input_ids: torch.Tensor, position_ids: torch.Tensor | None,
                cfg: LlamaConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE (cos, sin) [b, s, head_dim] in `cfg.dtype` at `position_ids`
    (default: 0..s-1 on every row)."""
    b, s = input_ids.shape
    if position_ids is None:
        position_ids = torch.arange(s, device=input_ids.device).expand(b, s)
    return rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, dtype=cfg.dtype)


def chunk_hidden(
    params: Params,
    x: torch.Tensor | None,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    cfg: LlamaConfig,
    first: bool,
    last: bool,
    attn_fn: AttnFn = attention,
    remat: bool = False,
    kernel_prologue: bool = False,
    remat_policy: str = "nothing_saveable",
    tp_group=None,
    act_tap: Callable[[torch.Tensor], None] | None = None,
) -> torch.Tensor:
    """The forward of one pipeline chunk (reference: the chunk body of
    parallel/pipeline.py's interpreter): the embedding of `input_ids` when
    `first` (the chunk that holds `embed.embedding`; `x` is then None), else
    the received hidden states `x`; then the chunk's `layers.*` leaves (a
    leading axis of its layers) through run_layers; then, when `last` (the
    chunk that holds `norm`), the final norm, giving what the loss head
    takes. The whole model is the one chunk that is both. `act_tap`, when
    given, sees the layers' output before the final norm (the numerics
    observatory's stage-boundary activation, utils/numerics.act_fold)."""
    if first:
        x = embed(params, input_ids, cfg)
    layers = {name[len("layers."):]: leaf for name, leaf in params.items()
              if name.startswith("layers.")}
    x = run_layers(layers, x, attention_mask, cos, sin, cfg, attn_fn, remat, kernel_prologue,
                   remat_policy, tp_group)
    if act_tap is not None:
        act_tap(x)
    return final_norm(params, x, cfg) if last else x


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
    remat_policy: str = "nothing_saveable",
    tp_group=None,
    act_tap: Callable[[torch.Tensor], None] | None = None,
) -> torch.Tensor:
    """Single-device forward up to and including the final norm -> [b, s, d]
    in `cfg.dtype`: what the loss head takes (`act_tap` as in chunk_hidden).

    `attention_mask` is per-token [b, s] SEGMENT IDS (0 = pad; packed batches
    number each example 1..k), never a materialised [b, 1, L, L] tensor."""
    cos, sin = rope_tables(input_ids, position_ids, cfg)
    return chunk_hidden(params, None, input_ids, attention_mask, cos, sin, cfg=cfg, first=True,
                        last=True, attn_fn=attn_fn, remat=remat,
                        kernel_prologue=kernel_prologue, remat_policy=remat_policy,
                        tp_group=tp_group, act_tap=act_tap)


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
    remat_policy: str = "nothing_saveable",
) -> torch.Tensor:
    """Single-device full forward -> fp32 logits [b, s, V] (`hidden_states`,
    then `lm_head`)."""
    x = hidden_states(params, input_ids, attention_mask, position_ids, cfg=cfg,
                      attn_fn=attn_fn, remat=remat, kernel_prologue=kernel_prologue,
                      remat_policy=remat_policy)
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
