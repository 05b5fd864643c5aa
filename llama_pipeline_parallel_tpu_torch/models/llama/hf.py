"""HF <-> this package's parameter names.

The counterpart of llama_pipeline_parallel_tpu/models/llama/hf.py over the
dotted names of models/llama/model.py. An HF `LlamaForCausalLM` state dict
keeps one tensor per layer, each projection as torch.nn.Linear stores it,
`[out, in]` (y = x @ W.T); here layer leaves are stacked `[num_layers, ...]`
and projections are `[in, out]` (y = x @ W). So every projection transposes
on the way in and out; norms do not. Leaves are widened to fp32.
tools/convert_hf.py and tools/export_hf.py wrap this with the file I/O.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig

# dotted layer leaf -> (HF name under model.layers.{i}., transposed)
_LAYER_LEAVES = {
    "layers.attn.wq": ("self_attn.q_proj.weight", True),
    "layers.attn.wk": ("self_attn.k_proj.weight", True),
    "layers.attn.wv": ("self_attn.v_proj.weight", True),
    "layers.attn.wo": ("self_attn.o_proj.weight", True),
    "layers.mlp.gate": ("mlp.gate_proj.weight", True),
    "layers.mlp.up": ("mlp.up_proj.weight", True),
    "layers.mlp.down": ("mlp.down_proj.weight", True),
    "layers.input_norm": ("input_layernorm.weight", False),
    "layers.post_norm": ("post_attention_layernorm.weight", False),
}


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32)


def params_from_hf_state_dict(sd: Mapping[str, torch.Tensor], cfg: LlamaConfig
                              ) -> dict[str, torch.Tensor]:
    """{dotted name: fp32 CPU tensor} from an HF LlamaForCausalLM state dict
    (any mapping of name -> tensor, read one tensor at a time)."""
    n = cfg.num_hidden_layers
    params = {"embed.embedding": _fp32(sd["model.embed_tokens.weight"]).clone()}
    for leaf, (suffix, transpose) in _LAYER_LEAVES.items():
        first = _fp32(sd[f"model.layers.0.{suffix}"])
        shape = first.T.shape if transpose else first.shape
        stacked = torch.empty((n, *shape), dtype=torch.float32)
        for i in range(n):
            w = first if i == 0 else _fp32(sd[f"model.layers.{i}.{suffix}"])
            stacked[i] = w.T if transpose else w
        params[leaf] = stacked
    params["norm"] = _fp32(sd["model.norm.weight"]).clone()
    if cfg.tie_word_embeddings:
        params["lm_head"] = params["embed.embedding"].T.contiguous()
    elif "lm_head.weight" not in sd:
        raise KeyError(
            "state_dict has no 'lm_head.weight' but tie_word_embeddings=False; "
            "refusing to silently tie (LLaMA must not tie)")
    else:
        params["lm_head"] = _fp32(sd["lm_head.weight"]).T.contiguous()
    return params


def hf_state_dict_from_params(params: Mapping[str, torch.Tensor], cfg: LlamaConfig
                              ) -> dict[str, torch.Tensor]:
    """The inverse: HF names -> fp32 CPU tensors, `lm_head.weight` always
    written (as the reference's exporter does)."""
    out = {"model.embed_tokens.weight": _fp32(params["embed.embedding"]).contiguous(),
           "model.norm.weight": _fp32(params["norm"]).contiguous(),
           "lm_head.weight": _fp32(params["lm_head"]).T.contiguous()}
    for leaf, (suffix, transpose) in _LAYER_LEAVES.items():
        stacked = _fp32(params[leaf])
        for i in range(cfg.num_hidden_layers):
            w = stacked[i]
            out[f"model.layers.{i}.{suffix}"] = (w.T if transpose else w).contiguous()
    return out
