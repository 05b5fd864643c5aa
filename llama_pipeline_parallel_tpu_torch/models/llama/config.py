"""LLaMA model configuration.

The counterpart of llama_pipeline_parallel_tpu/models/llama/config.py: a typed
dataclass with presets for the model family the reference targets
(LLaMA-7B/13B/65B, Llama-2, CodeLlama-34B-16k), with `dtype` / `param_dtype`
as torch dtypes (bf16 compute, fp32 master weights).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None  # GQA; None -> MHA
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False  # LLaMA must NOT tie
    # compute dtype for activations; params are kept fp32 master and cast at entry
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    def __post_init__(self) -> None:
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be a multiple of "
                f"num_attention_heads ({self.num_attention_heads})")
        if self.num_key_value_heads is not None and self.num_key_value_heads < 1:
            raise ValueError(f"num_key_value_heads must be >= 1, got {self.num_key_value_heads}")
        if self.num_attention_heads % self.kv_heads:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        if self.num_key_value_heads is None:
            return self.num_attention_heads
        return self.num_key_value_heads

    # ---- presets -----------------------------------------------------------

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """4-layer toy model for tests."""
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, dtype=torch.float32,
        )
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama_13b(**kw) -> "LlamaConfig":
        base = dict(hidden_size=5120, intermediate_size=13824,
                    num_hidden_layers=40, num_attention_heads=40)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama_33b(**kw) -> "LlamaConfig":
        base = dict(hidden_size=6656, intermediate_size=17920,
                    num_hidden_layers=60, num_attention_heads=52)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def codellama_34b_16k(**kw) -> "LlamaConfig":
        base = dict(hidden_size=8192, intermediate_size=22016,
                    num_hidden_layers=48, num_attention_heads=64,
                    num_key_value_heads=8, max_position_embeddings=16384,
                    rope_theta=1000000.0)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama_65b(**kw) -> "LlamaConfig":
        base = dict(hidden_size=8192, intermediate_size=22016,
                    num_hidden_layers=80, num_attention_heads=64)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        """Llama-2 generation: 4k context (GQA only on the 70B size)."""
        base = dict(max_position_embeddings=4096)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        base = dict(hidden_size=5120, intermediate_size=13824,
                    num_hidden_layers=40, num_attention_heads=40,
                    max_position_embeddings=4096)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_70b(**kw) -> "LlamaConfig":
        """GQA flagship: 8 kv heads over 64 query heads."""
        base = dict(hidden_size=8192, intermediate_size=28672,
                    num_hidden_layers=80, num_attention_heads=64,
                    num_key_value_heads=8, max_position_embeddings=4096)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def from_hf_config(hf_config: Any, **kw) -> "LlamaConfig":
        """Build from an HF LLaMA config: the dict of a `config.json`, or an
        object with the same attributes (`transformers.LlamaConfig`)."""
        get = (hf_config.get if isinstance(hf_config, dict)
               else lambda key, default=None: getattr(hf_config, key, default))
        base = dict(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            num_key_value_heads=get("num_key_value_heads", None),
            max_position_embeddings=get("max_position_embeddings"),
            rms_norm_eps=get("rms_norm_eps"),
            rope_theta=get("rope_theta", 10000.0),
            tie_word_embeddings=get("tie_word_embeddings", False),
        )
        base.update(kw)
        return LlamaConfig(**base)
