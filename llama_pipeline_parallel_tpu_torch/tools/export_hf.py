"""A checkpoint of this package -> an HF LlamaForCausalLM directory.

    python -m llama_pipeline_parallel_tpu_torch.tools.export_hf \
        --checkpoint_dir <dir> --output_dir <hf-dir> [--step N]

The counterpart of the JAX package's tools/export_hf.py, without
`transformers`: writes `config.json` (`architectures`, `model_type: llama` and
the model's fields) and an fp32 `model.safetensors` (ckpt/tensor_io.py), and
copies the tokenizer files that convert_hf placed beside the checkpoint. The
result loads with `transformers.LlamaForCausalLM.from_pretrained` and converts
back with either package's convert_hf.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch

from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import load_module_checkpoint
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.hf import hf_state_dict_from_params
from llama_pipeline_parallel_tpu_torch.tools.convert_hf import tokenizer_files


def hf_config(cfg: LlamaConfig) -> dict:
    """config.json of an HF LLaMA with `cfg`'s fields."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.kv_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "hidden_act": "silu", "torch_dtype": "float32"}


def export_params(params: dict[str, torch.Tensor], cfg: LlamaConfig, output_dir: str) -> int:
    """Write `params` (dotted names, on any device) as an HF directory;
    returns the bytes of model.safetensors."""
    os.makedirs(output_dir, exist_ok=True)
    nbytes = tensor_io.write_file(os.path.join(output_dir, tensor_io.SINGLE_FILE),
                                  hf_state_dict_from_params(params, cfg),
                                  metadata={"format": "pt"})
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=2)
    return nbytes


def export(checkpoint_dir: str, output_dir: str, step: int | None = None) -> None:
    params, cfg, _, step = load_module_checkpoint(checkpoint_dir, step, device="cpu")
    export_params(params, cfg, output_dir)
    # carry the tokenizer files along (convert_hf places them next to the
    # checkpoint so the round trip is self-contained)
    for name in tokenizer_files(checkpoint_dir):
        shutil.copy2(os.path.join(checkpoint_dir, name), os.path.join(output_dir, name))
    print(f"exported checkpoint-{step} to {output_dir}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    args = p.parse_args(argv)
    export(args.checkpoint_dir, args.output_dir, args.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
