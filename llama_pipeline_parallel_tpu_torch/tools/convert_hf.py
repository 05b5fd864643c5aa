"""HF LLaMA directory -> a module-only checkpoint of this package.

    python -m llama_pipeline_parallel_tpu_torch.tools.convert_hf \
        --model_name_or_path <hf-dir> --output_dir <dir> [--no_expand_vocab]

The counterpart of the JAX package's tools/convert_hf.py, without
`transformers`: reads `config.json` and the weights -- `model.safetensors`
(or the shards `model.safetensors.index.json` names) through ckpt/tensor_io.py,
else `pytorch_model.bin` (or the shards of `pytorch_model.bin.index.json`)
through `torch.load(weights_only=True, mmap=True)` -- and writes
`checkpoint-0` (fp32 params, the one-stage manifest, no optimizer state) with
a `latest` tag, then copies `config.json` and the tokenizer files beside it.
A run warm-starts from it with `model_name_or_path: <dir>`.

Vocabulary expansion (the special tokens the JAX converter adds through the
tokenizer) needs a tokenizer, which this package does not have yet: with
tokenizer files present it refuses unless `--no_expand_vocab` is given; a
weights-only directory converts as it is, as the JAX converter does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from collections.abc import Mapping

import torch

from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import CheckpointManager
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.hf import params_from_hf_state_dict
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest

BIN_FILE = "pytorch_model.bin"
BIN_INDEX = "pytorch_model.bin.index.json"


def tokenizer_files(directory: str) -> list[str]:
    """The tokenizer files of an HF directory (the names the JAX exporter
    carries along)."""
    return sorted(name for name in os.listdir(directory)
                  if os.path.isfile(os.path.join(directory, name))
                  and ("token" in name or name in ("special_tokens_map.json", "vocab.json",
                                                   "merges.txt", "spiece.model")))


def hf_weights(directory: str) -> Mapping[str, torch.Tensor]:
    """The HF state dict of `directory`, by name, read lazily where the
    format allows (safetensors shards, mmap'd .bin files)."""
    if (os.path.isfile(os.path.join(directory, tensor_io.INDEX_FILE))
            or os.path.isfile(os.path.join(directory, tensor_io.SINGLE_FILE))):
        return tensor_io.ShardedTensors(directory)
    index = os.path.join(directory, BIN_INDEX)
    if os.path.isfile(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    elif os.path.isfile(os.path.join(directory, BIN_FILE)):
        shards = [BIN_FILE]
    else:
        raise FileNotFoundError(f"no {tensor_io.SINGLE_FILE}, {tensor_io.INDEX_FILE}, "
                                f"{BIN_FILE} or {BIN_INDEX} under {directory}")
    sd: dict[str, torch.Tensor] = {}
    for shard in shards:
        sd.update(torch.load(os.path.join(directory, shard), map_location="cpu",
                             weights_only=True, mmap=True))
    return sd


def convert(model_name_or_path: str, output_dir: str, expand_vocab: bool = True) -> str:
    """Convert; returns the checkpoint's path."""
    with open(os.path.join(model_name_or_path, "config.json")) as f:
        hf_config = json.load(f)
    tokenizer = tokenizer_files(model_name_or_path)
    if tokenizer and expand_vocab:
        raise NotImplementedError(
            f"{model_name_or_path} holds tokenizer files {tokenizer}: expanding the "
            f"vocabulary for the special tokens needs a tokenizer, which this package does "
            f"not have yet; pass --no_expand_vocab (expand_vocab=False) to convert the "
            f"weights as they are")
    if not tokenizer:
        print(f"warning: no tokenizer files at {model_name_or_path}; skipping vocab "
              f"expansion and tokenizer export", file=sys.stderr)
    cfg = LlamaConfig.from_hf_config(hf_config)
    params = params_from_hf_state_dict(hf_weights(model_name_or_path), cfg)
    # the canonical layout is pipeline-agnostic: save through the one-stage manifest
    manifest = StageManifest(num_layers=cfg.num_hidden_layers, num_stages=1)
    path = CheckpointManager(output_dir).save(step=0, params=params, manifest=manifest,
                                              cfg=cfg)
    for name in tokenizer + ["config.json"]:
        shutil.copy2(os.path.join(model_name_or_path, name), os.path.join(output_dir, name))
    print(f"wrote module-only checkpoint to {path}")
    return path


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--no_expand_vocab", action="store_true",
                   help="skip special-token vocab expansion")
    args = p.parse_args(argv)
    convert(args.model_name_or_path, args.output_dir, expand_vocab=not args.no_expand_vocab)
    return 0


if __name__ == "__main__":
    sys.exit(main())
