"""HF LLaMA directory -> a module-only checkpoint of this package.

    python -m llama_pipeline_parallel_tpu_torch.tools.convert_hf \
        --model_name_or_path <hf-dir> --output_dir <dir> [--no_expand_vocab]

The counterpart of the JAX package's tools/convert_hf.py. It reads
`config.json` and the weights without `transformers` -- `model.safetensors`
(or the shards `model.safetensors.index.json` names) through ckpt/tensor_io.py,
else `pytorch_model.bin` (or the shards of `pytorch_model.bin.index.json`)
through `torch.load(weights_only=True, mmap=True)` -- and writes
`checkpoint-0` (fp32 params, the one-stage manifest, no optimizer state) with
a `latest` tag, then writes `config.json` and the tokenizer beside it. A run
warm-starts from it with `model_name_or_path: <dir>`.

Vocabulary expansion, as the JAX converter does it: the directory's tokenizer
is loaded through `transformers.AutoTokenizer` (imported only then) and given
its missing special tokens (data/tokenization.py); when that adds tokens,
`embed_tokens` and an untied `lm_head` are resized to the tokenizer's length
(`resize_vocab`) and the tokenizer is saved beside the checkpoint. A
directory without tokenizer files, or whose tokenizer does not load, skips
the expansion with a warning; `--no_expand_vocab` skips it and copies the
tokenizer files as they are.
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
from llama_pipeline_parallel_tpu_torch.data.tokenization import expand_special_tokenizer
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


def load_tokenizer(directory: str):
    """`transformers.AutoTokenizer` of `directory`, or None (with a warning)
    when none loads from its files."""
    from transformers import AutoTokenizer

    try:
        return AutoTokenizer.from_pretrained(directory)
    except Exception as e:  # files of another kind, or unreadable ones
        print(f"warning: no loadable tokenizer at {directory} ({e!r}); skipping vocab "
              f"expansion", file=sys.stderr)
        return None


def resize_vocab(sd: Mapping[str, torch.Tensor], new_num_tokens: int,
                 tie_word_embeddings: bool) -> dict[str, torch.Tensor]:
    """The HF state dict with `embed_tokens` (and an untied `lm_head`) cut or
    grown to `new_num_tokens` rows, in fp32: the rows kept as they are, each
    added row the mean of the old rows. transformers' resize_token_embeddings
    (what the JAX converter calls) draws each added row from a normal around
    that mean with 1e-9 of the rows' covariance, a spread of ~3e-5 of a
    column's standard deviation; here the mean itself, so the result is
    deterministic."""
    out = dict(sd)
    names = ["model.embed_tokens.weight"] + ([] if tie_word_embeddings else ["lm_head.weight"])
    for name in names:
        old = sd[name].float()
        keep = min(old.shape[0], new_num_tokens)
        added = new_num_tokens - keep
        out[name] = torch.cat([old[:keep], old.mean(dim=0).expand(added, -1)])
    return out


def convert(model_name_or_path: str, output_dir: str, expand_vocab: bool = True) -> str:
    """Convert; returns the checkpoint's path."""
    with open(os.path.join(model_name_or_path, "config.json")) as f:
        hf_config = json.load(f)
    files = tokenizer_files(model_name_or_path)
    if not files:
        print(f"warning: no tokenizer files at {model_name_or_path}; skipping vocab "
              f"expansion and tokenizer export", file=sys.stderr)
    tokenizer = load_tokenizer(model_name_or_path) if files and expand_vocab else None
    sd = hf_weights(model_name_or_path)
    resized = tokenizer is not None and expand_special_tokenizer(tokenizer) > 0
    if resized:
        cfg = LlamaConfig.from_hf_config(hf_config)
        sd = resize_vocab(sd, len(tokenizer), cfg.tie_word_embeddings)
        print(f"resized the vocabulary {hf_config['vocab_size']} -> {len(tokenizer)} for "
              f"the added special tokens", file=sys.stderr)
        hf_config["vocab_size"] = len(tokenizer)
    cfg = LlamaConfig.from_hf_config(hf_config)
    params = params_from_hf_state_dict(sd, cfg)
    # the canonical layout is pipeline-agnostic: save through the one-stage manifest
    manifest = StageManifest(num_layers=cfg.num_hidden_layers, num_stages=1)
    path = CheckpointManager(output_dir).save(step=0, params=params, manifest=manifest,
                                              cfg=cfg)
    if tokenizer is not None:
        tokenizer.save_pretrained(output_dir)
    else:
        for name in files:
            shutil.copy2(os.path.join(model_name_or_path, name), os.path.join(output_dir, name))
    if resized:
        with open(os.path.join(output_dir, "config.json"), "w") as f:
            json.dump(hf_config, f, indent=2)
    else:
        shutil.copy2(os.path.join(model_name_or_path, "config.json"),
                     os.path.join(output_dir, "config.json"))
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
