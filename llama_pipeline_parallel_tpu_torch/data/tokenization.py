"""Tokenizer special-token normalization: a copy of
llama_pipeline_parallel_tpu/data/tokenization.py.

`expand_special_tokenizer` makes sure BOS/EOS/UNK/PAD exist on an HF-style
tokenizer, with the same environment-variable overrides (EOS_TOKEN /
BOS_TOKEN / UNK_TOKEN / PAD_TOKEN) and the pad -> eos fallback. It calls only
the tokenizer's own methods, so any object with the HF attributes will do.
"""

from __future__ import annotations

import os
from typing import Any

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_BOS_TOKEN = "<s>"
DEFAULT_EOS_TOKEN = "</s>"
DEFAULT_UNK_TOKEN = "<unk>"


def tokenizer_get_name(tokenizer: Any) -> str:
    """Lower-cased class name: the model-family switch."""
    return tokenizer.__class__.__name__.lower()


def is_seq2seq_tokenizer(tokenizer: Any) -> bool:
    """True for encoder-decoder tokenizers."""
    name = tokenizer_get_name(tokenizer)
    return any(k in name for k in ("t5", "bart", "mbart", "pegasus", "marian", "blenderbot"))


def expand_special_tokenizer(tokenizer: Any) -> int:
    """Ensure bos/eos/unk/pad exist; returns how many NEW tokens were added
    (the embeddings must grow by that many rows: tools/convert_hf.py)."""
    if is_seq2seq_tokenizer(tokenizer):
        raise ValueError(
            f"encoder-decoder tokenizer {tokenizer_get_name(tokenizer)!r}: "
            "this framework trains dense causal LLaMA-family models only")
    special: dict[str, str] = {}

    # fill in ONLY missing tokens: a tokenizer shipping its own specials must
    # keep them, or the pretrained weights' special-token ids stop matching
    if tokenizer.bos_token is None:
        special["bos_token"] = DEFAULT_BOS_TOKEN
    if tokenizer.eos_token is None:
        special["eos_token"] = DEFAULT_EOS_TOKEN
    if tokenizer.unk_token is None:
        special["unk_token"] = DEFAULT_UNK_TOKEN

    for env, key in (("BOS_TOKEN", "bos_token"), ("EOS_TOKEN", "eos_token"),
                     ("UNK_TOKEN", "unk_token"), ("PAD_TOKEN", "pad_token")):
        if os.environ.get(env):
            special[key] = os.environ[env]
            logger.info("special-token override from $%s: %s=%r", env, key, special[key])

    num_added = 0
    if special:
        num_added = tokenizer.add_special_tokens(special)

    if tokenizer.pad_token is None:
        # pad -> eos fallback: no new embedding row needed
        tokenizer.pad_token = tokenizer.eos_token
        logger.info("pad_token unset; falling back to eos_token %r", tokenizer.eos_token)
    return num_added
