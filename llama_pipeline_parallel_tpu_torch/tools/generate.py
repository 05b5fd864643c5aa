"""Generate text from a native checkpoint (KV-cache batched decoding).

The counterpart of the JAX package's tools/generate.py, over the port's
`models.llama.decode.generate`:

    python -m llama_pipeline_parallel_tpu_torch.tools.generate \\
        --checkpoint_dir /ckpts/run1 --prompt "Once upon a time" \\
        --prompt "def main():" --max_new_tokens 64 --temperature 0.8 \\
        --top_k 40 --top_p 0.95 [--device cpu]

Prompts are left-padded into one batch at a BUCKET length (--bucket_sizes,
the smallest bucket holding the longest prompt): left padding is invisible
to the model, so the bucket only costs prefill work, and a prompt served by
tools.serve at the same bucket gets the same tokens. The checkpoint's fp32
masters are read on the host; the work runs on `--device` (default cuda; a
missing card is refused) with one compute-dtype copy of the weights. A run
summary with tokens/s goes to stderr (stdout stays the decoded text).
"""

from __future__ import annotations

import argparse
import sys
import time

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def bucket_length(longest: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= the longest prompt; a prompt past the last bucket
    falls back to its own length."""
    for b in sorted(buckets):
        if b >= longest:
            return b
    return longest


def run(args: argparse.Namespace) -> list[str]:
    import torch
    from transformers import AutoTokenizer

    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import load_module_checkpoint
    from llama_pipeline_parallel_tpu_torch.data.tokenization import expand_special_tokenizer
    from llama_pipeline_parallel_tpu_torch.models.llama.decode import (
        GenerationConfig,
        compute_params,
        generate,
    )

    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu to "
                           "generate on the host")
    params, cfg, _, _ = load_module_checkpoint(args.checkpoint_dir, args.step, device="cpu")
    params = compute_params(params, cfg, device=device)

    tok_path = args.tokenizer_path or args.checkpoint_dir
    tokenizer = AutoTokenizer.from_pretrained(tok_path)
    added = expand_special_tokenizer(tokenizer)
    # This tool cannot resize the checkpoint's embeddings: an id at or past
    # the model vocab would be refused by generate (the reference clamps).
    if added > 0 or len(tokenizer) > cfg.vocab_size:
        raise ValueError(
            f"tokenizer has {len(tokenizer)} tokens ({added} just added) but "
            f"the checkpoint's vocab is {cfg.vocab_size}; re-convert with "
            f"tools.convert_hf (vocab expansion is its default) so the "
            f"embeddings match")

    tokenizer.padding_side = "left"
    if tokenizer.pad_token is None:  # max_length padding needs a pad token
        tokenizer.pad_token = tokenizer.eos_token or tokenizer.unk_token
    lengths = [len(ids) for ids in tokenizer(list(args.prompt))["input_ids"]]
    bucket_arg = getattr(args, "bucket_sizes", None)  # optional for callers
    buckets = (tuple(int(b) for b in bucket_arg.split(","))
               if bucket_arg else DEFAULT_BUCKETS)
    bucket = bucket_length(max(lengths), buckets)
    enc = tokenizer(list(args.prompt), return_tensors="np",
                    padding="max_length", max_length=bucket, truncation=False)
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=getattr(args, "top_p", 1.0),
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id or 0)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    out = generate(params, enc["input_ids"], enc["attention_mask"], cfg, gen,
                   generator=generator)
    tokens = out["tokens"].cpu().numpy()      # blocks on the result
    dt = time.perf_counter() - t0
    print(f"[generate] {len(lengths)} prompt(s) (longest {max(lengths)}) "
          f"padded to bucket {bucket} on {device}; {tokens.size} tokens in "
          f"{dt:.2f}s = {tokens.size / max(dt, 1e-9):.1f} tok/s",
          file=sys.stderr, flush=True)

    texts = []
    for row in tokens:
        ids = row.tolist()
        if gen.eos_token_id is not None and gen.eos_token_id in ids:
            ids = ids[:ids.index(gen.eos_token_id)]  # truncate at FIRST eos
        texts.append(tokenizer.decode(ids, skip_special_tokens=True))
    return texts


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="where generation runs (default cuda; 'cpu' on the host)")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--tokenizer_path", default=None,
                   help="defaults to checkpoint_dir (tools.convert_hf places "
                        "tokenizer files there)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--prompt", action="append", required=True,
                   help="repeatable; prompts batch together")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0,
                   help="nucleus sampling mass (1.0 disables)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bucket_sizes", default=None,
                   help="comma-separated ascending prompt pad buckets "
                        f"(default {','.join(map(str, DEFAULT_BUCKETS))})")
    args = p.parse_args(argv)
    for prompt, text in zip(args.prompt, run(args)):
        print(f"=== {prompt!r}\n{text}\n")


if __name__ == "__main__":
    main()
