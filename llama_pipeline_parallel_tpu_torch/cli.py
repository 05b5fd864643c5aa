"""Console entry point:
`python -m llama_pipeline_parallel_tpu_torch.cli --config conf/<name>.yaml
[--device cuda|cpu] [key=value ...]`.

Overrides accept both `key=value` and `--key=value`. The run is on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True, help="path to a YAML config")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to train (default: the card)")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    args, unknown = p.parse_known_args(argv)
    bad = [u for u in unknown if not (u.startswith("--") and "=" in u)]
    if bad:
        p.error(f"unrecognized arguments: {' '.join(bad)}")
    args.overrides += unknown

    from llama_pipeline_parallel_tpu_torch.train import run_training
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, args.overrides)
    summary = run_training(cfg, device=args.device)
    print(f"training done: {summary}")


if __name__ == "__main__":
    main()
