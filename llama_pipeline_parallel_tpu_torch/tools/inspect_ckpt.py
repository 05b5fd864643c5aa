"""Inspect a checkpoint directory: steps, completeness, manifest, layout.

    python -m llama_pipeline_parallel_tpu_torch.tools.inspect_ckpt <output_dir> \
        [--step N] [--verify] [--sizes]

The counterpart of the JAX package's tools/inspect_ckpt.py over this
package's checkpoints: what can be resumed, written at which topology, with
which optimizer state, without loading any tensor.

`--verify` recomputes every file's sha256 against the digests the commit
recorded in meta.json and reports per-file status: OK, MISMATCH (bit rot /
torn write), missing-on-disk (recorded but gone), or missing-from-meta (on
disk but never recorded -- a stray or post-commit write). Exits nonzero when
anything is not OK. `--sizes` gives each file's bytes beside the parameter
count's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import (
    CheckpointManager,
    _file_digest,
    config_from_meta,
)
from llama_pipeline_parallel_tpu_torch.utils.metrics import param_count


def describe(root: str, step: int | None = None) -> dict:
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no such directory: {root}")
    mgr = CheckpointManager(root)
    steps = mgr.list_steps()
    out = {
        "root": os.path.abspath(root),
        "latest_tag": mgr.latest_tag_value(),
        "latest_complete_step": mgr.latest_step(),
        "steps": {
            s: ("complete" if mgr.is_complete(s)
                else "INCOMPLETE (no meta.json -- interrupted save, ignored by resume)")
            for s in steps
        },
    }
    inspect_step = step if step is not None else mgr.latest_step()
    if step is not None and step not in steps:
        raise ValueError(f"step {step} not found under {root}; "
                         f"available: {steps or 'none'}")
    if inspect_step is not None and not mgr.is_complete(inspect_step):
        out["checkpoint"] = {
            "step": inspect_step,
            "status": "INCOMPLETE -- no meta.json (interrupted save); "
                      "files may be partial, resume ignores this step",
        }
        return out
    if inspect_step is not None and inspect_step in steps:
        meta = mgr.load_meta(inspect_step)
        man = meta.get("manifest", {})
        topo = meta.get("topology") or {}
        out["checkpoint"] = {
            "step": meta.get("step"),
            "stage_partition": (man.get("layer_counts")
                                or topo.get("layer_counts")
                                or f"even: {man.get('num_layers')} layers / "
                                   f"{man.get('num_stages')} stages"),
            "model_config": meta.get("model_config"),
            "optimizer_state": ("none (module-only / converter output)"
                                if not meta.get("has_optimizer_state")
                                else f"host AdamW, {meta['opt_layout']} (opt_m, opt_v; step "
                                     f"count {meta.get('opt_step_count')})"
                                if meta.get("opt_layout")
                                else "AdamW (mu, nu, count)"),
            "format_version": meta.get("format_version"),
            "storage": meta.get("storage") or "none (a JAX package checkpoint: Orbax arrays)",
            "source_topology": meta.get("topology") or "none recorded",
            "data_state": meta.get("data_state")
                          or "none recorded (resume positions by step count)",
            "items_on_disk": sorted(os.listdir(mgr.step_dir(inspect_step))),
        }
    return out


def verify_digests(root: str, step: int) -> dict:
    """Per-file sha256 status for one checkpoint against its meta.json
    digests. Walks the step dir so files the commit never recorded
    (missing-from-meta) surface too; meta.json itself is excluded (the
    digests live inside it)."""
    mgr = CheckpointManager(root)
    if not mgr.is_complete(step):
        return {"step": step, "status": "INCOMPLETE",
                "detail": "no meta.json (interrupted save) -- nothing to verify against"}
    meta = mgr.load_meta(step)
    integrity = meta.get("integrity") or {}
    recorded: dict = integrity.get("files") or {}
    if not recorded:
        return {"step": step, "status": "NO_DIGESTS",
                "detail": "meta.json carries no integrity digests (LPT_CKPT_DIGESTS=0 at save)"}
    step_dir = mgr.step_dir(step)
    on_disk = set()
    for dirpath, _, files in os.walk(step_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), step_dir).replace(os.sep, "/")
            if rel != "meta.json":
                on_disk.add(rel)
    files: dict[str, str] = {}
    for rel, want in sorted(recorded.items()):
        if rel not in on_disk:
            files[rel] = "missing-on-disk"
        else:
            files[rel] = "OK" if _file_digest(os.path.join(step_dir, rel)) == want else "MISMATCH"
    for rel in sorted(on_disk - set(recorded)):
        files[rel] = "missing-from-meta"
    counts: dict[str, int] = {}
    for status in files.values():
        counts[status] = counts.get(status, 0) + 1
    return {"step": step, "algo": integrity.get("algo", "sha256"),
            "status": "OK" if set(counts) == {"OK"} else "FAILED",
            "counts": counts, "files": files}


def sizes(root: str, step: int) -> dict:
    """Each file's bytes next to what the parameter count says they should
    be: fp32 params, and two fp32 moments each when the optimizer state was
    saved."""
    gib = 1 << 30
    mgr = CheckpointManager(root)
    step_dir = mgr.step_dir(step)
    files = {name: os.path.getsize(os.path.join(step_dir, name))
             for name in sorted(os.listdir(step_dir))
             if os.path.isfile(os.path.join(step_dir, name))}
    out: dict = {"step": step, "total_gib": round(sum(files.values()) / gib, 3),
                 "files": {k: {"gib": round(v / gib, 3), "bytes": v} for k, v in files.items()}}
    meta = mgr.load_meta(step) if mgr.is_complete(step) else {}
    if not isinstance(meta.get("model_config"), dict):
        out["model"] = "unavailable -- no model_config (incomplete step); measured bytes only"
        return out
    try:
        n = param_count(config_from_meta(meta))
    except Exception as e:  # a foreign/garbage model_config must degrade
        out["model"] = f"unavailable -- model_config not loadable ({e})"
        return out
    out["model"] = {"param_count": n, "params_gib": round(n * 4 / gib, 3)}
    if meta.get("has_optimizer_state"):
        out["model"]["opt_state_gib"] = round(n * 2 * 4 / gib, 3)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root", help="checkpoint output_dir")
    p.add_argument("--step", type=int, default=None,
                   help="inspect a specific step (default: latest complete)")
    p.add_argument("--verify", action="store_true",
                   help="recompute per-file sha256 digests against meta.json "
                        "and report OK/MISMATCH/missing per file")
    p.add_argument("--sizes", action="store_true",
                   help="per-file bytes next to the parameter count's")
    args = p.parse_args(argv)
    out = describe(args.root, args.step)
    rc = 0
    step = args.step if args.step is not None else out.get("latest_complete_step")
    if args.sizes:
        out["sizes"] = (sizes(args.root, step) if step is not None else
                        {"status": "NO_CHECKPOINT", "detail": "no complete checkpoint to size"})
    if args.verify:
        if step is None:
            out["verify"] = {"status": "NO_CHECKPOINT",
                             "detail": "no complete checkpoint to verify"}
            rc = 1
        else:
            out["verify"] = verify_digests(args.root, step)
            rc = 0 if out["verify"]["status"] == "OK" else 1
    print(json.dumps(out, indent=2, default=str))
    return rc


if __name__ == "__main__":
    sys.exit(main())
