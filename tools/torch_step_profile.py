#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch/CUDA port goes, on the card.

    python tools/torch_step_profile.py [--config conf/llama_7b_pp4.yaml]
        [--pipeline] [--steps 3] [key=value ...]

Builds the run as `run_training` does (`build_run`; defaults: the single-card
LLaMA-7B-width slice, chip_smoke.TRAIN_OVERRIDES; with `--pipeline`, the
pipeline phase's chip_smoke.PIPE_OVERRIDES: the config's own mesh.pp, every
stage in this process, to which `pipeline_schedule=zb1 virtual_stages=2` and
the like apply), takes one warm-up step, then profiles
`--steps` steps with torch.profiler (CPU + CUDA activities). Prints, per step:
the wall time (host clock around synchronised steps), device busy time (sum
of kernel times; the port runs one stream) and idle share, peak device memory
(max_memory_allocated over the warm-up and profiled steps), device time by
kernel family (the port's prologue, CE head and flash kernels, cuBLAS GEMMs, other
PyTorch kernels, copies), the fifteen costliest kernels, each of the port's
hand-written kernels with its launches, and one JSON line with the same numbers.
`kernels.prologue=xla` (or `kernels.ce=xla loss_vocab_chunks=1`) as an override
profiles the step without those kernels.
Prints the card's name and power limit beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import PIPE_OVERRIDES, TRAIN_OVERRIDES  # noqa: E402  (defined once)

FAMILIES = (  # (family, substrings of kernel names), first match wins
    # before flash_attention, whose "fwd_kernel" and "fwd_tc_kernel" are also in
    # "prologue_fwd_kernel" and "prologue_fwd_tc_kernel"
    ("prologue", ("prologue_rstd_kernel", "prologue_fwd_kernel", "prologue_dhidden_kernel",
                  "prologue_dw_kernel", "prologue_unrope_kernel", "prologue_dhidden_tc_kernel",
                  "prologue_norm_kernel", "prologue_fwd_tc_kernel", "prologue_dw_tc_kernel")),
    ("ce_head", ("ce_stats_kernel", "ce_lse_kernel", "ce_grad_kernel", "ce_dh_kernel",
                 "ce_dw_kernel", "ce_stats_tc_kernel", "ce_grad_tc_kernel", "ce_dh_tc_kernel",
                 "ce_dw_tc_kernel")),
    ("flash_attention", ("fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel", "fwd_tc_kernel",
                         "bwd_dq_tc_kernel", "bwd_dkv_tc_kernel")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")),
    ("copy", ("Memcpy", "Memset", "copy_")),
)


PORT_FAMILIES = ("prologue", "ce_head", "flash_attention")  # the hand-written kernels


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other_pytorch"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=os.path.join(ROOT, "conf", "llama_7b_pp4.yaml"))
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--pipeline", action="store_true",
                   help="profile the pipeline phase's step (PIPE_OVERRIDES) instead of the slice")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from llama_pipeline_parallel_tpu_torch.train import build_run
    from llama_pipeline_parallel_tpu_torch.utils.config import load_config

    base = PIPE_OVERRIDES if args.pipeline else TRAIN_OVERRIDES
    run = build_run(load_config(args.config, base + [
        f"output_dir={os.path.join(ROOT, 'build', 'torch_step_profile')}"] + args.overrides),
        "cuda")
    batches = run.batches()

    def step():
        run.step(next(batches))
        torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    step()  # warm-up: kernel build / load, cuBLAS handles, allocator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        wall = (time.perf_counter() - t0) / args.steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    kernels, launches = {}, {}  # device-side events only: an op's own row would count its kernels twice
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + evt.self_device_time_total / 1e3 / args.steps
            launches[evt.key] = launches.get(evt.key, 0) + evt.count / args.steps
    if not kernels:
        print("torch_step_profile: the trace holds no device time", file=sys.stderr)
        return 1
    by_family = {}
    for name, ms in kernels.items():
        by_family[family(name)] = by_family.get(family(name), 0.0) + ms
    busy = sum(kernels.values())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    if run.pipeline is not None:
        pcfg = run.pipeline.pcfg
        print(f"pipeline: {pcfg.num_stages} stages in one process, schedule {pcfg.schedule}, "
              f"virtual_stages {pcfg.virtual_stages}, {pcfg.num_microbatches} microbatches")
    print(f"per step ({args.steps} steps profiled): wall {1e3 * wall:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {1 - busy / (1e3 * wall):.4f}, max_memory_allocated "
          f"{peak_gib:.2f} GiB")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:16s} {ms:9.3f} ms  ({ms / busy:.1%} of busy)")
    print("top kernels (ms per step):")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f}  {name[:110]}")
    print("the port's kernels (ms per step, launches per step, ms per launch):")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1]):
        if family(name) in PORT_FAMILIES:
            short = re.search(r"::(\w+)[<(]", name)
            print(f"  {ms:9.3f}  {launches[name]:5.0f}  {ms / launches[name]:8.4f}  "
                  f"{short.group(1) if short else name[:60]}")
    print(json.dumps({"card": card, "steps": args.steps, "wall_ms": 1e3 * wall,
                      "busy_ms": busy, "idle_share": 1 - busy / (1e3 * wall),
                      "peak_gib": peak_gib, "family_ms": by_family}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
