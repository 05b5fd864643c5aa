"""Readings for the limits: the precision control and the planted faults, per seed.

    python3 bench_port/control.py --workload <cell> --seeds 11,12,13 [--faults half_batch]
                                  [--control 0]

For each seed: the port's run is built and driven through its first steps,
sound and then with each named fault planted (in runs of their own); the
fp32 reference follows the same documents; and the control, the reference
computed with fp8 products (reference/model.py), is put in the program's
place (`--control 0`: not). Prints one JSON line a reading: the seed, what
ran ("sound", the fault or "control") and its gaps (compare.py). Benchmark runs never run this; it sets the limits' upper
readings (PERF.md). `unchanged` needs no run: it reads 1 on grad1 and change.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

import torch  # noqa: E402

from bench_port import cells, compare, faults, harness  # noqa: E402
from bench_port.run import environment  # noqa: E402


def readings(cell, seed: int, fault_names: list[str], device, control: bool = True
             ) -> list[dict]:
    numbers, dataset = {}, None
    for name in [None, *fault_names]:
        prog = harness.Program(cell, seed, device)
        if name is not None:
            faults.FAULTS[name](prog)
        numbers[name or "sound"] = prog.first_steps()
        dataset = dataset or prog.dataset
        prog.close()
    t = time.monotonic()
    ref = harness.reference_numbers(cell, seed, dataset, device)
    ref_s = time.monotonic() - t
    out = [{"seed": seed, "what": what, "gaps": compare.gaps(n, ref)}
           for what, n in numbers.items()]
    out[0].update(reference_s=ref_s, losses={"program": numbers["sound"].losses,
                                             "reference": ref.losses})
    if control:
        t = time.monotonic()
        ctl = harness.reference_numbers(cell, seed, dataset, device, quant="fp8")
        out.append({"seed": seed, "what": "control", "gaps": compare.gaps(ctl, ref),
                    "control_s": time.monotonic() - t, "losses": ctl.losses})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    environment()
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    names = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(cell, seed, names, torch.device("cuda", 0),
                             bool(args.control)):
            print(json.dumps(dict(line, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
