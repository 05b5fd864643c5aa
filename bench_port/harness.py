"""One run of one cell: set-up, the first steps, the window, the comparison, the readers.

The system under test is `llama_pipeline_parallel_tpu_torch.train`: `build_run(cfg)`
builds the run from the cell's configuration and traffic; the benchmark copies
its seeded weights into `run.state.params`; then every step is
`run.step(next(run.batches()))` followed by a synchronisation, the calls
`train.train_run` makes a step (its meter, heartbeat and spans are left out;
no eval or save is configured).

Set-up drives that one run through its first `FIRST_STEPS` steps, which warm
every shape the window uses, and reads from its state the numbers the
comparison needs: each step's loss, each leaf's first gradient as the
optimizer holds it (AdamW's first moment after one step over 1 - beta1) and
each leaf's change over the steps (against the seeded weights drawn again).
The same run then goes into the window. Once the window has closed and the
program's state is freed, the reference trains the same seeded weights on
the same documents and the two are compared (compare.py).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from contextlib import nullcontext

import torch

from bench_port import cells, compare, counts, devtrace, generator, weights
from bench_port.reference import train as reference
from bench_port.tokenizer import WordTokenizer

FIRST_STEPS = 3
TRACE_MAX_STEPS = 4
BUILD_DIR = os.path.join(cells.BENCH_DIR, "build")
MODEL_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
              "rms_norm_eps", "rope_theta", "tie_word_embeddings")
TRAINER_KEYS = ("learning_rate", "warmup_proportion", "total_steps", "weight_decay",
                "adam_beta1", "adam_beta2", "adam_eps", "max_grad_norm", "loss_vocab_chunks",
                "attention", "kernels")


@dataclasses.dataclass
class Reading:
    """What the metric readers read (metrics/<name>.py)."""

    cell: cells.Cell
    setup_s: float
    window_s: float
    steps: int
    tokens: int                       # non-pad tokens of the window's steps
    peak_bytes: int                   # max_memory_allocated over the window
    data_wait_s: list[float]
    shapes: list[counts.StepShape]    # the window's steps (traced runs)
    pad_positions: int
    row_positions: int
    trace: devtrace.DeviceTrace | None = None


def port_config(cell: cells.Cell, seed: int) -> dict:
    """The port's config for this cell: the model as run, the trainer block,
    the traffic's layout, and the benchmark's dataset."""
    conf, traffic, trainer = cell.config, cell.traffic, cell.config["trainer"]
    cfg = {k: trainer[k] for k in TRAINER_KEYS}
    cfg.update({
        "output_dir": os.path.join(BUILD_DIR, "out"),
        "resume": False,
        "seed": generator.loader_seed(seed),
        "model": {**{k: conf[k] for k in MODEL_KEYS}, "dtype": trainer["compute_dtype"],
                  "param_dtype": "float32"},
        "dataset": {"_target_": "bench_port.generator.make_dataset", "traffic": traffic,
                    "seed": seed, "vocab_size": conf["vocab_size"]},
        "max_seq_length": traffic["seq_length"],
        "per_device_train_batch_size": traffic["rows_per_microbatch"],
        "gradient_accumulation_steps": traffic["microbatches"],
        "activation_checkpointing": traffic["activation_checkpointing"],
    })
    cfg.update(generator.kind(traffic).port_data(traffic))
    return cfg


def log(msg: str) -> None:
    print(f"bench_port: {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port's training run for a cell, fed and stepped as its trainer does."""

    def __init__(self, cell: cells.Cell, seed: int, device: torch.device):
        from llama_pipeline_parallel_tpu_torch.train import build_run

        self.cell, self.seed, self.device = cell, seed, device
        if device.type == "cuda":
            from llama_pipeline_parallel_tpu_torch.ops import kernel_build

            kernel_build.build(["flash_attention", "fused_ce", "fused_prologue"])
        tokenizer = WordTokenizer(cell.config["vocab_size"])
        t = time.monotonic()
        self.run = build_run(port_config(cell, seed), device, tokenizer=tokenizer)
        built = time.monotonic()
        self.dataset = self.run.loader.dataset
        params = self.run.state.params
        model = cell.config
        if set(params) != set(weights.leaf_shapes(model)):
            raise RuntimeError(f"the port's leaves {sorted(params)} are not the model's")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(weights.make_leaf(model, name, seed, device))
        _sync(device)
        log(f"build_run {built - t:.2f} s, seeded weights {time.monotonic() - built:.2f} s")
        if len(self.dataset.fetched) != generator.PROBES:
            raise RuntimeError(f"build_run read {len(self.dataset.fetched)} records, not "
                               f"{generator.PROBES}: the steps' records would be misplaced")
        self.batches = self.run.batches()

    def first_steps(self) -> reference.Numbers:
        """Steps 1..FIRST_STEPS, and the numbers the comparison reads."""
        opt, params = self.run.state.optimizer, self.run.state.params
        losses, grad1 = [], {}
        for t in range(FIRST_STEPS):
            metrics = self.run.step(next(self.batches))
            losses.append(metrics["loss"])
            if t == 0:
                grad1 = {n: _norm(opt.mu[n]) / (1.0 - opt.cfg.beta1) for n in params}
        with torch.no_grad():
            change = {n: _norm(p - weights.make_leaf(self.cell.config, n, self.seed, self.device))
                      for n, p in params.items()}
        _sync(self.device)
        return reference.Numbers([float(x) for x in losses], grad1, change)

    def close(self) -> None:
        self.batches.close()
        del self.run, self.batches
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def _wrap_optimizer(run) -> None:
    """In the traced run only: the optimizer's step inside a named range."""
    opt = run.state.optimizer
    inner = opt.step

    def step(*args, **kwargs):
        with torch.profiler.record_function(devtrace.OPTIMIZER_RANGE):
            return inner(*args, **kwargs)

    opt.step = step


def window(prog: Program, seconds: float, traced: bool) -> dict:
    """Steps until `seconds` have passed (traced: at most TRACE_MAX_STEPS);
    each step waits for the device. Returns the host-side record."""
    device = prog.device
    rf = torch.profiler.record_function if traced else (lambda name: nullcontext())
    waits, losses, tokens, kept = [], [], [], []
    _sync(device)
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        with rf("bench_port.data_wait"):
            batch = next(prog.batches)
        waits.append(time.perf_counter() - t)
        with rf("bench_port.step"):
            metrics = prog.run.step(batch)
        with rf("bench_port.sync"):
            _sync(device)
        losses.append(metrics["loss"])
        tokens.append((batch["attention_mask"] != 0).sum())
        if traced:
            kept.append((batch["attention_mask"], batch["labels"]))
        elapsed = time.perf_counter() - start
        if elapsed >= seconds or (traced and len(waits) >= TRACE_MAX_STEPS):
            break
    losses = torch.stack(losses).float().cpu()
    masks = [(m.cpu().numpy(), l.cpu().numpy()) for m, l in kept]
    return {"window_s": elapsed, "steps": len(waits), "waits": waits,
            "tokens": int(torch.stack(tokens).sum()),
            "failed": int((~torch.isfinite(losses)).sum()), "batches": masks}


def reference_numbers(cell: cells.Cell, seed: int, dataset, device: torch.device,
                      quant: str | None = None) -> reference.Numbers:
    """The reference's first steps on the documents the program was fed."""
    traffic = cell.traffic
    rows = generator.kind(traffic).reference_rows
    tokenizer = WordTokenizer(cell.config["vocab_size"])
    steps = [rows(dataset.step_records(t), traffic, tokenizer) for t in range(FIRST_STEPS)]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return reference.run(cell.config, cell.config["trainer"], seed, steps, device, quant)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, plant=None) -> dict:
    """Everything but the result line: `t0` is the process's start
    (time.monotonic). `plant(program)`, where given, breaks the program
    before its first step (the harness's own tests)."""
    prog = Program(cell, seed, device)
    if plant is not None:
        plant(prog)
    t = time.monotonic()
    numbers = prog.first_steps()
    log(f"first {FIRST_STEPS} steps and their numbers {time.monotonic() - t:.2f} s")
    if trace:
        _wrap_optimizer(prog.run)
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.monotonic() - t0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            rec = window(prog, seconds, traced=True)
    else:
        rec = window(prog, seconds, traced=False)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    dataset = prog.dataset
    prog.close()
    held = torch.cuda.memory_allocated(device) / 2**30 if device.type == "cuda" else 0.0
    log(f"setup {setup_s:.2f} s, window {rec['window_s']:.2f} s over {rec['steps']} steps, "
        f"peak {peak / 2**30:.3f} GiB; {held:.3f} GiB still allocated after the program")
    t = time.monotonic()
    dev_trace = devtrace.read(prof) if prof is not None else None
    del prof
    log(f"trace read in {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    ref = reference_numbers(cell, seed, dataset, device)
    found = compare.gaps(numbers, ref)
    log(f"reference {time.monotonic() - t:.2f} s; losses program {numbers.losses} "
        f"reference {ref.losses}; gaps {found}")
    for what in ("grad1", "change"):
        by_leaf = compare.leaf_gaps(getattr(numbers, what), getattr(ref, what), getattr(ref, what))
        log(f"{what} gap by leaf: " + ", ".join(f"{n} {g:.3g}" for n, g in by_leaf.items()))
    micro = cell.traffic["microbatches"]
    shapes = [counts.StepShape.of(m, l, micro) for m, l in rec["batches"]]
    reading = Reading(
        cell=cell, setup_s=setup_s, window_s=rec["window_s"], steps=rec["steps"],
        tokens=rec["tokens"], peak_bytes=peak, data_wait_s=rec["waits"], shapes=shapes,
        pad_positions=sum(int((m == 0).sum()) for m, _ in rec["batches"]),
        row_positions=sum(int(m.size) for m, _ in rec["batches"]), trace=dev_trace)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cells.reported(cell, kind):
        value = cells.reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"correct": compare.verdict(found, cell.limits), "found": found,
            "attempted": FIRST_STEPS + rec["steps"], "failed": rec["failed"],
            "metrics": metrics, "memory_peak_bytes": max(setup_peak, peak),
            "reading": reading, "numbers": (numbers, ref)}


def breakdown(trace: devtrace.DeviceTrace) -> dict:
    return {"device_ops": [[n, s] for n, s in trace.top_ops()],
            "idle_gaps": [[n, s] for n, s in trace.gaps]}
