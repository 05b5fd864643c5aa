"""The one traffic generator: a cell's traffic file (`traffic/<name>.json`) in, the
port's dataset and data settings and the reference's rows out.

`documents.kind` names the module `traffic/kinds/<kind>.py` that knows that
kind of document. It gives:

- `make_dataset(traffic, seed, vocab_size)`: the dataset the port's loader
  reads (a `Stream`);
- `port_data(traffic)`: the port's config keys that choose its collator
  (`packing_factor`, or a `collator` `_target_`);
- `reference_rows(records, traffic, tokenizer)`: the step's rows as the
  reference builds them again from the step's records (reference/packing.py);
- `SEGMENTED`: whether the port's attention reads segment ids.

A new kind of document is a new file there; the harness finds it by name.

The dataset logs the indices the port's loader reads, in order (`fetched`),
so the reference rebuilds each step from the same records without knowing
the loader's shuffle. `build_run` reads `PROBES` records itself (the row
length), before the loader starts; the harness holds it to that count, and
stream position 0 is the loader's first read.
"""

from __future__ import annotations

import importlib.util
import os
import threading

KINDS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic", "kinds")
PROBES = 1


class Stream:
    """A dataset that logs what its loader reads. `record(index, position)`
    makes a record; `position` counts the loader's reads (negative for
    `build_run`'s probes)."""

    def __init__(self, per_step: int):
        self.per_step = per_step
        self._lock = threading.Lock()
        self.fetched: list[int] = []

    def __getitem__(self, i: int) -> dict:
        with self._lock:
            k = len(self.fetched)
            self.fetched.append(int(i))
        return self.record(int(i), k - PROBES)

    def step_records(self, step: int) -> list:
        """The records of step `step` (0-based) as the loader read them."""
        first = PROBES + step * self.per_step
        with self._lock:
            ids = self.fetched[first:first + self.per_step]
        if len(ids) < self.per_step:
            raise RuntimeError(f"step {step}: the loader read {len(ids)} of "
                               f"{self.per_step} records")
        if len(set(ids)) < len(ids):
            raise RuntimeError(f"step {step}: the loader read a record twice: {ids}")
        return [self.record(i, step * self.per_step + j) for j, i in enumerate(ids)]

    def record(self, i: int, position: int) -> dict:
        raise NotImplementedError


def kind(traffic: dict):
    """The module of `traffic/kinds/<documents.kind>.py`."""
    name = traffic["documents"]["kind"]
    path = os.path.join(KINDS_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"unknown documents kind {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"bench_port_kind_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_dataset(traffic: dict, seed: int, vocab_size: int) -> Stream:
    """The dataset a cell's traffic describes (the port's `dataset._target_`)."""
    return kind(traffic).make_dataset(traffic, seed, vocab_size)


def examples_per_step(traffic: dict) -> int:
    return (traffic["rows_per_microbatch"] * traffic["microbatches"]
            * traffic.get("packing_factor", 1))


def loader_seed(seed: int) -> int:
    """The port's config seed: its loader seeds numpy's RandomState with
    seed * 131071 + epoch, which must stay under 2**32."""
    return int(seed) % 32749
