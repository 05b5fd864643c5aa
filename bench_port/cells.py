"""Finding a cell's pieces by name: `BENCHMARK.json` at the checkout's root names the
cells and metrics; everything else sits in a file named after it.

- `configs/<config>.json` (the `file` of the config entry): the model's
  published keys as run, with `assumed`, `deployment` and the `trainer` block;
- `traffic/<traffic>.json`: the documents and the step's layout;
- `limits/<cell>.json`: each compared number's limit;
- `metrics/<metric>.py`: the reader of a metric, `read(reading) -> float | None`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    metrics: list[dict]  # every metric entry of BENCHMARK.json, end-to-end first


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def load(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
    w = work[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, config_name=config["name"],
        config=_load_json(os.path.join(root, config["file"])),
        traffic=_load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(BENCH_DIR, "limits", f"{name}.json")),
        chips=w["chips"],
        metrics=[dict(m, kind="end_to_end") for m in bench["end_to_end"]]
        + [dict(m, kind="per_layer") for m in bench["per_layer"]])


def reported(cell: Cell, kind: str) -> list[dict]:
    """The metrics of `kind` this cell reports: those that list it, or, with no
    list, per-layer metrics whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in cell.metrics
           if m["kind"] == "end_to_end" and cell.name in m.get("workloads", [cell.name])}
    out = []
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        if "workloads" in m:
            if cell.name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(metric: str):
    """The `read` function of `metrics/<metric>.py`."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
