"""Cells, configurations, traffic, limits and metric readers are found by name,
and BENCHMARK.json keeps to the benchmark's contract."""

import os
import re

import pytest

from bench_port import cells, compare

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 * 24 runs of run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1,200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["source"] == "device_trace"


def test_each_config_is_a_file_under_paths_and_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench_port/configs/")
        conf = cells._load_json(os.path.join(cells.ROOT, c["file"]))
        assert conf["source"] == c["source"]
        assert set(c["reduced"]) == set(conf["reduced"])
        assert all(not k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = cells.load(name)
    assert cell.chips == 1
    assert cell.limits and set(cell.limits) <= set(compare.NAMES)
    assert all(0 < v < 1 for v in cell.limits.values())
    for kind in ("end_to_end", "per_layer"):
        for m in cells.reported(cell, kind):
            assert callable(cells.reader(m["name"]))
    e2e = [m["name"] for m in cells.reported(cell, "end_to_end")]
    assert "setup_s" in e2e and "tokens_per_s" in e2e
    layer = [m["name"] for m in cells.reported(cell, "per_layer")]
    assert ("pad_share" in layer) == (cell.traffic.get("packing_factor", 1) > 1)
    assert "mfu" in layer


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load("no-such-cell")


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(len(BENCH["workloads"]) // 4, 1)

