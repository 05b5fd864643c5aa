"""The comparison that decides `correct`: the reference follows the port, sound
runs pass the cells' limits, and planted faults and the precision control fail
them. Tiny stand-ins on the CPU (the port's plain twins, fp32: the limits were
set at the cells' own widths in bf16, where rounding reads differently); the
`cuda` test repeats the control and a fault at a cell's own size on the card."""

import time

import pytest
import torch

from bench_port import cells, compare, control, faults, harness
from tiny import tiny_cell

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
SEED = 2**31 + 101


def _run(cell, plant=None, seed=SEED):
    torch.manual_seed(0)
    return harness.run_cell(cell, seed, 0.2, False, torch.device("cpu"), time.monotonic(),
                            plant=plant)


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port_in_fp32(name):
    out = _run(tiny_cell(name, "float32"))
    found = out["found"]
    assert found["loss_gap"] < 1e-6 and found["grad1_gap"] < 1e-5
    assert found["change_gap"] < 1e-5
    prog, ref = out["numbers"]
    assert len(prog.losses) == harness.FIRST_STEPS and all(v > 0 for v in ref.change.values())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_passes_and_a_planted_fault_fails(name):
    sound = _run(tiny_cell(name))
    assert sound["correct"], sound["found"]
    assert sound["failed"] == 0 and sound["attempted"] > harness.FIRST_STEPS
    for fault in sorted(faults.FAULTS):
        out = _run(tiny_cell(name), plant=faults.FAULTS[fault])
        assert not out["correct"], (fault, out["found"])


@pytest.mark.parametrize("name", CELLS)
def test_bf16_on_the_cpu_stays_near_the_reference(name):
    """The port's bf16 plain twins at tiny widths: a tenth of a fault's gap."""
    found = _run(tiny_cell(name, "bfloat16"))["found"]
    assert found["loss_gap"] < 1e-3 and found["grad1_gap"] < 1e-2
    assert found["change_gap"] < 1e-2


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_in_the_programs_place_fails(name):
    cell = tiny_cell(name, "float32")
    got = control.readings(cell, SEED, [], torch.device("cpu"))
    gaps = next(g["gaps"] for g in got if g["what"] == "control")
    assert not compare.verdict(gaps, cell.limits), gaps


def test_a_gap_that_is_not_finite_fails():
    limits = dict.fromkeys(compare.NAMES, 1.0)
    assert compare.verdict(dict.fromkeys(compare.NAMES, 0.5), limits)
    assert not compare.verdict(dict(dict.fromkeys(compare.NAMES, 0.5), loss_gap=float("nan")),
                               limits)


@pytest.mark.cuda
def test_the_control_and_half_batch_fail_at_the_cells_size(cuda_device):
    cell = cells.load("mistral7b-stage.full-4k")
    for reading in control.readings(cell, 2**31 + 11, ["half_batch"], cuda_device):
        assert not compare.verdict(reading["gaps"], cell.limits), reading


def test_a_build_run_that_reads_another_count_of_records_is_refused(monkeypatch):
    """The steps' records start after build_run's own reads: a count other than
    the one the generator expects would misplace every step's records."""
    from bench_port import generator

    monkeypatch.setattr(generator, "PROBES", generator.PROBES + 1)
    with pytest.raises(RuntimeError, match="build_run read 1 records"):
        harness.Program(tiny_cell("mistral7b-stage.sft-packed-4k"), SEED, torch.device("cpu"))
