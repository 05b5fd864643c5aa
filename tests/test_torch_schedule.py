"""The port's copy of the unit-sequence schedules (parallel/schedule.py)
against the JAX package's: the same sequences, byte for byte in `to_json`,
the same bubble counts, the same validator verdicts, and files written by
the reference load in the port. Everything here is numpy, so every check is
exact."""

import dataclasses
import importlib
import itertools

import numpy as np
import pytest

from llama_pipeline_parallel_tpu_torch.parallel import schedule as t_us


@pytest.fixture(scope="module")
def ref_us():
    """The reference's schedule module, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it
    (its package imports the host stash, which names it)."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    return importlib.import_module("llama_pipeline_parallel_tpu.parallel.schedule")


def _cases():
    """(schedule, m, s, v, stage_costs, offload_wgrad) over m < S, m = S and
    m > S at S = 2 and 4, v in {1, 2}, even and (3, 1) costs, offload on and
    off: every combination the generators accept (v > 1 needs m % S == 0 and
    an interleaved schedule; uneven costs need v = 1 and S = 2; offload only
    splits zb1's W queue)."""
    out = []
    for schedule, s, m, v, costs, off in itertools.product(
            ("1f1b", "interleaved_1f1b", "zb1"), (2, 4), (1, 2, 4, 8), (1, 2),
            (None, (3, 1)), (False, True)):
        if schedule == "1f1b" and v > 1:
            continue
        if v > 1 and m % s:
            continue
        if costs is not None and (s != 2 or v > 1):
            continue
        if off and schedule != "zb1":
            continue
        if m not in (s // 2, s, 2 * s) and not (s == 2 and m == 1):
            continue
        out.append((schedule, m, s, v, costs, off))
    return out


CASES = _cases()


def _id(case):
    schedule, m, s, v, costs, off = case
    return (f"{schedule}-m{m}-s{s}-v{v}" + (f"-costs{costs[0]}{costs[1]}" if costs else "")
            + ("-offload" if off else ""))


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_canonical_sequences_json_equal_reference(ref_us, case):
    """canonical_schedule's sequence serialises to the same JSON text in both
    packages, and both count the same bubble."""
    schedule, m, s, v, costs, off = case
    got = t_us.canonical_schedule(schedule, m, s, v, offload_wgrad=off, stage_costs=costs)
    want = ref_us.canonical_schedule(schedule, m, s, v, offload_wgrad=off, stage_costs=costs)
    assert t_us.to_json(got) == ref_us.to_json(want)
    assert t_us.bubble_stats(got) == ref_us.bubble_stats(want)
    t_us.validate(got)


@pytest.mark.parametrize("placement", ["trailing", "drain"])
def test_list_schedule_json_equal_reference(ref_us, placement):
    """The solver's list schedule (W placement trailing or interleaved with
    the drain, half the residuals offloaded) is the reference's."""
    off = np.array([True, False] * 4)
    got = t_us.list_schedule(4, 2, 2, w_placement=placement, offload_units=off)
    want = ref_us.list_schedule(4, 2, 2, w_placement=placement, offload_units=off)
    assert t_us.to_json(got) == ref_us.to_json(want)
    assert [dataclasses.astuple(x) for x in t_us.segments(got)] == \
           [dataclasses.astuple(x) for x in ref_us.segments(want)]
    assert t_us.segment_stats(got) == ref_us.segment_stats(want)


@pytest.mark.parametrize("schedule,s,m,v,idle,wall", [
    ("zb1", 8, 256, 2, 14, 1550),  # the 65B shape's pin (tests/test_interleaved.py)
    ("interleaved_1f1b", 8, 256, 2, 7, 519),
    ("1f1b", 4, 8, 1, 6, 14),
])
def test_bubble_stats_equal_reference_and_pins(ref_us, schedule, s, m, v, idle, wall):
    """bubble_stats of both packages agree and reduce to the reference's
    pinned fractions (idle / wall)."""
    got = t_us.bubble_stats(t_us.canonical_schedule(schedule, m, s, v))
    assert got == ref_us.bubble_stats(ref_us.canonical_schedule(schedule, m, s, v))
    assert got[0] * wall == got[1] * idle


def _corrupt(us, kind: str):
    """A canonical sequence broken one way (the reference validator's own
    negative cases), made with module `us`."""
    if kind == "w-before-b":
        seq = us.canonical_schedule("zb1", 4, 2, 1)
        w, has_w = seq.w_unit.copy(), seq.has_w.copy()
        w[w == 3] = -1
        w[2, :] = 3
        has_w[2] = True
        return dataclasses.replace(seq, w_unit=w, has_w=has_w)
    if kind == "ring-overflow":
        return dataclasses.replace(us.canonical_schedule("interleaved_1f1b", 8, 2, 2),
                                   ring_slots=2)
    if kind == "broken-transport":
        seq = us.canonical_schedule("1f1b", 4, 2)
        f = seq.f_unit.copy()
        f[[1, 2], :] = f[[2, 1], :]
        return dataclasses.replace(seq, f_unit=f)
    if kind == "incomplete-stream":
        seq = us.canonical_schedule("1f1b", 4, 2)
        b = seq.b_unit.copy()
        b[b == 2] = -1
        return dataclasses.replace(seq, b_unit=b)
    if kind == "unit-outside-flags":
        seq = us.canonical_schedule("interleaved_1f1b", 4, 2, 2)
        has_f = seq.has_f.copy()
        has_f[0] = False
        return dataclasses.replace(seq, has_f=has_f)
    if kind == "wq-slot-collision":
        seq = us.canonical_schedule("zb1", 4, 2, 1)
        return dataclasses.replace(seq, wq_slot=np.zeros_like(seq.wq_slot), wq_hbm_slots=1)
    raise AssertionError(kind)


CORRUPTIONS = ["w-before-b", "ring-overflow", "broken-transport", "incomplete-stream",
               "unit-outside-flags", "wq-slot-collision"]


@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_validate_rejects_what_the_reference_rejects(ref_us, kind):
    """Each corrupted sequence raises ScheduleError in both packages, with
    the same message."""
    with pytest.raises(ref_us.ScheduleError) as want:
        ref_us.validate(_corrupt(ref_us, kind))
    with pytest.raises(t_us.ScheduleError) as got:
        t_us.validate(_corrupt(t_us, kind))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("schedule,m,s,v,costs", [
    ("1f1b", 4, 2, 1, None), ("interleaved_1f1b", 4, 2, 2, None), ("zb1", 8, 4, 2, None),
    ("zb1", 4, 2, 1, (3, 1)),
])
def test_reference_file_loads_in_port(ref_us, tmp_path, schedule, m, s, v, costs):
    """A sequence the reference wrote with to_json loads in the port (load
    validates it) to the same grids, flags and slots, and writes back the
    same text."""
    want = ref_us.canonical_schedule(schedule, m, s, v, stage_costs=costs)
    path = tmp_path / "unit_schedule.json"
    path.write_text(ref_us.to_json(want))
    got = t_us.load(str(path))
    for field in ("f_unit", "b_unit", "w_unit", "has_f", "has_b", "has_w", "ring_fwd",
                  "ring_bwd", "offload_units", "wq_slot"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (got.ring_slots, got.stage_costs, got.label) == \
           (want.ring_slots, want.stage_costs, want.label)
    assert t_us.to_json(got) == path.read_text()
