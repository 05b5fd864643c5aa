"""What the traced window's profiler saw, reduced in memory to what the readers need.

Device events are the kernels, copies and sets on the card (the profiler's
GPU user annotations are ranges, not work, and are left out). A device event
belongs to the optimizer when the host op that launched it (its linked
correlation id) started inside a `bench_port.optimizer` range, or, where the
trace has no such link, when it starts inside that range's annotation on the
device. Busy time is the union of the device events' intervals, so overlap
is counted once. An idle gap is named by the benchmark range and the
innermost host event that were running at its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

from torch.autograd import DeviceType

OPTIMIZER_RANGE = "bench_port.optimizer"
RANGE_PREFIX = "bench_port."
TOP = 10


@dataclasses.dataclass
class Kernel:
    name: str
    start_ns: int
    dur_ns: int
    optimizer: bool


@dataclasses.dataclass
class DeviceTrace:
    kernels: list[Kernel]
    busy_s: float
    gaps: list[tuple[str, float]]  # the longest idle gaps, named

    def seconds(self, keep) -> float:
        return sum(k.dur_ns for k in self.kernels if keep(k)) / 1e9

    def top_ops(self) -> list[tuple[str, float]]:
        by = {}
        for k in self.kernels:
            short = _short(k.name)
            by[short] = by.get(short, 0) + k.dur_ns
        return [(n, ns / 1e9) for n, ns in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def _short(name: str) -> str:
    name = re.sub(r"<.*>", "<>", name)
    return name[:96]


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _inside(t: int, ranges: list[tuple[int, int]]) -> bool:
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def read(prof) -> DeviceTrace:
    """Reduce a finished torch.profiler.profile to a DeviceTrace."""
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    launched = {e.correlation_id(): e.start_ns() for e in host}
    opt_host = sorted((e.start_ns(), e.end_ns()) for e in host if e.name() == OPTIMIZER_RANGE)
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    opt_dev = sorted((e.start_ns(), e.end_ns()) for e in device
                     if e.is_user_annotation() and e.name() == OPTIMIZER_RANGE)
    kernels = []
    for e in device:
        if e.is_user_annotation():
            continue
        at = launched.get(e.linked_correlation_id())
        in_opt = _inside(at, opt_host) if at is not None else _inside(e.start_ns(), opt_dev)
        kernels.append(Kernel(e.name(), e.start_ns(), e.duration_ns(), in_opt))
    busy = _union([(k.start_ns, k.start_ns + k.dur_ns) for k in kernels])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)
    named = [(_host_doing(host, (g0 + g1) // 2), (g1 - g0) / 1e9) for _, g0, g1 in gaps[:TOP]]
    return DeviceTrace(kernels, sum(b - a for a, b in busy) / 1e9, named)


def _host_doing(host, t: int) -> str:
    """`<benchmark range>/<innermost host event>` running at time t."""
    def length(e):
        return e.end_ns() - e.start_ns()

    around = [e for e in host if e.start_ns() <= t <= e.end_ns()]
    ours = min((e for e in around if e.name().startswith(RANGE_PREFIX)), key=length, default=None)
    inner = min(around, key=length, default=None)
    names = dict.fromkeys(e.name() for e in (ours, inner) if e is not None)
    return "/".join(names) or "no host event"
