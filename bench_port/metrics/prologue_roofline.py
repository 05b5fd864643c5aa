"""prologue_roofline: the least time of the traced steps' norm -> q | k | v -> RoPE
(counts.prologue_least_s) over the device time of the prologue kernels, in %."""

from bench_port import counts


def read(r):
    if r.trace is None:
        return None
    spent = r.trace.seconds(lambda k: counts.family(k.name) == "prologue")
    if not spent:
        return None
    return 100.0 * sum(counts.prologue_least_s(r.cell.config, s) for s in r.shapes) / spent
