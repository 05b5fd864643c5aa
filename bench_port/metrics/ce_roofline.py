"""ce_roofline: the least time of the traced steps' head product (counts.ce_least_s)
over the device time of the CE kernels, in %."""

from bench_port import counts


def read(r):
    if r.trace is None:
        return None
    spent = r.trace.seconds(lambda k: counts.family(k.name) == "ce_head")
    if not spent:
        return None
    return 100.0 * sum(counts.ce_least_s(r.cell.config, s) for s in r.shapes) / spent
