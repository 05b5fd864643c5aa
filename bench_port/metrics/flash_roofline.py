"""flash_roofline: the least time of the traced steps' attention (counts.flash_least_s)
over the device time of the flash kernels, in %."""

from bench_port import counts, generator


def read(r):
    if r.trace is None:
        return None
    spent = r.trace.seconds(lambda k: counts.family(k.name) == "flash_attention")
    if not spent:
        return None
    segmented = generator.kind(r.cell.traffic).SEGMENTED
    least = sum(counts.flash_least_s(r.cell.config, s, segmented) for s in r.shapes)
    return 100.0 * least / spent
