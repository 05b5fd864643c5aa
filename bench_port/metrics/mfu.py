"""mfu: the traced steps' model FLOPs (6 N_mm a non-pad token plus causal
attention inside each document: counts.model_flops) over their wall seconds,
as a share of one H100's dense bf16 peak, in %."""

from bench_port import counts


def read(r):
    if r.trace is None or not r.trace.kernels:
        return None
    flops = sum(counts.model_flops(r.cell.config, s) for s in r.shapes)
    return 100.0 * flops / (r.window_s * counts.PEAK_FLOPS)
