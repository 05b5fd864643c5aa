"""gemm_ms: device milliseconds a step of the cuBLAS GEMM kernels (family `gemm`)."""

from bench_port import counts


def read(r):
    if r.trace is None or not r.trace.kernels:
        return None
    return 1e3 * r.trace.seconds(lambda k: counts.family(k.name) == "gemm") / r.steps
