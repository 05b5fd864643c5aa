"""eager_ms: device milliseconds a step of every other PyTorch kernel (elementwise,
reductions, casts, copies: families `other_pytorch` and `copy`) outside the
optimizer's range."""

from bench_port import counts


def read(r):
    if r.trace is None or not r.trace.kernels:
        return None
    eager = ("other_pytorch", "copy")
    return 1e3 * r.trace.seconds(
        lambda k: not k.optimizer and counts.family(k.name) in eager) / r.steps
