"""optimizer_ms: device milliseconds a step of the kernels launched inside the
`bench_port.optimizer` range around the optimizer's step (clip and AdamW)."""


def read(r):
    if r.trace is None or not any(k.optimizer for k in r.trace.kernels):
        return None
    return 1e3 * r.trace.seconds(lambda k: k.optimizer) / r.steps
