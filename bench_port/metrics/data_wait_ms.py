"""data_wait_ms: host milliseconds a step spent in `next(run.batches())` (the
prefetch queue, collation not yet done, the copy to the card), over the traced steps."""


def read(r):
    return 1e3 * sum(r.data_wait_s) / r.steps
