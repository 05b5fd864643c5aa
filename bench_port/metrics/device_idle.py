"""device_idle: 1 - (union of the device events' intervals) / the traced window's
wall, in %."""


def read(r):
    if r.trace is None or not r.trace.kernels:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.window_s)
