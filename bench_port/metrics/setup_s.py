"""setup_s: process start to the first timed step: build, weights, the first
steps (which warm every shape and, in a checkout's first run, build the kernels)."""


def read(r):
    return r.setup_s
