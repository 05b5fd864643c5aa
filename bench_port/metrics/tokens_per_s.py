"""tokens_per_s: non-pad tokens of every step finished in the window over the
window's seconds (first step's start to the last step's synchronised end)."""


def read(r):
    return r.tokens / r.window_s
