"""peak_mem_gib: torch.cuda.max_memory_allocated over the window's steps (reset
after set-up), in GiB."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
