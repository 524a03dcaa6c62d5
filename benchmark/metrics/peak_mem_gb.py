"""torch.cuda.max_memory_allocated() over the window (reset at its
start), GB."""


def read(r):
    return r.peak_bytes / 1e9 if r.peak_bytes else None
