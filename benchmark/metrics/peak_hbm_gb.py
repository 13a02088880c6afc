"""Peak device memory over the window: torch.cuda.max_memory_allocated(),
reset at the window's start, in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
