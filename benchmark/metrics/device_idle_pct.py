"""The share of a steady prove's wall in which no operation ran on the
device: 100 (1 - busy / wall).  Busy is the union of the kernels and copies
of the one prove traced under torch.profiler (CUDA activity); the wall is
the mean wall of the window's untraced proves, since the profiler's own
host work stretches the traced prove's wall and is no idle time of a
prove."""


def read(run):
    p = run.profile
    walls = [s.prove_s for s in run.done]
    if not p or not walls:
        return None
    return 100.0 * (1.0 - p["trace"].busy_ns() / 1e9 / (sum(walls) / len(walls)))
