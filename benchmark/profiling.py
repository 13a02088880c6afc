"""The device side of one traced prove: torch.profiler's CUDA activity,
read from its raw events (post-processing a whole prove through
``key_averages`` would take longer than the prove), and the program's
hand-kernel launch counters around it."""

from __future__ import annotations

import collections
import sys
import time

PROGRAM = "starkpack_winterfell_tpu_torch"


def launch_counters():
    """{module name: copy of its LAUNCHES_BY_SHAPE} of every loaded module
    of the program that counts launches."""
    return {name: dict(getattr(module, "LAUNCHES_BY_SHAPE"))
            for name, module in list(sys.modules.items())
            if name.startswith(PROGRAM + ".") and module is not None
            and hasattr(module, "LAUNCHES_BY_SHAPE")}


def launches_between(before: dict, after: dict) -> dict:
    out = {}
    for name, keys in after.items():
        diff = {k: c - before.get(name, {}).get(k, 0) for k, c in keys.items()}
        diff = {k: c for k, c in diff.items() if c}
        if diff:
            out[name] = diff
    return out


def _ns(event, what: str) -> int:
    """An event's start or duration in ns, across torch versions."""
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class DeviceTrace:
    """Device operations of one profiled interval: (name, start ns, end ns),
    in start order, on the clock of ``time.time_ns`` (kineto's)."""

    def __init__(self, events):
        self.ops = sorted(events, key=lambda e: e[1])

    @classmethod
    def from_profiler(cls, prof):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                start = _ns(e, "start")
                events.append((e.name(), start, start + _ns(e, "duration")))
        return cls(events)

    def kernels(self) -> int:
        return sum(not is_copy(name) for name, _, _ in self.ops)

    def busy_ns(self) -> int:
        """The union of the operations' intervals."""
        busy, end = 0, None
        for _, s, e in self.ops:
            if end is None or s >= end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def by_name(self) -> dict:
        """name -> (operations, summed ns)."""
        out = collections.defaultdict(lambda: [0, 0])
        for name, s, e in self.ops:
            out[name][0] += 1
            out[name][1] += e - s
        return {k: tuple(v) for k, v in out.items()}

    def gaps(self, t0: int, t1: int):
        """(start ns, ns) of each stretch of [t0, t1] in which no operation
        ran."""
        out, cursor = [], t0
        for _, s, e in self.ops:
            if s > cursor:
                out.append((cursor, s - cursor))
            cursor = max(cursor, e)
        if t1 > cursor:
            out.append((cursor, t1 - cursor))
        return out


def profile_prove(prove):
    """Runs ``prove()`` under torch.profiler (CUDA activity only) and
    returns (its result, DeviceTrace, launches by counter, start ns, end
    ns), the interval on ``time.time_ns``."""
    import torch

    before = launch_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time_ns()
        result = prove()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    launches = launches_between(before, launch_counters())
    return result, DeviceTrace.from_profiler(prof), launches, t0, t1

