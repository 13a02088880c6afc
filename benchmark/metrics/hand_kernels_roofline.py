"""The hand kernels' share of their roofline in one steady prove: the sum
of each launch's least time (its shape from the program's launch counters,
priced by benchmark/kernels/) over the sum of their device times
(torch.profiler).  None where the prove launched no hand kernel."""

from ..kernels import roofline


def read(run):
    p = run.profile
    if not p or not p["launches"]:
        return None
    least, device = roofline(p["launches"], p["trace"].by_name())
    return 100.0 * least / device if device else None
