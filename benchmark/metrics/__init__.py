"""The metric readers: one module a metric, named as the metric, each with
``read(run) -> float | None`` over a ``harness.Run``.  A reader that finds
nothing to read returns None, and the run leaves its metric out."""

from __future__ import annotations


def phase_mean_ms(run, names) -> float | None:
    """The mean over the window's proofs of the milliseconds the program
    recorded for the phases ``names``; None where no proof recorded one."""
    sums = [sum(ms for phase, ms in step.phases if phase in names) for step in run.done
            if any(phase in names for phase, _ in step.phases)]
    return sum(sums) / len(sums) if sums else None
