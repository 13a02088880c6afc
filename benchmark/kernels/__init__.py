"""The hand kernels' pricing: one module a kernel, found by listing this
package.  Each names the program's launch counter it prices (``COUNTER``:
a module with a ``LAUNCHES_BY_SHAPE`` counter), the substring of the
kernel's name in the profiler (``NAME``), which keys of the counter it
prices (``claims``) and the least seconds of a launch at a key
(``least_time_s``)."""

from __future__ import annotations

import importlib
import pkgutil


class UnpricedLaunch(RuntimeError):
    pass


def pricing_modules():
    return [importlib.import_module(f"{__name__}.{m.name}")
            for m in pkgutil.iter_modules(__path__) if not m.name.startswith("_")]


def roofline(launches: dict, device_ns: dict):
    """(least seconds, device seconds) of the hand-kernel launches of one
    prove.  ``launches``: counter module -> {key: launches}; ``device_ns``:
    profiler kernel name -> (launches, summed device ns).  A launch that no
    module prices, or a priced kernel whose launches the profiler does not
    show one for one, raises UnpricedLaunch."""
    modules = pricing_modules()
    least, counted = 0.0, {}
    for counter, keys in launches.items():
        for key, count in keys.items():
            owners = [m for m in modules if m.COUNTER == counter and m.claims(key)]
            if len(owners) != 1:
                raise UnpricedLaunch(f"{len(owners)} pricing modules claim {counter} {key}")
            least += count * owners[0].least_time_s(key)
            counted[owners[0]] = counted.get(owners[0], 0) + count
    device = 0
    for module, count in counted.items():
        seen = [(c, ns) for name, (c, ns) in device_ns.items() if module.NAME in name]
        if sum(c for c, _ in seen) != count:
            raise UnpricedLaunch(f"{module.__name__}: {count} launches counted, "
                                 f"{sum(c for c, _ in seen)} seen by the profiler")
        device += sum(ns for _, ns in seen)
    return least, device / 1e9
