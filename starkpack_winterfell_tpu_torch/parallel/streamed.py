"""Device-memory plan of the one-shot pipeline of parallel/full_pipeline.py.

Counterpart of starkpack_winterfell_tpu/parallel/streamed.py cut to the
budget check: ``oneshot_peak_estimate`` (:65), ``should_stream`` (:73),
``preflight_check`` (:84).  The coset-streamed kernels themselves are not
ported: a config that would need them raises NotImplementedError instead of
attempting a one-shot run that cannot fit.

The budget is the card's own: the free device memory ``torch.cuda.
mem_get_info`` reports when the prove starts.  The peak factor is the port's own too: peak
``torch.cuda.max_memory_allocated`` of a prove over the bytes of its main
LDE, measured by chip_smoke.py's limb proves (PERF.md has the runs).
"""

from __future__ import annotations

import torch

#: peak demand of the one-shot pipeline in units of main-LDE bytes: twice the
#: ratio chip_smoke.py measured on an NVIDIA H100 80GB HBM3 at the sizes where
#: the estimate matters (20.3 at 2^20 rows x 6 f128 columns, 20.3 at 4 x 2^14
#: x 6, 21.6 at 2^12 x 6; the eager f128 multiply keeps tens of temporaries of
#: its operands' size alive, so the ratio is far above the handful of tables
#: the pipeline holds).  Proves of a few MB read higher (29 and 57 at 2 x 512
#: x 2) because their fixed tables dominate; no budget is near them.
ONESHOT_PEAK_FACTOR = 40


def budget_bytes(device) -> int:
    """Bytes the one-shot path may demand on ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        # host runs (the tests): no card to protect
        return 1 << 62
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)


def oneshot_peak_estimate(n: int, w: int, length: int, blowup: int,
                          el_bytes: int) -> int:
    """Upper-bound estimate of the one-shot pipeline's peak device memory."""
    return ONESHOT_PEAK_FACTOR * n * w * length * blowup * el_bytes


def should_stream(n, w, length, blowup, el_bytes, device) -> bool:
    return oneshot_peak_estimate(n, w, length, blowup, el_bytes) > budget_bytes(device)


def preflight_check(n, w, length, blowup, el_bytes, device):
    """Fail fast, before anything is allocated, when the one-shot pipeline
    cannot fit the card.  ``w``: the main width plus each aux column once
    per extension component."""
    if should_stream(n, w, length, blowup, el_bytes, device):
        demand = oneshot_peak_estimate(n, w, length, blowup, el_bytes)
        raise NotImplementedError(
            f"config not ported yet (needs the coset-streamed pipeline, "
            f"ROADMAP queue 1(f)): n={n}, width={w}, trace length={length}, "
            f"blowup={blowup} projects ~{demand / 1e9:.1f} GB peak device "
            f"memory against a {budget_bytes(device) / 1e9:.1f} GB budget"
        )
