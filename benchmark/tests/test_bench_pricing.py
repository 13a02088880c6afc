"""The frozen kernel pricing gives the bounds PERF.md records for the main
shapes, as chip_smoke.py's arithmetic computed them from the same SASS
counts: kernel 1 on the 2^20 x 12 chain 3.808 ms, kernel 4 on Lamport 1024
16.930 ms, kernel 5's f64 Rescue body 3.809 ms."""

import pytest

from benchmark.kernels import UnpricedLaunch, cons_eval, limb_tile, ntt_tile, roofline

# kernel 1's eight launches of one prove of the 2^20 x 12 chain
# (dif, B, n, lanes, epilogue, interleave, pre, transposed)
CHAIN_TILES = [
    (True, 12, 4096, 256, True, 1, False, True), (True, 12, 256, 4096, True, 1, False, False),
    (False, 12, 2048, 4096, True, 8, False, True), (False, 12, 4096, 2048, False, 1, False, False),
    (True, 1, 4096, 2048, True, 1, False, True), (True, 1, 2048, 4096, True, 1, False, False),
    (False, 7, 2048, 4096, True, 8, True, True), (False, 7, 4096, 2048, False, 1, False, False),
]


def test_kernel1_on_the_chain():
    assert sum(ntt_tile.least_time_s(k) for k in CHAIN_TILES) * 1e3 == pytest.approx(3.808, abs=5e-4)


# kernel 4's 22 launches of one Lamport 1024 prove, as the launch counter of
# ops/limb_ntt.py keys them (one-launch keys, but for the three alike)
LAMPORT_TILES = [(1, k) for k in [
    ("f128", True, 1, 14, 1024, 1024, 1024, (0, 1048576, 1024, 1), (0, 1048576, 1, 1024), None, False, False, False),
    ("f128", True, 1, 14, 1024, 1024, 1024, (0, 1048576, 1024, 1), (0, 1048576, 1024, 1), (1024, 1), False, False, False),
    ("f128", False, 8, 14, 1024, 1024, 1024, (0, 1048576, 1024, 1), (14680064, 1048576, 1, 1024), None, True, True, False),
    ("f128", False, 8, 14, 1024, 1024, 1024, (14680064, 1048576, 1024, 1), (1, 8388608, 8192, 8), (1024, 1), False, False, False),
    ("f128", True, 1, 1, 4096, 4096, 2048, (0, 0, 2048, 1), (0, 0, 1, 4096), None, False, False, False),
    ("f128", True, 1, 1, 2048, 2048, 4096, (0, 0, 4096, 1), (0, 0, 4096, 1), (4096, 1), False, False, False),
    ("f128", False, 1, 56, 1024, 1024, 1024, (0, 1048576, 1024, 1), (0, 1048576, 1, 1024), None, True, True, False),
    ("f128", False, 1, 56, 1024, 1024, 1024, (0, 1048576, 1024, 1), (0, 1048576, 1024, 1), (1024, 1), False, False, False),
    ("f128", False, 1, 8, 1024, 1024, 1024, (0, 1048576, 1024, 1), (0, 1048576, 1, 1024), None, True, True, False),
    ("f128", False, 1, 8, 1024, 1024, 1024, (0, 1048576, 1024, 1), (0, 1048576, 1024, 1), (1024, 1), False, False, False),
    ("f128", True, 1, 1, 128, 128, 1, (0, 0, 1, 0), (0, 0, 1, 0), None, False, False, True),
]] + [(3, ("f128", False, 8192, 1, 1024, 1024, 1, (0, 0, 1, 0), (1, 0, 8192, 0), None, True, False, False))] + [
    (1, ("f128", True, 1, 1, 4, 4, lanes, (0, 0, 1, 4), (0, 0, 1, 4), None, False, False, True))
    for lanes in (2097152, 524288, 131072, 32768, 8192, 2048, 512, 128)]


def test_kernel4_on_lamport_1024():
    assert sum(n for n, _ in LAMPORT_TILES) == 22
    total = sum(n * limb_tile.least_time_s(k) for n, k in LAMPORT_TILES)
    assert total * 1e3 == pytest.approx(16.930, abs=5e-4)


def test_kernel5_rescue_body():
    key = ("f64", "RescueChainAir", 1, 12, 1 << 23, 0, 1, 8)
    assert cons_eval.least_time_s(key) * 1e3 == pytest.approx(3.809, abs=5e-4)


def test_an_unpriced_launch_fails():
    with pytest.raises(UnpricedLaunch):
        roofline({"starkpack_winterfell_tpu_torch.ops.cons_kernel":
                  {("f64", "NoSuchAir", 1, 3, 64, 0, 1, 8): 1}}, {})


def test_launches_the_profiler_does_not_show_fail():
    with pytest.raises(UnpricedLaunch):
        roofline({"starkpack_winterfell_tpu_torch.ops.ntt4": {CHAIN_TILES[0]: 2}},
                 {"void ntt_tile_kernel<...>": (1, 1000)})
    least, device = roofline({"starkpack_winterfell_tpu_torch.ops.ntt4": {CHAIN_TILES[0]: 2}},
                             {"void ntt_tile_kernel<...>": (2, 4_000_000)})
    assert least == pytest.approx(2 * ntt_tile.least_time_s(CHAIN_TILES[0]))
    assert device == pytest.approx(4e-3)
