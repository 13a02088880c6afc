"""PyTorch port, the Jive hashers RpJive64_256 and GriffinJive64_256 (f64,
width 8): the permutations (plain tensor code of ops/rescue_sponge.py and
the host C of native/rescue_perm.c and native/griffin_perm.c) against the
JAX package's python-int permutations and the Griffin golden vector; the
host byte API on the C sponges and the words API on tensors
(``rescue_sponge_plain``, the plain version of the CUDA sponge kernel) and
on numpy (the C sponges) against the JAX package's hashers on the same
seeded inputs; the plain proof-of-work search against the C search and the
JAX ``merge_with_int``.  Exact arithmetic: tolerance 0."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.crypto import griffin as jgriffin
from starkpack_winterfell_tpu.crypto import rescue_jive as jjive
from starkpack_winterfell_tpu.math import scalar as jfs

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.crypto.griffin import GriffinJive64_256
from starkpack_winterfell_tpu_torch.crypto.rescue_jive import RpJive64_256
from starkpack_winterfell_tpu_torch.ops import rescue_sponge as rsp

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P = jfs.P
# name -> (JAX module, JAX hasher, port hasher)
PAIRS = {"rp_jive64_256": (jjive, jjive.RpJive64_256, RpJive64_256),
         "griffin_jive64_256": (jgriffin, jgriffin.GriffinJive64_256, GriffinJive64_256)}
NAMES = list(PAIRS)
# JAX tests/test_rescue.py:149-157
GRIFFIN_OF_0_TO_7 = [
    5100889723013202324, 6905683344086677437, 8236358786066512460,
    1729367862961866374, 11501420603552582981, 15040992847148175954,
    10400407304634768298, 1197713229800045418,
]


def _words(vals):
    """(R, n) u64 elements -> (R, 2n) u32 words as int64."""
    return torch.from_numpy(np.stack([vals & np.uint64(0xFFFFFFFF), vals >> np.uint64(32)],
                                     axis=-1).reshape(vals.shape[0], -1).astype(np.int64))


def _states(rng, n):
    """(8, n) seeded states, 0 and p - 1 among their words."""
    s = rng.integers(0, P, size=(8, n), dtype=np.uint64)
    s[:, 0] = 0
    s[:, 1] = P - 1
    s[::2, 2] = 0
    s[1::2, 2] = P - 1
    return s


def _digest(H, rng):
    return H.hash_elements([int(v) for v in rng.integers(0, P, size=5, dtype=np.uint64)])


def test_registered_and_routed():
    from starkpack_winterfell_tpu_torch.prover.device import LIMB_HASHERS, PORTED_HASHERS

    assert T.get_hasher("rp_jive64_256") is RpJive64_256
    assert T.get_hasher("griffin_jive64_256") is GriffinJive64_256
    assert {"rp_jive64_256", "griffin_jive64_256"} <= set(PORTED_HASHERS)
    assert not {"rp_jive64_256", "griffin_jive64_256"} & set(LIMB_HASHERS)
    assert rsp.LAYOUTS["rp_jive64_256"] is RpJive64_256.LAYOUT
    assert rsp.LAYOUTS["griffin_jive64_256"] is GriffinJive64_256.LAYOUT


def test_griffin_golden_vector_in_plain_torch_and_in_c():
    s = torch.tensor([[v] for v in range(8)], dtype=torch.int64)
    plain = [int(v) & (2**64 - 1) for v in rsp.permute_plain(rsp.GRIFFIN64_256, s)[:, 0]]
    assert plain == GRIFFIN_OF_0_TO_7
    assert GriffinJive64_256.apply_permutation_ints(list(range(8))) == GRIFFIN_OF_0_TO_7
    assert jgriffin.apply_permutation_ints(list(range(8))) == GRIFFIN_OF_0_TO_7


@pytest.mark.parametrize("name", NAMES)
def test_permutations_match_jax(name):
    """The plain permutation on stacked states and the C permutation (one
    state, and a batch) against the JAX package's python-int one."""
    jmod, _, H = PAIRS[name]
    rng = np.random.default_rng(len(name))
    s = _states(rng, 6)
    want = [jmod.apply_permutation_ints([int(v) for v in s[:, k]]) for k in range(6)]
    got = rsp.permute_plain(H.LAYOUT, torch.from_numpy(s.astype(np.int64)))
    assert [[int(v) & (2**64 - 1) for v in got[:, k]] for k in range(6)] == want
    assert [H.apply_permutation_ints([int(v) for v in s[:, k]]) for k in range(6)] == want
    batch = np.ascontiguousarray(s.T)
    assert H._native()["sponge"].permute_rows(batch).tolist() == want


@pytest.mark.parametrize("name", NAMES)
def test_byte_api_matches_jax(name):
    _, J, H = PAIRS[name]
    rng = np.random.default_rng(21 + len(name))
    for n in (0, 1, 6, 7, 8, 27, 28, 29, 57):
        data = bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
        assert H.hash(data) == J.hash(data), n
    for k in range(10):
        elems = [int(v) for v in rng.integers(0, P, size=k, dtype=np.uint64)]
        assert H.hash_elements(elems) == J.hash_elements(elems), k
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, P, size=(3, 2), dtype=np.uint64)]
    assert H.hash_elements(pairs) == J.hash_elements(pairs)
    a, b = _digest(H, rng), _digest(H, rng)
    assert H.merge(a, b) == J.merge(a, b)
    pairs = [(_digest(H, rng), _digest(H, rng)) for _ in range(5)]
    assert H.merge_many(pairs) == [J.merge(x, y) for x, y in pairs]
    lists = [[1, 2, 3], [int(v) for v in rng.integers(0, P, size=9, dtype=np.uint64)]]
    assert H.hash_elements_many(lists) == [J.hash_elements(e) for e in lists]


@pytest.mark.parametrize("name", NAMES)
def test_merge_with_int_matches_jax_below_and_above_p(name):
    _, J, H = PAIRS[name]
    seed = _digest(H, np.random.default_rng(3))
    for value in (0, 1, 12345, (1 << 32) + 7, P - 1, P, P + 5, (1 << 64) - 1):
        assert H.merge_with_int(seed, value) == J.merge_with_int(seed, value), value


@pytest.mark.parametrize("name", NAMES)
def test_hash_words_on_tensors_and_numpy_match_jax(name):
    """Rows of 1 ... 9 elements (4 and 8 among them: no flag, no padding),
    0 and p - 1 among random ones: the plain sponge on tensors and the C
    sponge on numpy words against the JAX words API and byte API."""
    _, J, H = PAIRS[name]
    rng = np.random.default_rng(31 + len(name))
    for n in range(1, 10):
        vals = rng.integers(0, P, size=(3, n), dtype=np.uint64)
        vals[0, 0], vals[1, -1] = 0, P - 1
        words = _words(vals)
        got = H.hash_words(words, 8 * n)
        assert isinstance(got, torch.Tensor)
        want = np.asarray(J.hash_words(words.numpy().astype(np.uint32), 8 * n))
        assert np.array_equal(got.numpy(), want.astype(np.int64)), n
        assert np.array_equal(H.hash_words(words.numpy().astype(np.uint32), 8 * n), want), n
        assert [H.digest_to_bytes(got[r]) for r in range(3)] == \
            [J.hash_elements([int(v) for v in vals[r]]) for r in range(3)], n


@pytest.mark.parametrize("name", NAMES)
def test_merge_words_on_tensors_and_numpy_match_jax(name):
    """Merges of a Merkle level's pairs read through its row stride."""
    _, J, H = PAIRS[name]
    rng = np.random.default_rng(41 + len(name))
    digests = [_digest(H, rng) for _ in range(8)]
    cur = torch.from_numpy(np.stack([np.frombuffer(d, dtype="<u4") for d in digests])
                           .astype(np.int64))
    got = H.merge_words(cur[0::2], cur[1::2])
    want = [J.merge(digests[2 * k], digests[2 * k + 1]) for k in range(4)]
    assert [H.digest_to_bytes(got[k]) for k in range(4)] == want
    c = cur.numpy().astype(np.uint32)
    jw = np.asarray(J.merge_words(c[0::2], c[1::2]))
    assert np.array_equal(got.numpy(), jw.astype(np.int64))
    assert np.array_equal(H.merge_words(c[0::2], c[1::2]), jw)


@pytest.mark.parametrize("name", NAMES)
def test_merge_with_int_plain_matches_jax(name):
    """The plain search's digests: the seed at state[0..4), the nonce at
    state[4], state[7] = 5, the Jive sum, for nonces below p."""
    _, J, H = PAIRS[name]
    seed = _digest(H, np.random.default_rng(51 + len(name)))
    nonces = [1, 2, 77, (1 << 40) + 9, P - 1]
    got = rsp.merge_with_int_plain(H.LAYOUT, H.seed_elements(seed),
                                   torch.tensor([v - (1 << 64) if v >> 63 else v
                                                 for v in nonces], dtype=torch.int64))
    assert [H.digest_to_bytes(got[k]) for k in range(len(nonces))] == \
        [J.merge_with_int(seed, v) for v in nonces]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("bits", [4, 8])
def test_search_plain_finds_the_c_searchs_nonce(name, bits):
    """The plain search and the C search find the same lowest nonce over
    the same range, the one the JAX ``merge_with_int`` gives first; a range
    without one gives None from both."""
    _, J, H = PAIRS[name]
    rng = np.random.default_rng(61 + bits + len(name))
    seed = _digest(H, rng)
    count = 1 << (bits + 2)
    plain, _ = rsp.first_merge_with_int_plain(H.LAYOUT, H.seed_elements(seed), 1, count, bits)
    c = H.first_merge_with_int(seed, 1, count, bits, "cpu")
    assert plain is not None and plain == c
    mask = (1 << bits) - 1
    first = next(v for v in range(1, count + 1)
                 if int.from_bytes(J.merge_with_int(seed, v)[:8], "little") & mask == 0)
    assert c == first
    if first > 1:
        assert H.first_merge_with_int(seed, 1, first - 1, bits, "cpu") is None
        assert rsp.first_merge_with_int_plain(H.LAYOUT, H.seed_elements(seed), 1, first - 1,
                                              bits)[0] is None


def test_layout_geometry_multiplies_and_constants():
    """What the kernel and the bound read off the layouts: width 8, rate 4;
    Griffin's non-linear layer at 7 x (72 + 4 + 3 x 6) multiplies and
    RpJive's S-boxes at 7 x 8 x (4 + 72); both MDS tables the circulant of
    entries below 32; Griffin's last ARK row (no constants) zero in the
    kernel's table and its alpha and beta in the ARK2 room."""
    jive, gr = rsp.RPJIVE64_256, rsp.GRIFFIN64_256
    assert (jive.width, jive.rate, gr.width, gr.rate) == (8, 4, 8, 4)
    assert rsp.sbox_multiplies(gr) == 7 * (72 + 4 + 18)
    assert rsp.sbox_multiplies(jive) == 7 * 8 * 76
    assert rsp.sbox_multiplies(rsp.RP64_256) == 7 * 12 * 76
    assert rsp.permutations(jive, 10, 12) == 30 and rsp.permutations(gr, 10, 13) == 40
    assert rsp.permutations(gr, 10, 0) == 0 and rsp.permutations(gr, 10) == 10
    assert jive.mds == gr.mds and max(max(r) for r in gr.mds) < 32
    for layout in rsp.LAYOUTS.values():
        assert rsp.kernel_constants(layout).shape == (144 + 84 + 84,)
    t = rsp.kernel_constants(gr)
    assert list(t[:64]) == [v for row in gr.mds for v in row] and not t[64:144].any()
    assert not t[144 + 48: 144 + 84].any()
    assert list(t[228: 240]) == list(gr.ark2[0]) + list(gr.ark2[1]) and not t[240:].any()
    assert list(rsp.SLOTS) == ["rp64_256", "rp62_248", "rp_jive64_256", "griffin_jive64_256"]
