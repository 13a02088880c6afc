"""PyTorch port, the algebraic hashers Rp64_256 (f64) and Rp62_248 (f62):
the host byte API on the C sponge of native/rescue_perm.c and the words API
on tensors (``ops/rescue_sponge.py:rescue_sponge_plain``, the plain version
of the CUDA sponge kernel) against the JAX package's hashers on the same
seeded numpy inputs; the batched nonce search and the native round states
against their sequential definitions.  Exact arithmetic: tolerance 0."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.crypto.rescue import Rp64_256 as JRp64
from starkpack_winterfell_tpu.crypto.rescue62 import Rp62_248 as JRp62
from starkpack_winterfell_tpu.math import scalar as jfs

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.crypto import rescue as trescue
from starkpack_winterfell_tpu_torch.crypto.rescue import Rp64_256 as TRp64
from starkpack_winterfell_tpu_torch.crypto.rescue62 import Rp62_248 as TRp62
from starkpack_winterfell_tpu_torch.ops import rescue_sponge as rsp
from starkpack_winterfell_tpu_torch.ops.limb_field import F62

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P64 = jfs.P
PAIRS = {"rp64_256": (JRp64, TRp64, P64), "rp62_248": (JRp62, TRp62, F62.P)}
NAMES = list(PAIRS)


def _words(vals):
    """(R, n) u64 elements -> (R, 2n) u32 words."""
    return np.stack([vals & np.uint64(0xFFFFFFFF), vals >> np.uint64(32)],
                    axis=-1).reshape(vals.shape[0], -1).astype(np.uint32)


def _rand_bytes(rng, n):
    return bytes(rng.integers(0, 256, size=n, dtype=np.uint8))


def _digest(H, rng):
    """A digest of H over random elements (a canonical digest)."""
    return H.hash_elements([int(v) for v in rng.integers(0, 1 << 61, size=5)])


def test_registered_and_routed():
    assert T.get_hasher("rp64_256") is TRp64 and T.get_hasher("rp62_248") is TRp62
    from starkpack_winterfell_tpu_torch.prover.device import LIMB_HASHERS, PORTED_HASHERS
    assert {"rp64_256", "sha3_256"} <= set(PORTED_HASHERS)
    assert "rp62_248" in LIMB_HASHERS


@pytest.mark.parametrize("name", NAMES)
def test_byte_api_matches_jax(name):
    J, H, P = PAIRS[name]
    rng = np.random.default_rng(11)
    for n in (0, 1, 6, 7, 8, 55, 57, 130):
        data = _rand_bytes(rng, n)
        assert H.hash(data) == J.hash(data), n
    for k in (0, 1, 4, 8, 9, 17):
        elems = [int(v) for v in rng.integers(0, P, size=k, dtype=np.uint64)]
        assert H.hash_elements(elems) == J.hash_elements(elems), k
    if name == "rp64_256":  # extension elements absorb component by component
        pairs = [(int(a), int(b)) for a, b in rng.integers(0, P, size=(3, 2), dtype=np.uint64)]
        assert H.hash_elements(pairs) == J.hash_elements(pairs)
    a, b = _digest(H, rng), _digest(H, rng)
    assert H.merge(a, b) == J.merge(a, b)
    pairs = [(_digest(H, rng), _digest(H, rng)) for _ in range(5)]
    assert H.merge_many(pairs) == [J.merge(x, y) for x, y in pairs]
    lists = [[1, 2, 3], [int(v) for v in rng.integers(0, P, size=9, dtype=np.uint64)]]
    assert H.hash_elements_many(lists) == [J.hash_elements(e) for e in lists]


@pytest.mark.parametrize("name", NAMES)
def test_merge_with_int_matches_jax_below_and_above_2_32_and_p(name):
    J, H, P = PAIRS[name]
    seed = _digest(H, np.random.default_rng(3))
    for value in (0, 1, 12345, (1 << 32) - 1, 1 << 32, (1 << 32) + 7, (1 << 40) + 3,
                  P - 1, P, P + 5, (1 << 64) - 1):
        assert H.merge_with_int(seed, value) == J.merge_with_int(seed, value), value


@pytest.mark.parametrize("name", NAMES)
def test_digest_round_trips(name):
    J, H, _ = PAIRS[name]
    d = _digest(H, np.random.default_rng(5))
    assert len(d) == H.DIGEST_BYTES
    words = H.digest_from_bytes(d)
    assert np.array_equal(words, J.digest_from_bytes(d))
    assert H.digest_to_bytes(words) == d == J.digest_to_bytes(words)
    assert H.digest_to_bytes(torch.from_numpy(words.astype(np.int64))) == d
    if name == "rp62_248":  # the packed words' top byte is zero
        assert words[7] >> 24 == 0


@pytest.mark.parametrize("name", NAMES)
def test_first_merge_with_int_is_the_lowest_nonce(name):
    """The batched proof-of-work search on the C permutation returns the
    lowest nonce the sequential ``merge_with_int`` loop finds."""
    _, H, _ = PAIRS[name]
    seed = _digest(H, np.random.default_rng(9))
    bits = 6
    nonce = 1
    while int.from_bytes(H.merge_with_int(seed, nonce)[:8], "little") & ((1 << bits) - 1):
        nonce += 1
    assert H.first_merge_with_int(seed, 1, 4096, bits) == nonce
    assert H.first_merge_with_int(seed, nonce + 1, 1, bits) in (None, nonce + 1)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_elems", [1, 7, 8, 9, 12, 24])
def test_hash_words_on_tensors_matches_jax(name, n_elems):
    """The words API on CPU tensors (the plain sponge) against the JAX
    package's words API on numpy (its C sponge), rows of 1 ... 24
    elements: empty tails, one permutation and several."""
    J, H, P = PAIRS[name]
    rng = np.random.default_rng(n_elems)
    words = _words(rng.integers(0, P, size=(5, n_elems), dtype=np.uint64))
    want = np.asarray(J.hash_words(words, 8 * n_elems)).astype(np.int64)
    got = H.hash_words(torch.from_numpy(words.astype(np.int64)), 8 * n_elems)
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)
    # numpy rows (the verifier's query rows) take the C sponge
    assert np.array_equal(np.asarray(H.hash_words(words, 8 * n_elems)).astype(np.int64), want)


@pytest.mark.parametrize("name", NAMES)
def test_merge_words_on_tensors_matches_jax(name):
    """Two halves of a Merkle level, as the prover hands them (row stride 16
    words), every word a random 32-bit value: for Rp62_248 the unpacked
    values reach 2^62 - 1, above p, and stay unreduced as in the
    reference."""
    J, H, _ = PAIRS[name]
    rng = np.random.default_rng(21)
    cur = rng.integers(0, 1 << 32, size=(14, 8)).astype(np.uint32)
    if name == "rp64_256":  # canonical digest elements
        cur[:, 1::2] = np.minimum(cur[:, 1::2], 0xFFFFFFFE)
    want = np.asarray(J.merge_words(cur[0::2], cur[1::2])).astype(np.int64)
    t = torch.from_numpy(cur.astype(np.int64))
    got = H.merge_words(t[0::2], t[1::2])
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(np.asarray(H.merge_words(cur[0::2], cur[1::2])).astype(np.int64), want)


def test_empty_rows_hash_to_the_empty_sponge():
    for _, H, _ in PAIRS.values():
        got = H.hash_words(torch.zeros((3, 0), dtype=torch.int64), 0)
        d = H.hash_elements([])
        want = np.frombuffer(d + bytes(32 - len(d)), dtype="<u4").astype(np.int64)
        assert np.array_equal(got.numpy(), np.tile(want, (3, 1)))


def test_plain_permutation_matches_the_python_rounds():
    """The stacked plain permutation, the C permutation and seven
    ``round_ints`` agree."""
    rng = np.random.default_rng(2)
    states = [[int(v) for v in s] for s in rng.integers(0, P64, size=(4, 12), dtype=np.uint64)]
    stacked = torch.tensor(np.array(states, dtype=np.uint64).view(np.int64)).t()
    got = rsp.permute_plain(rsp.RP64_256, stacked).t().numpy().view(np.uint64)
    for s, g in zip(states, got):
        want = s
        for r in range(7):
            want = trescue.round_ints(want, r)
        assert [int(v) for v in g] == want == trescue.apply_permutation_ints(s)


def test_round_states_match_round_ints():
    rng = np.random.default_rng(4)
    states = rng.integers(0, P64, size=(3, 12), dtype=np.uint64)
    out = trescue.round_states(states)
    for s, rows in zip(states, out):
        cur = [int(v) for v in s]
        assert [int(v) for v in rows[0]] == cur
        for r in range(7):
            cur = trescue.round_ints(cur, r)
            assert [int(v) for v in rows[r + 1]] == cur


def test_wrapper_refuses_other_devices_and_bad_shapes():
    x = torch.zeros((4, 8), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rsp.rescue_sponge(rsp.RP64_256, x, 4)
    with pytest.raises(ValueError):
        rsp.rescue_sponge(rsp.RP64_256, torch.zeros((4, 6), dtype=torch.int64), 4)
    with pytest.raises(TypeError):
        rsp.rescue_sponge(rsp.RP62_248, torch.zeros((4, 8), dtype=torch.int32), 4)


def test_launch_rule_counts():
    """The permutation and multiply counts the smoke's bound uses: the
    S-boxes by the layouts' addition chains, what the kernel, the plain
    version and the host C sponge do."""
    assert rsp.permutations(rsp.RP64_256, 10, 12) == 20
    assert rsp.permutations(rsp.RP64_256, 10, 8) == 10
    assert rsp.permutations(rsp.RP62_248, 10, 0) == 0
    assert rsp.permutations(rsp.RP62_248, 10) == 10
    assert rsp.sbox_multiplies(rsp.RP64_256) == 7 * 12 * (4 + 72)
    assert rsp.sbox_multiplies(rsp.RP62_248) == 7 * 12 * (2 + 72)


@pytest.mark.parametrize("name", ["rp64_256", "rp62_248"])
def test_inverse_sbox_chain_reaches_the_exponent(name):
    """The addition chain the bound counts (and the host C sponge runs)
    raises x to 1/alpha: its exponent is INV_ALPHA, and it inverts x^alpha
    on random elements."""
    layout = rsp.LAYOUTS[name]
    assert rsp.chain_exponent(layout.inv_chain) == layout.inv_alpha
    assert rsp.chain_exponent(layout.alpha_chain) == layout.alpha
    assert layout.alpha * layout.inv_alpha % (layout.P - 1) == 1
    rng = np.random.default_rng(3)
    for x in rng.integers(1, layout.P, size=4, dtype=np.uint64).tolist():
        t = [x]
        for a, n, b in layout.inv_chain:
            v = pow(t[a], 1 << n, layout.P)
            t.append(v * t[b] % layout.P if b is not None else v)
        assert pow(t[-1], layout.alpha, layout.P) == x


def _seed_bytes(name, rng):
    """A random seed digest: Rp64_256 four canonical elements; Rp62_248 31
    random bytes, whose unpacked values may lie in [p, 2^62)."""
    if name == "rp64_256":
        return b"".join(int(v).to_bytes(8, "little")
                        for v in rng.integers(0, P64, size=4, dtype=np.uint64))
    return _rand_bytes(rng, 31)


def _digest_bytes(name, words):
    return words.numpy().astype("<u4").tobytes()[:PAIRS[name][1].DIGEST_BYTES]


@pytest.mark.parametrize("name", NAMES)
def test_merge_with_int_plain_matches_jax(name):
    """The plain version of the kernel's search mode: each nonce's digest
    against the JAX package's byte-API ``merge_with_int``, nonces below
    2^32 and up to p - 1."""
    J, H, P = PAIRS[name]
    rng = np.random.default_rng(31)
    for seed in (_seed_bytes(name, rng), _seed_bytes(name, rng)):
        nonces = [1, 2, 77, (1 << 32) - 1, 1 << 32, (1 << 40) + 3, P - 2, P - 1]
        t = torch.tensor([v - (1 << 64) if v >= 1 << 63 else v for v in nonces],
                         dtype=torch.int64)
        got = rsp.merge_with_int_plain(H.LAYOUT, H.seed_elements(seed), t)
        for v, row in zip(nonces, got):
            assert _digest_bytes(name, row.unsqueeze(0)) == J.merge_with_int(seed, v), v


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("bits", [4, 8])
def test_search_plain_finds_the_host_sponges_nonce(name, bits):
    """The lowest nonce of the plain search (the CPU branch of the wrapper,
    what ``ProverChannel._find_nonce`` asks on the card) equals the host C
    sponge's ``first_merge_with_int`` and the JAX ``merge_with_int`` loop;
    a range past it finds the next one or None."""
    J, H, _ = PAIRS[name]
    seed = _seed_bytes(name, np.random.default_rng(bits))
    want = H.first_merge_with_int(seed, 1, 1024, bits)
    got, digests = rsp.first_merge_with_int(H.LAYOUT, H.seed_elements(seed), 1, 1024, bits,
                                            digests=True)
    assert got == want is not None
    assert int.from_bytes(J.merge_with_int(seed, got)[:8], "little") % (1 << bits) == 0
    assert _digest_bytes(name, digests[got - 1: got]) == J.merge_with_int(seed, got)
    nxt = H.first_merge_with_int(seed, got + 1, 64, bits)
    assert rsp.first_merge_with_int(H.LAYOUT, H.seed_elements(seed), got + 1, 64, bits)[0] == nxt


def test_search_wrapper_refuses_nonces_at_p_and_bad_bits():
    elems = [1, 2, 3, 4]
    for layout in (rsp.RP64_256, rsp.RP62_248):
        with pytest.raises(ValueError, match="must lie in"):
            rsp.first_merge_with_int(layout, elems, layout.P - 3, 4, 8)
        with pytest.raises(ValueError, match="must lie in"):
            rsp.first_merge_with_int(layout, elems, 0, 4, 8)
        with pytest.raises(ValueError, match="bits"):
            rsp.first_merge_with_int(layout, elems, 1, 4, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        rsp.first_merge_with_int(rsp.RP64_256, elems, 1, 4, 8, device="meta")


def test_rp62_merges_of_unreduced_digest_words_match_jax():
    """Rp62_248 digests whose four 62-bit words all lie in [p, 2^62): the
    merge maps each to the residue it denotes, as the reference does."""
    J, H, P = PAIRS["rp62_248"]
    rng = np.random.default_rng(41)
    v = [int(a) for a in rng.integers(P, 1 << 62, size=24, dtype=np.uint64)]
    words = np.array([[(sum(v[4 * r + k] << (62 * k) for k in range(4)) >> (32 * j)) & 0xFFFFFFFF
                       for j in range(8)] for r in range(6)], dtype=np.uint32)
    want = np.asarray(J.merge_words(words[0::2], words[1::2])).astype(np.int64)
    t = torch.from_numpy(words.astype(np.int64))
    assert np.array_equal(H.merge_words(t[0::2], t[1::2]).numpy(), want)
