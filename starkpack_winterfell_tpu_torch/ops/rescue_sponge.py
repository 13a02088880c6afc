"""The sponge of the algebraic hashers on one hand-written CUDA kernel: the
words API of ``Rp64_256`` (Goldilocks), ``Rp62_248`` (f62),
``RpJive64_256`` and ``GriffinJive64_256`` (Goldilocks, width 8), and their
proof-of-work search.

Counterpart of what ``hash_words`` / ``merge_words`` of
starkpack_winterfell_tpu/crypto/rescue.py (:211-261), crypto/rescue62.py
(:375-449), crypto/rescue_jive.py (:188-239) and crypto/griffin.py
(:194-248) compute.  The JAX package has no Pallas kernel for it: there the
sponge is XLA code (``apply_permutation_limbs``, rescue.py:92,
rescue62.py:128, rescue_jive.py:67, griffin.py:78) or a host sponge.  Eager
tensor code would not finish a full-width prove (a Goldilocks multiply is
~40 tensor ops, one Rp64_256 permutation ~28k), so the sponge is the kernel
``rescue_sponge`` of csrc/rescue_sponge.cu, one thread a row, the state in
registers.

Three modes of one kernel, for a ``SpongeLayout`` (field, width, positions
of the rate, tag and digest, Jive or tagged rules, round kind, S-box
chains, constants, digest packing):

* hash: ``x`` (R, >= 2*n_elems) u32 words in int64, each row n_elems
  canonical LE u64 elements -> the sponge of the row (``hash_elements``):
  the element count as the tag; or (Jive) the flag 1 at the tag's place
  when the count is not a multiple of the rate and the last partial block
  padded with 1, 0, ...;
* merge: ``x`` and ``y`` (R, 8) digest words -> the 2-to-1 merge of each
  pair (``merge``): the two digests in the rate, tag 2 * digest size; or
  (Jive) the two digests as state[0..8) and digest_i = init_i + init_{4+i}
  + final_i + final_{4+i};
* search (``first_merge_with_int``): a seed's four digest elements and a
  range of nonces -> the lowest nonce whose ``merge_with_int(seed, nonce)``
  digest has ``bits`` trailing zeros in its first 8 bytes (the seed
  elements at ``seed_start``, the nonce after them, digest size + 1 at
  ``search_tag``; Jive: the Jive sum; the host C search of
  crypto/_native_perm.py builds the same states).

Hash and merge return (R, 8) digest words: four LE u64 elements (Rp64_256), or four
62-bit values bit-packed into 31 bytes with a zero top byte (Rp62_248,
rescue62.py:digest_to_bytes31); a merge unpacks them masked to 62 bits, not
reduced mod p, as the reference does.

``rescue_sponge_plain`` is the same function in plain PyTorch, with the
state words stacked as ONE (width, R) tensor so one field op covers the
whole state (``merge_with_int_plain`` / ``first_merge_with_int_plain`` for the
search).  ``rescue_sponge`` and ``first_merge_with_int`` take it only for
tensors on the CPU; on a CUDA device they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from ..crypto import griffin_constants as cgr
from ..crypto import rescue62_constants as c62
from ..crypto import rescue_constants as c64
from ..crypto import rescue_jive_constants as cj
from . import gl64 as gl
from .limb_field import F62

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
_M62 = (1 << 62) - 1
ROUNDS = 7
MAX_WIDTH = 12  # the kernel's constant table holds layouts up to this width
THREADS = 128  # threads a block of the kernel, one row each
# words a pass of the kernel's Rescue S-box raises together
# (csrc/rescue_sponge.cu SBOX_GROUP; a layout of another width takes the
# greatest common divisor), chosen from ptxas's spills and the
# measured times (kernel_times.py --only sponge --variants; PERF.md)
SBOX_GROUP = 4

# launches of the kernel made by ``rescue_sponge`` (and nowhere else): the
# total, and by (layout name, mode, rows, elements a row or 0 for a merge);
# and of its search mode, made by ``first_merge_with_int``, by layout name
LAUNCHES = 0
LAUNCHES_BY_SHAPE: dict = {}
SEARCH_LAUNCHES = 0
SEARCH_LAUNCHES_BY_LAYOUT: dict = {}


def reset_launch_counts():
    global LAUNCHES, SEARCH_LAUNCHES
    LAUNCHES = SEARCH_LAUNCHES = 0
    LAUNCHES_BY_SHAPE.clear()
    SEARCH_LAUNCHES_BY_LAYOUT.clear()


class SpongeLayout(NamedTuple):
    """One sponge: field, state geometry, rules, round kind, S-box
    exponents and constants.  ``field`` is ``"gl64"`` or ``"f62"``;
    ``tag_index`` the capacity word of the hash's count tag (Jive: of its
    flag) and the tagged merge's tag; ``jive`` the Jive rules of the hash
    padding, the merge and the search (module docstring); ``seed_start``
    and ``search_tag`` where the search puts the seed (the nonce after it)
    and digest size + 1; ``griffin`` the round kind: Griffin's non-linear
    layer (``ark1`` its six rows of round constants, ``ark2`` its (alpha,
    beta) rows), else Rescue-Prime's x^alpha and x^(1/alpha) half-rounds;
    ``packed31`` marks Rp62_248's bit-packed 31-byte digests;
    ``alpha_chain`` and ``inv_chain`` are addition chains for x^alpha and
    x^(1/alpha) (``ALPHA_CHAIN_*``, ``INV_CHAIN_*``)."""

    name: str
    field: str
    P: int
    width: int
    rate_start: int
    rate: int
    tag_index: int
    digest_start: int
    digest_size: int
    jive: bool
    seed_start: int
    search_tag: int
    griffin: bool
    alpha: int
    inv_alpha: int
    mds: tuple
    ark1: tuple
    ark2: tuple
    packed31: bool
    alpha_chain: tuple
    inv_chain: tuple


def _freeze(t):
    return tuple(tuple(int(v) for v in row) for row in t)


# x^(1/alpha) by an addition chain: each step (a, n, b) appends t[a]^(2^n) *
# t[b] to t (no multiply when b is None), t[0] = x, the last t the result.
# Rp64_256's is the reference's apply_inv_sbox (rp64_256/mod.rs): 63
# squarings and 9 multiplies.  Rp62_248's builds x^0b10, x^0b11, x^0b1010,
# x^0b101010, x^0b10101010 and x^(0b10 * 8) and reads its exponent as
# (10)^8 0001 01 (10)^8 (10)^8 (10)^3 11: 61 squarings and 11 multiplies.
INV_CHAIN_RP64 = ((0, 1, None), (1, 1, None), (2, 3, 2), (3, 6, 3), (4, 12, 4), (5, 6, 3),
                  (6, 31, 6), (7, 1, 6), (8, 2, None), (1, 0, 2), (10, 0, 0), (9, 0, 11))
INV_CHAIN_RP62 = ((0, 1, None), (1, 0, 0), (1, 2, 1), (3, 2, 1), (4, 2, 1), (5, 8, 5),
                  (6, 4, 0), (7, 2, 0), (8, 16, 6), (9, 16, 6), (10, 6, 4), (11, 2, 2))
# x^alpha: x^7 = x^4 * x^2 * x (four multiplies; the same steps end
# INV_CHAIN_RP64, whose t[11] is x^7), x^3 = x^2 * x (two)
ALPHA_CHAIN_RP64 = ((0, 1, None), (1, 1, None), (1, 0, 2), (3, 0, 0))
ALPHA_CHAIN_RP62 = ((0, 1, None), (1, 0, 0))

INV_ALPHA_RP64 = 10540996611094048183
# capacity first: tag in state[0], rate state[4..12], digest state[4..8]
RP64_256 = SpongeLayout(
    name="rp64_256", field="gl64", P=gl.P, width=12, rate_start=4, rate=8, tag_index=0,
    digest_start=4, digest_size=4, jive=False, seed_start=4, search_tag=0, griffin=False,
    alpha=7, inv_alpha=INV_ALPHA_RP64, mds=_freeze(c64.MDS), ark1=_freeze(c64.ARK1),
    ark2=_freeze(c64.ARK2), packed31=False, alpha_chain=ALPHA_CHAIN_RP64,
    inv_chain=INV_CHAIN_RP64)
# the legacy rate-first layout: rate state[0..8], digest state[0..4], tag in
# state[11]
RP62_248 = SpongeLayout(
    name="rp62_248", field="f62", P=F62.P, width=12, rate_start=0, rate=8, tag_index=11,
    digest_start=0, digest_size=4, jive=False, seed_start=0, search_tag=11, griffin=False,
    alpha=3, inv_alpha=3074416663688030891, mds=_freeze(c62.MDS62), ark1=_freeze(c62.ARK1_62),
    ark2=_freeze(c62.ARK2_62), packed31=True, alpha_chain=ALPHA_CHAIN_RP62,
    inv_chain=INV_CHAIN_RP62)
# Jive, width 8: flag in state[0], rate and digest state[4..8]
RPJIVE64_256 = SpongeLayout(
    name="rp_jive64_256", field="gl64", P=gl.P, width=8, rate_start=4, rate=4, tag_index=0,
    digest_start=4, digest_size=4, jive=True, seed_start=0, search_tag=7, griffin=False,
    alpha=7, inv_alpha=INV_ALPHA_RP64, mds=_freeze(cj.MDS8), ark1=_freeze(cj.ARK1_8),
    ark2=_freeze(cj.ARK2_8), packed31=False, alpha_chain=ALPHA_CHAIN_RP64,
    inv_chain=INV_CHAIN_RP64)
# Griffin in Jive mode, width 8: rate and digest state[0..4], flag state[4];
# s0^(1/7) and s1^7 by Rp64_256's chains
GRIFFIN64_256 = SpongeLayout(
    name="griffin_jive64_256", field="gl64", P=gl.P, width=8, rate_start=0, rate=4,
    tag_index=4, digest_start=0, digest_size=4, jive=True, seed_start=0, search_tag=7,
    griffin=True, alpha=7, inv_alpha=INV_ALPHA_RP64, mds=_freeze(cgr.MDS_G),
    ark1=_freeze(cgr.ARK_G), ark2=_freeze((cgr.ALPHA_G, cgr.BETA_G)), packed31=False,
    alpha_chain=ALPHA_CHAIN_RP64, inv_chain=INV_CHAIN_RP64)
# the kernel's layouts, in the order of its constant slots (csrc/
# rescue_sponge.cu kConsts, the ``slot`` of its launchers)
LAYOUTS = {l.name: l for l in (RP64_256, RP62_248, RPJIVE64_256, GRIFFIN64_256)}
SLOTS = {name: slot for slot, name in enumerate(LAYOUTS)}


def chain_exponent(chain) -> int:
    """The exponent an addition chain (``INV_CHAIN_*``) raises x to."""
    t = [1]
    for a, n, b in chain:
        t.append((t[a] << n) + (t[b] if b is not None else 0))
    return t[-1]


def chain_multiplies(chain) -> int:
    """Field multiplies of an addition chain, squarings included."""
    return sum(n + (b is not None) for _, n, b in chain)


def sbox_multiplies(layout: SpongeLayout) -> int:
    """Field multiplies of the non-linear layers of one permutation, what
    the kernel, the plain version and the host C sponges do.  Rescue-Prime:
    x^alpha and x^(1/alpha) by the layout's addition chains on every state
    word of every round (4 + 72 a word for Rp64_256 and RpJive64_256, 2 +
    72 for Rp62_248).  Griffin: a round raises s0 to 1/7 (72) and s1 to 7
    (4) and takes three multiplies for each of the other width - 2 words
    (l^2, alpha * l, s * quad; its (i - 1) * s0 is a running sum of adds)."""
    up = chain_multiplies(layout.alpha_chain)
    down = chain_multiplies(layout.inv_chain)
    if layout.griffin:
        return ROUNDS * (up + down + 3 * (layout.width - 2))
    return ROUNDS * layout.width * (up + down)


def permutations(layout: SpongeLayout, rows: int, n_elems: int = None) -> int:
    """Permutations of one call: ceil(n_elems / rate) a row hashed (none
    for an empty row: the sponge permutes only after absorbing; Jive pads
    only a started block), one a pair merged (``n_elems`` None)."""
    if n_elems is None:
        return rows
    return rows * (-(-n_elems // layout.rate))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


class _Field:
    """add / mul of one field on one-word int64 tensors, and powers by an
    addition chain."""

    def __init__(self, layout):
        self.gl = layout.field == "gl64"

    def add(self, a, b):
        return gl.add(a, b) if self.gl else F62.add((a,), (b,))[0]

    def mul(self, a, b):
        return gl.mul(a, b) if self.gl else F62.mul((a,), (b,))[0]

    def chain(self, x, chain):
        """x raised to ``chain_exponent(chain)``."""
        t = [x]
        for a, n, b in chain:
            v = t[a]
            for _ in range(n):
                v = self.mul(v, v)
            t.append(self.mul(v, t[b]) if b is not None else v)
        return t[-1]


_TABLES: dict = {}


def _tables(layout, device):
    """The layout's constants on ``device``: MDS (width, width) and the
    ARKs (rows, width, 1) (Griffin: ark1 (6, 8, 1), ark2 its (alpha, beta)
    rows (2, 6, 1)), as words; for Goldilocks also the MDS as float64 (its
    entries are below 32, so sums of 12 products of an entry and a 32-bit
    half stay below 2^41 and the float64 product is exact)."""
    key = (layout.name, str(device))
    if key not in _TABLES:
        def words(t):
            return torch.tensor([[gl._wrap(v) for v in row] for row in t],
                                dtype=torch.int64, device=device)
        mds = words(layout.mds)
        _TABLES[key] = {
            "mds": mds,
            "mds_f64": mds.to(torch.float64) if layout.field == "gl64" else None,
            "ark1": words(layout.ark1).unsqueeze(-1),
            "ark2": words(layout.ark2).unsqueeze(-1),
        }
    return _TABLES[key]


def _mds_plain(layout, F, t, s):
    """MDS @ s for the stacked state s (width, R)."""
    if layout.field == "gl64":
        m = t["mds_f64"]
        lo = torch.matmul(m, (s & MASK32).to(torch.float64)).to(torch.int64)
        hi = torch.matmul(m, ((s >> 32) & MASK32).to(torch.float64)).to(torch.int64)
        # value = lo + hi * 2^32 < 2^74, as a (low word, high word) pair
        shifted = hi << 32
        low = lo + shifted
        high = (hi >> 32) + gl._ult(low, shifted).to(torch.int64)
        return gl._reduce128(low, high)
    prod = F.mul(t["mds"].unsqueeze(-1), s.unsqueeze(0))  # (width, width, R)
    acc = [prod[:, j] for j in range(layout.width)]
    while len(acc) > 1:
        acc = [F.add(acc[i], acc[i + 1]) if i + 1 < len(acc) else acc[i]
               for i in range(0, len(acc), 2)]
    return acc[0]


def _griffin_layer(layout, F, t, s):
    """Griffin's non-linear layer on stacked states s (8, R): s0^(1/7),
    s1^7, then s_i * (l_i^2 + alpha l_i + beta) with l_i = (i - 1) s0 + s1
    + s_{i-1} (already updated; none for i = 2), i = 2..7."""
    s0 = F.chain(s[0], layout.inv_chain)
    s1 = F.chain(s[1], layout.alpha_chain)
    alpha, beta = t["ark2"]
    out, acc = [s0, s1], s0
    for i in range(2, layout.width):
        if i > 2:
            acc = F.add(acc, s0)
        l = F.add(acc, s1)
        if i > 2:
            l = F.add(l, out[-1])
        quad = F.add(F.add(F.mul(l, l), F.mul(alpha[i - 2], l)), beta[i - 2])
        out.append(F.mul(s[i], quad))
    return torch.stack(out)


def permute_plain(layout: SpongeLayout, s):
    """The layout's permutation of stacked states s (width, R): Rescue-Prime
    (7 rounds of x^alpha, MDS, ARK1, x^(1/alpha), MDS, ARK2) or Griffin (6
    rounds of the non-linear layer, MDS and round constants, then the
    non-linear layer and MDS)."""
    F = _Field(layout)
    t = _tables(layout, s.device)
    if layout.griffin:
        for r in range(ROUNDS):
            s = _mds_plain(layout, F, t, _griffin_layer(layout, F, t, s))
            if r < ROUNDS - 1:
                s = F.add(s, t["ark1"][r])
        return s
    for r in range(ROUNDS):
        s = F.chain(s, layout.alpha_chain)
        s = F.add(_mds_plain(layout, F, t, s), t["ark1"][r])
        s = F.chain(s, layout.inv_chain)
        s = F.add(_mds_plain(layout, F, t, s), t["ark2"][r])
    return s


def _elements(words, n: int):
    """(R, >= 2n) u32 words -> (n, R) u64 elements."""
    w = words[:, : 2 * n]
    return (w[:, 0::2] | (w[:, 1::2] << 32)).t()


def _digest_words(layout, d):
    """Four digest values a row (4, R) -> (R, 8) u32 words."""
    if layout.packed31:
        v1, v2, v3, v4 = d
        d = torch.stack([v1 | (v2 << 62), (v2 >> 2) | (v3 << 60),
                         (v3 >> 4) | (v4 << 58), v4 >> 6])
    return torch.stack([d & MASK32, (d >> 32) & MASK32], dim=-1).permute(1, 0, 2) \
        .reshape(-1, 2 * layout.digest_size)


def _digest_elements(layout, words):
    """(R, 8) digest words -> (4, R) state values (Rp62_248: unpacked and
    masked to 62 bits, not reduced)."""
    w = _elements(words, 4)
    if not layout.packed31:
        return w
    return torch.stack([
        w[0] & _M62,
        (((w[0] >> 62) & 3) | (w[1] << 2)) & _M62,
        (((w[1] >> 60) & 0xF) | (w[2] << 4)) & _M62,
        (((w[2] >> 58) & 0x3F) | (w[3] << 6)) & _M62,
    ])


def _squeeze(layout, s, initial=None):
    """The digest words of permuted states s (width, R): the digest's place,
    or (``initial``, the states before the permutation) the Jive sum."""
    ds = layout.digest_size
    if initial is None:
        return _digest_words(layout, s[layout.digest_start: layout.digest_start + ds])
    F = _Field(layout)
    return _digest_words(layout, F.add(F.add(initial[:ds], initial[ds: 2 * ds]),
                                       F.add(s[:ds], s[ds: 2 * ds])))


def rescue_sponge_plain(layout: SpongeLayout, x, n_elems: int = None, y=None):
    """Plain PyTorch version of the kernel: hash rows (``y`` None) or merge
    digest pairs; see the module docstring."""
    F = _Field(layout)
    R = x.shape[0]
    s = torch.zeros((layout.width, R), dtype=torch.int64, device=x.device)
    ds, rs = layout.digest_size, layout.rate_start
    if y is not None:
        at = 0 if layout.jive else rs
        s[at: at + ds] = _digest_elements(layout, x)
        s[at + ds: at + 2 * ds] = _digest_elements(layout, y)
        if layout.jive:
            return _squeeze(layout, permute_plain(layout, s), s)
        s[layout.tag_index] = 2 * ds
        return _squeeze(layout, permute_plain(layout, s))
    e = _elements(x, n_elems)
    if not layout.jive:
        s[layout.tag_index] = n_elems % layout.P
    elif n_elems % layout.rate:
        s[layout.tag_index] = 1
    for k in range(0, n_elems, layout.rate):
        block = e[k: k + layout.rate]
        m = block.shape[0]
        s[rs: rs + m] = F.add(s[rs: rs + m], block)
        if layout.jive and m < layout.rate:  # 1, 0, ... in the rest of the rate
            s[rs + m] = 1
            s[rs + m + 1: rs + layout.rate] = 0
        s = permute_plain(layout, s)
    return _squeeze(layout, s)


def merge_with_int_plain(layout: SpongeLayout, seed_elems, nonces):
    """``merge_with_int(seed, nonce)`` digests as (R, 8) words for an (R,)
    int64 tensor of nonces below p (one element each; read as u64): the
    seed's four digest elements at ``seed_start``, the nonce after them,
    digest size + 1 at ``search_tag``, one permutation (Jive: the Jive
    sum)."""
    s = torch.zeros((layout.width, nonces.shape[0]), dtype=torch.int64, device=nonces.device)
    at, ds = layout.seed_start, layout.digest_size
    s[at: at + ds] = torch.tensor([gl._wrap(int(v)) for v in seed_elems], dtype=torch.int64,
                                  device=nonces.device).unsqueeze(-1)
    s[at + ds] = nonces
    s[layout.search_tag] = ds + 1
    return _squeeze(layout, permute_plain(layout, s), s if layout.jive else None)


def first_merge_with_int_plain(layout: SpongeLayout, seed_elems, start: int, count: int,
                               bits: int, device="cpu"):
    """Plain version of the kernel's search: (the lowest nonce in [start,
    start + count) whose digest has ``bits`` trailing zeros in its first 8
    bytes, or None; the (count, 8) digest words)."""
    # the nonces as int64 (u64 read as two's complement)
    nonces = torch.arange(count, dtype=torch.int64, device=device) + gl._wrap(start)
    d = merge_with_int_plain(layout, seed_elems, nonces)
    head = d[:, 0] | (d[:, 1] << 32)  # the digest's first 8 bytes, little-endian
    ok = torch.nonzero((head & ((1 << bits) - 1)) == 0)
    return (int(nonces[ok[0, 0]]) & MASK64 if ok.numel() else None), d


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

_FNS: dict = {}


def kernel_sources():
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
    return [os.path.join(d, "rescue_sponge.cu")]


def kernel_prelude(group: int = None) -> str:
    """The definitions csrc/rescue_sponge.cu is built with: the S-box group
    and the layouts' addition chains as X-macros, step K (a, n, b) as
    ``S(K, a, n, b)`` (b = -1 for no multiply).  The chains are
    ``ALPHA_CHAIN_*`` / ``INV_CHAIN_*``, the tuples the plain version and
    the host C sponge run."""
    lines = ["// generated by ops/rescue_sponge.py:kernel_prelude",
             f"#define SBOX_GROUP {SBOX_GROUP if group is None else group}",
             f"#define SPONGE_SLOTS {len(LAYOUTS)}"]
    for name, chain in (("RP64_ALPHA", ALPHA_CHAIN_RP64), ("RP64_INV", INV_CHAIN_RP64),
                        ("RP62_ALPHA", ALPHA_CHAIN_RP62), ("RP62_INV", INV_CHAIN_RP62)):
        steps = " ".join(f"S({k}, {a}, {n}, {-1 if b is None else b})"
                         for k, (a, n, b) in enumerate(chain, 1))
        lines += [f"#define {name}_CHAIN(S) {steps}", f"#define {name}_CHAIN_LEN {len(chain)}"]
    return "\n".join(lines) + "\n"


def kernel_source(group: int = None):
    """(library name, path) of the generated source that defines
    ``kernel_prelude(group)`` and includes csrc/rescue_sponge.cu, written
    under the build directory when missing or different; the name carries
    a hash of both."""
    from ..native import BUILD_DIR

    src = kernel_prelude(group) + '#include "rescue_sponge.cu"\n'
    with open(kernel_sources()[0]) as f:
        body = f.read()
    tag = hashlib.sha256((src + body).encode()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"rescue_sponge_{tag}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not os.path.exists(path) or open(path).read() != src:
        with open(path, "w") as f:
            f.write(src)
    return f"starkrescue_{tag}", path


def kernel_constants(layout: SpongeLayout) -> np.ndarray:
    """MDS (144), ARK1 (84) and ARK2 (84) words of a layout, the table the
    kernel keeps in constant memory, each part zero-padded to its room at
    MAX_WIDTH (the MDS row-major at the layout's width; Griffin: its six
    ARK rows, then alpha and beta as ARK2): Goldilocks words (the MDS
    entries must be below 2^32, as the kernel multiplies them with 32-bit
    halves), f62 words in Montgomery form (x * 2^64 mod p)."""
    parts = []
    for t, room in ((layout.mds, MAX_WIDTH * MAX_WIDTH), (layout.ark1, ROUNDS * MAX_WIDTH),
                    (layout.ark2, ROUNDS * MAX_WIDTH)):
        vals = [v for row in t for v in row]
        if len(vals) > room:
            raise ValueError(f"{layout.name}: {len(vals)} constants for a room of {room}")
        parts += vals + [0] * (room - len(vals))
    if layout.field == "f62":
        parts = [(v << 64) % layout.P for v in parts]
    elif any(v >> 32 for row in layout.mds for v in row):
        raise ValueError(f"{layout.name}: the kernel takes MDS entries below 2^32")
    return np.array(parts, dtype=np.uint64)


def _lib(group: int = None):
    """Build (first use) and load the kernel library with S-box group
    ``group`` (default ``SBOX_GROUP``) and copy every layout's constants to
    the current device; raises on failure."""
    group = SBOX_GROUP if group is None else group
    if group not in _FNS:
        from ..native import load_kernels

        p, i, ll, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64
        name, path = kernel_source(group)
        fns = load_kernels(name, [path], "rescue_sponge_init", {
            "rescue_sponge_set_constants": [i, p],
            "rescue_sponge_launch": [i, i, p, p, p, ll, ll, ll, i, i, p],
            "rescue_sponge_search": [i, p, u64, ll, i, p, p, i, p],
        })
        for slot, layout in enumerate(LAYOUTS.values()):
            consts = kernel_constants(layout)
            rc = fns["rescue_sponge_set_constants"](slot, consts.ctypes.data_as(p))
            if rc != 0:
                raise RuntimeError(f"rescue_sponge: copying the {layout.name} "
                                   f"constants failed with cudaError {rc}")
        _FNS[group] = fns
    return _FNS[group]


def _check(name, t, cols):
    if t.dtype != torch.int64:
        raise TypeError(f"{name} must be int64 (u32 words), got {t.dtype}")
    if t.dim() != 2 or t.shape[1] < cols:
        raise ValueError(f"{name} must be (rows, >= {cols}), got {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must have contiguous rows")


def rescue_sponge(layout: SpongeLayout, x, n_elems: int = None, y=None):
    """Hash rows (``y`` None: x (R, >= 2*n_elems) words, n_elems elements a
    row) or merge digest pairs (x, y (R, 8)); returns (R, 8) digest words.
    Rows are read through their row stride (a Merkle level's ``cur[0::2]``
    is read where it lies).

    CPU tensors take ``rescue_sponge_plain``.  CUDA tensors launch the kernel
    of csrc/rescue_sponge.cu on the current stream (no synchronisation) or
    raise."""
    global LAUNCHES
    merge = y is not None
    if merge:
        _check("x", x, 8)
        _check("y", y, 8)
        if y.shape[0] != x.shape[0] or y.device != x.device:
            raise ValueError("x and y must have the same rows on one device")
    else:
        if n_elems is None or n_elems < 0:
            raise ValueError("hashing rows needs their element count")
        _check("x", x, 2 * n_elems)
    if x.device.type == "cpu":
        return rescue_sponge_plain(layout, x, n_elems, y)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from ..native import launch

    R = x.shape[0]
    out = torch.empty((R, 8), dtype=torch.int64, device=x.device)
    if R == 0:
        return out
    rc = launch(
        _lib()["rescue_sponge_launch"], x.device, SLOTS[layout.name], int(merge),
        x.data_ptr(), y.data_ptr() if merge else None, out.data_ptr(), x.stride(0),
        y.stride(0) if merge else 0, R, 0 if merge else n_elems, THREADS,
    )
    if rc != 0:
        raise RuntimeError(
            f"rescue_sponge kernel launch failed: cudaError {rc} "
            f"({layout.name}, rows={R}, n_elems={n_elems}, merge={merge})")
    LAUNCHES += 1
    key = (layout.name, "merge" if merge else "hash", R, 0 if merge else n_elems)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return out


def first_merge_with_int(layout: SpongeLayout, seed_elems, start: int, count: int, bits: int,
                         device="cpu", digests: bool = False):
    """The proof-of-work search over nonces [start, start + count): (the
    lowest nonce whose ``merge_with_int(seed, nonce)`` digest has ``bits``
    trailing zeros in its first 8 bytes read little-endian, or None; with
    ``digests`` the (count, 8) digest words, else None).  ``seed_elems``:
    the seed's four digest elements (Rp62_248: unpacked, masked to 62 bits,
    not reduced).  The nonces must lie in [1, p), one element each.

    On the CPU, ``first_merge_with_int_plain``.  On a CUDA device, one launch
    of the kernel's search mode on the current stream, then one
    synchronisation to read the nonce; or a raise."""
    global SEARCH_LAUNCHES
    if start < 1 or count < 1 or start + count > layout.P:
        raise ValueError(f"nonces [{start}, {start + count}) must lie in [1, p)")
    if not 0 <= bits <= 63:
        raise ValueError(f"bits must lie in [0, 63], got {bits}")
    device = torch.device(device)
    if device.type == "cpu":
        nonce, d = first_merge_with_int_plain(layout, seed_elems, start, count, bits)
        return nonce, d if digests else None
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from ..native import launch

    found = torch.full((1,), -1, dtype=torch.int64, device=device)  # u64 max
    out = torch.empty((count, 8), dtype=torch.int64, device=device) if digests else None
    seed = np.array([int(v) for v in seed_elems], dtype=np.uint64)
    if seed.shape != (4,):
        raise ValueError(f"the seed is four digest elements, got {seed.shape}")
    rc = launch(_lib()["rescue_sponge_search"], device, SLOTS[layout.name],
                seed.ctypes.data_as(ctypes.c_void_p), start, count, bits, found.data_ptr(),
                out.data_ptr() if digests else None, THREADS)
    if rc != 0:
        raise RuntimeError(f"rescue_sponge search launch failed: cudaError {rc} "
                           f"({layout.name}, start={start}, count={count}, bits={bits})")
    SEARCH_LAUNCHES += 1
    SEARCH_LAUNCHES_BY_LAYOUT[layout.name] = SEARCH_LAUNCHES_BY_LAYOUT.get(layout.name, 0) + 1
    v = int(found.item()) & MASK64
    return (None if v == MASK64 else v), out


