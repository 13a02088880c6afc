"""The two AIRs of the benchmark's configurations, written out on Python
ints from their published descriptions: Winterfell's Rescue hash chain
(the Rescue-XLIX permutation of Rp64_256 over Goldilocks, one round a row in
cycles of 8 rows) and the StarkPack fork's aggregated Lamport+ signatures
over f128 (Rescue128, 1024-row blocks).  Each gives its constraint degrees,
assertions, periodic columns and transition constraints at one point."""

from __future__ import annotations

from . import rescue128_constants as r128
from . import rescue_constants as rp64
from .field import F64, F128

SINGLE = 0  # the stride of a single-step assertion


def with_cycles(base: int, cycles=()):
    return (base, tuple(cycles))


class Assertion:
    def __init__(self, column: int, first_step: int, stride: int, values):
        self.column, self.first_step, self.stride = column, first_step, stride
        self.values = list(values)

    def key(self):
        return (self.stride, self.first_step, self.column)


def _mds(matrix, state, P):
    return [sum(m * s for m, s in zip(row, state)) % P for row in matrix]


class RescueChain:
    """Public inputs: 8 seed elements and the 4-element result.  Row 8c+k
    holds the state after k rounds of permutation c; row 8c+7 is copied into
    row 8(c+1)."""

    field = F64
    width = 12
    ROUNDS, CYCLE = 7, 8

    def __init__(self, trace_length: int, seed, result):
        self.trace_length = trace_length
        self.seed, self.result = list(seed), list(result)
        self.degrees = [with_cycles(7, [self.CYCLE])] * self.width

    def pub_elements(self):
        return self.seed + self.result

    def assertions(self):
        last = self.trace_length - 1
        out = [Assertion(i, 0, SINGLE, [0]) for i in range(4)]
        out += [Assertion(4 + i, 0, SINGLE, [v]) for i, v in enumerate(self.seed)]
        out += [Assertion(4 + i, last, SINGLE, [v]) for i, v in enumerate(self.result)]
        return out

    def periodic_columns(self):
        cols = [[1] * self.ROUNDS + [0]]
        cols += [[rp64.ARK1[r][i] for r in range(self.ROUNDS)] + [0] for i in range(self.width)]
        cols += [[rp64.ARK2[r][i] for r in range(self.ROUNDS)] + [0] for i in range(self.width)]
        return cols

    def transition(self, cur, nxt, periodic):
        """flag * (MDS(cur^7) + ARK1 - (INV_MDS(next - ARK2))^7)
        + (1 - flag) * (next - cur), column by column."""
        P = self.field.P
        w = self.width
        flag, ark1, ark2 = periodic[0], periodic[1:1 + w], periodic[1 + w:1 + 2 * w]
        fwd = _mds(rp64.MDS, [pow(c, 7, P) for c in cur], P)
        bwd = [pow(b, 7, P) for b in _mds(rp64.INV_MDS, [(n - a) % P for n, a in zip(nxt, ark2)], P)]
        return [(flag * (fwd[i] + ark1[i] - bwd[i]) + (1 - flag) * (nxt[i] - cur[i])) % P
                for i in range(w)]


class LamportAgg:
    """Public inputs: each signature's message and 2-element public key.
    Columns: A (0..5) hashes the revealed secret of a message bit, B (6..11)
    absorbs the public-key sponge, 12 the message bit, 13 the message
    accumulator; a block of 8 (k + 1) rows a signature, reset at its last
    row.  Each block's B0, B1 and message at its last row are bound to the
    public key and message by sequence assertions."""

    field = F128
    width = 14
    A0, B0, BIT, MSG = 0, 6, 12, 13
    S = 6  # Rescue128 state width

    def __init__(self, trace_length: int, messages, pub_keys):
        self.trace_length = trace_length
        self.messages = list(messages)
        self.pub_keys = [list(pk) for pk in pub_keys]
        n = len(self.messages)
        if trace_length % (r128.CYCLE_LENGTH * n):
            raise ValueError("the trace does not split into signature blocks")
        self.block = trace_length // n
        c = r128.CYCLE_LENGTH
        self.degrees = ([with_cycles(5, [c])] * self.S + [with_cycles(5, [c, self.block, self.block])] * self.S
                        + [with_cycles(2, [c]), with_cycles(1, [c, self.block])])

    def pub_elements(self):
        out = []
        for m, pk in zip(self.messages, self.pub_keys):
            out += [m, *pk]
        return out

    def assertions(self):
        last, n = self.block - 1, len(self.messages)
        out = [Assertion(self.A0 + i, 0, SINGLE, [0]) for i in range(2, self.S)]
        out += [Assertion(self.B0 + i, 0, SINGLE, [0]) for i in range(self.S)]
        out.append(Assertion(self.MSG, 0, SINGLE, [0]))
        bound = ((self.B0, [pk[0] for pk in self.pub_keys]),
                 (self.B0 + 1, [pk[1] for pk in self.pub_keys]),
                 (self.MSG, self.messages))
        for column, values in bound:
            stride = SINGLE if n == 1 else self.block
            out.append(Assertion(column, last, stride, values))
        return out

    def periodic_columns(self):
        c, r = r128.CYCLE_LENGTH, r128.NUM_ROUNDS
        cols = [[1] * r + [0] * (c - r)]
        cols += [[r128.ARK[i][j] for i in range(c)] for j in range(2 * self.S)]
        cols.append([1] * r + [0] * (self.block - r))
        cols.append([0] * (self.block - 1) + [1])
        return cols

    def _round(self, cur, nxt, ark, P):
        """(INV_MDS(next - ARK[6:]))^5 - (MDS(cur^5) + ARK[:6])."""
        step1 = _mds(r128.MDS, [pow(c, r128.ALPHA, P) for c in cur], P)
        step1 = [(s + a) % P for s, a in zip(step1, ark[:self.S])]
        step2 = _mds(r128.INV_MDS, [(n - a) % P for n, a in zip(nxt, ark[self.S:])], P)
        return [(pow(s2, r128.ALPHA, P) - s1) % P for s1, s2 in zip(step1, step2)]

    def transition(self, cur, nxt, periodic):
        P = self.field.P
        S, A0, B0, BIT, MSG = self.S, self.A0, self.B0, self.BIT, self.MSG
        flag, ark = periodic[0], periodic[1:1 + 2 * S]
        first7, reset = periodic[1 + 2 * S], periodic[2 + 2 * S]
        b = cur[BIT]
        round_a = self._round(cur[A0:A0 + S], nxt[A0:A0 + S], ark, P)
        round_b = self._round(cur[B0:B0 + S], nxt[B0:B0 + S], ark, P)
        # absorbing rows: A's rate is free, its capacity 0; B adds A's digest
        # to rate slots 0..1 for bit 0 and 2..3 for bit 1, capacity carries
        absorb_a = [0, 0] + [nxt[A0 + i] for i in range(2, S)]
        absorb_b = [0] * S
        for i in range(2):
            absorb_b[i] = (1 - b) * (nxt[B0 + i] - cur[B0 + i] - cur[A0 + i])
            absorb_b[2 + i] = b * (nxt[B0 + 2 + i] - cur[B0 + 2 + i] - cur[A0 + i])
        for i in range(4, S):
            absorb_b[i] = nxt[B0 + i] - cur[B0 + i]
        out = [(flag * round_a[i] + (1 - flag) * absorb_a[i]) % P for i in range(S)]
        for i in range(S):
            regular = flag * round_b[i] + (1 - flag) * absorb_b[i]
            in_block = first7 * (nxt[B0 + i] - cur[B0 + i]) + (1 - first7) * regular
            out.append((reset * nxt[B0 + i] + (1 - reset) * in_block) % P)
        out.append((1 - flag) * b * (1 - b) % P)
        accumulate = nxt[MSG] - 2 * cur[MSG] - b
        in_block_m = flag * (nxt[MSG] - cur[MSG]) + (1 - flag) * accumulate
        out.append((reset * nxt[MSG] + (1 - reset) * in_block_m) % P)
        return out


AIRS = {"rescue_chain": RescueChain, "lamport_agg": LamportAgg}


def rescue128_digest(elements):
    """Rescue128 sponge over rate-4 blocks, no padding: the 2-element digest
    that the Lamport+ wallet hashes each secret and each public key with."""
    P, S = F128.P, r128.STATE_WIDTH
    state = [0] * S
    i = 0

    def permute(state):
        for r in range(r128.NUM_ROUNDS):
            ark = r128.ARK[r % r128.CYCLE_LENGTH]
            state = _mds(r128.MDS, [pow(x, r128.ALPHA, P) for x in state], P)
            state = [(x + k) % P for x, k in zip(state, ark[:S])]
            state = _mds(r128.MDS, [pow(x, r128.INV_ALPHA, P) for x in state], P)
            state = [(x + k) % P for x, k in zip(state, ark[S:])]
        return state

    for e in elements:
        state[i] = (state[i] + e) % P
        i += 1
        if i == r128.RATE_WIDTH:
            state = permute(state)
            i = 0
    if i:
        state = permute(state)
    return state[:2]
