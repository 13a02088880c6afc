# Copy of starkpack_winterfell_tpu/prover/channel.py; cut: nothing; the batched BLAKE3 nonce search runs on tensors (device of the prove), the Rescue hashers' search on the sponge kernel (CUDA) or batches of their host sponge (CPU), SHA3's one nonce at a time.
"""Prover-side Fiat-Shamir channel — equivalent of prover/src/channel.rs.

The exact transcript order (SURVEY.md §3.1) is driven from here; every
draw/reseed mirrors the reference line-for-line:
  seed(ctx0 ++ all pub inputs) -> reseed(main root) -> [aux rands, reseed(aux
  root)]* -> n x constraint coeffs -> final_coeff -> reseed(constraint root)
  -> z -> per-trace reseed(H(ood states)) -> reseed(H(ood evals)) -> deep
  coeffs -> [reseed(layer root), alpha]* -> reseed_with_int(nonce) -> query
  positions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..air.proof import Commitments, Context, OodFrame, StarkProof
from ..crypto.random_coin import RandomCoin
from ..ops import blake3 as b3

# nonces a launch of the sponge kernel's proof-of-work search tries: at
# grinding 16 one launch finds a nonce with probability 1 - 1/e
NONCE_BATCH_CARD = 1 << 16


class ProverChannel:
    def __init__(self, n: int, airs, pub_inputs_elements_vec, hasher, ext_deg: int,
                 field=None, device="cpu"):
        assert n == len(airs) == len(pub_inputs_elements_vec)
        self.airs = airs
        self.hasher = hasher
        self.ext_deg = ext_deg
        if field is None:
            from ..math.fieldspec import GL64_SPEC as field
        self.field = field
        self.contexts = [
            Context.new(air.trace_info(), air.options(), field) for air in airs
        ]
        seed_elements = list(self.contexts[0].to_elements())
        for pub_elements in pub_inputs_elements_vec:
            seed_elements.extend(pub_elements)
        self.public_coin = RandomCoin(hasher, seed_elements, field=field)
        self.commitments = Commitments()
        self.ood_frames = [OodFrame() for _ in range(n)]
        self.pow_nonce = 0
        self.device = device  # where the batched proof-of-work search runs

    # -- commitments ---------------------------------------------------------

    def commit_trace(self, trace_root: bytes):
        self.commitments.add(trace_root)
        self.public_coin.reseed(trace_root)

    def commit_constraints(self, constraint_root: bytes):
        self.commitments.add(constraint_root)
        self.public_coin.reseed(constraint_root)

    def commit_fri_layer(self, layer_root: bytes):
        self.commitments.add(layer_root)
        self.public_coin.reseed(layer_root)

    # -- ood frames ----------------------------------------------------------

    def send_ood_trace_states(self, trace_states_vec):
        """channel.rs:108-116 — reseed once per trace with the interleaved
        states."""
        for trace_states, ood_frame in zip(trace_states_vec, self.ood_frames):
            result = ood_frame.set_trace_states(trace_states, self.field)
            self.public_coin.reseed(
                self.hasher.hash_elements(result, self.field.ELEMENT_BYTES)
            )

    def send_ood_constraint_evaluations(self, evaluations):
        """channel.rs:120-125 — same evals into every frame, reseed once."""
        for ood_frame in self.ood_frames:
            ood_frame.set_constraint_evaluations(evaluations, self.field)
        self.public_coin.reseed(
            self.hasher.hash_elements(evaluations, self.field.ELEMENT_BYTES)
        )

    # -- draws ---------------------------------------------------------------

    def get_aux_trace_segment_rand_elements(self, aux_segment_idx: int):
        return self.airs[0].get_aux_trace_segment_random_elements(
            aux_segment_idx, self.public_coin, self.ext_deg
        )

    def get_constraint_composition_coeffs(self):
        return self.airs[0].get_constraint_composition_coefficients(
            self.public_coin, self.ext_deg
        )

    def get_final_polynomial_coeffs(self):
        return self.public_coin.draw(self.ext_deg)

    def get_ood_point(self):
        return self.public_coin.draw(self.ext_deg)

    def get_deep_composition_coeffs(self):
        return self.airs[0].get_deep_composition_coefficients(
            self.airs, self.public_coin, self.ext_deg
        )

    def draw_fri_alpha(self):
        return self.public_coin.draw(self.ext_deg)

    def get_query_positions(self):
        num_queries = self.contexts[0].options.num_queries
        lde_domain_size = self.contexts[0].lde_domain_size()
        return self.public_coin.draw_integers(num_queries, lde_domain_size)

    def grind_query_seed(self):
        """channel.rs:182-198 — serial semantics: the LOWEST valid nonce
        (deterministic), found with a vectorized batched search."""
        grinding_factor = self.contexts[0].options.grinding_factor
        nonce = self._find_nonce(grinding_factor)
        self.pow_nonce = nonce
        self.public_coin.reseed_with_int(nonce)

    def _find_nonce(self, grinding_factor: int) -> int:
        """The lowest nonce >= 1 whose ``merge_with_int(seed, nonce)`` has
        ``grinding_factor`` trailing zero bits in its first 8 digest bytes
        read little-endian (channel.rs:182-198, serial semantics).  The
        seed is one digest of the transcript hasher: 32 bytes, or 24
        (BLAKE3-192) or 31 (Rp62_248).  The nonces are tried in ascending
        blocks: BLAKE3 as tensors on the prove's device; a hasher with
        ``first_merge_with_int`` (Rp64_256, Rp62_248) as one launch of the
        sponge kernel's search on a CUDA device (NONCE_BATCH_CARD nonces),
        one batch of its C sponge (4096) on the CPU; any other (SHA3-256)
        one ``merge_with_int`` at a time."""
        if grinding_factor == 0:
            return 1  # (1..).find(|_| trailing_zeros >= 0) == 1
        seed = self.public_coin.seed
        mask = (1 << grinding_factor) - 1
        first = getattr(self.hasher, "first_merge_with_int", None)
        if first is not None:
            batch = NONCE_BATCH_CARD if torch.device(self.device).type == "cuda" else 1 << 12
            nonce = 1
            while (found := first(seed, nonce, batch, grinding_factor, self.device)) is None:
                nonce += batch
            return found
        if not self.hasher.NAME.startswith("blake3"):
            nonce = 1
            while int.from_bytes(self.hasher.merge_with_int(seed, nonce)[:8], "little") & mask:
                nonce += 1
            return nonce
        # digest_from_bytes zero-pads the words of a 24-byte seed
        seed_words = torch.from_numpy(
            np.asarray(self.hasher.digest_from_bytes(seed)).astype(np.int64)
        ).to(self.device)
        batch = 1 << 14
        seeds = seed_words.reshape(1, 8).expand(batch, 8)
        start = 1
        while True:
            nonces = torch.arange(start, start + batch, dtype=torch.int64,
                                  device=self.device)
            digests = _merge_with_int_batch(seeds, nonces, self.hasher.DIGEST_BYTES)
            # trailing zeros of the first 8 digest bytes read little-endian
            head = digests[:, 0] | (digests[:, 1] << 32)
            ok = torch.nonzero((head & mask) == 0)
            if ok.numel():
                return int(nonces[ok[0, 0]])
            start += batch

    # -- assembly ------------------------------------------------------------

    def build_proof(self, trace_queries, constraint_queries, fri_proof) -> StarkProof:
        return StarkProof(
            self.contexts,
            self.commitments,
            trace_queries,
            constraint_queries,
            self.ood_frames,
            fri_proof,
            self.pow_nonce,
        )


def _merge_with_int_batch(seed_words, nonces, digest_bytes: int = 32):
    """Vectorized hash(seed_digest_bytes || nonce_le) over a batch of
    nonces — one BLAKE3 compress per row, for the 32-byte and the truncated
    24-byte digests.  seed_words: (batch, 8) word tensor; nonces: (batch,)
    int64 tensor of values below 2^63."""
    lo = nonces & 0xFFFFFFFF
    hi = (nonces >> 32) & 0xFFFFFFFF
    if digest_bytes == 32:
        return b3.merge_with_int(seed_words, (lo, hi))
    sw = digest_bytes // 4  # seed words actually hashed
    z = torch.zeros_like(lo)
    blk = [seed_words[:, i] for i in range(sw)] + [lo, hi] + [z] * (16 - sw - 2)
    out = b3.compress([z + v for v in b3.IV], blk, 0, digest_bytes + 8,
                      b3.CHUNK_START | b3.CHUNK_END | b3.ROOT)
    return torch.stack(out, dim=-1)
