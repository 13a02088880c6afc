# Copy of starkpack_winterfell_tpu/fri/channel.py; cut: nothing (DefaultProverChannel for library-level FRI).
"""Standalone FRI channels — equivalent of fri/src/prover/channel.rs and
fri/src/verifier/channel.rs DefaultProverChannel/DefaultVerifierChannel.
Used for library-level FRI (tests, benches) outside the STARK pipeline."""

from __future__ import annotations

from ..crypto.random_coin import RandomCoin


class DefaultProverChannel:
    def __init__(self, hasher, domain_size: int, num_queries: int, ext_deg: int = 1):
        assert domain_size >= 8 and domain_size & (domain_size - 1) == 0
        assert 0 < num_queries < domain_size
        self.public_coin = RandomCoin(hasher, [])
        self.commitments = []
        self.domain_size = domain_size
        self.num_queries = num_queries
        self.ext_deg = ext_deg

    def commit_fri_layer(self, layer_root: bytes):
        self.commitments.append(layer_root)
        self.public_coin.reseed(layer_root)

    def draw_fri_alpha(self):
        return self.public_coin.draw(self.ext_deg)

    def draw_query_positions(self):
        return self.public_coin.draw_integers(self.num_queries, self.domain_size)

    def layer_commitments(self):
        return list(self.commitments)
