"""The statements a cell proves, made from ``--seed`` by the benchmark: one
module a configuration's ``statement`` key names.  Each module's ``build``
draws the inputs, builds the program's traces with the program's host
builders, and returns a ``Pool``."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Statement:
    """One proof's inputs: the program's traces and public inputs, and the
    statement the reference judges the proof against (one dict an
    instance, the benchmark's own inputs with the claims the proof has to
    back)."""

    traces: list
    pub_inputs: list
    reference: list


@dataclass
class Pool:
    prover: object
    air_class: object
    statements: list
    build_s: float
    # name -> (callable returning the count of wrong answers, its limit);
    # run once the window has closed, beside the reference verifier
    checks: dict = field(default_factory=dict)
