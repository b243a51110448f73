"""The single source of wire-format truth (bit accounting).

The port's copy of ``repro/core/wire.py``, kept line for line: the
port imports nothing of the JAX package, and
``tests/test_torch_core.py`` holds the two copies equal.

Every bit the repo reports — compressor ``wire_bits``, the fleet's
uplink payloads, the serving benchmarks — must trace back here: the
communication-complexity tables are the paper's headline claim, and
PR 6/7 both grew local ``32 * nnz``-style math that drifted from the
core model until reconciled.  The ``bit-accounting`` checker
(``repro.analysis``) enforces the discipline mechanically: literal
bit-width arithmetic outside ``core/`` is a finding.

Widths are floats because the complexity curves are analytic counts
(Tables 1-2), not byte-aligned encodings.
"""
from __future__ import annotations

import math

FLOAT_BITS = 32.0
"""Bits per transmitted float value (fp32 wire format)."""

GROUP_HEADER_BITS = 32.0
"""Per aggregated round-group: the dispatch-round id the tree fleet
stamps on each uplink group."""


def index_bits(d: int) -> float:
    """Bits per transmitted coordinate index: ``ceil(log2 d)``."""
    return float(max(1, math.ceil(math.log2(max(d, 2)))))


def payload_bits(nnz: int, d: int,
                 value_bits: float = FLOAT_BITS) -> float:
    """Lossless sparse-or-dense wire size of one aggregated vector:
    whichever of (value, index) pairs or the dense vector is smaller."""
    return float(min(nnz * (value_bits + index_bits(d)),
                     d * value_bits))
