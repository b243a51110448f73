"""Synthetic data pipeline (the port's copy of
``repro/data/synthetic.py``; numpy only, so both packages make the same
batches from the same seed).

Deterministic, seeded, infinite streams shaped for the DASHA-PP node
layout: every batch leaf carries a leading ``num_nodes`` dimension,
i.e. tokens are ``(num_nodes, per_node_batch, seq_len)``.

Heterogeneity knob: each node draws from its own unigram distribution
(Zipf with node-specific permutation), giving genuinely different
``f_i`` across nodes — the regime the paper targets.

Only the text frontend is ported: an architecture with an audio or
vision frontend raises (its stub embeddings come with those models).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    num_nodes: int
    vocab_size: int
    zipf_a: float = 1.2
    heterogeneous: bool = True
    seed: int = 0

    @property
    def per_node(self) -> int:
        if self.global_batch % self.num_nodes:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"num_nodes {self.num_nodes}")
        return self.global_batch // self.num_nodes


def _node_unigrams(cfg: DataConfig) -> np.ndarray:
    """(num_nodes, vocab) sampling probabilities."""
    rng = np.random.default_rng(cfg.seed)
    base = 1.0 / np.arange(1, cfg.vocab_size + 1) ** cfg.zipf_a
    base /= base.sum()
    if not cfg.heterogeneous:
        return np.tile(base, (cfg.num_nodes, 1))
    probs = np.empty((cfg.num_nodes, cfg.vocab_size))
    for i in range(cfg.num_nodes):
        probs[i] = base[rng.permutation(cfg.vocab_size)]
    return probs


def token_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"tokens": (n, per_node, T) int32} forever."""
    probs = _node_unigrams(cfg)
    cum = np.cumsum(probs, axis=1)
    rng = np.random.default_rng(cfg.seed + 1)
    n, b, t = cfg.num_nodes, cfg.per_node, cfg.seq_len
    while True:
        u = rng.random((n, b, t))
        toks = np.empty((n, b, t), np.int32)
        for i in range(n):
            toks[i] = np.searchsorted(cum[i], u[i]).astype(np.int32)
        yield {"tokens": toks}


def make_batch(arch: ArchConfig, data: DataConfig, step: int = 0
               ) -> Dict[str, np.ndarray]:
    """One batch of tokens (node-major layout).  Cheap and deterministic —
    used by tests, examples, and the sharded trainer."""
    if arch.frontend is not None:
        raise NotImplementedError(
            f"{arch.name}: the {arch.frontend} frontend's batches come with "
            "its model (ROADMAP queue 1, slice 3 item 7)")
    rng = np.random.default_rng(data.seed + 7919 * step)
    n, b, t = data.num_nodes, data.per_node, data.seq_len
    return {"tokens": rng.integers(0, arch.vocab_size,
                                   (n, b, t)).astype(np.int32)}
