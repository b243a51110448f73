"""Partial-participation samplers (paper Section 2.2, Assumption 8).

The port of ``repro/core/participation.py``.  A sampler draws, per
communication round, a boolean participation mask of shape ``(n,)``
with

    Prob(i participates)            = p_a      for all i,
    Prob(i and j both participate)  = p_aa     for all i != j,

independently across rounds.  Draws come from an explicit
:class:`torch.Generator` and land on its device.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


class ParticipationSampler:
    n: int

    @property
    def p_a(self) -> float:
        raise NotImplementedError

    @property
    def p_aa(self) -> float:
        raise NotImplementedError

    def sample(self, generator: torch.Generator) -> Tensor:
        """-> bool mask of shape (n,) on the generator's device."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SNice(ParticipationSampler):
    """Uniformly choose exactly ``s`` of ``n`` nodes without replacement."""

    n: int
    s: int

    def __post_init__(self):
        if not (1 <= self.s <= self.n):
            raise ValueError(f"need 1 <= s <= n, got s={self.s}, n={self.n}")

    @property
    def p_a(self) -> float:
        return self.s / self.n

    @property
    def p_aa(self) -> float:
        if self.n == 1:
            return 1.0
        return self.s * (self.s - 1) / (self.n * (self.n - 1))

    def sample(self, generator: torch.Generator) -> Tensor:
        perm = torch.randperm(self.n, generator=generator,
                              device=generator.device)
        return perm < self.s


@dataclasses.dataclass(frozen=True)
class Independent(ParticipationSampler):
    """Each node participates independently with probability p."""

    n: int
    p: float

    def __post_init__(self):
        if not (0.0 < self.p <= 1.0):
            raise ValueError(f"need 0 < p <= 1, got {self.p}")

    @property
    def p_a(self) -> float:
        return self.p

    @property
    def p_aa(self) -> float:
        return self.p * self.p

    def sample(self, generator: torch.Generator) -> Tensor:
        u = torch.rand(self.n, generator=generator, device=generator.device)
        return u < self.p


@dataclasses.dataclass(frozen=True)
class FullParticipation(ParticipationSampler):
    """p_a = p_aa = 1: every node every round (the DASHA setting)."""

    n: int

    @property
    def p_a(self) -> float:
        return 1.0

    @property
    def p_aa(self) -> float:
        return 1.0

    def sample(self, generator: torch.Generator) -> Tensor:
        return torch.ones(self.n, dtype=torch.bool, device=generator.device)


@dataclasses.dataclass(frozen=True)
class EdgeSNice(ParticipationSampler):
    """Per-edge s-nice over a contiguous edge partition, the fleet's
    sampler (``repro/core/participation.py:158``).

    Clients are split into contiguous per-edge chunks (``bounds``, as
    :func:`repro_torch.fl.client_store.edge_partition` makes them); each
    round every edge picks exactly ``s`` of its clients uniformly without
    replacement.  ``p_a`` is the fleet mean ``E*s/n``; ``p_aa`` is the
    largest pairwise rate ``(s / min_chunk)**2``, the conservative choice
    for the step-size bounds.  The reference seeds per-edge numpy
    generators from one JAX draw; here each edge's pick is one
    ``randperm`` from the given ``torch.Generator``, so the two agree in
    distribution, not in bits.
    """

    bounds: tuple
    s: int

    def __post_init__(self):
        b = tuple(int(x) for x in self.bounds)
        object.__setattr__(self, "bounds", b)
        if len(b) < 2 or b[0] != 0 or any(y <= x for x, y in
                                          zip(b, b[1:])):
            raise ValueError(f"bounds must be ascending from 0: {b}")
        smallest = min(y - x for x, y in zip(b, b[1:]))
        if not (1 <= self.s <= smallest):
            raise ValueError(f"need 1 <= s <= min edge size "
                             f"({smallest}), got s={self.s}")

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.bounds[-1]

    @property
    def num_edges(self) -> int:
        return len(self.bounds) - 1

    @property
    def p_a(self) -> float:
        return self.num_edges * self.s / self.n

    @property
    def p_aa(self) -> float:
        smallest = min(y - x for x, y in zip(self.bounds, self.bounds[1:]))
        if smallest == 1:
            return 1.0
        return (self.s / smallest) ** 2

    def sample(self, generator: torch.Generator) -> Tensor:
        mask = torch.zeros(self.n, dtype=torch.bool, device=generator.device)
        for lo, hi in zip(self.bounds, self.bounds[1:]):
            perm = torch.randperm(hi - lo, generator=generator,
                                  device=generator.device)
            mask[lo:hi] = perm < self.s
        return mask


def make_sampler(name: str, n: int, **kwargs) -> ParticipationSampler:
    if name == "s_nice":
        return SNice(n=n, s=kwargs["s"])
    if name == "independent":
        return Independent(n=n, p=kwargs["p"])
    if name == "full":
        return FullParticipation(n=n)
    if name == "edge_s_nice":
        return EdgeSNice(bounds=tuple(kwargs["bounds"]), s=kwargs["s"])
    raise ValueError(f"unknown sampler {name!r}")
