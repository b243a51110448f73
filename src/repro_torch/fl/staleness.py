"""Staleness-weight policies for the async runtimes (DESIGN.md §9-§10).

The port's copy of ``repro/fl/staleness.py``, equal to it but for its
imports (the port imports nothing of the JAX package);
``tests/test_torch_core.py`` holds the two copies equal.

A commit of a contribution dispatched at round ``r`` and applied at
round ``t`` carries staleness ``s = t - r``; a policy maps ``s`` to the
weight ``w(s) ∈ (0, 1]`` applied to the compressed increment (both
``g_i`` and ``g``, preserving the estimator invariant — the weighting
semantics live in the commit, not here).  One policy instance is
created per run and is *stateful*: :meth:`observe` feeds it the
realized staleness of every commit, which is what makes the
delay-adaptive variant possible while keeping replays deterministic
(the weight sequence is a pure function of the commit sequence).

Policies (:func:`make_staleness`):

* ``power``    — the fixed FedBuff-style power law
  ``w(s) = (1 + s)^-rho``; ignores observations.
* ``adaptive`` — delay-adaptive: ``w(s) = ((1 + s) / (1 + s̄))^-rho``
  clipped to ≤ 1, where ``s̄`` is the running mean of *observed* commit
  staleness.  A commit is discounted for being unusually stale
  relative to the fleet the server actually sees, not against an
  absolute scale — on a uniformly slow fleet the fixed power law
  over-discounts every commit, while the adaptive weight recenters at
  w(s̄) = 1.  In the zero-jitter sync limit every ``s`` is 0, so
  ``w ≡ 1`` and the sync-limit parity contract is untouched.

Shared by :class:`repro.fl.server.AsyncDashaServer` (per-client jobs)
and :class:`repro.fl.cohorts.CohortScheduler` (per-cohort commits).
"""
from __future__ import annotations

import dataclasses


class StalenessPolicy:
    """Maps observed staleness to commit weights; stateful per run."""

    def weight(self, s: int) -> float:
        raise NotImplementedError

    def observe(self, s: int) -> None:
        """Record the staleness of a commit that was just applied.
        Called AFTER :meth:`weight` for the same commit, so a commit's
        own staleness never influences its own weight."""

    @property
    def mean_observed(self) -> float:
        return 0.0


@dataclasses.dataclass
class PowerLawStaleness(StalenessPolicy):
    """``w(s) = (1 + s)^-exponent`` (FedBuff uses exponent 1/2)."""

    exponent: float = 0.5

    def weight(self, s: int) -> float:
        return float((1.0 + s) ** -self.exponent)


@dataclasses.dataclass
class AdaptiveStaleness(StalenessPolicy):
    """Delay-adaptive weights from observed per-commit staleness:
    ``w(s) = min(1, ((1 + s) / (1 + s̄))^-exponent)`` with ``s̄`` the
    running mean of everything :meth:`observe` has seen this run."""

    exponent: float = 0.5
    _count: int = dataclasses.field(default=0, repr=False)
    _total: float = dataclasses.field(default=0.0, repr=False)

    def weight(self, s: int) -> float:
        if s <= 0:
            return 1.0
        w = ((1.0 + s) / (1.0 + self.mean_observed)) ** -self.exponent
        return float(min(1.0, w))

    def observe(self, s: int) -> None:
        self._count += 1
        self._total += float(s)

    @property
    def mean_observed(self) -> float:
        return self._total / self._count if self._count else 0.0


def compose_hops(dispatch_round: int, hop_rounds, commit_round: int):
    """Decompose end-to-end staleness into per-hop increments.

    A contribution dispatched at round ``r`` traverses the tree and is
    stamped with the (root-clock) round at which each tier flushes it;
    ``hop_rounds`` is that ascending stamp sequence and ``commit_round``
    the root commit.  Returns ``(total, increments)`` where
    ``increments[k]`` is the staleness picked up on hop ``k`` and the
    telescoping identity ``sum(increments) == commit_round -
    dispatch_round == total`` holds by construction — the root weights a
    contribution by ``w(total)``, so composing staleness across hops is
    exactly the flat-server semantics (tests/test_tree_invariants.py
    property b).
    """
    points = [int(dispatch_round), *[int(h) for h in hop_rounds],
              int(commit_round)]
    if any(b < a for a, b in zip(points, points[1:])):
        raise ValueError(f"hop stamps must be non-decreasing: {points}")
    increments = tuple(b - a for a, b in zip(points, points[1:]))
    return int(commit_round) - int(dispatch_round), increments


STALENESS_POLICIES = ("power", "adaptive")


def make_staleness(name: str, *, exponent: float = 0.5) -> StalenessPolicy:
    """A FRESH policy instance (stateful — never share across runs)."""
    if name == "power":
        return PowerLawStaleness(exponent=exponent)
    if name == "adaptive":
        return AdaptiveStaleness(exponent=exponent)
    raise ValueError(f"unknown staleness policy {name!r}; choose from "
                     f"{list(STALENESS_POLICIES)}")
