"""Per-client latency models for the async federated runtime.

The port's copy of ``repro/fl/latency.py``, equal to it but for its
imports (the port imports nothing of the JAX package);
``tests/test_torch_core.py`` holds the two copies equal.

A model prices one dispatched job in *virtual seconds*:

    compute_s  — local gradient/compression work,
    network_s  — ``uplink_bits / bandwidth``, with the bits coming from
                 the engine's wire accounting (``Compressor.wire_bits``,
                 which delegates to :func:`repro.core.variants.
                 message_bits` for the sharded wire formats) — so the
                 communication savings the paper claims show up as
                 virtual wall-clock, not just counters,
    dropped    — the client accepted the job but never delivers
                 (network partition / preemption); it rejoins the idle
                 pool ``rejoin_s`` after its compute would have ended.

Determinism: every draw comes from ``np.random.default_rng((seed,
client, dispatch_idx))`` — keyed by *position*, not call order — so a
replay with the same seed prices every job identically regardless of
event interleaving (the replay contract of DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class JobTiming:
    compute_s: float
    network_s: float
    dropped: bool
    rejoin_s: float


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Base: constant compute, optional bandwidth and dropout — the
    zero-jitter sync limit when left at defaults."""

    compute_s: float = 1.0
    bandwidth_bps: Optional[float] = None   # None => network time 0
    dropout: float = 0.0                    # Prob(job never arrives)
    rejoin_s: float = 5.0                   # idle-again delay after a drop
    seed: int = 0

    def _rng(self, client: int, dispatch_idx: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, int(client), int(dispatch_idx)))

    # -- hooks subclasses override ------------------------------------
    def _compute(self, client: int, rng: np.random.Generator) -> float:
        return self.compute_s

    def _bandwidth(self, client: int) -> Optional[float]:
        return self.bandwidth_bps

    # -- the API the event loop consumes ------------------------------
    def job(self, client: int, dispatch_idx: int,
            uplink_bits: float) -> JobTiming:
        rng = self._rng(client, dispatch_idx)
        compute = float(self._compute(client, rng))
        bw = self._bandwidth(client)
        network = float(uplink_bits / bw) if bw else 0.0
        dropped = bool(self.dropout > 0.0
                       and rng.random() < self.dropout)
        return JobTiming(compute_s=compute, network_s=network,
                         dropped=dropped, rejoin_s=self.rejoin_s)


@dataclasses.dataclass(frozen=True)
class ConstantLatency(LatencyModel):
    """Alias for the base model: every client takes exactly
    ``compute_s`` — the sync-limit anchor of the parity tests."""


@dataclasses.dataclass(frozen=True)
class LognormalLatency(LatencyModel):
    """Heterogeneous fleet: client ``i``'s speed is a *fixed* lognormal
    multiplier (slow phones stay slow), and each dispatch adds lognormal
    jitter on top.  ``sigma`` controls per-dispatch jitter,
    ``client_sigma`` the persistent spread across the fleet,
    ``bandwidth_sigma`` the spread of per-client uplink bandwidth."""

    sigma: float = 0.5
    client_sigma: float = 0.5
    bandwidth_sigma: float = 0.0

    # Salts live far above any dispatch index, so per-client persistent
    # draws never collide with per-dispatch streams.
    _SALT_COMPUTE = 2 ** 62
    _SALT_BANDWIDTH = 2 ** 62 + 1

    def _client_scale(self, client: int, sigma: float,
                      salt: int) -> float:
        rng = np.random.default_rng((self.seed, int(client), salt))
        return float(np.exp(sigma * rng.standard_normal()))

    def _compute(self, client: int, rng: np.random.Generator) -> float:
        persistent = self._client_scale(client, self.client_sigma,
                                        salt=self._SALT_COMPUTE)
        jitter = float(np.exp(self.sigma * rng.standard_normal()
                              - 0.5 * self.sigma ** 2))
        return self.compute_s * persistent * jitter

    def _bandwidth(self, client: int) -> Optional[float]:
        if self.bandwidth_bps is None:
            return None
        if self.bandwidth_sigma == 0.0:
            return self.bandwidth_bps
        return self.bandwidth_bps / self._client_scale(
            client, self.bandwidth_sigma, salt=self._SALT_BANDWIDTH)


class PoissonAvailability:
    """Client-availability windows beyond the latency-model-implied
    arrival process (the ROADMAP-deferred extension): per client,
    *outages* arrive as a Poisson process of ``rate`` events per
    virtual second (exponential inter-arrival gaps measured from the
    end of the previous outage) and last ``Exp(off_mean)`` seconds.
    A client is available whenever it is not inside an outage window.

    Determinism: client ``i``'s window sequence is a pure function of
    ``(seed, i)`` — windows are generated by one positional-keyed rng
    per client, extended lazily and monotonically, so replays see
    identical availability regardless of when/at what times the
    scheduler queries (:mod:`repro.fl` replay contract).

    ``rate=0`` means always available (the identity the sync-limit
    parity tests rely on)."""

    def __init__(self, rate: float = 0.0, off_mean: float = 5.0,
                 seed: int = 0):
        if rate < 0 or off_mean <= 0:
            raise ValueError("need rate >= 0 and off_mean > 0")
        self.rate = float(rate)
        self.off_mean = float(off_mean)
        self.seed = int(seed)
        self._rngs: dict = {}
        self._windows: dict = {}   # client -> list[(start, end)], sorted

    _SALT = 2 ** 62 + 2   # clear of the LognormalLatency salts

    def _extend(self, client: int, t: float) -> list:
        wins = self._windows.setdefault(client, [])
        if self.rate == 0.0:
            return wins
        rng = self._rngs.get(client)
        if rng is None:
            rng = self._rngs[client] = np.random.default_rng(
                (self.seed, int(client), self._SALT))
        horizon = wins[-1][1] if wins else 0.0
        while horizon <= t:
            gap = rng.exponential(1.0 / self.rate)
            dur = rng.exponential(self.off_mean)
            wins.append((horizon + gap, horizon + gap + dur))
            horizon = wins[-1][1]
        return wins

    def available(self, client: int, t: float) -> bool:
        for start, end in self._extend(client, float(t)):
            if start <= t < end:
                return False
            if start > t:
                break
        return True

    def mask(self, n: int, t: float) -> np.ndarray:
        """(n,) bool availability mask at virtual time ``t``."""
        return np.asarray([self.available(i, t) for i in range(n)])


def make_latency(name: str, **kwargs) -> LatencyModel:
    if name == "constant":
        return ConstantLatency(**kwargs)
    if name == "lognormal":
        return LognormalLatency(**kwargs)
    raise ValueError(f"unknown latency model {name!r}; "
                     "choose from ['constant', 'lognormal']")
