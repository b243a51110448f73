"""Live invariant monitors — test-suite invariants promoted to runtime.

The port's copy of ``repro/obs/monitors.py``, equal to it but for its
imports (the port imports nothing of the JAX package);
``tests/test_torch_core.py`` holds the two copies equal.

Each monitor is a pure check returning a :class:`MonitorResult`;
:func:`emit` turns failures into structured :class:`ObsWarning`
warnings plus trace instants and ``obs.monitor_*`` counters.  The
instrumented runtimes run monitors only in traced runs (tracing off =
zero cost), but the checks are also importable directly by tests and
benches.

Monitors (DESIGN.md §13):

- ``fleet_ledger``      — wire-bits reconciliation:
  ``bits_cum[-1] == tier_bits.sum()`` and the edge/root hops equal the
  message-log total (tests/test_tree_invariants.py property a).
- ``pool_conservation`` — page refcount conservation: held + free ==
  num_pages and no page is both free and referenced (the non-asserting
  twin of ``PagePool.check_invariants``).
- ``hops_monotone``     — every ``CommitRecord``'s hop stamps are
  non-decreasing and ``compose_hops`` telescopes to the stamped
  staleness (tests/test_tree_invariants.py property b).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = [
    "ObsWarning", "MonitorResult", "check_fleet_ledger",
    "check_pool_conservation", "check_hops_monotone", "emit",
    "run_fleet_monitors",
]


class ObsWarning(UserWarning):
    """A live monitor found an invariant violation in a traced run."""


@dataclasses.dataclass(frozen=True)
class MonitorResult:
    monitor: str
    ok: bool
    detail: Dict[str, Any]

    def message(self) -> str:
        kv = " ".join(f"{k}={v}" for k, v in self.detail.items())
        state = "ok" if self.ok else "VIOLATED"
        return f"monitor[{self.monitor}] {state}: {kv}"


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-6)


def check_fleet_ledger(result: Any) -> MonitorResult:
    """``bits_cum[-1] == tier_bits.sum()`` and message log reconciles."""
    tier_total = float(np.sum(np.asarray(result.tier_bits)))
    bits_final = float(result.bits_cum[-1]) if len(result.bits_cum) else 0.0
    # every flushed message eventually arrives (the drain loop runs the
    # heap dry), and each arrival at tier k prices hop k+1 — so hops
    # 1.. must equal the message-log total
    msg_total = sum(float(m.bits) for m in result.message_log)
    upper_total = float(np.sum(np.asarray(result.tier_bits)[1:]))
    ok = _close(tier_total, bits_final) and _close(upper_total, msg_total)
    return MonitorResult("fleet_ledger", ok, {
        "tier_bits_sum": tier_total, "bits_cum_final": bits_final,
        "upper_hops": upper_total, "message_log_bits": msg_total})


def check_pool_conservation(pool: Any) -> MonitorResult:
    """held + free == num_pages; no page both free and referenced."""
    free = set(pool._free)
    held = sum(1 for r in pool._ref if r > 0)
    referenced_free = sorted(p for p in free if pool._ref[p] > 0)
    ok = (held + len(free) == pool.num_pages) and not referenced_free
    return MonitorResult("pool_conservation", ok, {
        "held": held, "free": len(free), "num_pages": pool.num_pages,
        "referenced_free": referenced_free[:10]})


def check_hops_monotone(commit_log: Iterable[Any]) -> MonitorResult:
    """Hop stamps non-decreasing; composed staleness == stamped."""
    from repro_torch.fl.staleness import compose_hops
    checked = 0
    bad: List[Dict[str, Any]] = []
    for rec in commit_log:
        checked += 1
        try:
            total, _ = compose_hops(rec.dispatch_round,
                                    [r for _, r in rec.hops],
                                    rec.commit_round)
        except ValueError as e:
            bad.append({"client": rec.client, "error": str(e)})
            continue
        if total != rec.staleness:
            bad.append({"client": rec.client, "composed": total,
                        "stamped": rec.staleness})
    return MonitorResult("hops_monotone", not bad,
                         {"checked": checked, "violations": bad[:10],
                          "n_violations": len(bad)})


def emit(results: Iterable[MonitorResult],
         registry: Optional[_metrics.Registry] = None,
         warn: bool = True) -> List[MonitorResult]:
    """Record monitor outcomes: counters always, warnings + trace
    instants on violation.  Returns the results for callers to inspect."""
    reg = registry or _metrics.get_registry()
    out = []
    for res in results:
        out.append(res)
        reg.counter("obs.monitor_checks").inc()
        if not res.ok:
            reg.counter("obs.monitor_failures").inc()
            _trace.instant(f"monitor.{res.monitor}", track="monitors",
                           **{k: repr(v) for k, v in res.detail.items()})
            if warn:
                warnings.warn(ObsWarning(res.message()), stacklevel=2)
    return out


def run_fleet_monitors(result: Any,
                       registry: Optional[_metrics.Registry] = None
                       ) -> List[MonitorResult]:
    """The end-of-run monitor set for a ``FleetRunResult``."""
    return emit([check_fleet_ledger(result),
                 check_hops_monotone(result.commit_log)],
                registry=registry)
