"""Typed metrics registry + jsonl sink + Prometheus text exposition.

The port's copy of ``repro/obs/metrics.py``, equal to it but for its
imports (the port imports nothing of the JAX package);
``tests/test_torch_core.py`` holds the two copies equal.

Naming scheme (DESIGN.md §13): dotted, ``<subsystem>.<metric>[.<tag>]``

- ``train.*``   — sync/cohort trainer (``train.bits_sent``,
  ``train.oracle_calls``, ``train.steps``, ``train.loss``)
- ``fleet.*``   — hierarchical tree + async server
  (``fleet.tier_bits``, ``fleet.tier_bits.hop<k>``, ``fleet.committed``)
- ``serving.*`` — decode engines (``serving.decode_tokens``,
  ``serving.ttft_p50`` in serve-pass ticks, ``serving.latency_p95``)
- ``pool.*``    — KV page pool (``pool.pages_live``, ``pool.cow_copies``)
- ``obs.*``     — the observability layer itself
  (``obs.monitor_checks``, ``obs.monitor_failures``)

All metric types are float-valued.  Counters only accumulate
(``inc``), gauges hold the latest value (``set``), histograms record
observations and expose count/sum/min/max/percentiles.  The registry
is get-or-create by name with a kind check, so publishing sites never
coordinate.  ``snapshot()``/``write_snapshot()`` produce the JSON
artifact validated by obs/validate.py; ``to_prometheus()`` renders the
text exposition format.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, IO, List, Mapping, Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "JsonlSink",
    "get_registry", "set_registry", "counter", "gauge", "histogram",
    "publish_serving", "publish_fleet",
]

_HIST_CAP = 100_000    # raw observations kept for exact percentiles


class Counter:
    """Monotonically accumulating value."""
    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += float(amount)

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Latest-value metric."""
    kind = "gauge"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += float(amount)

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Observation histogram with exact percentiles (capped reservoir)."""
    kind = "histogram"
    __slots__ = ("name", "count", "sum", "min", "max", "_values")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._values: List[float] = []

    def observe(self, value: float, n: int = 1) -> None:
        v = float(value)
        self.count += n
        self.sum += v * n
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        room = _HIST_CAP - len(self._values)
        if room > 0:
            self._values.extend([v] * min(n, room))

    def percentile(self, q: float) -> Optional[float]:
        if not self._values:
            return None
        vals = sorted(self._values)
        idx = min(int(round(q / 100.0 * (len(vals) - 1))), len(vals) - 1)
        return vals[idx]

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p95": self.percentile(95)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Get-or-create metric store; kind mismatches are errors."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, kind: str):
        m = self._metrics.get(name)
        if m is None:
            m = _KINDS[kind](name)
            self._metrics[name] = m
        elif m.kind != kind:
            raise TypeError(f"metric {name!r} is a {m.kind}, not a {kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        self._metrics.clear()

    # -- export -----------------------------------------------------
    def snapshot(self, extra: Optional[Mapping[str, Any]] = None
                 ) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "ts": time.time(),
            "metrics": {name: self._metrics[name].as_dict()
                        for name in self.names()},
        }
        if extra:
            doc.update(extra)
        return doc

    def write_snapshot(self, path: str,
                       extra: Optional[Mapping[str, Any]] = None) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(extra), f, indent=1)
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition (dots -> underscores)."""
        lines: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            pname = "repro_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)
            if m.kind == "histogram":
                lines.append(f"# TYPE {pname} summary")
                lines.append(f"{pname}_count {m.count}")
                lines.append(f"{pname}_sum {m.sum}")
                for q in (50, 95):
                    p = m.percentile(q)
                    if p is not None:
                        lines.append(
                            f'{pname}{{quantile="0.{q}"}} {p}')
            else:
                lines.append(f"# TYPE {pname} {m.kind}")
                lines.append(f"{pname} {m.value}")
        return "\n".join(lines) + "\n"


_registry = Registry()


def get_registry() -> Registry:
    return _registry


def set_registry(reg: Registry) -> Registry:
    global _registry
    _registry = reg
    return reg


def counter(name: str) -> Counter:
    return _registry.counter(name)


def gauge(name: str) -> Gauge:
    return _registry.gauge(name)


def histogram(name: str) -> Histogram:
    return _registry.histogram(name)


class JsonlSink:
    """Append-mode jsonl writer with an idempotent ``close()``."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._file: Optional[IO[str]] = open(path, "a")

    def write(self, record: Mapping[str, Any]) -> None:
        if self._file is None:
            raise ValueError(f"JsonlSink({self.path!r}) is closed")
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self) -> None:
        f, self._file = self._file, None
        if f is not None:
            f.close()

    @property
    def closed(self) -> bool:
        return self._file is None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------
# publish helpers: existing engine ledgers -> registry
# ---------------------------------------------------------------------
def publish_serving(engine_metrics: Mapping[str, Any],
                    registry: Optional[Registry] = None) -> None:
    """Publish ``PagedEngine.metrics()`` into ``serving.*`` / ``pool.*``."""
    reg = registry or _registry
    serving_keys = ("clock", "decode_steps", "prefill_forwards",
                    "mixed_passes", "mid_prefill_preemptions",
                    "decode_tokens", "decode_tok_per_s", "requests",
                    "latency_p50", "latency_p95", "ttft_p50", "ttft_p95",
                    "cache_hbm_bytes")
    for k in serving_keys:
        v = engine_metrics.get(k)
        if v is not None:
            reg.gauge(f"serving.{k}").set(float(v))
    for k, v in engine_metrics.items():
        if k.startswith("pool_") and isinstance(v, (int, float)):
            reg.gauge("pool." + k[len("pool_"):]).set(float(v))
    pool = engine_metrics.get("pool")
    if isinstance(pool, Mapping):
        for k, v in pool.items():
            if isinstance(v, (int, float)):
                reg.gauge(f"pool.{k}").set(float(v))


def publish_fleet(result: Any, registry: Optional[Registry] = None) -> None:
    """Publish a ``FleetRunResult``'s ledgers into ``fleet.*``.

    ``fleet.tier_bits`` is the total wire bits summed over every hop —
    by the §12 ledger invariant it equals ``bits_cum[-1]``, which the
    ledger monitor (obs/monitors.py) re-checks at runtime.
    """
    reg = registry or _registry
    tier_bits = [float(b) for b in result.tier_bits]
    reg.gauge("fleet.tier_bits").set(sum(tier_bits))
    for k, b in enumerate(tier_bits):
        reg.gauge(f"fleet.tier_bits.hop{k}").set(b)
    if len(result.bits_cum):
        reg.gauge("fleet.bits_cum").set(float(result.bits_cum[-1]))
        reg.gauge("fleet.root_bits_cum").set(float(result.root_bits_cum[-1]))
        reg.gauge("fleet.virtual_time").set(float(result.time[-1]))
    reg.gauge("fleet.committed").set(float(sum(result.committed)))
    reg.gauge("fleet.dropped").set(float(result.dropped))
    reg.gauge("fleet.discarded_stale").set(float(result.discarded_stale))
    reg.gauge("fleet.forced_flushes").set(float(result.forced_flushes))
    h = reg.histogram("fleet.staleness")
    for s, c in sorted(result.staleness_hist.items()):
        h.observe(float(s), n=int(c))
