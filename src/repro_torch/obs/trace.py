"""Span tracing with dual clocks and a Chrome trace-event exporter.

The port's copy of ``repro/obs/trace.py``, equal to it but for its
imports (the port imports nothing of the JAX package);
``tests/test_torch_core.py`` holds the two copies equal.

Design (DESIGN.md §13):

- **Spans** are nestable timed regions opened with :func:`span` (a
  context manager) or the :func:`traced` decorator.  Each span records
  wall time from ``time.perf_counter`` relative to the tracer's origin.
- **Dual clocks.**  The FL runtimes are event-driven simulations with a
  *virtual* clock (seconds of simulated time).  A runtime publishes its
  clock via :func:`set_virtual_time`; while a virtual time is known,
  every span/instant/counter is emitted twice — once on the wall-clock
  process (pid 1) and once on the virtual-clock process (pid 2) with
  ``ts = virtual_seconds * 1e6``.  Virtual-clock events are
  replay-deterministic: the same seed produces byte-identical virtual
  tracks, whatever the host machine is doing.
- **Flow links.**  :func:`flow_start` / :func:`flow_step` /
  :func:`flow_end` emit Chrome flow events (``ph`` s/t/f sharing an
  ``id``), which Perfetto renders as causality arrows between the
  enclosing slices.  The FL runtimes thread a flow id per contribution
  (client dispatch → edge flush → root commit) so a committed round can
  be walked back to the exact client/hop chain that bounded it — the
  input the critical-path engine in ``obs/analyze`` consumes.
- **Disabled fast path.**  With no tracer installed the module-level
  helpers return a shared no-op span / return immediately — no
  allocation, no branching beyond one global load — so instrumentation
  can stay unconditional on hot paths (benchmarks/bench_obs.py asserts
  the cost is < 3% of a fused serve pass).
- **Bounded memory.**  The event buffer is capped (``max_events``,
  default 1e6).  Once full, *new* events are dropped — drop-newest, so
  the retained prefix stays a consistent trace with no dangling flow
  arrows into the void of evicted history — and counted in
  ``Tracer.dropped``, mirrored to the ``obs.dropped_events`` registry
  counter and the export metadata.  Multi-hour fleet runs therefore
  plateau at the cap instead of growing without bound.
- **Export** is the Chrome trace-event JSON format (``"traceEvents"``
  list of ``ph`` X/i/C/M/s/t/f events, microsecond timestamps),
  loadable in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``.

The module is stdlib-only.  :func:`kernel_scope` lazily imports torch
to wrap kernel launch sites in ``torch.profiler.record_function`` so
kernels show up named in ``torch.profiler`` traces; it degrades to a
no-op when torch is absent.  It is the one function of this copy whose
body differs from the original's (``jax.named_scope`` there).

Event appends are plain list appends (atomic under CPython); the
runtimes instrumented here are single-threaded per process.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Tracer", "configure", "install", "uninstall", "get_tracer",
    "active", "span", "instant", "counter", "set_virtual_time",
    "clear_virtual_time", "flow_start", "flow_step", "flow_end",
    "traced", "kernel_scope", "export",
]

WALL_PID = 1      # wall-clock process in the exported trace
VIRTUAL_PID = 2   # virtual-clock (simulator) process

# Event-buffer cap (satellite: bounded tracer memory).  Generous — a
# traced fleet smoke is ~1e3 events — but finite: at ~200 bytes/event
# the worst case is ~200 MB, not an unbounded multi-hour leak.
DEFAULT_MAX_EVENTS = 1_000_000


class _NullSpan:
    """Shared no-op span returned when tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """A single open span; created via :meth:`Tracer.span`."""
    __slots__ = ("_tracer", "name", "cat", "track", "args", "_t0", "_v0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 track: Optional[str], args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self._t0 = 0.0
        self._v0: Optional[float] = None

    def set(self, **args):
        """Attach/overwrite span args (shown in the trace viewer)."""
        self.args.update(args)

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._v0 = self._tracer.virtual_now
        return self

    def __exit__(self, *exc):
        self._tracer._finish_span(self)
        return False


class Tracer:
    """Collects trace events; export with :meth:`export_chrome`."""

    def __init__(self, meta: Optional[Dict[str, Any]] = None,
                 max_events: int = DEFAULT_MAX_EVENTS):
        self._origin = time.perf_counter()
        self.virtual_now: Optional[float] = None
        self.events: List[Dict[str, Any]] = []
        self.meta: Dict[str, Any] = dict(meta or {})
        self.max_events = int(max_events)
        self.dropped = 0
        self._drop_counter: Optional[Any] = None
        self._tids: Dict[str, int] = {}

    # -- clocks -----------------------------------------------------
    def wall_us(self) -> float:
        return (time.perf_counter() - self._origin) * 1e6

    def set_virtual_time(self, t: float) -> None:
        self.virtual_now = float(t)

    def clear_virtual_time(self) -> None:
        """Forget the virtual clock: subsequent events (and spans that
        *close* after this) emit on the wall pid only.  Runtimes call
        this on exit so a later run on the same tracer cannot inherit a
        stale simulated clock."""
        self.virtual_now = None

    # -- tracks -----------------------------------------------------
    def _tid(self, track: Optional[str]) -> int:
        name = track or "main"
        tid = self._tids.get(name)
        if tid is None:
            tid = len(self._tids)
            self._tids[name] = tid
        return tid

    # -- emit -------------------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> None:
        """Append one event, honoring the buffer cap (drop-newest)."""
        if len(self.events) >= self.max_events:
            if self.dropped == 0:
                # lazy: keep the hot no-drop path free of the import
                from repro_torch.obs import metrics as _metrics
                self._drop_counter = _metrics.counter("obs.dropped_events")
            self.dropped += 1
            self._drop_counter.inc()
            return
        self.events.append(ev)

    def span(self, name: str, cat: str = "", track: Optional[str] = None,
             **args) -> Span:
        return Span(self, name, cat, track, args)

    def _finish_span(self, sp: Span) -> None:
        t1 = time.perf_counter()
        ts = (sp._t0 - self._origin) * 1e6
        dur = (t1 - sp._t0) * 1e6
        tid = self._tid(sp.track)
        ev: Dict[str, Any] = {"ph": "X", "pid": WALL_PID, "tid": tid,
                              "name": sp.name, "ts": ts, "dur": dur}
        if sp.cat:
            ev["cat"] = sp.cat
        if sp.args:
            ev["args"] = sp.args
        self._emit(ev)
        if sp._v0 is not None and self.virtual_now is not None:
            vts = sp._v0 * 1e6
            # clamp: zero-width virtual spans would be invisible
            vdur = max((self.virtual_now - sp._v0) * 1e6, 1.0)
            vev = dict(ev)
            vev["pid"] = VIRTUAL_PID
            vev["ts"] = vts
            vev["dur"] = vdur
            self._emit(vev)

    def instant(self, name: str, track: Optional[str] = None, **args):
        tid = self._tid(track)
        ev: Dict[str, Any] = {"ph": "i", "pid": WALL_PID, "tid": tid,
                              "name": name, "ts": self.wall_us(), "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)
        if self.virtual_now is not None:
            vev = dict(ev)
            vev["pid"] = VIRTUAL_PID
            vev["ts"] = self.virtual_now * 1e6
            self._emit(vev)

    def counter(self, name: str, value: float, track: Optional[str] = None):
        ev: Dict[str, Any] = {"ph": "C", "pid": WALL_PID,
                              "tid": self._tid(track), "name": name,
                              "ts": self.wall_us(),
                              "args": {"value": float(value)}}
        self._emit(ev)
        if self.virtual_now is not None:
            vev = dict(ev)
            vev["pid"] = VIRTUAL_PID
            vev["ts"] = self.virtual_now * 1e6
            self._emit(vev)

    def _flow(self, ph: str, name: str, flow_id: int,
              track: Optional[str], args: Dict[str, Any]) -> None:
        tid = self._tid(track)
        ev: Dict[str, Any] = {"ph": ph, "pid": WALL_PID, "tid": tid,
                              "name": name, "cat": "flow",
                              "id": int(flow_id), "ts": self.wall_us()}
        if ph == "f":
            ev["bp"] = "e"   # bind to enclosing slice, not the next one
        if args:
            ev["args"] = args
        self._emit(ev)
        if self.virtual_now is not None:
            vev = dict(ev)
            vev["pid"] = VIRTUAL_PID
            vev["ts"] = self.virtual_now * 1e6
            self._emit(vev)

    def flow_start(self, name: str, flow_id: int,
                   track: Optional[str] = None, **args) -> None:
        """Open a flow arrow (ph "s") anchored at the current clocks."""
        self._flow("s", name, flow_id, track, args)

    def flow_step(self, name: str, flow_id: int,
                  track: Optional[str] = None, **args) -> None:
        """Continue a flow (ph "t") through an intermediate hop."""
        self._flow("t", name, flow_id, track, args)

    def flow_end(self, name: str, flow_id: int,
                 track: Optional[str] = None, **args) -> None:
        """Terminate a flow (ph "f", bp "e") at its consuming slice."""
        self._flow("f", name, flow_id, track, args)

    # -- export -----------------------------------------------------
    def _metadata_events(self) -> List[Dict[str, Any]]:
        evs: List[Dict[str, Any]] = [
            {"ph": "M", "pid": WALL_PID, "tid": 0, "name": "process_name",
             "args": {"name": "wall"}},
            {"ph": "M", "pid": VIRTUAL_PID, "tid": 0, "name": "process_name",
             "args": {"name": "virtual"}},
        ]
        for track, tid in self._tids.items():
            for pid in (WALL_PID, VIRTUAL_PID):
                evs.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name", "args": {"name": track}})
        return evs

    def to_chrome(self) -> Dict[str, Any]:
        meta = dict(self.meta)
        if self.dropped:
            meta["dropped_events"] = self.dropped
        return {"traceEvents": self._metadata_events() + self.events,
                "displayTimeUnit": "ms",
                "metadata": meta}

    def export_chrome(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# ---------------------------------------------------------------------
# module-level API (the instrumented code uses only these)
# ---------------------------------------------------------------------
_tracer: Optional[Tracer] = None


def install(tracer: Tracer) -> Tracer:
    global _tracer
    _tracer = tracer
    return tracer


def uninstall() -> Optional[Tracer]:
    global _tracer
    t, _tracer = _tracer, None
    return t


def configure(meta: Optional[Dict[str, Any]] = None,
              max_events: int = DEFAULT_MAX_EVENTS) -> Tracer:
    """Create and install a fresh global tracer."""
    return install(Tracer(meta=meta, max_events=max_events))


def get_tracer() -> Optional[Tracer]:
    return _tracer


def active() -> bool:
    return _tracer is not None


def span(name: str, cat: str = "", track: Optional[str] = None, **args):
    """Open a span on the installed tracer (no-op span when disabled)."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, cat, track, **args)


def instant(name: str, track: Optional[str] = None, **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, track, **args)


def counter(name: str, value: float, track: Optional[str] = None) -> None:
    t = _tracer
    if t is not None:
        t.counter(name, value, track)


def set_virtual_time(t_virtual: float) -> None:
    t = _tracer
    if t is not None:
        t.set_virtual_time(t_virtual)


def clear_virtual_time() -> None:
    t = _tracer
    if t is not None:
        t.clear_virtual_time()


def flow_start(name: str, flow_id: int, track: Optional[str] = None,
               **args) -> None:
    t = _tracer
    if t is not None:
        t.flow_start(name, flow_id, track, **args)


def flow_step(name: str, flow_id: int, track: Optional[str] = None,
              **args) -> None:
    t = _tracer
    if t is not None:
        t.flow_step(name, flow_id, track, **args)


def flow_end(name: str, flow_id: int, track: Optional[str] = None,
             **args) -> None:
    t = _tracer
    if t is not None:
        t.flow_end(name, flow_id, track, **args)


def traced(name: Optional[str] = None, cat: str = "",
           track: Optional[str] = None):
    """Decorator form of :func:`span`."""
    def deco(fn):
        label = name or fn.__qualname__

        def wrapper(*a, **kw):
            with span(label, cat, track):
                return fn(*a, **kw)
        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


def kernel_scope(name: str):
    """Annotate a kernel launch site.

    Returns ``torch.profiler.record_function("repro.kernel.<name>")`` so
    the launch is attributable in ``torch.profiler`` traces.  Degrades
    to a no-op context when torch is unavailable, keeping the obs core
    stdlib-only.
    """
    try:
        import torch
    except Exception:      # pragma: no cover - torch is the port's base
        return _NULL_SPAN
    return torch.profiler.record_function(f"repro.kernel.{name}")


def export(path: str) -> Optional[str]:
    """Export the installed tracer's events to ``path`` (Chrome JSON)."""
    t = _tracer
    if t is None:
        return None
    return t.export_chrome(path)
