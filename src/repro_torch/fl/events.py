"""Deterministic virtual-time event scheduler for the async federated
runtime (DESIGN.md §9).

The port's copy of ``repro/fl/events.py``, equal to it but for its
imports (the port imports nothing of the JAX package);
``tests/test_torch_core.py`` holds the two copies equal.

The simulator advances a *virtual* clock: the server dispatches work,
the latency models (:mod:`repro.fl.latency`) price each job in virtual
seconds, and completion/rejoin events land on a heap keyed by
``(time, seq)`` — ``seq`` is a monotonic counter, so simultaneous
events (the sync limit: zero jitter makes a whole cohort finish at the
same instant) pop in dispatch order and the schedule is a pure
function of the seed.  Every popped event is appended to ``log``;
replay determinism (same seed ⇒ identical log and final iterate) is
asserted by tests/test_fl.py.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

ARRIVAL = "arrival"    # a client's compressed message reaches the server
REJOIN = "rejoin"      # a dropped client becomes available again
# Hierarchical-fleet kinds (fl/tree.py, DESIGN.md §12):
TIER_ARRIVAL = "tier_arrival"   # an aggregator's merged message reaches
#                                 its parent tier (or the root)
DROP = "drop"          # a mid-flight dropout is *detected* at the edge
#                        (the would-be arrival time passes with no data)


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    """One scheduled occurrence.  Ordered by ``(time, seq)`` — the
    dataclass field order — so heap pops are deterministic even under
    ties."""
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    client: int = dataclasses.field(compare=False)
    round_idx: int = dataclasses.field(compare=False)
    # Trace-context propagation (DESIGN.md §15): the flow id of the
    # contribution/message this event carries, or -1 when the event is
    # not part of a causal chain (rejoins, drops, untraced runs).  Not
    # part of the replay-determinism ordering or the log_tuples record.
    flow_id: int = dataclasses.field(compare=False, default=-1)


class EventQueue:
    """Min-heap of :class:`Event` with a monotonic tie-break counter and
    a log of everything popped (the replay record)."""

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = 0
        self.log: List[Event] = []

    def push(self, time: float, kind: str, client: int,
             round_idx: int, flow_id: int = -1) -> Event:
        ev = Event(time=float(time), seq=self._seq, kind=kind,
                   client=client, round_idx=round_idx, flow_id=flow_id)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        ev = heapq.heappop(self._heap)
        self.log.append(ev)
        return ev

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def log_tuples(self) -> List[Tuple[float, int, str, int, int]]:
        """The popped-event log as plain tuples (stable across runs of
        the same seed; handy for equality asserts and JSON traces)."""
        return [(ev.time, ev.seq, ev.kind, ev.client, ev.round_idx)
                for ev in self.log]
