"""Hierarchical edge-aggregator fleet for async DASHA-PP (the port of
``repro/fl/tree.py``, DESIGN.md §12).

The flat :class:`~repro.fl.server.AsyncDashaServer` delivers every
client's compressed increment straight to the root — fine for tens of
clients, not for the ROADMAP's million-client fleet.  This runtime
interposes a configurable aggregation *tree*: clients report to edge
aggregators (tier 0), edges pre-reduce and forward to tier 1, …, the
top tier reports to the root server.  Per tier:

* **Pre-reduction**: an aggregator merges the buffered contributions
  into per-dispatch-round partial sums (float64 accumulation of the
  float32 client messages), so the root applies one weighted group per
  (message, dispatch round) instead of one per client.  Grouping by
  dispatch round is what lets the root keep the flat server's
  staleness semantics exactly: a group dispatched at round ``r`` and
  committed at round ``t`` is weighted by ``w(t - r)`` from the same
  :mod:`repro.fl.staleness` policy registry, and the per-hop stamps it
  carries telescope to ``t - r`` (:func:`repro.fl.staleness.
  compose_hops`; tests/test_tree_invariants.py).
* **FedBuff-style buffering**: ``buffer_size=K`` flushes after exactly
  ``K`` buffered items; ``None`` is the barrier tier — it flushes when
  its subtree is quiet (no live contribution below it still in
  flight).  The root has the same knob over *messages*.
* **Compressed-uplink accounting**: every tier message is priced on
  the wire sparse-or-dense — ``min(nnz·(value_bits + ceil(log2 d)),
  d·value_bits)`` per round-group plus a round header — so compression
  that survives pre-reduction (union of RandK supports below d) keeps
  paying upstream, and the per-hop totals sum into the existing
  ``bits_cum`` metric.
* **Out-of-core client state**: the per-client trackers live in a
  :class:`~repro.fl.client_store.ClientStore` chunked by edge (numpy
  or memmap), so a round touches cohort rows only and ``n`` scales to
  1e6+ without an (n, d) resident array.

State-write placement: an edge *owns* its clients' tracker shards and
writes ``h_i`` (and ``h_ij``) when it flushes the contribution upstream;
the root writes ``g_i``/``g`` at commit (the ack broadcast).  A
contribution discarded for staleness *at its own edge* is therefore
discarded whole, exactly like the flat server; one discarded higher up
keeps its (already correct) local tracker write but contributes nothing
to ``g``/``g_i``.  With the depth-0 tree (``tiers=()``) clients feed
the root directly and all writes happen at commit — the flat semantics.

Mid-flight dropout: a dropped client's non-arrival is *detected at its
edge* at the would-be arrival time (barrier tiers hold the flush until
then), its contribution is excluded everywhere, and the client re-enters
through a REJOIN event ``rejoin_s`` after detection.

Sync-limit parity contract (tests/test_fleet.py): a depth-1 tree with
zero jitter, barrier buffers everywhere and no availability process
reproduces the synchronous :meth:`DashaPP.run` trajectory allclose for
all four variants, fused on/off — the fleet is an anchored
generalization of the reference engine, through the same
:meth:`DashaPP.dispatch`.

In the port the event loop, the aggregation tree and the
:class:`~repro_torch.fl.client_store.ClientStore` stay on the host, as
in the reference (numpy, float64 pre-reduction); the workload's
dispatch and measurement run on its device.  Randomness comes in
per-round :class:`~repro_torch.core.variants.RoundDraws`, drawn by the
workload from a ``torch.Generator`` or given to :meth:`HierarchicalFleet.
run`.  ``StreamedGradientWorkload`` (client data regenerated from JAX
keys) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import (Any, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import variants, wire
from repro_torch.core.compressors import Compressor
from repro_torch.core.dasha_pp import DashaPP, DashaPPConfig, DashaPPState
from repro_torch.core.participation import ParticipationSampler
from repro_torch.core.variants import RoundDraws
from repro_torch.fl.client_store import ClientStore, edge_partition
from repro_torch.fl.events import (ARRIVAL, DROP, REJOIN, TIER_ARRIVAL,
                                   EventQueue)
from repro_torch.fl.latency import LatencyModel, PoissonAvailability
from repro_torch.fl.staleness import compose_hops, make_staleness
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import monitors as obs_monitors
from repro_torch.obs import trace as obs_trace

ROOT = ("root",)            # pending-counter key for the root server

# bit accounting is single-sourced in the core wire model; re-exported
# here because the fleet public API grew up around these names
GROUP_HEADER_BITS = wire.GROUP_HEADER_BITS
payload_bits = wire.payload_bits


# ----------------------------------------------------------------------
# Configuration
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierConfig:
    """One aggregator tier.  ``buffer_size=None`` is the barrier tier
    (flush when the subtree is quiet); ``K`` flushes after exactly K
    buffered items.  ``latency`` prices the aggregator→parent uplink
    (reliable transport: dropout on infrastructure links is rejected);
    ``max_staleness`` discards contributions whole at flush time."""
    aggregators: int
    buffer_size: Optional[int] = None
    latency: Optional[LatencyModel] = None
    max_staleness: Optional[int] = None

    def __post_init__(self):
        if self.aggregators < 1:
            raise ValueError("aggregators must be >= 1")
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1 (or None)")
        if self.latency is not None and self.latency.dropout > 0.0:
            raise ValueError("tier uplinks are infrastructure links; "
                             "dropout belongs on the client latency "
                             "model, not a TierConfig")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Tree topology + root policy.  ``tiers=()`` is the depth-0
    (flat) fleet: clients feed the root directly."""
    tiers: Tuple[TierConfig, ...] = ()
    buffer_size: Optional[int] = None      # root K (messages); None=barrier
    staleness_policy: str = "power"
    staleness_exponent: float = 0.5
    max_staleness: Optional[int] = None
    value_bits: float = wire.FLOAT_BITS

    def __post_init__(self):
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1 (or None)")
        make_staleness(self.staleness_policy)   # raises on unknown names
        for lo, hi in zip(self.tiers[1:], self.tiers[:-1]):
            if lo.aggregators > hi.aggregators:
                raise ValueError("tiers must narrow toward the root")

    @property
    def depth(self) -> int:
        return len(self.tiers)


# ----------------------------------------------------------------------
# Workloads: what one dispatch computes (the client-side math)
# ----------------------------------------------------------------------

class FleetDispatch(NamedTuple):
    """One round of client work for the dispatched cohort only."""
    x_new: np.ndarray                 # (d,)   float32
    idx: np.ndarray                   # (C,)   global client ids
    m_rows: np.ndarray                # (C, d) compressed uplink messages
    h_rows: np.ndarray                # (C, d) tracker rows after update
    hij_rows: Optional[np.ndarray]    # (C, m, d) component-tracker delta
    oracle_calls: float


class FleetWorkload:
    """The client-side math of one round.  ``dispatch`` computes rows
    for the cohort ONLY (against tracker rows gathered from the store),
    which is what keeps the runtime O(cohort) per round regardless of
    ``n``; ``draw`` makes one round's randomness."""

    sampler: ParticipationSampler
    n: int
    d: int
    wire_bits: float
    has_hij: bool = False

    def store_fields(self) -> Mapping[str, Tuple[int, ...]]:
        raise NotImplementedError

    def init(self, x0: np.ndarray, store: ClientStore
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Populate the store; return ``(x0_f32, g0_f64)``."""
        raise NotImplementedError

    def draw(self, generator: torch.Generator) -> RoundDraws:
        raise NotImplementedError

    def dispatch(self, draws: RoundDraws, t: int, x: np.ndarray,
                 g: np.ndarray, store: ClientStore,
                 eff: np.ndarray) -> FleetDispatch:
        raise NotImplementedError

    def measure(self, x: np.ndarray, g: np.ndarray
                ) -> Tuple[float, float]:
        raise NotImplementedError


class DenseProblemWorkload(FleetWorkload):
    """Reference-scale workload over a :class:`DistributedProblem`,
    routed through the *exact* :meth:`DashaPP.dispatch` (all four
    variants, fused on/off) on the problem's device: the parity anchor.
    Every dispatch gathers all ``n`` tracker rows from the host store and
    sends them to the device (``(n, m, d)`` more for finite-MVR), so
    reference scale only; the bytes are counted in the
    ``fleet.dense.h2d_bytes`` / ``fleet.dense.d2h_bytes`` gauges."""

    def __init__(self, problem, compressor: Compressor,
                 sampler: ParticipationSampler, config: DashaPPConfig,
                 device="cuda"):
        self.engine = DashaPP(problem, compressor, sampler, config,
                              device=device)
        self.device = self.engine.device
        self.problem = problem
        self.sampler = sampler
        self.cfg = config
        self.n, self.d = problem.n, problem.d
        self.has_hij = variants.get_rule(config.variant).component_trackers
        self.wire_bits = float(compressor.wire_bits(problem.d))
        self.h2d_bytes = self.d2h_bytes = 0

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        self.h2d_bytes += a.nbytes
        return torch.from_numpy(a).to(self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        a = t.cpu().numpy()
        self.d2h_bytes += a.nbytes
        return a

    def store_fields(self):
        fields = {"g_i": (self.d,), "h_i": (self.d,)}
        if self.has_hij:
            fields["h_ij"] = (self.problem.m, self.d)
        return fields

    def init(self, x0, store):
        state = self.engine.init(self._to_device(np.array(x0, np.float32)))
        everyone = np.arange(self.n)
        store.scatter_set("g_i", everyone, self._to_host(state.g_i))
        store.scatter_set("h_i", everyone, self._to_host(state.h_i))
        if self.has_hij:
            store.scatter_set("h_ij", everyone, self._to_host(state.h_ij))
        return (self._to_host(state.x).astype(np.float32),
                self._to_host(state.g).astype(np.float64))

    def draw(self, generator):
        return self.engine.draw(generator)

    def _state(self, t: int, x, g, store) -> DashaPPState:
        everyone = np.arange(self.n)
        hij = (self._to_device(store.gather("h_ij", everyone))
               if self.has_hij else None)
        return DashaPPState(
            x=self._to_device(np.asarray(x, np.float32)),
            g=self._to_device(np.asarray(g, np.float32)),
            g_i=self._to_device(store.gather("g_i", everyone)),
            h_i=self._to_device(store.gather("h_i", everyone)),
            h_ij=hij, step=torch.full((), t, dtype=torch.int64,
                                      device=self.device))

    def dispatch(self, draws, t, x, g, store, eff):
        idx = np.nonzero(eff)[0]
        out = self.engine.dispatch(
            self._state(t, x, g, store),
            draws.to(self.device)._replace(mask=self._to_device(eff)))
        rows = self._to_device(idx)
        hij = None
        if self.has_hij:
            # the cohort's dense (C, m, d) tracker deltas, as the store
            # takes them: zero but at the drawn rows
            batch_idx, delta = out.h_ij_rows
            batch_idx = batch_idx.index_select(0, rows)
            delta = delta.index_select(0, rows)
            dense = torch.zeros(len(idx), self.problem.m, self.d,
                                device=self.device)
            dense.scatter_add_(1, batch_idx[:, :, None].expand_as(delta),
                               delta)
            hij = self._to_host(dense)
        # repro: ignore[host-sync] -- the fleet's tree, store and ledger are host-side: the cohort's rows and the oracle count come back once per dispatch, as in the reference
        return FleetDispatch(
            x_new=self._to_host(out.x_new).astype(np.float32), idx=idx,
            m_rows=self._to_host(out.m_i.index_select(0, rows)),
            h_rows=self._to_host(out.h_new.index_select(0, rows)),
            hij_rows=hij,
            oracle_calls=float(self._to_host(out.oracle_calls)))

    def measure(self, x, g):
        xt = self._to_device(np.asarray(x, np.float32))
        p = self.problem
        loss, gnsq = self._to_host(torch.stack(
            [p.loss(xt), torch.sum(p.full_grad(xt) ** 2)])).tolist()
        return loss, gnsq


# ----------------------------------------------------------------------
# Runtime records
# ----------------------------------------------------------------------

class MessageRecord(NamedTuple):
    """One tier flush, as measured on the wire."""
    tier: int
    agg: int
    round_idx: int
    bits: float
    n_groups: int
    n_members: int
    forced: bool


class CommitRecord(NamedTuple):
    """One contribution's life, stamped at root commit."""
    client: int
    dispatch_round: int
    hops: Tuple[Tuple[int, int], ...]   # (tier, root-round at flush)
    commit_round: int
    staleness: int
    weight: float


class _Contrib(NamedTuple):
    client: int
    round_idx: int
    m: np.ndarray
    h: Optional[np.ndarray]
    hij: Optional[np.ndarray]


@dataclasses.dataclass
class _Msg:
    src_tier: int
    src_agg: int
    # groups: dispatch round -> [float64 partial sum, member cids]
    groups: Dict[int, Tuple[np.ndarray, List[int]]]
    bits: float
    n_members: int


class FleetState(NamedTuple):
    x: np.ndarray            # (d,) float32
    g: np.ndarray            # (d,) float64 root estimator
    store: ClientStore       # per-client trackers (g_i, h_i[, h_ij])


@dataclasses.dataclass
class FleetRunResult:
    """Per-root-step trajectories + end-of-run trace aggregates."""
    time: np.ndarray
    loss: np.ndarray
    grad_norm_sq: np.ndarray
    committed: np.ndarray          # contributions applied per step
    committed_msgs: np.ndarray     # root buffer units applied per step
    participants: np.ndarray
    skipped_busy: np.ndarray
    skipped_offline: np.ndarray
    staleness_mean: np.ndarray
    staleness_max: np.ndarray
    bits_cum: np.ndarray           # cumulative wire bits over ALL hops
    root_bits_cum: np.ndarray      # cumulative bits delivered to the root
    staleness_hist: Dict[int, int]
    tier_bits: np.ndarray          # (depth+1,) final per-hop totals
    dropped: int
    discarded_stale: int
    forced_flushes: int
    total_time: float
    event_log: List[Tuple[float, int, str, int, int]]
    message_log: List[MessageRecord]
    commit_log: List[CommitRecord]
    flush_sizes: Dict[int, Dict[int, int]]   # tier -> {#members: count}


# ----------------------------------------------------------------------
# The fleet runtime
# ----------------------------------------------------------------------

class HierarchicalFleet:
    """Event-driven aggregation tree over a :class:`FleetWorkload`.
    ``run(generator, x0, num_rounds)`` plays the whole schedule and returns
    ``(FleetState, FleetRunResult)``."""

    def __init__(self, workload: FleetWorkload, fleet_config: FleetConfig,
                 latency: LatencyModel,
                 availability: Optional[PoissonAvailability] = None, *,
                 store_backend: str = "ram",
                 store_dir: Optional[str] = None):
        self.workload = workload
        self.fcfg = fleet_config
        self.latency = latency
        self.availability = availability
        self.store_backend = store_backend
        self.store_dir = store_dir

        T = fleet_config.depth
        n = workload.n
        # Tier 0 partitions clients; tier k+1 partitions tier-k aggs.
        # With tiers=() clients form one chunk feeding the root.
        first = fleet_config.tiers[0].aggregators if T else 1
        self.bounds = edge_partition(n, first)
        self._parents: List[np.ndarray] = []
        for k in range(T - 1):
            pb = edge_partition(fleet_config.tiers[k].aggregators,
                                fleet_config.tiers[k + 1].aggregators)
            self._parents.append(
                np.searchsorted(pb, np.arange(
                    fleet_config.tiers[k].aggregators),
                    side="right") - 1)

    # -- static topology helpers ---------------------------------------
    def _edge_of(self, client: int) -> int:
        return int(np.searchsorted(self.bounds, client, side="right") - 1)

    def _path(self, client: int) -> List[Tuple[int, int]]:
        """Aggregator (tier, index) chain from edge to top tier."""
        T = self.fcfg.depth
        if T == 0:
            return []
        path = [(0, self._edge_of(client))]
        for k in range(T - 1):
            path.append((k + 1, int(self._parents[k][path[-1][1]])))
        return path

    # -- the event loop -------------------------------------------------
    def run(self, generator: Optional[torch.Generator], x0,
            num_rounds: int, draws: Optional[Sequence[RoundDraws]] = None
            ) -> Tuple[FleetState, FleetRunResult]:
        """Play ``num_rounds`` rounds and the drain; each round's
        randomness comes from ``generator`` through the workload, or from
        ``draws[t]`` when given."""
        if draws is not None and len(draws) < num_rounds:
            raise ValueError(f"{len(draws)} rounds of draws for "
                             f"{num_rounds} rounds")
        wl, fcfg = self.workload, self.fcfg
        n, d, T = wl.n, wl.d, fcfg.depth
        K_root = fcfg.buffer_size
        policy = make_staleness(fcfg.staleness_policy,
                                exponent=fcfg.staleness_exponent)
        store = ClientStore(self.bounds, wl.store_fields(),
                            backend=self.store_backend,
                            directory=self.store_dir)
        x, g = wl.init(np.asarray(x0, np.float32), store)
        g = np.asarray(g, np.float64)

        q = EventQueue()
        now = 0.0
        obs_trace.set_virtual_time(now)
        round_now = 0                       # the root's round clock
        idle = np.ones(n, bool)
        contribs: Dict[int, _Contrib] = {}
        hops: Dict[int, List[Tuple[int, int]]] = {}
        client_cid: Dict[int, int] = {}     # busy client -> live cid
        msgs: Dict[int, _Msg] = {}
        next_id = 0
        buffers = {(k, j): []
                   for k in range(T)
                   for j in range(fcfg.tiers[k].aggregators)}
        pending: Dict[Any, int] = dict.fromkeys(buffers, 0)
        pending[ROOT] = 0
        root_buffer: List[int] = []         # mids (or cids when T == 0)
        flush_seq: Counter = Counter()
        hop_bits = np.zeros(T + 1, np.float64)
        dropped = discarded = forced_flushes = 0
        hist: Counter = Counter()
        flush_sizes: Dict[int, Counter] = {k: Counter() for k in range(T)}
        message_log: List[MessageRecord] = []
        commit_log: List[CommitRecord] = []
        rows: List[Dict[str, Any]] = []

        def discard_contrib(cid: int, arrived_through: int) -> None:
            """Kill a live contribution: free its client, and release
            the pending counts of every tree level it never reached
            (levels <= ``arrived_through`` already decremented at their
            arrivals; -1 = nothing reached)."""
            nonlocal discarded
            c = contribs.pop(cid)
            hops.pop(cid, None)
            idle[c.client] = True
            client_cid.pop(c.client, None)
            discarded += 1
            for (k, j) in self._path(c.client):
                if k > arrived_through:
                    pending[(k, j)] -= 1
                    maybe_flush(k, j)
            pending[ROOT] -= 1

        def flush(k: int, j: int, nitems: int, forced: bool) -> None:
            """Merge the first ``nitems`` buffered items of aggregator
            (k, j) into one upstream message."""
            nonlocal next_id, forced_flushes
            tier = fcfg.tiers[k]
            buf = buffers[(k, j)]
            items, buffers[(k, j)] = buf[:nitems], buf[nitems:]
            groups: Dict[int, Tuple[np.ndarray, List[int]]] = {}
            members: List[int] = []

            def add(r: int, vec64: np.ndarray, cids: List[int]):
                if r not in groups:
                    groups[r] = (np.zeros(d, np.float64), [])
                groups[r][0][:] += vec64
                groups[r][1].extend(cids)
                members.extend(cids)

            if k == 0:
                h_idx: List[int] = []
                h_rows: List[np.ndarray] = []
                hij_rows: List[np.ndarray] = []
                for cid in items:
                    c = contribs[cid]
                    s = round_now - c.round_idx
                    if (tier.max_staleness is not None
                            and s > tier.max_staleness):
                        discard_contrib(cid, arrived_through=0)
                        continue
                    # The edge owns the client's tracker shard: h lands
                    # when the contribution is forwarded upstream.
                    h_idx.append(c.client)
                    h_rows.append(c.h)
                    if c.hij is not None:
                        hij_rows.append(c.hij)
                    contribs[cid] = c._replace(h=None, hij=None)
                    add(c.round_idx, c.m.astype(np.float64), [cid])
                if h_idx:
                    store.scatter_set("h_i", h_idx, np.stack(h_rows))
                    if hij_rows:
                        store.scatter_add("h_ij", h_idx,
                                          np.stack(hij_rows))
            else:
                for mid in items:
                    msg = msgs.pop(mid)
                    for r, (vec, cids) in msg.groups.items():
                        s = round_now - r
                        if (tier.max_staleness is not None
                                and s > tier.max_staleness):
                            for cid in cids:
                                discard_contrib(cid, arrived_through=k)
                            continue
                        add(r, vec, cids)
            if not members:
                return
            for cid in members:
                hops[cid].append((k, round_now))
            bits = sum(GROUP_HEADER_BITS
                       + payload_bits(int(np.count_nonzero(vec)), d,
                                      fcfg.value_bits)
                       for vec, _ in groups.values())
            if tier.latency is not None:
                timing = tier.latency.job(j, flush_seq[(k, j)], bits)
                link_compute_s = timing.compute_s
                link_network_s = timing.network_s
            else:
                link_compute_s = link_network_s = 0.0
            delay = link_compute_s + link_network_s
            flush_seq[(k, j)] += 1
            if forced:
                forced_flushes += 1
            mid = next_id
            next_id += 1
            msgs[mid] = _Msg(src_tier=k, src_agg=j, groups=groups,
                             bits=bits, n_members=len(members))
            q.push(now + delay, TIER_ARRIVAL, mid, round_now,
                   flow_id=mid)
            # Span (not instant) so the flow arrows have a slice to bind
            # to; args carry the causal edge set (inputs -> mid) and the
            # link pricing the critical-path engine re-walks.
            with obs_trace.span("fleet.flush", track="fleet", tier=k,
                                agg=j, mid=mid,
                                inputs=[int(i) for i in items],
                                members=len(members), bits=bits,
                                forced=forced,
                                link_compute_s=link_compute_s,
                                link_network_s=link_network_s):
                for cid in members:
                    obs_trace.flow_step("fleet.contrib", cid,
                                        track="fleet")
            message_log.append(MessageRecord(
                tier=k, agg=j, round_idx=round_now, bits=bits,
                n_groups=len(groups), n_members=len(members),
                forced=forced))
            flush_sizes[k][len(members)] += 1

        def maybe_flush(k: int, j: int) -> None:
            Kk = fcfg.tiers[k].buffer_size
            buf = buffers[(k, j)]
            if Kk is not None:
                while len(buffers[(k, j)]) >= Kk:
                    flush(k, j, Kk, forced=False)
            elif pending[(k, j)] == 0 and buf:
                flush(k, j, len(buf), forced=False)

        def handle(ev) -> None:
            nonlocal now, dropped
            now = max(now, ev.time)
            obs_trace.set_virtual_time(now)
            if ev.kind == REJOIN:
                idle[ev.client] = True
            elif ev.kind == DROP:
                # Detected at the edge: the expected arrival time passed
                # with no data.  Exclude the contribution everywhere and
                # schedule the rejoin from the detection instant.
                dropped += 1
                for (k, j) in self._path(ev.client):
                    pending[(k, j)] -= 1
                    maybe_flush(k, j)
                pending[ROOT] -= 1
                timing = self.latency.job(ev.client, ev.round_idx,
                                          wl.wire_bits)
                q.push(now + timing.rejoin_s, REJOIN, ev.client,
                       ev.round_idx)
            elif ev.kind == ARRIVAL:
                cid = client_cid[ev.client]
                if T == 0:
                    root_buffer.append(cid)
                    pending[ROOT] -= 1
                    hop_bits[0] += wl.wire_bits
                else:
                    e = self._edge_of(ev.client)
                    pending[(0, e)] -= 1
                    hop_bits[0] += wl.wire_bits
                    buffers[(0, e)].append(cid)
                    maybe_flush(0, e)
            elif ev.kind == TIER_ARRIVAL:
                msg = msgs[ev.client]            # client slot = mid
                k = msg.src_tier
                if k + 1 >= T:
                    root_buffer.append(ev.client)
                    pending[ROOT] -= msg.n_members
                    hop_bits[T] += msg.bits
                else:
                    pj = int(self._parents[k][msg.src_agg])
                    buffers[(k + 1, pj)].append(ev.client)
                    pending[(k + 1, pj)] -= msg.n_members
                    hop_bits[k + 1] += msg.bits
                    maybe_flush(k + 1, pj)
            else:                                # pragma: no cover
                raise RuntimeError(f"unknown event kind {ev.kind!r}")

        def step_event() -> None:
            """Advance the simulation by one event, or — when the heap
            is dry but contributions sit in under-full buffers — by one
            forced flush (the timeout path that guarantees progress)."""
            if len(q):
                handle(q.pop())
                return
            for key_kj in sorted(buffers):
                if buffers[key_kj]:
                    flush(*key_kj, len(buffers[key_kj]), forced=True)
                    return
            raise RuntimeError("fleet stuck: live contributions but no "
                               "events and no buffered items")

        def alive() -> int:
            return pending[ROOT] + len(root_buffer)

        def collect_and_commit() -> Tuple[List[int], int]:
            """Fill the root buffer per policy, then commit.  The
            barrier root (K_root=None) waits until no live contribution
            is still below it; the buffered root commits the first
            K_root buffered units (top-tier messages, or client
            contributions when depth is 0)."""
            if K_root is None:
                while pending[ROOT] > 0:
                    step_event()
                return commit_traced(len(root_buffer))
            while len(root_buffer) < K_root and pending[ROOT] > 0:
                step_event()
            return commit_traced(min(K_root, len(root_buffer)))

        def commit_traced(ncommit: int) -> Tuple[List[int], int]:
            with obs_trace.span("fleet.commit", track="fleet",
                                round=round_now, units=ncommit,
                                unit_ids=[int(i) for i in
                                          root_buffer[:ncommit]]) as sp:
                stale, nmsgs = commit(ncommit)
                sp.set(committed=len(stale))
            obs_trace.counter("fleet.bits_cum", float(hop_bits.sum()),
                              track="fleet")
            return stale, nmsgs

        def commit(ncommit: int) -> Tuple[List[int], int]:
            nonlocal g
            batch, del_n = root_buffer[:ncommit], ncommit
            del root_buffer[:del_n]
            stale: List[int] = []
            gi_idx: List[int] = []
            gi_rows: List[np.ndarray] = []
            h_idx: List[int] = []
            h_rows: List[np.ndarray] = []
            hij_rows: List[np.ndarray] = []
            for item in batch:
                if T == 0:
                    c = contribs[item]
                    groups = {c.round_idx: (c.m.astype(np.float64),
                                            [item])}
                else:
                    groups = msgs.pop(item).groups
                for r in sorted(groups):
                    vec, cids = groups[r]
                    s = round_now - r
                    if (fcfg.max_staleness is not None
                            and s > fcfg.max_staleness):
                        for cid in list(cids):
                            # already at the root: nothing left pending
                            discard_contrib(cid, arrived_through=T)
                            pending[ROOT] += 1   # undo the double count
                        continue
                    w = policy.weight(s)
                    for _ in cids:
                        policy.observe(s)
                    g = g + (w / n) * vec
                    for cid in cids:
                        obs_trace.flow_end("fleet.contrib", cid,
                                           track="fleet")
                        c = contribs.pop(cid)
                        hop_list = hops.pop(cid, [])
                        idle[c.client] = True
                        client_cid.pop(c.client, None)
                        gi_idx.append(c.client)
                        gi_rows.append(w * c.m)
                        if T == 0:
                            h_idx.append(c.client)
                            h_rows.append(c.h)
                            if c.hij is not None:
                                hij_rows.append(c.hij)
                        total, _ = compose_hops(
                            c.round_idx, [hr for _, hr in hop_list],
                            round_now)
                        assert total == s
                        commit_log.append(CommitRecord(
                            client=c.client, dispatch_round=c.round_idx,
                            hops=tuple(hop_list),
                            commit_round=round_now, staleness=s,
                            weight=w))
                        hist[s] += 1
                        stale.append(s)
            if gi_idx:
                store.scatter_add("g_i", gi_idx,
                                  np.stack(gi_rows).astype(np.float32))
            if h_idx:
                store.scatter_set("h_i", h_idx, np.stack(h_rows))
                if hij_rows:
                    store.scatter_add("h_ij", h_idx, np.stack(hij_rows))
            return stale, len(batch)

        def record(stale, nmsgs, participants, skipped, skipped_off):
            loss, gnsq = wl.measure(x, g)
            rows.append(dict(
                time=now, loss=loss, gnsq=gnsq, committed=len(stale),
                committed_msgs=nmsgs, participants=participants,
                skipped=skipped, skipped_off=skipped_off,
                bits=float(hop_bits.sum()), root_bits=float(hop_bits[T]),
                s_mean=float(np.mean(stale)) if stale else 0.0,
                s_max=int(max(stale)) if stale else 0))

        for t in range(num_rounds):
            round_now = t
            draws_t = (draws[t] if draws is not None
                       else wl.draw(generator))
            sampled = draws_t.mask.cpu().numpy()
            avail = (self.availability.mask(n, now)
                     if self.availability is not None
                     else np.ones(n, bool))
            eff = sampled & idle & avail
            skipped = int((sampled & ~idle).sum())
            skipped_off = int((sampled & idle & ~avail).sum())

            with obs_trace.span("fleet.dispatch", track="fleet",
                                round=t, cohort=int(eff.sum())):
                disp = wl.dispatch(draws_t, t, x, g, store, eff)
                x = disp.x_new
                for row_i, client in enumerate(disp.idx):
                    client = int(client)
                    timing = self.latency.job(client, t, wl.wire_bits)
                    idle[client] = False
                    arrival_t = now + timing.compute_s + timing.network_s
                    for agg in self._path(client):
                        pending[agg] += 1
                    pending[ROOT] += 1
                    if timing.dropped:
                        q.push(arrival_t, DROP, client, t)
                    else:
                        cid = next_id
                        next_id += 1
                        contribs[cid] = _Contrib(
                            client=client, round_idx=t,
                            m=disp.m_rows[row_i],
                            h=disp.h_rows[row_i],
                            hij=(disp.hij_rows[row_i]
                                 if disp.hij_rows is not None else None))
                        hops[cid] = []
                        client_cid[client] = cid
                        q.push(arrival_t, ARRIVAL, client, t,
                               flow_id=cid)
                        obs_trace.flow_start(
                            "fleet.contrib", cid, track="fleet",
                            client=client, round=t,
                            compute_s=timing.compute_s,
                            network_s=timing.network_s,
                            bits=wl.wire_bits)

            stale: List[int] = []
            nmsgs = 0
            if alive() == 0 and len(q):
                # Nothing can reach the root (everyone is dropped or
                # awaiting rejoin) — advance by one event so the fleet
                # recovers instead of idling out the run.
                handle(q.pop())
            elif alive() == 0 and self.availability is not None:
                # Frozen-clock guard: whole fleet idle inside Poisson
                # outage windows; availability depends on `now`.
                now += 1.0
                obs_trace.set_virtual_time(now)
            elif alive() > 0:
                stale, nmsgs = collect_and_commit()
            record(stale, nmsgs, int(eff.sum()), skipped, skipped_off)

        # Drain: every live contribution lands (chunks of K_root); each
        # chunk is one more dispatch-free root step, so the round clock
        # keeps advancing and staleness/discard semantics match the
        # in-loop commits (same contract as fl/server.py).
        while alive() > 0:
            round_now += 1
            stale, nmsgs = collect_and_commit()
            record(stale, nmsgs, 0, 0, 0)

        col = lambda k, dt: np.asarray([r[k] for r in rows], dtype=dt)
        result = FleetRunResult(
            time=col("time", np.float64),
            loss=col("loss", np.float64),
            grad_norm_sq=col("gnsq", np.float64),
            committed=col("committed", np.int64),
            committed_msgs=col("committed_msgs", np.int64),
            participants=col("participants", np.int64),
            skipped_busy=col("skipped", np.int64),
            skipped_offline=col("skipped_off", np.int64),
            staleness_mean=col("s_mean", np.float64),
            staleness_max=col("s_max", np.int64),
            bits_cum=col("bits", np.float64),
            root_bits_cum=col("root_bits", np.float64),
            staleness_hist=dict(sorted(hist.items())),
            tier_bits=hop_bits.copy(),
            dropped=dropped, discarded_stale=discarded,
            forced_flushes=forced_flushes, total_time=now,
            event_log=q.log_tuples(), message_log=message_log,
            commit_log=commit_log,
            flush_sizes={k: dict(v) for k, v in flush_sizes.items()})
        obs_metrics.publish_fleet(result)
        if obs_trace.active():
            obs_monitors.run_fleet_monitors(result)
        # Drop the simulated clock so a later run on the same tracer
        # cannot emit virtual twins against this run's final time.
        obs_trace.clear_virtual_time()
        return FleetState(x=x, g=g, store=store), result
