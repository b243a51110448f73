"""AsyncDashaServer: buffered, staleness-aware DASHA-PP over virtual
time (the port of ``repro/fl/server.py``).

One *dispatch* is exactly :meth:`repro_torch.core.dasha_pp.DashaPP.
dispatch` (Alg. 1 lines 4-11, with the fused CUDA kernels on the GPU),
but the per-node results are delivered by the event queue at their
latency-priced virtual arrival times, and the server commits a buffer of
the **first K arrivals** per step (FedBuff-style; ``buffer_size=None``
waits for the full cohort, the barrier baseline).  A contribution
dispatched at round ``r`` and committed at round ``t`` has staleness
``s = t - r`` and enters ``g_i`` and ``g`` with the policy's weight
``w(s)`` (:mod:`repro_torch.fl.staleness`); the trackers ``h_i`` (and
``h_ij``) are applied unweighted; contributions older than
``max_staleness`` are discarded whole.  Sync-limit contract: zero
latency jitter and ``buffer_size`` equal to the cohort reproduce
:meth:`DashaPP.run`.

Differences from the reference, all for the card:

* randomness comes in per-round :class:`~repro_torch.core.variants.
  RoundDraws` (from a ``torch.Generator`` or given), and the server
  dispatches on ``sampled & idle & available`` in place of the drawn
  mask, as the reference does;
* a job keeps its client's rows **on the device**: ``m_i`` and
  ``h_new``, and for finite-MVR the ``(B,)`` batch indices with their
  ``(B, d)`` tracker increments, gathered from the round's outputs right
  after the dispatch.  The reference copies all of ``m_i``, ``h_new``
  and the dense ``(n, m, d)`` ``h_ij`` delta to the host every round and
  back at every commit;
* the commit (:meth:`AsyncDashaServer._commit`) stacks only the rows it
  commits, a ``(K, d)`` buffer, where the reference pads a host buffer
  to capacity ``n`` with weight-0 rows (which add exact zeros; a step
  whose arrivals were all discarded therefore commits nothing); ``g``
  goes through :func:`repro_torch.kernels.ops.buffered_commit_op` (the
  CUDA kernel on the GPU) and ``g_i``, ``h_i`` and ``h_ij`` are updated
  in place with ``index_add_``, in the reference's duplicate-safe
  masked-delta form.  The run therefore gives ``g_i`` a tensor of its
  own at init (the engine starts ``g_i`` and ``h_i`` as one tensor);
* ``loss`` and ``||grad f||^2`` of each server step stay on the device
  and are read once, after the run.

The event loop itself runs on the host: it reads the drawn mask once a
round and sends the effective cohort back.  The bytes that cross
between host and device are counted in the ``fleet.async.h2d_bytes`` and
``fleet.async.d2h_bytes`` gauges.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import variants
from repro_torch.core.compressors import Compressor
from repro_torch.core.dasha_pp import DashaPP, DashaPPConfig, DashaPPState
from repro_torch.core.participation import ParticipationSampler
from repro_torch.core.problems import sample_batch_indices
from repro_torch.core.variants import RoundDraws
from repro_torch.fl.events import ARRIVAL, REJOIN, EventQueue
from repro_torch.fl.latency import LatencyModel, PoissonAvailability
from repro_torch.fl.staleness import make_staleness
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Server-side async policy (the latency model is runtime, not
    config)."""
    buffer_size: Optional[int] = None   # K arrivals per step; None=barrier
    staleness_exponent: float = 0.5     # rho of the chosen policy
    # "power": w(s) = (1+s)^-rho (FedBuff); "adaptive": delay-adaptive
    # w from observed commit-staleness statistics (fl/staleness.py).
    staleness_policy: str = "power"
    max_staleness: Optional[int] = None  # discard contributions older
    # The commit of g as one buffered-commit launch: the CUDA kernel on
    # the GPU, its plain version on the CPU.  False runs the reference's
    # use_pallas=False formula, g + (w @ m) / n.
    fused: bool = True

    def __post_init__(self):
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1 (or None)")
        make_staleness(self.staleness_policy)   # raises on unknown names


class _Job(NamedTuple):
    round_idx: int
    m: Tensor                    # (d,) compressed message, on the device
    h: Tensor                    # (d,) tracker row after the update
    hij: Optional[Tuple[Tensor, Tensor]]   # finite_mvr: (B,) rows and
    #                              their (B, d) increments of h_ij[i]
    fid: int = -1                # trace flow id (dispatch -> commit arrow)


@dataclasses.dataclass
class AsyncRunResult:
    """Per-server-step trajectories + end-of-run trace aggregates."""
    time: np.ndarray            # virtual wall-clock after each commit
    loss: np.ndarray            # f(x) after each commit
    grad_norm_sq: np.ndarray    # ||∇f(x)||² after each commit
    committed: np.ndarray       # arrivals applied per step
    participants: np.ndarray    # dispatched cohort size per round
    skipped_busy: np.ndarray    # sampled-but-busy clients per round
    skipped_offline: np.ndarray  # sampled-but-unavailable (Poisson windows)
    staleness_mean: np.ndarray
    staleness_max: np.ndarray
    bits_cum: np.ndarray        # cumulative uplink bits on the wire
    staleness_hist: Dict[int, int]
    utilization: np.ndarray     # (n,) busy-fraction of virtual time
    dropped: int                # jobs lost to dropout
    discarded_stale: int        # arrivals beyond max_staleness
    total_time: float
    event_log: List[Tuple[float, int, str, int, int]]


def _to_device(a: np.ndarray, device: torch.device) -> Tensor:
    return torch.from_numpy(a).to(device)


class AsyncDashaServer:
    """Event-driven DASHA-PP.  ``run(generator, x0, num_rounds)`` plays
    the whole schedule and returns ``(final_state, AsyncRunResult)``."""

    def __init__(self, problem, compressor: Compressor,
                 sampler: ParticipationSampler, config: DashaPPConfig,
                 async_config: AsyncConfig, latency: LatencyModel,
                 availability: Optional[PoissonAvailability] = None,
                 device="cuda"):
        self.engine = DashaPP(problem, compressor, sampler, config,
                              device=device)
        self.device = self.engine.device
        self.problem = problem
        self.compressor = compressor
        self.sampler = sampler
        self.cfg = config
        self.acfg = async_config
        self.latency = latency
        self.availability = availability
        self.rule = variants.get_rule(config.variant)

    # -- the buffered server step ----------------------------------------
    def _commit(self, state: DashaPPState, idx: Tensor, w: Tensor,
                m_rows: Tensor, h_rows: Tensor,
                hij_rows: Optional[Tuple[Tensor, Tensor]]) -> DashaPPState:
        """Apply ``K`` arrivals: clients ``idx`` (K,), weights ``w`` (K,),
        messages ``m_rows`` and tracker rows ``h_rows`` (K, d), and for
        finite-MVR the ``(K, B)`` rows of ``h_ij`` with their ``(K, B, d)``
        increments.  ``g_i``, ``h_i`` and ``h_ij`` are updated in place;
        a client appears at most once (it is busy until its job lands)."""
        n, d = self.problem.n, self.problem.d
        if self.acfg.fused:
            g = ops.buffered_commit_op(state.g, m_rows, w, n_nodes=n)
        else:
            g = state.g + (w @ m_rows) / n
        state.g_i.index_add_(0, idx, w[:, None] * m_rows)
        # the tracker "set" as a delta-add, as the reference writes it
        state.h_i.index_add_(0, idx, h_rows - state.h_i[idx])
        if hij_rows is not None:
            rows, delta = hij_rows
            flat = (idx[:, None] * self.problem.m + rows).reshape(-1)
            state.h_ij.view(-1, d).index_add_(0, flat, delta.reshape(-1, d))
        return state._replace(g=g)

    # -- the event loop -------------------------------------------------
    def run(self, generator: Optional[torch.Generator], x0: Tensor,
            num_rounds: int, b_init=None,
            draws: Optional[Sequence[RoundDraws]] = None
            ) -> Tuple[DashaPPState, AsyncRunResult]:
        """Play ``num_rounds`` dispatch rounds and the drain.  Each round's
        randomness comes from ``generator`` or, when given, from
        ``draws[t]``.  ``b_init`` (MVR) is the per-node size of the init
        minibatch, drawn from ``generator``, or its ``(n, B_init)``
        indices."""
        p = self.problem
        n, d = p.n, p.d
        dev = self.device
        if draws is not None and len(draws) < num_rounds:
            raise ValueError(f"{len(draws)} rounds of draws for "
                             f"{num_rounds} rounds")
        K = self.acfg.buffer_size
        policy = make_staleness(self.acfg.staleness_policy,
                                exponent=self.acfg.staleness_exponent)
        has_hij = self.rule.component_trackers
        wire_bits = float(self.compressor.wire_bits(d))

        b_init_idx = None
        if b_init is not None and self.cfg.variant == "mvr":
            b_init_idx = (b_init.to(dev) if isinstance(b_init, Tensor)
                          else sample_batch_indices(generator, n, p.m,
                                                    b_init, replace=True))
        state = self.engine.init(x0, b_init_idx=b_init_idx)
        # the commit updates g_i and h_i in place; init made them one
        state = state._replace(g_i=state.g_i.clone())

        q = EventQueue()
        now = 0.0
        obs_trace.set_virtual_time(now)
        idle = np.ones(n, bool)
        jobs: Dict[int, _Job] = {}
        next_fid = 0                  # trace flow ids (one per job)
        outstanding = 0               # undelivered ARRIVAL events
        # (client, start, duration) busy windows, clipped to the final
        # virtual clock at the end
        busy: List[Tuple[int, float, float]] = []
        bits_total = 0.0
        dropped = discarded = 0
        h2d = d2h = 0                 # host <-> device bytes
        hist: Counter = Counter()
        rows: List[Dict[str, Any]] = []
        measured: List[Tensor] = []   # (loss, ||grad f||^2) per step

        def collect(target: int):
            """Pop events until ``target`` arrivals are in hand (rejoins
            processed inline); returns the arrival events."""
            nonlocal now, outstanding
            got = []
            while len(got) < target:
                ev = q.pop()
                now = max(now, ev.time)
                obs_trace.set_virtual_time(now)
                if ev.kind == REJOIN:
                    idle[ev.client] = True
                    continue
                outstanding -= 1
                got.append(ev)
            return got

        def commit(arrivals, round_now: int):
            nonlocal bits_total, discarded, h2d
            idx, ws, taken = [], [], []
            stale = []
            for ev in arrivals:
                job = jobs.pop(ev.client)
                if job.fid >= 0:
                    obs_trace.flow_end("async.contrib", job.fid,
                                       track="async")
                idle[ev.client] = True
                bits_total += wire_bits
                s = round_now - job.round_idx
                if (self.acfg.max_staleness is not None
                        and s > self.acfg.max_staleness):
                    discarded += 1
                    continue
                hist[s] += 1
                stale.append(s)
                idx.append(ev.client)
                # weight BEFORE observe: a commit's own staleness never
                # influences its own weight (fl/staleness.py contract)
                ws.append(policy.weight(s))
                policy.observe(s)
                taken.append(job)
            if not taken:
                # all discarded: the reference's all-zero-weight commit
                # leaves the state as it was
                return state, stale
            idx_h = np.asarray(idx, np.int64)
            w_h = np.asarray(ws, np.float32)
            h2d += idx_h.nbytes + w_h.nbytes
            hij = None
            if has_hij:
                hij = (torch.stack([j.hij[0] for j in taken]),
                       torch.stack([j.hij[1] for j in taken]))
            new_state = self._commit(
                state, _to_device(idx_h, dev), _to_device(w_h, dev),
                torch.stack([j.m for j in taken]),
                torch.stack([j.h for j in taken]), hij)
            return new_state, stale

        def measure():
            measured.append(torch.stack(
                [p.loss(state.x), torch.sum(p.full_grad(state.x) ** 2)]))

        for t in range(num_rounds):
            dr = (draws[t].to(dev) if draws is not None
                  else self.engine.draw(generator))
            sampled = dr.mask.cpu().numpy()
            d2h += sampled.nbytes
            avail = (self.availability.mask(n, now)
                     if self.availability is not None
                     else np.ones(n, bool))
            eff = sampled & idle & avail
            skipped = int((sampled & ~idle).sum())
            skipped_off = int((sampled & idle & ~avail).sum())
            cohort = np.nonzero(eff)[0]

            with obs_trace.span("fleet.dispatch", track="async",
                                round=t, cohort=len(cohort)):
                out = self.engine.dispatch(
                    state, dr._replace(mask=_to_device(eff, dev)))
                # the cohort's rows, copied out of the round's outputs
                sel = _to_device(cohort, dev)
                h2d += eff.nbytes + cohort.nbytes
                m_sel = out.m_i.index_select(0, sel)
                h_sel = out.h_new.index_select(0, sel)
                if has_hij:
                    hij_idx, hij_delta = out.h_ij_rows
                    hij_idx = hij_idx.index_select(0, sel)
                    hij_delta = hij_delta.index_select(0, sel)
                for j, i in enumerate(cohort.tolist()):
                    timing = self.latency.job(i, t, wire_bits)
                    idle[i] = False
                    if timing.dropped:
                        dropped += 1
                        busy.append((i, now, timing.compute_s))
                        q.push(now + timing.compute_s + timing.rejoin_s,
                               REJOIN, i, t)
                    else:
                        dur = timing.compute_s + timing.network_s
                        busy.append((i, now, dur))
                        fid = next_fid
                        next_fid += 1
                        jobs[i] = _Job(t, m_sel[j], h_sel[j],
                                       (hij_idx[j], hij_delta[j])
                                       if has_hij else None, fid=fid)
                        q.push(now + dur, ARRIVAL, i, t, flow_id=fid)
                        outstanding += 1
                        obs_trace.flow_start(
                            "async.contrib", fid, track="async",
                            client=i, round=t,
                            compute_s=timing.compute_s,
                            network_s=timing.network_s, bits=wire_bits)
            state = state._replace(x=out.x_new, step=state.step + 1)

            target = outstanding if K is None else min(K, outstanding)
            stale: List[int] = []
            if target == 0 and len(q):
                # Nothing in flight and nobody dispatchable (all
                # sampled clients await rejoin): the heap can only hold
                # rejoins, so advance the clock by one event.
                ev = q.pop()
                now = max(now, ev.time)
                obs_trace.set_virtual_time(now)
                idle[ev.client] = True
            elif target == 0 and self.availability is not None:
                # Frozen-clock guard: nothing in flight, nothing on the
                # heap, the whole fleet idle inside outage windows;
                # availability is a function of `now`, so tick it.
                now += 1.0
                obs_trace.set_virtual_time(now)
            elif target > 0:
                arrivals = collect(target)
                with obs_trace.span("fleet.commit", track="async",
                                    round=t, units=target,
                                    unit_ids=[int(ev.flow_id)
                                              for ev in arrivals
                                              if ev.flow_id >= 0]) as sp:
                    state, stale = commit(arrivals, t)
                    sp.set(committed=len(stale))
            measure()
            rows.append(dict(
                time=now, committed=len(stale), participants=len(cohort),
                skipped=skipped, skipped_off=skipped_off, bits=bits_total,
                s_mean=float(np.mean(stale)) if stale else 0.0,
                s_max=int(max(stale)) if stale else 0))

        # Drain: every in-flight arrival lands (chunks of K); each chunk
        # is one more dispatch-free server step, so the effective round
        # index keeps advancing and late jobs carry their real staleness.
        t_eff = num_rounds
        while outstanding:
            chunk = outstanding if K is None else min(K, outstanding)
            arrivals = collect(chunk)
            with obs_trace.span("fleet.commit", track="async",
                                round=t_eff, units=chunk,
                                unit_ids=[int(ev.flow_id)
                                          for ev in arrivals
                                          if ev.flow_id >= 0]) as sp:
                state, stale = commit(arrivals, t_eff)
                sp.set(committed=len(stale))
            t_eff += 1
            measure()
            rows.append(dict(
                time=now, committed=len(stale), participants=0, skipped=0,
                skipped_off=0, bits=bits_total,
                s_mean=float(np.mean(stale)) if stale else 0.0,
                s_max=int(max(stale)) if stale else 0))

        # one device-to-host read of every step's metrics
        loss_gnsq = torch.stack(measured).cpu().double().numpy()
        d2h += len(measured) * 2 * 4
        total = max(now, 1e-12)
        busy_s = np.zeros(n)
        for client, start, dur in busy:
            busy_s[client] += max(0.0, min(start + dur, total) - start)
        col = lambda k, dt: np.asarray([r[k] for r in rows], dtype=dt)
        result = AsyncRunResult(
            time=col("time", np.float64),
            loss=loss_gnsq[:, 0], grad_norm_sq=loss_gnsq[:, 1],
            committed=col("committed", np.int64),
            participants=col("participants", np.int64),
            skipped_busy=col("skipped", np.int64),
            skipped_offline=col("skipped_off", np.int64),
            staleness_mean=col("s_mean", np.float64),
            staleness_max=col("s_max", np.int64),
            bits_cum=col("bits", np.float64),
            staleness_hist=dict(sorted(hist.items())),
            utilization=busy_s / total,
            dropped=dropped, discarded_stale=discarded,
            total_time=now, event_log=q.log_tuples())
        reg = obs_metrics.get_registry()
        reg.gauge("fleet.async.bits_total").set(float(bits_total))
        reg.gauge("fleet.async.committed").set(
            float(result.committed.sum()))
        reg.gauge("fleet.async.dropped").set(float(dropped))
        reg.gauge("fleet.async.virtual_time").set(float(now))
        reg.gauge("fleet.async.h2d_bytes").set(float(h2d))
        reg.gauge("fleet.async.d2h_bytes").set(float(d2h))
        obs_trace.clear_virtual_time()
        return state, result
