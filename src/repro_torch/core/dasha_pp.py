"""DASHA-PP (paper Algorithm 1) and its sub-algorithms (Algs. 2-5).

The port of ``repro/core/dasha_pp.py``.  One engine runs Algorithm 1;
the four ``k_i`` rules plug in from :mod:`repro_torch.core.variants`:

* ``gradient``    — Alg. 2 (DASHA-PP)
* ``page``        — Alg. 3 (DASHA-PP-PAGE, finite-sum)
* ``finite_mvr``  — Alg. 4 (DASHA-PP-FINITE-MVR, finite-sum)
* ``mvr``         — Alg. 5 (DASHA-PP-MVR, stochastic)

All ``n`` nodes are simulated node-major on one device.  With
``fused=True`` (the default) lines 9-11 of a round are one launch of a
hand-written CUDA kernel for all nodes when the problem lives on the
GPU, and that kernel's plain PyTorch version on the CPU
(:mod:`repro_torch.kernels.ops`).

Differences from the reference, all forced by PyTorch:

* randomness is explicit: :meth:`DashaPP.dispatch` and :meth:`DashaPP.step`
  take a round's :class:`~repro_torch.core.variants.RoundDraws`, and
  :meth:`DashaPP.run` draws them from a ``torch.Generator``;
* ``run`` is a Python loop (no ``lax.scan``); its metrics stay on the
  device and are stacked once at the end;
* finite-MVR updates ``h_ij`` in place at the drawn rows, so ``step``
  hands the same ``h_ij`` tensor on to the new state (see
  :mod:`repro_torch.core.variants`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import variants
from repro_torch.core.compressors import Compressor
from repro_torch.core.participation import ParticipationSampler
from repro_torch.core.problems import DistributedProblem, sample_batch_indices
from repro_torch.core.variants import RoundDraws
from repro_torch.device import resolve_device

Tensor = torch.Tensor


class DashaPPState(NamedTuple):
    x: Tensor              # (d,)   model point x^t
    g: Tensor              # (d,)   server estimator g^t
    g_i: Tensor            # (n, d) node estimators
    h_i: Tensor            # (n, d) node gradient trackers
    h_ij: Optional[Tensor]  # (n, m, d) component trackers (finite_mvr)
    step: Tensor           # ()


class StepMetrics(NamedTuple):
    loss: Tensor
    grad_norm_sq: Tensor        # ||∇f(x^t)||^2, the paper's plotted quantity
    bits_sent: Tensor           # total uplink bits this round (all nodes)
    grad_oracle_calls: Tensor   # (stochastic) gradient evaluations
    participants: Tensor
    x_norm: Tensor              # ||x^t||


class DispatchOutputs(NamedTuple):
    """One round of client work before the server applies it (Alg. 1
    lines 4-11)."""
    x_new: Tensor         # (d,)   x^{t+1}
    mask: Tensor          # (n,)   participation indicator
    m_i: Tensor           # (n, d) compressed uplink messages (masked)
    h_new: Tensor         # (n, d) tracker step (non-participants unchanged)
    h_ij_rows: Optional[Tuple[Tensor, Tensor]]  # finite_mvr: (batch_idx,
    #        (n, B, d) increments of h_ij at those rows)
    oracle_calls: Tensor


@dataclasses.dataclass(frozen=True)
class DashaPPConfig:
    variant: str                      # gradient | page | finite_mvr | mvr
    gamma: float
    a: float                          # compressor momentum
    b: float                          # VR momentum
    p_page: float = 1.0               # page only
    batch_size: int = 1               # page / finite_mvr / mvr
    replace: bool = True              # batch sampling w/ replacement (Alg.3)
    # Lines 9-11 as one fused update per round: the CUDA kernel on the
    # GPU, its plain version on the CPU.  False runs the unfused rule
    # and tail (the reference's use_pallas=False chain).
    fused: bool = True

    def __post_init__(self):
        variants.get_rule(self.variant)   # raises on unknown names


class DashaPP:
    """Engine for Algorithm 1: ``state = init(x0)``, then
    ``state, metrics = step(state, draw(generator))``, or ``run``."""

    def __init__(self, problem: DistributedProblem, compressor: Compressor,
                 sampler: ParticipationSampler, config: DashaPPConfig,
                 device="cuda"):
        dev = resolve_device(device)
        if problem.device != dev:
            raise ValueError(f"the problem lives on {problem.device}, "
                             f"not on {dev}")
        if sampler.n != problem.n:
            raise ValueError("sampler.n != problem.n")
        self.problem = problem
        self.compressor = compressor
        self.sampler = sampler
        self.cfg = config
        self.rule = variants.get_rule(config.variant)
        self.device = dev

    # ------------------------------------------------------------------
    def init(self, x0: Tensor, b_init_idx: Optional[Tensor] = None
             ) -> DashaPPState:
        """Line 2: g_i^0 = h_i^0 = ∇f_i(x^0), or for MVR with
        ``b_init_idx`` (n, B_init) a minibatch estimate (Corollary 3)."""
        p = self.problem
        if x0.device != self.device:
            raise ValueError(f"x0 lives on {x0.device}, not on {self.device}")
        if self.cfg.variant == "mvr" and b_init_idx is not None:
            h0 = p.batch_grad(x0, b_init_idx)
        else:
            h0 = p.grad(x0)
        h_ij = None
        if self.rule.component_trackers:
            h_ij = p.component_grad_all(x0)    # h_ij^0 = ∇f_ij(x^0)
        return DashaPPState(
            x=x0, g=torch.mean(h0, dim=0), g_i=h0, h_i=h0, h_ij=h_ij,
            step=torch.zeros((), dtype=torch.int64, device=self.device))

    # ------------------------------------------------------------------
    def draw(self, generator: torch.Generator) -> RoundDraws:
        """One round's randomness from ``generator`` (on the engine's
        device): participation, the rule's oracle draws, compression."""
        p = self.problem
        batch_idx, coin = self.rule.sample_oracle(generator, p, self.cfg)
        return RoundDraws(mask=self.sampler.sample(generator),
                          batch_idx=batch_idx, coin=coin,
                          comp_idx=self.compressor.draw(generator, p.n, p.d))

    # ------------------------------------------------------------------
    def dispatch(self, state: DashaPPState,
                 draws: RoundDraws) -> DispatchOutputs:
        """Alg. 1 lines 4-11: the broadcast and all client-side work of
        one round, without applying it to the server estimators."""
        p, cfg, C, rule = self.problem, self.cfg, self.compressor, self.rule
        pa = self.sampler.p_a

        # Lines 4-5: x^{t+1} = x^t - gamma * g^t; broadcast.
        x_new = state.x - cfg.gamma * state.g

        # Lines 7-8: participation mask.
        mask = draws.mask
        maskf = mask.to(state.x.dtype)[:, None]

        # Line 9 oracles.
        ox, k_rows, calls = rule.reference_oracle(draws, p, cfg, x_new,
                                                  state.x, state)
        if cfg.fused:
            # Lines 9-11 fused: one launch for all n simulated nodes.
            _, h_new, payload = rule.fused_batched(
                ox, state.h_i, state.g_i, mask, b=cfg.b, a=cfg.a, pa=pa,
                p_page=cfg.p_page)
        else:
            k_i = rule.k(ox, state.h_i, b=cfg.b, p_page=cfg.p_page)
            h_new, payload = variants.control_variate_tail(
                k_i, state.h_i, state.g_i, a=cfg.a, pa=pa, part=maskf)

        h_ij_rows = None
        if k_rows is not None:
            idx, k_sel = k_rows
            h_ij_rows = (idx, maskf[:, :, None] * (k_sel / pa))

        # Line 11: m_i = C_i(payload), independent draws per node.
        m_i = maskf * C.compress(payload, draws.comp_idx)
        return DispatchOutputs(x_new=x_new, mask=mask, m_i=m_i,
                               h_new=h_new, h_ij_rows=h_ij_rows,
                               oracle_calls=calls)

    # ------------------------------------------------------------------
    def step(self, state: DashaPPState, draws: RoundDraws
             ) -> Tuple[DashaPPState, StepMetrics]:
        p, C = self.problem, self.compressor
        out = self.dispatch(state, draws)

        # Lines 12, 19: the synchronous commit.
        g_i_new = state.g_i + out.m_i
        g_new = state.g + torch.mean(out.m_i, dim=0)
        h_ij = state.h_ij
        if out.h_ij_rows is not None:
            idx, delta = out.h_ij_rows
            h_ij.scatter_add_(1, idx[:, :, None].expand_as(delta), delta)

        n_part = torch.sum(out.mask)
        metrics = StepMetrics(
            loss=p.loss(state.x),
            grad_norm_sq=torch.sum(p.full_grad(state.x) ** 2),
            bits_sent=n_part * C.wire_bits(p.d),
            grad_oracle_calls=out.oracle_calls,
            participants=n_part,
            x_norm=torch.linalg.vector_norm(state.x),
        )
        new_state = DashaPPState(x=out.x_new, g=g_new, g_i=g_i_new,
                                 h_i=out.h_new, h_ij=h_ij,
                                 step=state.step + 1)
        return new_state, metrics

    # ------------------------------------------------------------------
    def run(self, generator: torch.Generator, x0: Tensor, num_rounds: int,
            b_init: Optional[int] = None) -> Tuple[DashaPPState, StepMetrics]:
        """``num_rounds`` rounds with draws from ``generator``; returns the
        final state and the per-round metrics stacked on the device."""
        if num_rounds < 1:
            raise ValueError("num_rounds must be >= 1")
        p = self.problem
        b_init_idx = None
        if b_init is not None and self.cfg.variant == "mvr":
            b_init_idx = sample_batch_indices(generator, p.n, p.m, b_init,
                                              replace=True)
        state = self.init(x0, b_init_idx=b_init_idx)
        history = []
        for _ in range(num_rounds):
            state, met = self.step(state, self.draw(generator))
            history.append(met)
        return state, StepMetrics(*(torch.stack(f) for f in zip(*history)))


# ----------------------------------------------------------------------
# Named constructors
# ----------------------------------------------------------------------

def dasha_pp(problem, compressor, sampler, *, gamma, a, b, fused=True,
             device="cuda") -> DashaPP:
    """DASHA-PP, gradient setting (Alg. 1 + Alg. 2, Theorem 2)."""
    return DashaPP(problem, compressor, sampler,
                   DashaPPConfig("gradient", gamma=gamma, a=a, b=b,
                                 fused=fused), device=device)


def dasha_pp_page(problem, compressor, sampler, *, gamma, a, b, p_page,
                  batch_size, fused=True, device="cuda") -> DashaPP:
    """DASHA-PP-PAGE (Alg. 1 + Alg. 3, Theorem 3)."""
    return DashaPP(problem, compressor, sampler,
                   DashaPPConfig("page", gamma=gamma, a=a, b=b,
                                 p_page=p_page, batch_size=batch_size,
                                 fused=fused), device=device)


def dasha_pp_finite_mvr(problem, compressor, sampler, *, gamma, a, b,
                        batch_size, fused=True, device="cuda") -> DashaPP:
    """DASHA-PP-FINITE-MVR (Alg. 1 + Alg. 4, Theorem 7)."""
    return DashaPP(problem, compressor, sampler,
                   DashaPPConfig("finite_mvr", gamma=gamma, a=a, b=b,
                                 batch_size=batch_size, fused=fused),
                   device=device)


def dasha_pp_mvr(problem, compressor, sampler, *, gamma, a, b, batch_size,
                 fused=True, device="cuda") -> DashaPP:
    """DASHA-PP-MVR (Alg. 1 + Alg. 5, Theorem 4)."""
    return DashaPP(problem, compressor, sampler,
                   DashaPPConfig("mvr", gamma=gamma, a=a, b=b,
                                 batch_size=batch_size, fused=fused),
                   device=device)
