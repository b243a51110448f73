"""Variant-rule layer: the ``k_i`` rules of Algorithms 2-5 and what each
rule owns (the port of ``repro/core/variants.py``).

A :class:`VariantRule` holds

(a) the ``k_i`` formula, node-major ``(n, d)``;
(b) the oracles the step needs, as ``sample_oracle`` (the rule's share
    of a round's randomness) and ``reference_oracle`` (their evaluation
    against a :class:`~repro_torch.core.problems.DistributedProblem`);
(c) oracle-call accounting;
(d) the fused-kernel dispatch (``dasha_update`` for gradient and MVR,
    ``dasha_page_update`` for PAGE, the tail alone for finite-MVR).

**The random-draw seam.**  Torch cannot reproduce JAX's threefry bits,
so a round's randomness is one explicit :class:`RoundDraws`: the
participation mask, the minibatch indices, the PAGE coin and the
compressor's indices.  :meth:`DashaPP.run
<repro_torch.core.dasha_pp.DashaPP.run>` draws it from a
``torch.Generator``; parity tests compute it with the reference's key
derivation and hand the same numbers to both packages.

**Finite-MVR is sparse here.**  The reference scatters the ``B``
component updates into a dense ``(n, m, d)`` ``k_ij`` and adds all of it
to ``h_ij`` (``repro/core/variants.py:457-460``,
``repro/core/dasha_pp.py:173,200``).  The port keeps the ``(n, B, d)``
values at ``batch_idx`` and updates ``h_ij`` row by row: the draw is
without replacement, so no index repeats, and the rows it skips would
have gained exactly zero.  At the real-sim width the dense form is a
6 GB temporary per round.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.problems import sample_batch_indices, take_rows
from repro_torch.kernels import ops

Tensor = torch.Tensor


class RoundDraws(NamedTuple):
    """All the randomness of one round of Algorithm 1."""
    mask: Tensor                        # (n,) bool participation
    batch_idx: Optional[Tensor] = None  # (n, B) int64 minibatch indices
    coin: Optional[Tensor] = None       # () bool PAGE coin
    comp_idx: Optional[Tensor] = None   # (n, k) or (n, kb) compressor picks

    def to(self, device) -> "RoundDraws":
        return RoundDraws(*(None if t is None else t.to(device)
                            for t in self))


# ----------------------------------------------------------------------
# Pure k_i formulas (Alg. 1 line 9)
# ----------------------------------------------------------------------

def k_same_sample(gn: Tensor, go: Tensor, h: Tensor, *, b: float) -> Tensor:
    """Algs. 2/5: ``k = gn - go - b (h - go)`` with ``gn/go`` the full
    (Alg. 2) or same-sample minibatch (Alg. 5) gradients."""
    return gn - go - b * (h - go)


def k_page(gn: Tensor, go: Tensor, bn: Tensor, bo: Tensor, h: Tensor,
           coin: Tensor, *, b: float, p_page: float) -> Tensor:
    """Alg. 3: the full branch ``gn - go - (b/p_page)(h - go)`` where the
    shared ``coin`` is set, else the minibatch branch ``bn - bo``."""
    k_full = gn - go - (b / p_page) * (h - go)
    k_mini = bn - bo
    return torch.where(coin.to(torch.bool), k_full, k_mini)


def k_finite_mvr_components(gn_sel: Tensor, go_sel: Tensor, h_sel: Tensor,
                            m: int, *, b: float) -> Tensor:
    """Alg. 4 at the ``B`` selected components, (n, B, d): the values the
    reference scatters into its dense ``(n, m, d)`` ``k_ij``."""
    B = gn_sel.shape[1]
    return (m / B) * (gn_sel - go_sel - b * (h_sel - go_sel))


def control_variate_tail(k: Tensor, h: Tensor, g_i: Tensor, *, a: float,
                         pa: float, part) -> Tuple[Tensor, Tensor]:
    """Alg. 1 lines 10-11 given ``k``: the tracker step and the uplink
    payload; ``part`` broadcasts against ``k`` ((n, 1) node-major)."""
    h_new = h + part * (k / pa)
    payload = k / pa - (a / pa) * (g_i - h)
    return h_new, payload


# ----------------------------------------------------------------------
# Block plan and uplink accounting (aggregation-aware)
# ----------------------------------------------------------------------

def block_plan(d: int, block_size: int, ratio: float
               ) -> Tuple[int, int, int]:
    """(effective block size, #blocks, #selected blocks) of a ``d``-vector
    under compression ``ratio``."""
    bs = min(block_size, d)
    nb = -(-d // bs)
    kb = max(1, math.ceil(ratio * nb))
    return bs, nb, kb


FLOAT_BITS = 32.0
INDEX_BITS = 32.0

WIRE_FORMATS = ("block_randk", "topk", "dithering")


def message_bits(d: int, *, aggregation: str,
                 compression_ratio: Optional[float],
                 block_size: int, wire_format: str = "block_randk",
                 dithering_levels: int = 4) -> float:
    """Uplink bits one participating node pays to send one ``d``-leaf
    message; the reference's formula (``repro/core/variants.py:200``).
    Only ``sparse_allgather`` has a compressed wire format;
    ``compression_ratio=None`` is the uncompressed baseline."""
    if compression_ratio is None or aggregation != "sparse_allgather":
        return d * FLOAT_BITS
    if wire_format == "dithering":
        return FLOAT_BITS + d * (
            1 + math.ceil(math.log2(dithering_levels + 1)))
    if wire_format == "topk":
        k = max(1, math.ceil(compression_ratio * d))
        return k * (FLOAT_BITS + INDEX_BITS)
    bs, _, kb = block_plan(d, block_size, compression_ratio)
    return kb * (bs * FLOAT_BITS + INDEX_BITS)


# ----------------------------------------------------------------------
# Oracle inputs
# ----------------------------------------------------------------------

class OracleBatch(NamedTuple):
    """Evaluated gradient-oracle inputs for one step: gradient/mvr use
    ``(gn, go)``, page adds ``(bn, bo, coin)``, finite_mvr carries its
    node mean ``k``."""
    gn: Any = None
    go: Any = None
    bn: Any = None
    bo: Any = None
    coin: Any = None
    k: Any = None


def _count(value: int, device: torch.device) -> Tensor:
    """A 0-d int64 count made on the device (no host-to-device copy)."""
    return torch.full((), value, dtype=torch.int64, device=device)


# ----------------------------------------------------------------------
# The rules
# ----------------------------------------------------------------------

class VariantRule:
    """One Algorithm-2..5 sub-algorithm; stateless, registered in
    :data:`VARIANTS`."""

    name: str = ""
    component_trackers: bool = False   # (n, m, d) h_ij state (finite_mvr)

    def k(self, ox: OracleBatch, h: Tensor, *, b: float,
          p_page: float = 1.0) -> Tensor:
        raise NotImplementedError

    def sample_oracle(self, generator: torch.Generator, problem, cfg
                      ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
        """The rule's share of a round's draws: ``(batch_idx, coin)``."""
        return None, None

    def reference_oracle(self, draws: RoundDraws, problem, cfg, x_new,
                         x_old, state
                         ) -> Tuple[OracleBatch, Optional[Tuple[Tensor,
                                                                Tensor]],
                                    Tensor]:
        """Evaluate the oracles at ``draws``.  Returns ``(ox, k_rows,
        oracle_calls)``; ``k_rows`` is finite-MVR's ``(batch_idx,
        k_sel)``, else None."""
        raise NotImplementedError

    def fused_batched(self, ox: OracleBatch, h, gi, mask, *, b, a, pa,
                      p_page: float = 1.0):
        """Node-major (n, d) fused update -> (k, h_new, payload)."""
        raise NotImplementedError


class GradientRule(VariantRule):
    """Alg. 2 (DASHA-PP): full local gradients at x^{t+1} and x^t."""
    name = "gradient"

    def k(self, ox, h, *, b, p_page=1.0):
        return k_same_sample(ox.gn, ox.go, h, b=b)

    def reference_oracle(self, draws, problem, cfg, x_new, x_old, state):
        ox = OracleBatch(gn=problem.grad(x_new), go=problem.grad(x_old))
        return ox, None, _count(2 * problem.m * problem.n, problem.device)

    def fused_batched(self, ox, h, gi, mask, *, b, a, pa, p_page=1.0):
        return ops.dasha_update_batched_op(ox.gn, ox.go, h, gi, mask,
                                           b=b, a=a, pa=pa)


class MvrRule(GradientRule):
    """Alg. 5 (DASHA-PP-MVR): a same-sample minibatch gradient pair."""
    name = "mvr"

    def sample_oracle(self, generator, problem, cfg):
        return sample_batch_indices(generator, problem.n, problem.m,
                                    cfg.batch_size, replace=True), None

    def reference_oracle(self, draws, problem, cfg, x_new, x_old, state):
        idx = draws.batch_idx
        ox = OracleBatch(gn=problem.batch_grad(x_new, idx),
                         go=problem.batch_grad(x_old, idx))
        return ox, None, _count(2 * cfg.batch_size * problem.n,
                                problem.device)


class PageRule(VariantRule):
    """Alg. 3 (DASHA-PP-PAGE): a full pass with probability ``p_page``
    (one coin for all nodes), else a same-sample minibatch pair."""
    name = "page"

    def k(self, ox, h, *, b, p_page):
        return k_page(ox.gn, ox.go, ox.bn, ox.bo, h, ox.coin,
                      b=b, p_page=p_page)

    def sample_oracle(self, generator, problem, cfg):
        coin = torch.rand((), generator=generator,
                          device=generator.device) < cfg.p_page
        idx = sample_batch_indices(generator, problem.n, problem.m,
                                   cfg.batch_size, replace=cfg.replace)
        return idx, coin

    def reference_oracle(self, draws, problem, cfg, x_new, x_old, state):
        idx = draws.batch_idx
        ox = OracleBatch(gn=problem.grad(x_new), go=problem.grad(x_old),
                         bn=problem.batch_grad(x_new, idx),
                         bo=problem.batch_grad(x_old, idx), coin=draws.coin)
        n, m, B = problem.n, problem.m, cfg.batch_size
        calls = torch.where(draws.coin.to(torch.bool), 2 * m * n, 2 * B * n)
        return ox, None, calls

    def fused_batched(self, ox, h, gi, mask, *, b, a, pa, p_page=1.0):
        return ops.dasha_page_update_op(ox.gn, ox.go, ox.bn, ox.bo, h, gi,
                                        mask, ox.coin, b=b, a=a, pa=pa,
                                        p_page=p_page)


class FiniteMvrRule(VariantRule):
    """Alg. 4 (DASHA-PP-FINITE-MVR): component gradient pairs at a
    without-replacement minibatch, against the ``h_ij`` trackers."""
    name = "finite_mvr"
    component_trackers = True

    def k(self, ox, h, *, b, p_page=1.0):
        return ox.k

    def sample_oracle(self, generator, problem, cfg):
        return sample_batch_indices(generator, problem.n, problem.m,
                                    cfg.batch_size, replace=False), None

    def reference_oracle(self, draws, problem, cfg, x_new, x_old, state):
        idx, m = draws.batch_idx, problem.m
        gn = problem.component_grads(x_new, idx)     # (n, B, d)
        go = problem.component_grads(x_old, idx)
        h_sel = take_rows(state.h_ij, idx)
        k_sel = k_finite_mvr_components(gn, go, h_sel, m, b=cfg.b)
        # the node mean over all m components; the unselected ones are 0
        ox = OracleBatch(k=torch.sum(k_sel, dim=1) / m)
        return ox, (idx, k_sel), _count(2 * cfg.batch_size * problem.n,
                                        problem.device)

    def fused_batched(self, ox, h, gi, mask, *, b, a, pa, p_page=1.0):
        h_new, payload = ops.dasha_tail_op(ox.k, h, gi, mask, a=a, pa=pa)
        return ox.k, h_new, payload


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------

VARIANTS = {r.name: r for r in
            (GradientRule(), PageRule(), FiniteMvrRule(), MvrRule())}


def get_rule(name: str) -> VariantRule:
    """The Algorithm-2..5 rule registered under ``name``."""
    try:
        return VARIANTS[name]
    except KeyError:
        raise ValueError(
            f"unknown variant {name!r}; choose from {sorted(VARIANTS)}"
        ) from None
