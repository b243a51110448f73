"""The production train step: Model x ShardedDasha x ServerOptimizer (the
port of ``repro/training/trainer.py``).

Step order is Algorithm 1, as in the reference:

    1. x^{t+1} = x^t + server_update(g^t)        (paper: -gamma g^t)
    2. per-node stochastic grads at x^{t+1} AND x^t, by variant:
         * ``mvr``      — the same minibatch at both points (Alg. 5 pair)
         * ``gradient`` — the fixed-batch local gradient pair; the
           old-point gradients are cached from the previous round (one
           backward pass per node and step instead of two)
         * ``page``     — the round's shared coin picks EITHER a full
           pass over the node batch OR a minibatch pass over its first
           ``page_mini_batch`` examples; only the taken pair is
           computed (the coin is a host bool of the round's draws)
         * ``finite_mvr`` — each node's FIXED batch examples are the m
           finite-sum components: the round's draws name
           ``component_batch`` of them per node (without replacement),
           whose per-example gradients (n, B, *param) are taken at both
           points; the engine carries the (n, m, *param) ``h_ij``
    3. node update: h_i, g_i, compressed messages m_i, aggregation ->
       g^{t+1} (:meth:`ShardedDasha.node_update`, in place).

The per-node gradients are a loop over the nodes (the reference's
``vmap``), each a backward pass over the node's batch; finite-MVR's
per-example gradients a loop over the ``n B`` drawn examples, each a
batch of one.  The async halves (``dispatch_step``/``commit_step``) come
with a later slice (ROADMAP).  ``train_step`` consumes its state: the
engine updates ``g``, ``g_i``, ``h_i`` and ``h_ij`` in place, as the
reference's jitted step donates its input.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.sharded import (ShardedDasha, ShardedDashaConfig,
                                      ShardedDashaState, ShardedDraws)
from repro_torch.core.variants import get_rule
from repro_torch.models.model import Model
from repro_torch.training.optim import ServerOptimizer

Tensor = torch.Tensor
Params = Dict[str, Tensor]


class TrainState(NamedTuple):
    params: Params
    dasha: ShardedDashaState
    opt: Any
    step: int
    # gradient variant: (losses (n,), per-node grads) at the CURRENT
    # params, next round's old-point pair; None before the first round
    cache: Optional[Tuple[Tensor, Params]] = None


class TrainMetrics(NamedTuple):
    loss: Tensor
    loss_old: Tensor
    grad_norm: Tensor     # ||g^{t+1}|| of the server estimator
    step: int
    bits_sent: Tensor     # uplink bits this round, all nodes
    participants: Tensor  # |S^t| this round


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    dasha: ShardedDashaConfig
    server: ServerOptimizer
    # page variant: per-node examples of the minibatch branch
    page_mini_batch: int = 1
    # gradient variant: cache the old-point per-node gradients (None =
    # on iff variant == "gradient"); exact only for fixed node batches
    cache_old_grads: Optional[bool] = None
    # finite_mvr (a fixed-batch finite-sum setting): m = examples per
    # node in every batch (sizes h_ij), B = components drawn per round
    num_components: Optional[int] = None
    component_batch: int = 1

    def __post_init__(self):
        rule = get_rule(self.dasha.variant)
        if rule.component_trackers:
            if self.num_components is None:
                raise ValueError(
                    "finite_mvr needs TrainerConfig.num_components "
                    "(= examples per node in every batch) to size the "
                    "h_ij component trackers")
            if not 1 <= self.component_batch <= self.num_components:
                raise ValueError(
                    f"need 1 <= component_batch <= num_components, got "
                    f"{self.component_batch} / {self.num_components}")


def tree_norm(tree: Params) -> Tensor:
    """sqrt of the sum of squares of every leaf, in leaf order."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def per_node_value_and_grads(loss_fn: Callable, params: Params,
                             batch: Dict[str, Tensor]
                             ) -> Tuple[Tensor, Params]:
    """``loss_fn(params, node_batch) -> scalar``; ``batch`` leaves carry a
    leading node dimension.  Returns ``(losses (n,), grads)`` with grad
    leaves ``(n, *param_shape)`` in the parameters' dtype: the unreduced
    per-node gradients, one backward pass per node."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    n = next(iter(batch.values())).shape[0]
    grads = {k: torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                            device=v.device) for k, v in leaves.items()}
    losses = None
    for i in range(n):
        loss = loss_fn(leaves, {k: v[i] for k, v in batch.items()})
        if losses is None:
            losses = torch.empty(n, dtype=loss.dtype, device=loss.device)
        for dst, g in zip(grads.values(),
                          torch.autograd.grad(loss, list(leaves.values()))):
            dst[i].copy_(g)
        losses[i] = loss.detach()
        del loss
    return losses, grads


class Trainer:
    def __init__(self, model: Model, cfg: TrainerConfig, num_nodes: int):
        self.model = model
        self.cfg = cfg
        self.n_nodes = num_nodes
        shapes = {k: tuple(p.shape) for k, p in model.params().items()}
        self.engine = ShardedDasha(cfg.dasha, num_nodes, shapes,
                                   num_components=cfg.num_components,
                                   component_batch=cfg.component_batch)
        self.rule = self.engine.rule
        self.cache_old = (cfg.cache_old_grads
                          if cfg.cache_old_grads is not None
                          else cfg.dasha.variant == "gradient")

    # ---- init -------------------------------------------------------------
    def init(self) -> TrainState:
        """Zero control variates at the model's weights."""
        params = self.model.params()
        return TrainState(params=params,
                          dasha=self.engine.init_zero(params),
                          opt=self.cfg.server.init(params), step=0,
                          cache=None)

    # ---- the step --------------------------------------------------------
    def _node_grads(self, params: Params, batch: Dict[str, Tensor]):
        return per_node_value_and_grads(self.model.loss, params, batch)

    def full_pass(self, params_new: Params, params_old: Params,
                  batch: Dict[str, Tensor]):
        """The gradient pair over the whole node batch."""
        ln, gn = self._node_grads(params_new, batch)
        lo, go = self._node_grads(params_old, batch)
        return ln, lo, gn, go

    def mini_pass(self, params_new: Params, params_old: Params,
                  batch: Dict[str, Tensor]):
        """PAGE's minibatch pair over the first ``page_mini_batch``
        examples of every node."""
        m = self.cfg.page_mini_batch
        return self.full_pass(params_new, params_old,
                              {k: v[:, :m] for k, v in batch.items()})

    def component_pass(self, params_new: Params, params_old: Params,
                       batch: Dict[str, Tensor], component_idx: Tensor):
        """Finite-MVR's per-example pair (``trainer.py:247-274``): the
        examples ``component_idx`` (n, B) of every node, each a batch of
        one.  Returns the losses (n,), the means over the B examples,
        and the gradients (n, B, *param)."""
        n, B = component_idx.shape
        nodes = torch.arange(n, device=component_idx.device)[:, None]
        examples = {k: v[nodes, component_idx].reshape((n * B, 1)
                                                       + v.shape[2:])
                    for k, v in batch.items()}
        ln, lo, gn, go = self.full_pass(params_new, params_old, examples)

        def per_node(grads):
            return {k: g.view((n, B) + g.shape[1:]) for k, g in grads.items()}
        return (ln.view(n, B).mean(dim=1), lo.view(n, B).mean(dim=1),
                per_node(gn), per_node(go))

    def _advance_and_grads(self, state: TrainState,
                           batch: Dict[str, Tensor], draws: ShardedDraws):
        """Phases (1)-(2): the server update of the params with g^t and
        the variant's per-node gradient oracles (``trainer.py:195-293``)."""
        cfg = self.cfg
        delta, opt_new = cfg.server.update(state.dasha.g, state.opt,
                                           state.params)
        params_new = {k: (p.float() + delta[k]).to(p.dtype)
                      for k, p in state.params.items()}
        del delta
        node_kwargs: Dict[str, Any] = {}
        cache_new = state.cache
        if self.rule.needs_minibatch:        # page: the coin's pair only
            if draws.coin:
                losses_new, losses_old, g_new, g_old = self.full_pass(
                    params_new, state.params, batch)
            else:
                losses_new, losses_old, b_new, b_old = self.mini_pass(
                    params_new, state.params, batch)
                g_new = g_old = None
                node_kwargs = dict(mini_new=b_new, mini_old=b_old)
        elif self.rule.component_trackers:   # finite_mvr: per-example pair
            losses_new, losses_old, g_new, g_old = self.component_pass(
                params_new, state.params, batch, draws.component_idx)
        elif self.cache_old:                 # gradient: reuse old grads
            losses_new, g_new = self._node_grads(params_new, batch)
            if state.cache is None:
                losses_old, g_old = self._node_grads(state.params, batch)
            else:
                losses_old, g_old = state.cache
            cache_new = (losses_new, g_new)
        else:                                # mvr: same-sample pair
            losses_new, losses_old, g_new, g_old = self.full_pass(
                params_new, state.params, batch)
        return (params_new, opt_new, cache_new, losses_new, losses_old,
                g_new, g_old, node_kwargs)

    def train_step(self, state: TrainState, batch: Dict[str, Tensor],
                   draws: ShardedDraws) -> Tuple[TrainState, TrainMetrics]:
        (params_new, opt_new, cache_new, losses_new, losses_old,
         g_new, g_old, node_kwargs) = self._advance_and_grads(
            state, batch, draws)
        dasha_new, wire = self.engine.node_update(
            g_new, g_old, state.dasha, draws, **node_kwargs)
        metrics = TrainMetrics(loss=torch.mean(losses_new),
                               loss_old=torch.mean(losses_old),
                               grad_norm=tree_norm(dasha_new.g),
                               step=state.step, bits_sent=wire.bits_sent,
                               participants=wire.participants)
        return TrainState(params=params_new, dasha=dasha_new, opt=opt_new,
                          step=state.step + 1, cache=cache_new), metrics
