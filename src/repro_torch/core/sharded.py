"""DASHA-PP's sharded engine, nodes simulated node-major on one card (the
port of ``repro/core/sharded.py``).

The reference runs Algorithm 1 as a ``shard_map`` over the data axes of
a mesh: one node per data slice, its ``h_i, g_i`` rows sharded with it,
the server a collective.  Here the ``n`` nodes are the leading dimension
of every per-node tensor on one device, so

* the ``shard_map`` body (``sharded.py:431-617``) is a loop over the
  parameter leaves, each flattened to ``(n, D_leaf)`` rows, in the
  reference's ``jax.tree.leaves`` order (the model's
  :func:`~repro_torch.models.model.leaf_names`);
* the all-gather is the identity and ``psum`` a sum over the node rows;
* the server's scatter of the gathered blocks (``:599-603``) is
  ``index_add_``, which sums blocks that several nodes chose.

Parity with the reference holds against a mesh whose model axis is 1:
the reference compresses each model shard of a leaf on its own
(``block_plan`` of the local size, ``:476``), so its block plans and
bits per node differ on a mesh with a model axis.

**The random-draw seam.**  A round's randomness is one
:class:`ShardedDraws`: the participation mask, the PAGE coin (a host
bool: the trainer picks the gradient pair to compute by it, and never
reads a device tensor to branch), finite-MVR's ``(n, B)`` component
indices and one ``(n, kb)`` block-index tensor per leaf.
:meth:`ShardedDasha.draw` draws it from a ``torch.Generator``; the
parity tests replay the reference's keys (``leaf_node_key(k_comp, li,
node)``, ``sharded.py:504``; ``sample_batch_indices(k_oracle, ...)``,
``repro/training/trainer.py:255``).

**Finite-MVR is sparse here**, as in :mod:`repro_torch.core.variants`:
the reference forms a dense ``(m, D)`` ``k_ij`` per node and leaf, zero
at the components not drawn, and sets every row of ``h_ij``
(``sharded.py:479-490``, ``:662-664``).  The port computes ``k_ij`` at
the ``B`` drawn rows only and sets those rows: the others would gain
exactly zero.

**In place.**  :meth:`~ShardedDasha.commit` and
:meth:`~ShardedDasha.node_update` update the state's tensors in place
(the reference's jitted step donates its state): at granite-3-2b width
a second copy of ``g_i`` and ``h_i`` is gigabytes.  ``node_update``
applies each leaf as soon as it is computed, so only one leaf's float32
temporaries exist at a time.

Left for later slices: the ``topk`` and ``dithering`` wires (the
reference's ``wire_format``; the block_randk wire is the only one here;
ROADMAP).  There is no ``torch.distributed`` here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import variants
from repro_torch.core.participation import (FullParticipation, Independent,
                                            ParticipationSampler, SNice)
from repro_torch.core.problems import sample_batch_indices, take_rows
from repro_torch.core.variants import (OracleBatch, block_plan,
                                       block_scatter_add, block_scatter_rows,
                                       block_select)

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class ShardedDashaConfig:
    gamma: float
    a: float                       # compressor momentum (Alg.1 line 11)
    b: float                       # VR momentum
    p_a: float = 1.0
    sampler: str = "independent"   # independent | s_nice | full
    compression_ratio: Optional[float] = 0.01   # K/D; None => identity
    block_size: int = 128          # BlockRandK block
    aggregation: str = "sparse_allgather"       # or dense_psum
    variant: str = "mvr"           # gradient | mvr | page | finite_mvr
    p_page: float = 1.0            # page only: full-pass probability
    # Lines 9-11 through the fused kernels (the sparse wire: the tracker
    # pass and the payload at the selected blocks only); False runs the
    # rule and the tail unfused (the reference's use_pallas=False).
    fused: bool = True

    def __post_init__(self):
        variants.get_rule(self.variant)   # raises on unknown names
        if self.aggregation not in ("sparse_allgather", "dense_psum"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")


class ShardedDashaState(NamedTuple):
    g: Params      # server estimator, param-shaped
    g_i: Params    # per-node estimators (n, *shape)
    h_i: Params    # per-node gradient trackers (n, *shape)
    step: int      # rounds taken (host-side)
    # finite_mvr only: per-node, per-component trackers (n, m, *shape)
    # in the parameters' dtype
    h_ij: Optional[Params] = None


class ShardedDraws(NamedTuple):
    """All the randomness of one round of the sharded engine."""
    mask: Tensor                                 # (n,) bool participation
    coin: Optional[bool] = None                  # PAGE's shared coin
    block_idx: Optional[Dict[str, Tensor]] = None   # leaf -> (n, kb) int64
    # finite_mvr: (n, B) int64 components, without replacement per node
    component_idx: Optional[Tensor] = None

    def to(self, device) -> "ShardedDraws":
        idx, cidx = self.block_idx, self.component_idx
        return ShardedDraws(
            self.mask.to(device), self.coin,
            None if idx is None else {k: v.to(device)
                                      for k, v in idx.items()},
            None if cidx is None else cidx.to(device))


class NodeUpdateMetrics(NamedTuple):
    participants: Tensor   # |S^t|, float32 on the device
    bits_sent: Tensor      # uplink bits this round, all nodes


class ShardedDispatch(NamedTuple):
    """One round's client work before the server applies it (float32)."""
    h_new: Params          # (n, *shape) tracker rows after the update
    g_i_inc: Params        # (n, *shape) masked uplink increments m_i
    g_delta: Params        # (*shape,) server-estimator increment
    part: Tensor           # (n,) float32 participation
    # finite_mvr: the (n, B, *shape) component-tracker rows after the
    # update, at the draw's component_idx (n, B)
    h_ij_new: Optional[Params] = None
    component_idx: Optional[Tensor] = None


def make_participation(cfg: ShardedDashaConfig, n: int
                       ) -> ParticipationSampler:
    """The sampler ``participation.participates`` stands for."""
    if cfg.sampler == "full" or cfg.p_a >= 1.0:
        return FullParticipation(n=n)
    if cfg.sampler == "independent":
        return Independent(n=n, p=cfg.p_a)
    if cfg.sampler == "s_nice":
        return SNice(n=n, s=max(1, round(cfg.p_a * n)))
    raise ValueError(f"unknown sampler {cfg.sampler!r}")


class ShardedDasha:
    """Algorithm 1 over ``num_nodes`` simulated nodes.  Usage::

        engine = ShardedDasha(cfg, n, shapes)   # shapes: leaf -> shape
        state = engine.init_zero(params)
        state, wire = engine.node_update(gn, go, state, engine.draw(gen))

    ``page`` also takes ``mini_new=/mini_old=``; of the two pairs only
    the one the coin takes need be given (the other enters the kernels
    as zeros, one transient buffer per leaf, as the reference's
    ``lax.cond`` feeds them).  ``finite_mvr`` takes component gradients
    ``(n, B, *shape)`` at ``draws.component_idx`` and carries the
    ``h_ij`` trackers in its state; ``num_components`` (``m``) and
    ``component_batch`` (``B``) size its draws.
    """

    def __init__(self, cfg: ShardedDashaConfig, num_nodes: int,
                 shapes: Dict[str, Tuple[int, ...]],
                 num_components: Optional[int] = None,
                 component_batch: int = 1):
        self.cfg = cfg
        self.rule = variants.get_rule(cfg.variant)
        self.n_nodes = num_nodes
        self.shapes = dict(shapes)
        self.sampler = make_participation(cfg, num_nodes)
        self.num_components = num_components
        self.component_batch = component_batch

    # -- state ------------------------------------------------------------
    def init(self, grads0: Params,
             h_ij0: Optional[Params] = None) -> ShardedDashaState:
        """g_i^0 = h_i^0 = the per-node gradients (n, *shape), g^0 their
        mean; ``h_i`` is a copy, since the update works in place.
        ``finite_mvr`` also takes the trackers ``h_ij0`` (n, m, *shape)."""
        if self.rule.component_trackers and h_ij0 is None:
            raise ValueError(
                f"variant {self.cfg.variant!r} needs component trackers: "
                "pass h_ij0 with leaves (n, m, *param_shape)")
        return ShardedDashaState(
            g={k: torch.mean(v, dim=0) for k, v in grads0.items()},
            g_i=dict(grads0), h_i={k: v.clone() for k, v in grads0.items()},
            step=0, h_ij=h_ij0)

    def init_zero(self, params: Params,
                  num_components: Optional[int] = None
                  ) -> ShardedDashaState:
        """g_i^0 = h_i^0 = 0 and g^0 = 0 (``sharded.py:272``);
        ``finite_mvr`` also zeroes the (n, m, *shape) ``h_ij``, ``m =
        num_components`` (default: the engine's)."""
        def node_zeros(p, *lead):
            return torch.zeros((self.n_nodes,) + lead + tuple(p.shape),
                               dtype=p.dtype, device=p.device)
        h_ij = None
        if self.rule.component_trackers:
            m = (self.num_components if num_components is None
                 else num_components)
            if m is None:
                raise ValueError(
                    f"variant {self.cfg.variant!r} needs num_components "
                    "(= m) to size the h_ij trackers")
            h_ij = {k: node_zeros(p, m) for k, p in params.items()}
        return ShardedDashaState(
            g={k: torch.zeros_like(p) for k, p in params.items()},
            g_i={k: node_zeros(p) for k, p in params.items()},
            h_i={k: node_zeros(p) for k, p in params.items()}, step=0,
            h_ij=h_ij)

    # -- wire size of one node's message -------------------------------------
    def message_bits_per_node(self) -> float:
        """Uplink bits one participating node pays per round: the sum of
        its leaves' messages (``sharded.py:316`` with one model shard)."""
        cfg = self.cfg
        return sum(variants.message_bits(
            int(math.prod(shape)), aggregation=cfg.aggregation,
            compression_ratio=cfg.compression_ratio,
            block_size=cfg.block_size) for shape in self.shapes.values())

    def uplink_bits_per_round(self, d_total: int) -> float:
        """Expected uplink bits per node per round (Tables 1-2 metric)."""
        cfg = self.cfg
        return variants.uplink_bits_per_node(
            d_total, aggregation=cfg.aggregation,
            compression_ratio=cfg.compression_ratio,
            block_size=cfg.block_size, p_a=cfg.p_a)

    # -- the round's randomness ---------------------------------------------
    def draw(self, generator: torch.Generator) -> ShardedDraws:
        """One round's draws on ``generator``'s device: the mask, the PAGE
        coin (read to the host), finite-MVR's ``B`` of the ``m``
        components of every node and, on a compressed wire, ``kb`` of the
        ``nb`` blocks of every leaf for every node, both without
        replacement."""
        cfg, dev = self.cfg, generator.device
        mask = self.sampler.sample(generator)
        coin = component_idx = None
        if self.rule.needs_coin:
            coin = bool(torch.rand((), generator=generator, device=dev)
                        < cfg.p_page)
        if self.rule.component_trackers:
            if self.num_components is None:
                raise ValueError(
                    f"variant {cfg.variant!r} draws components: give the "
                    "engine num_components")
            component_idx = sample_batch_indices(
                generator, self.n_nodes, self.num_components,
                self.component_batch, replace=False)
        block_idx = None
        if cfg.compression_ratio is not None:
            block_idx = {}
            for name, shape in self.shapes.items():
                _, nb, kb = block_plan(int(math.prod(shape)), cfg.block_size,
                                       cfg.compression_ratio)
                block_idx[name] = torch.stack([
                    torch.randperm(nb, generator=generator, device=dev)[:kb]
                    for _ in range(self.n_nodes)])
        return ShardedDraws(mask=mask, coin=coin, block_idx=block_idx,
                            component_idx=component_idx)

    # -- one leaf of lines 9-11, compression and aggregation ------------------
    def _components(self, gn: Tensor, go: Tensor, hij: Tensor, cidx: Tensor,
                    part: Tensor) -> Tuple[OracleBatch, Tensor]:
        """Alg. 4 at the drawn components of one leaf
        (``sharded.py:479-490``): ``k_ij = (m/B)(gn - go - b (h_ij - go))``
        at the ``B`` rows ``cidx`` (n, B) of ``hij`` (n, m, ...), from
        the (n, B, ...) component gradients.  -> (the oracle batch with
        ``k = sum_j k_ij / m`` (n, D), the updated rows ``h_ij + part
        k_ij / pa`` (n, B, D)), float32; the rows not drawn would gain
        exactly zero."""
        cfg, n = self.cfg, self.n_nodes
        m, B = hij.shape[1], cidx.shape[1]
        h_sel = take_rows(hij.reshape(n, m, -1), cidx).float()
        go32 = go.reshape(n, B, -1).float()
        k = gn.reshape(n, B, -1).float() - go32
        # in place from here: the same roundings as the formula, one
        # (n, B, D) float32 temporary fewer at a time
        t = (h_sel - go32).mul_(cfg.b)
        del go32
        k.sub_(t).mul_(m / B)
        del t
        h_sel.add_(part[:, None, None] * (k / cfg.p_a))
        return OracleBatch(k=torch.sum(k, dim=1) / m), h_sel

    def _leaf(self, pairs: Dict[str, Optional[Tensor]],
              h: Tensor, gi: Tensor, part: Tensor,
              coin: Optional[Tensor], block_idx: Optional[Tensor],
              hij: Optional[Tensor] = None, cidx: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
        """-> (h_new (n, D), the g_i increment m_i (n, D), the server
        increment mean_i m_i (D,), finite-MVR's updated ``h_ij`` rows
        (n, B, D) or None), float32."""
        cfg, rule, n = self.cfg, self.rule, self.n_nodes
        fh = h.reshape(n, -1).float()
        fgi = gi.reshape(n, -1).float()
        d_leaf = fh.shape[1]
        hij_new = None
        if rule.component_trackers:
            ox, hij_new = self._components(pairs["gn"], pairs["go"], hij,
                                           cidx, part)
        else:
            zeros = None
            rows = {}
            for key, x in pairs.items():
                if x is None:      # PAGE's pair the coin did not take
                    if zeros is None:
                        zeros = torch.zeros_like(fh)
                    rows[key] = zeros
                else:
                    rows[key] = x.reshape(n, -1).float()
            ox = OracleBatch(coin=coin, **rows)
            del rows, zeros
        hp = dict(b=cfg.b, a=cfg.a, pa=cfg.p_a, p_page=cfg.p_page)

        def dense_update():
            if cfg.fused:
                return rule.fused_flat(ox, fh, fgi, part, **hp)
            k = rule.k(ox, fh, b=cfg.b, p_page=cfg.p_page)
            return variants.control_variate_tail(k, fh, fgi, a=cfg.a,
                                                 pa=cfg.p_a,
                                                 part=part[:, None])

        if cfg.compression_ratio is None:
            h_new, payload = dense_update()
            gi_inc = part[:, None] * payload
            return h_new, gi_inc, torch.sum(gi_inc, dim=0) / n, hij_new
        bs, nb, kb = block_plan(d_leaf, cfg.block_size,
                                cfg.compression_ratio)
        scale = nb / kb
        if cfg.aggregation == "dense_psum":
            # the compress step is already dense here: BlockRandK has no
            # traffic to save and stays plain in both paths
            h_new, payload = dense_update()
            sel = block_select(payload, block_idx, bs) * scale
            gi_inc = part[:, None] * block_scatter_rows(sel, block_idx,
                                                        d_leaf, bs)
            return h_new, gi_inc, torch.sum(gi_inc, dim=0) / n, hij_new
        if cfg.fused:
            h_new, vals = rule.fused_flat_blocks(
                ox, fh, fgi, part, block_idx, scale=scale, block_size=bs,
                **hp)
        else:
            h_new, payload = dense_update()
            vals = block_select(payload, block_idx, bs) * scale
        del ox, fh, fgi
        vals = part[:, None, None] * vals
        delta = block_scatter_add(
            torch.zeros(d_leaf, dtype=vals.dtype, device=vals.device),
            vals, block_idx, bs) / n
        return (h_new, block_scatter_rows(vals, block_idx, d_leaf, bs),
                delta, hij_new)

    def _leaves(self, grads_new, grads_old, state, draws, mini_new,
                mini_old):
        """(name, h_new, gi_inc, delta, hij_new) leaf by leaf, each
        computed when the caller asks for it."""
        if not self.rule.needs_minibatch and (grads_new is None
                                              or grads_old is None):
            raise ValueError(f"variant {self.cfg.variant!r} needs "
                             "grads_new and grads_old")
        if self.rule.needs_minibatch:
            if draws.coin is None:
                raise ValueError("variant 'page' needs draws.coin")
            if (grads_new if draws.coin else mini_new) is None:
                raise ValueError("page: the pair the coin takes is missing "
                                 "(coin set: grads_new/grads_old; else "
                                 "mini_new/mini_old)")
        if self.rule.component_trackers:
            if draws.component_idx is None:
                raise ValueError(f"variant {self.cfg.variant!r} needs "
                                 "draws.component_idx (n, B)")
            if state.h_ij is None:
                raise ValueError("state.h_ij is None: initialize with "
                                 "init_zero(..., num_components=m) or "
                                 "init(grads0, h_ij0=...)")
        if self.cfg.compression_ratio is not None and draws.block_idx is None:
            raise ValueError("a compressed wire needs draws.block_idx")
        part = draws.mask.to(torch.float32)
        coin = None
        if draws.coin is not None:
            coin = torch.full((), draws.coin, dtype=torch.bool,
                              device=part.device)
        for name in self.shapes:
            pairs = {"gn": None if grads_new is None else grads_new[name],
                     "go": None if grads_old is None else grads_old[name]}
            if self.rule.needs_minibatch:
                pairs["bn"] = None if mini_new is None else mini_new[name]
                pairs["bo"] = None if mini_old is None else mini_old[name]
            bidx = None if draws.block_idx is None else draws.block_idx[name]
            hij = None if state.h_ij is None else state.h_ij[name]
            yield (name,) + self._leaf(pairs, state.h_i[name],
                                       state.g_i[name], part, coin, bidx,
                                       hij, draws.component_idx)

    def _metrics(self, part: Tensor) -> NodeUpdateMetrics:
        participants = torch.sum(part)
        return NodeUpdateMetrics(
            participants=participants,
            bits_sent=participants * self.message_bits_per_node())

    def dispatch(self, grads_new: Optional[Params],
                 grads_old: Optional[Params], state: ShardedDashaState,
                 draws: ShardedDraws, *, mini_new: Optional[Params] = None,
                 mini_old: Optional[Params] = None
                 ) -> Tuple[ShardedDispatch, NodeUpdateMetrics]:
        """Lines 7-11 of Algorithm 1 for every leaf, without applying them
        (``sharded.py:360``).  Holds the whole round's float32 outputs;
        :meth:`node_update` applies leaf by leaf instead."""
        h_new, gi_inc, g_delta, h_ij_new = {}, {}, {}, {}
        for name, hn, inc, delta, hij in self._leaves(
                grads_new, grads_old, state, draws, mini_new, mini_old):
            shape = self.shapes[name]
            h_new[name] = hn.reshape((self.n_nodes,) + shape)
            gi_inc[name] = inc.reshape((self.n_nodes,) + shape)
            g_delta[name] = delta.reshape(shape)
            if hij is not None:
                h_ij_new[name] = hij.reshape(hij.shape[:2] + shape)
        part = draws.mask.to(torch.float32)
        trackers = self.rule.component_trackers
        return (ShardedDispatch(
                    h_new=h_new, g_i_inc=gi_inc, g_delta=g_delta, part=part,
                    h_ij_new=h_ij_new if trackers else None,
                    component_idx=draws.component_idx if trackers else None),
                self._metrics(part))

    def _commit_leaf(self, state: ShardedDashaState, name: str,
                     h_new: Tensor, gi_inc: Tensor, delta: Tensor,
                     part: Tensor, weight: float,
                     hij_new: Optional[Tensor] = None,
                     cidx: Optional[Tensor] = None) -> None:
        g, gi, h = state.g[name], state.g_i[name], state.h_i[name]
        g.copy_((g.float() + weight * delta.reshape(g.shape)).to(g.dtype))
        gi.copy_((gi.float() + weight * gi_inc.reshape(gi.shape))
                 .to(gi.dtype))
        rows = (part > 0).reshape((-1,) + (1,) * (h.dim() - 1))
        h.copy_(torch.where(rows, h_new.reshape(h.shape), h.float())
                .to(h.dtype))
        if hij_new is not None:
            # the drawn rows of the participating nodes (``sharded.py:664``)
            hij = state.h_ij[name]
            flat = hij.view(hij.shape[0], hij.shape[1], -1)
            new = hij_new.reshape(cidx.shape + (-1,))
            index = cidx[..., None].expand(new.shape)
            old = torch.gather(flat, 1, index).float()
            flat.scatter_(1, index, torch.where(
                (part > 0)[:, None, None], new, old).to(hij.dtype))

    def commit(self, state: ShardedDashaState, disp: ShardedDispatch,
               weight: float = 1.0) -> ShardedDashaState:
        """Lines 12/19 (``sharded.py:639``): add ``weight`` times the
        increments to ``g`` and ``g_i`` and set the participating rows of
        ``h_i`` (and finite-MVR's drawn ``h_ij`` rows), in place.  Leaves
        ``step`` to the caller."""
        for name in self.shapes:
            self._commit_leaf(
                state, name, disp.h_new[name], disp.g_i_inc[name],
                disp.g_delta[name], disp.part, weight,
                None if disp.h_ij_new is None else disp.h_ij_new[name],
                disp.component_idx)
        return state

    def node_update(self, grads_new: Optional[Params],
                    grads_old: Optional[Params], state: ShardedDashaState,
                    draws: ShardedDraws, *,
                    mini_new: Optional[Params] = None,
                    mini_old: Optional[Params] = None
                    ) -> Tuple[ShardedDashaState, NodeUpdateMetrics]:
        """Lines 7-19: :meth:`dispatch` and :meth:`commit` with weight 1,
        one leaf at a time, in place."""
        part = draws.mask.to(torch.float32)
        for name, hn, inc, delta, hij in self._leaves(
                grads_new, grads_old, state, draws, mini_new, mini_old):
            self._commit_leaf(state, name, hn, inc, delta, part, 1.0, hij,
                              draws.component_idx)
            # drop this leaf's rows before the next leaf is computed
            del hn, inc, delta, hij
        return state._replace(step=state.step + 1), self._metrics(part)
