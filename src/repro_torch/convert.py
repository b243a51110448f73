"""Reference arrays into the port: problem data, engine state and draws,
the LM trainer's parameters and state, and serving's decode states.

Takes numpy arrays or anything ``np.array`` accepts (a JAX array among
them) and always copies.  ``np.asarray`` of a JAX array is a read-only
view, and ``torch.from_numpy`` of a read-only array warns and would
alias memory the other framework owns.  The reference's objects are
read by attribute and class name only, so this module imports nothing
of the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.dasha_pp import DashaPPState
from repro_torch.core.sharded import ShardedDashaState
from repro_torch.core.problems import (DistributedProblem,
                                       LogisticSigmoidProblem,
                                       NonconvexSoftmaxProblem,
                                       QuadraticProblem)
from repro_torch.core.variants import RoundDraws
from repro_torch.device import resolve_device

Tensor = torch.Tensor


def tensor(x, device="cuda", dtype: Optional[torch.dtype] = None) -> Tensor:
    """A tensor holding a copy of array ``x`` (a bfloat16 array goes
    through float32, which holds it exactly)."""
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            resolve_device(device), dtype=dtype or torch.bfloat16)
    return torch.from_numpy(arr).to(resolve_device(device), dtype=dtype)


def problem(ref_problem, device="cuda") -> DistributedProblem:
    """The port's problem holding a copy of a reference problem's data."""
    name = type(ref_problem).__name__
    if name == "LogisticSigmoidProblem":
        return LogisticSigmoidProblem(tensor(ref_problem.feats, device),
                                      tensor(ref_problem.labels, device))
    if name == "NonconvexSoftmaxProblem":
        return NonconvexSoftmaxProblem(tensor(ref_problem.feats, device),
                                       tensor(ref_problem.labels, device),
                                       lam=ref_problem.lam)
    if name == "QuadraticProblem":
        return QuadraticProblem(A=tensor(ref_problem.A, device),
                                b=tensor(ref_problem.b, device))
    raise TypeError(f"no port of problem {name}")


def state(ref_state, device="cuda") -> DashaPPState:
    """A copy of a reference ``DashaPPState``."""
    h_ij = ref_state.h_ij
    return DashaPPState(
        x=tensor(ref_state.x, device), g=tensor(ref_state.g, device),
        g_i=tensor(ref_state.g_i, device), h_i=tensor(ref_state.h_i, device),
        h_ij=None if h_ij is None else tensor(h_ij, device),
        step=tensor(ref_state.step, device, torch.int64))


def round_draws(mask, batch_idx=None, coin=None, comp_idx=None,
                device="cuda") -> RoundDraws:
    """One round's draws from arrays: ``mask`` (n,), ``batch_idx``
    (n, B), ``coin`` (), ``comp_idx`` (n, k) or (n, kb) indices, or the
    (n, d) float uniforms of dithering."""
    def idx(a):
        return None if a is None else tensor(a, device, torch.int64)
    comp = None
    if comp_idx is not None:
        floating = np.issubdtype(np.asarray(comp_idx).dtype, np.floating)
        comp = (tensor(comp_idx, device, torch.float32) if floating
                else idx(comp_idx))
    return RoundDraws(
        mask=tensor(mask, device, torch.bool), batch_idx=idx(batch_idx),
        coin=None if coin is None else tensor(coin, device, torch.bool),
        comp_idx=comp)


def params_from_jax(tree, device="cuda") -> Dict[str, Tensor]:
    """A reference parameter pytree (nested dicts of arrays) as the port's
    flat ``{dotted name: tensor}`` dict, in ``jax.tree.leaves`` order
    (keys sorted at every level)."""
    flat: Dict[str, Tensor] = {}

    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], prefix + key + ".")
            else:
                flat[prefix + key] = tensor(node[key], device)

    walk(tree, "")
    return flat


def train_state_from_jax(ref_state, device="cuda"):
    """A copy of a reference ``TrainState`` (``repro.training.trainer``):
    params, the engine's ``g``/``g_i``/``h_i`` (and finite-MVR's
    ``h_ij``), the server optimizer's state and the step counters.  The gradient variant's cache carries
    over from the second round on (before it the reference's cache is
    zeros it does not read, the port's ``None``)."""
    from repro_torch.training import optim
    from repro_torch.training.trainer import TrainState

    def count(x):
        return int(np.array(x))

    d = ref_state.dasha
    dasha = ShardedDashaState(g=params_from_jax(d.g, device),
                              g_i=params_from_jax(d.g_i, device),
                              h_i=params_from_jax(d.h_i, device),
                              step=count(d.step),
                              h_ij=None if d.h_ij is None
                              else params_from_jax(d.h_ij, device))
    opt = ref_state.opt
    if type(opt).__name__ == "SGDState":
        opt = optim.SGDState(count=count(opt.count))
    else:
        opt = optim.AdamWState(count=count(opt.count),
                               mu=params_from_jax(opt.mu, device),
                               nu=params_from_jax(opt.nu, device))
    step = count(ref_state.step)
    cache = None
    if len(ref_state.cache) and step > 0:
        losses, grads = ref_state.cache
        cache = (tensor(losses, device), params_from_jax(grads, device))
    return TrainState(params=params_from_jax(ref_state.params, device),
                      dasha=dasha, opt=opt, step=step, cache=cache)


def _layer_caches(ref_caches, device):
    """A reference decode-cache tree as the port's tuple of one attention
    cache a layer (``KVCache`` or ``MLACache``, the same fields): the
    reference stacks the layers ``(L, ...)`` under its scan, or keeps a
    tuple when it unrolls."""
    from repro_torch.models.layers import KVCache
    from repro_torch.models.mla import MLACache
    ported = {"KVCache": KVCache, "MLACache": MLACache}
    kind = type(ref_caches).__name__
    if kind in ported:                                  # stacked (L, ...)
        fields = [np.array(x) for x in ref_caches]
        return tuple(ported[kind](*(tensor(x[i], device) for x in fields))
                     for i in range(fields[0].shape[0]))
    for c in ref_caches:
        if type(c).__name__ not in ported:
            raise TypeError(f"no port of decode cache {type(c).__name__} "
                            "(ROADMAP queue 1, slice 3 item 7)")
    return tuple(ported[type(c).__name__](*(tensor(x, device) for x in c))
                 for c in ref_caches)


def decode_state_from_jax(ref_state, device="cuda"):
    """A copy of a reference dense ``DecodeState`` (``repro.models.model``),
    its ring caches one ``KVCache`` or ``MLACache`` a layer."""
    from repro_torch.models.model import DecodeState
    return DecodeState(caches=_layer_caches(ref_state.caches, device),
                       position=tensor(ref_state.position, device,
                                       torch.int64))


def paged_state_from_jax(ref_state, device="cuda"):
    """A copy of a reference ``PagedDecodeState``: its pool pages one
    ``KVCache`` or ``MLACache`` a layer, with the port's scratch page
    (zeros) appended after the reference's ``num_pages``."""
    from repro_torch.models.model import PagedDecodeState

    def with_scratch(x):
        return torch.cat([x, torch.zeros_like(x[:1])])

    caches = tuple(type(c)(*(with_scratch(x) for x in c))
                   for c in _layer_caches(ref_state.caches, device))
    return PagedDecodeState(
        caches=caches,
        page_table=tensor(ref_state.page_table, device, torch.int32),
        seq_lens=tensor(ref_state.seq_lens, device, torch.int32))
