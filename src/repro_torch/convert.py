"""Reference arrays into the port: problem data, engine state and draws.

Takes numpy arrays or anything ``np.array`` accepts (a JAX array among
them) and always copies.  ``np.asarray`` of a JAX array is a read-only
view, and ``torch.from_numpy`` of a read-only array warns and would
alias memory the other framework owns.  The reference's objects are
read by attribute and class name only, so this module imports nothing
of the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.dasha_pp import DashaPPState
from repro_torch.core.problems import (DistributedProblem,
                                       LogisticSigmoidProblem,
                                       NonconvexSoftmaxProblem,
                                       QuadraticProblem)
from repro_torch.core.variants import RoundDraws
from repro_torch.device import resolve_device

Tensor = torch.Tensor


def tensor(x, device="cuda", dtype: Optional[torch.dtype] = None) -> Tensor:
    """A tensor holding a copy of array ``x``."""
    return torch.from_numpy(np.array(x)).to(resolve_device(device),
                                            dtype=dtype)


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
