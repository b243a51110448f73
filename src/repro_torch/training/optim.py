"""Server-side optimizers (the port of ``repro/training/optim.py``).

The paper's server step is plain ``x^{t+1} = x^t - gamma * g^t`` (Alg. 1
line 5) — that is the *faithful* mode and the default.

Beyond-paper: the server may treat ``g^t`` as the gradient fed to any
first-order optimizer; AdamW is offered, as in the reference.

The step count lives on the host (a Python int), so the learning-rate
schedule and AdamW's bias corrections are host scalars, formed in
float32 as the reference forms them from its int32 count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]


class SGDState(NamedTuple):
    count: int


class AdamWState(NamedTuple):
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class ServerOptimizer:
    """optax-like (init, update) pair; ``update`` maps the DASHA estimator
    g to a parameter delta (float32)."""
    name: str
    lr: float
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    warmup: int = 0

    def init(self, params: Params):
        if self.name == "sgd":
            return SGDState(count=0)
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in params.items()}
        return AdamWState(count=0, mu=zeros,
                          nu={k: torch.zeros_like(z)
                              for k, z in zeros.items()})

    def _schedule(self, count: int) -> np.float32:
        if self.warmup <= 0:
            return np.float32(self.lr)
        w = min(np.float32(1.0), np.float32(count + 1) / np.float32(
            self.warmup))
        return np.float32(self.lr) * w

    def update(self, g: Params, state, params: Params
               ) -> Tuple[Params, Any]:
        lr = float(self._schedule(state.count))
        if self.name == "sgd":
            wd = float(np.float32(lr) * np.float32(self.weight_decay))
            delta = {k: -lr * g[k].float() - wd * p.float()
                     for k, p in params.items()}
            return delta, SGDState(count=state.count + 1)
        if self.name != "adamw":
            raise ValueError(self.name)
        c = state.count + 1
        mu = {k: self.b1 * m + (1 - self.b1) * g[k].float()
              for k, m in state.mu.items()}
        nu = {k: self.b2 * v + (1 - self.b2) * torch.square(g[k].float())
              for k, v in state.nu.items()}
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(c))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(c))
        delta = {k: -lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                            + self.eps)
                           + self.weight_decay * p.float())
                 for k, p in params.items()}
        return delta, AdamWState(count=c, mu=mu, nu=nu)


def paper_server(gamma: float) -> ServerOptimizer:
    return ServerOptimizer(name="sgd", lr=gamma)


def adamw_server(lr: float, weight_decay: float = 0.01,
                 warmup: int = 100) -> ServerOptimizer:
    return ServerOptimizer(name="adamw", lr=lr, weight_decay=weight_decay,
                           warmup=warmup)
