"""Distributed problems for the paper-scale experiments (Section A).

The port of ``repro/core/problems.py``.  A :class:`DistributedProblem`
holds per-node data as tensors on one device and exposes the oracles the
DASHA-PP variants need:

* ``grad(x) -> (n, d)``                     full local gradients,
* ``component_grads(x, idx) -> (n, B, d)``  finite-sum component grads,
* ``batch_grad(x, idx) -> (n, d)``          their mean over ``B``.

Where the reference materialises every component gradient ``(n, m, d)``
and takes its mean (``repro/core/problems.py:110-118``), ``grad`` here
is a batched product over ``feats``: at the real-sim width one
``(n, m, d)`` temporary is 6 GB, and the product needs none.
``component_grads`` touches only the ``B`` selected rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device

Tensor = torch.Tensor


def make_synthetic_classification(generator: torch.Generator, n_nodes: int,
                                  m_per_node: int, d: int,
                                  heterogeneity: float = 1.0,
                                  density: float = 0.2,
                                  device="cuda") -> Tuple[Tensor, Tensor]:
    """Sparse features A: (n, m, d), labels y in {-1, +1}: (n, m).

    The reference's generator shape (Gaussian features kept with
    probability ``density`` and rescaled, a shared hyperplane plus
    per-node shifts scaled by ``heterogeneity``, 5% label flips) drawn
    from ``generator``, which must live on ``device``.  Torch cannot
    reproduce ``jax.random`` bits, so parity tests take the reference's
    arrays instead (:mod:`repro_torch.convert`).
    """
    dev = resolve_device(device)
    kw = dict(generator=generator, device=dev)
    feats = torch.randn(n_nodes, m_per_node, d, **kw)
    # in place: at the real-sim width feats alone is 6 GB
    feats.mul_(torch.rand(n_nodes, m_per_node, d, **kw) < density)
    feats.div_(math.sqrt(density))
    w_true = torch.randn(d, **kw)
    w_shift = heterogeneity * torch.randn(n_nodes, d, **kw) / math.sqrt(d)
    logits = torch.bmm(feats, (w_true[None, :] + w_shift)[:, :, None])[..., 0]
    flips = torch.rand(n_nodes, m_per_node, **kw) < 0.05
    y = torch.where(flips, -torch.sign(logits), torch.sign(logits))
    y = torch.where(y == 0, torch.ones_like(y), y)
    return feats, y


def sample_batch_indices(generator: torch.Generator, n: int, m: int, B: int,
                         replace: bool = True) -> Tensor:
    """(n, B) per-node component indices on the generator's device;
    without replacement, the ``B`` smallest of ``m`` uniform keys."""
    dev = generator.device
    if replace:
        return torch.randint(0, m, (n, B), generator=generator, device=dev)
    keys = torch.rand(n, m, generator=generator, device=dev)
    return torch.argsort(keys, dim=1)[:, :B]


class DistributedProblem:
    """n-node finite-sum problem on one device."""

    n: int
    m: int
    d: int

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def loss(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def grad(self, x: Tensor) -> Tensor:
        """-> (n, d) full local gradients."""
        raise NotImplementedError

    def full_grad(self, x: Tensor) -> Tensor:
        return torch.mean(self.grad(x), dim=0)

    def component_grad_all(self, x: Tensor) -> Tensor:
        """-> (n, m, d) gradients of every component (finite-MVR's
        ``h_ij^0``)."""
        raise NotImplementedError

    def component_grads(self, x: Tensor, idx: Tensor) -> Tensor:
        """idx: (n, B) component indices -> (n, B, d)."""
        raise NotImplementedError

    def batch_grad(self, x: Tensor, idx: Tensor) -> Tensor:
        return torch.mean(self.component_grads(x, idx), dim=1)

    def smoothness(self) -> "tuple[float, float, float, float]":
        """(L, L_hat, L_max, L_sigma) estimates from the data."""
        raise NotImplementedError


def take_rows(t: Tensor, idx: Tensor) -> Tensor:
    """``t[i, idx[i]]`` for every node: (n, m, ...) x (n, B) -> (n, B, ...)."""
    index = idx.reshape(idx.shape + (1,) * (t.dim() - 2))
    return torch.gather(t, 1, index.expand(idx.shape + t.shape[2:]))


def _row_sq_norms(feats: Tensor) -> Tensor:
    """(n, m) squared row norms without an (n, m, d) temporary."""
    return torch.linalg.vector_norm(feats, dim=-1) ** 2


class _LinearModelProblem(DistributedProblem):
    """Shared plumbing of the two classification losses: ``z = y a^T x``
    and gradients ``coef(z) y a`` (+ a regulariser)."""

    feats: Tensor
    labels: Tensor

    def _init_shapes(self):
        if self.feats.dim() != 3 or self.labels.shape != self.feats.shape[:2]:
            raise ValueError("need feats (n, m, d) and labels (n, m)")
        self.n, self.m, self.d = self.feats.shape

    @property
    def device(self) -> torch.device:
        return self.feats.device

    def _margins(self, feats: Tensor, labels: Tensor, x: Tensor) -> Tensor:
        return torch.matmul(feats, x) * labels

    def _coef(self, z: Tensor, labels: Tensor) -> Tensor:
        raise NotImplementedError

    def _reg_grad(self, x: Tensor) -> Optional[Tensor]:
        return None

    def grad(self, x: Tensor) -> Tensor:
        coef = self._coef(self._margins(self.feats, self.labels, x),
                          self.labels)
        g = torch.bmm(coef[:, None, :], self.feats)[:, 0, :] / self.m
        reg = self._reg_grad(x)
        return g if reg is None else g + reg

    def component_grad_all(self, x: Tensor) -> Tensor:
        coef = self._coef(self._margins(self.feats, self.labels, x),
                          self.labels)
        g = coef[..., None] * self.feats
        reg = self._reg_grad(x)
        return g if reg is None else g + reg

    def component_grads(self, x: Tensor, idx: Tensor) -> Tensor:
        feats = take_rows(self.feats, idx)
        labels = take_rows(self.labels, idx)
        coef = self._coef(self._margins(feats, labels, x), labels)
        g = coef[..., None] * feats
        reg = self._reg_grad(x)
        return g if reg is None else g + reg


@dataclasses.dataclass(eq=False)
class LogisticSigmoidProblem(_LinearModelProblem):
    """Paper eq. (11): f_ij(x) = sigmoid(-y a^T x)^2."""

    feats: Tensor   # (n, m, d)
    labels: Tensor  # (n, m)

    def __post_init__(self):
        self._init_shapes()

    def _component_loss(self, x: Tensor) -> Tensor:
        z = self._margins(self.feats, self.labels, x)
        return torch.sigmoid(-z) ** 2

    def loss(self, x: Tensor) -> Tensor:
        return torch.mean(self._component_loss(x))

    def _coef(self, z: Tensor, labels: Tensor) -> Tensor:
        s = torch.sigmoid(-z)
        return -2.0 * s**2 * (1.0 - s) * labels   # d/dz sigmoid(-z)^2 * y

    def smoothness(self):
        # |(sigmoid(-z)^2)''| <= ~0.3; row smoothness <= 0.3 ||a||^2.
        L_ij = 0.31 * _row_sq_norms(self.feats)
        L_i = torch.mean(L_ij, dim=1)
        L = float(torch.mean(L_i))
        L_hat = float(torch.sqrt(torch.mean(L_i**2)))
        L_max = float(torch.max(L_ij))
        return L, L_hat, L_max, L_max


@dataclasses.dataclass(eq=False)
class NonconvexSoftmaxProblem(_LinearModelProblem):
    """Paper eq. (12) reduced to one weight vector: binary softmax CE +
    the nonconvex regulariser lam * sum x^2/(1+x^2)."""

    feats: Tensor   # (n, m, d)
    labels: Tensor  # (n, m) in {-1, +1}
    lam: float = 1e-3

    def __post_init__(self):
        self._init_shapes()

    def _component_loss(self, x: Tensor) -> Tensor:
        z = self._margins(self.feats, self.labels, x)
        ce = torch.log1p(torch.exp(-z))
        reg = self.lam * torch.sum(x**2 / (1.0 + x**2))
        return ce + reg

    def loss(self, x: Tensor) -> Tensor:
        return torch.mean(self._component_loss(x))

    def _coef(self, z: Tensor, labels: Tensor) -> Tensor:
        return -torch.sigmoid(-z) * labels

    def _reg_grad(self, x: Tensor) -> Tensor:
        return self.lam * 2.0 * x / (1.0 + x**2) ** 2

    def smoothness(self):
        L_ij = 0.25 * _row_sq_norms(self.feats) + 2.0 * self.lam
        L_i = torch.mean(L_ij, dim=1)
        L = float(torch.mean(L_i))
        L_hat = float(torch.sqrt(torch.mean(L_i**2)))
        L_max = float(torch.max(L_ij))
        return L, L_hat, L_max, L_max


@dataclasses.dataclass(eq=False)
class QuadraticProblem(DistributedProblem):
    """f_i(x) = 0.5 x^T A_i x - b_i^T x with PSD A_i — a sanity/test
    problem with analytically known constants and minimiser."""

    A: Tensor  # (n, d, d)
    b: Tensor  # (n, d)

    def __post_init__(self):
        self.n, self.d = self.b.shape
        self.m = 1

    @property
    def device(self) -> torch.device:
        return self.b.device

    @classmethod
    def random(cls, generator: torch.Generator, n: int, d: int,
               cond: float = 10.0, device="cuda") -> "QuadraticProblem":
        dev = resolve_device(device)
        mats = torch.randn(n, d, d, generator=generator,
                           device=dev) / math.sqrt(d)
        A = torch.bmm(mats, mats.transpose(1, 2)) + torch.eye(
            d, device=dev) / cond
        b = torch.randn(n, d, generator=generator, device=dev)
        return cls(A=A, b=b)

    def loss(self, x: Tensor) -> Tensor:
        return torch.mean(self.node_loss(x))

    def node_loss(self, x: Tensor) -> Tensor:
        quad = 0.5 * torch.einsum("d,nde,e->n", x, self.A, x)
        return quad - self.b @ x

    def grad(self, x: Tensor) -> Tensor:
        return torch.einsum("nde,e->nd", self.A, x) - self.b

    def component_grad_all(self, x: Tensor) -> Tensor:
        return self.grad(x)[:, None, :]

    def component_grads(self, x: Tensor, idx: Tensor) -> Tensor:
        return self.grad(x)[:, None, :].expand(idx.shape + (self.d,)) \
            .contiguous()

    def smoothness(self):
        eigs = torch.linalg.eigvalsh(self.A)
        L_i = eigs[:, -1]
        L = float(torch.linalg.eigvalsh(torch.mean(self.A, 0))[-1])
        L_hat = float(torch.sqrt(torch.mean(L_i**2)))
        L_max = float(torch.max(L_i))
        return L, L_hat, L_max, L_max
