"""Plain PyTorch versions of the port's CUDA kernels: the three DASHA-PP
updates and the async server's buffered commit.

Each follows its Pallas body's arithmetic operation for operation
(``repro/kernels/dasha_update.py:159-163``, ``:209-215``, ``:260-262``,
``:389-394``): the hyperparameters enter as ``inv_pa = 1 / pa``,
``a * inv_pa``, ``b / p_page`` and ``inv_n = 1 / n`` formed in Python
double, and the PAGE coin blends the two branches arithmetically.  The
buffered commit sums its ``K`` rows one after another in order, as the
CUDA kernel does; ``w @ m``, whose order BLAS leaves open, would not
round the same way.  The CUDA kernels in ``csrc/dasha_update.cu``
round every operation the same way (built with ``--fmad=false``), so on
the card the two agree exactly.

The main path calls these only for CPU tensors (:mod:`.ops`); the tests
and ``chip_smoke.py`` also call them on CUDA tensors to hold the kernels
to them.  ``mask`` is the (n,) participation indicator, bool or float.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _tail(k: Tensor, h: Tensor, gi: Tensor, mask: Tensor, *, a: float,
          pa: float) -> Tuple[Tensor, Tensor]:
    part = mask.to(k.dtype)[:, None]
    inv_pa = 1.0 / pa
    k_pa = k * inv_pa
    h_new = h + part * k_pa
    payload = k_pa - (a * inv_pa) * (gi - h)
    return h_new, payload


def dasha_update_batched_ref(gn: Tensor, go: Tensor, h: Tensor, gi: Tensor,
                             mask: Tensor, *, b: float, a: float, pa: float
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Algs. 2/5 + lines 10-11: ``k = gn - go - b (h - go)``, then
    ``h_new = h + mask k/pa`` and ``payload = k/pa - (a/pa)(gi - h)``."""
    k = gn - go - b * (h - go)
    return (k,) + _tail(k, h, gi, mask, a=a, pa=pa)


def dasha_page_update_batched_ref(gn: Tensor, go: Tensor, bn: Tensor,
                                  bo: Tensor, h: Tensor, gi: Tensor,
                                  mask: Tensor, coin: Tensor, *, b: float,
                                  a: float, pa: float, p_page: float
                                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Alg. 3: ``k = coin k_full + (1 - coin) k_mini`` with the full
    branch ``gn - go - (b/p_page)(h - go)`` and the minibatch branch
    ``bn - bo``; ``coin`` is a 0-d tensor.  Then the same tail."""
    c = coin.to(gn.dtype)
    k_full = gn - go - (b / p_page) * (h - go)
    k_mini = bn - bo
    k = c * k_full + (1.0 - c) * k_mini
    return (k,) + _tail(k, h, gi, mask, a=a, pa=pa)


def dasha_tail_batched_ref(k: Tensor, h: Tensor, gi: Tensor, mask: Tensor,
                           *, a: float, pa: float) -> Tuple[Tensor, Tensor]:
    """Lines 10-11 given ``k`` (Alg. 4, finite-MVR)."""
    return _tail(k, h, gi, mask, a=a, pa=pa)


def buffered_commit_ref(g: Tensor, m_buf: Tensor, weights: Tensor, *,
                        n_nodes: int) -> Tensor:
    """``g + (1/n_nodes) sum_k weights[k] m_buf[k]``, the rows summed in
    order in float32 (``K = 0`` gives ``g``)."""
    acc = torch.zeros_like(g)
    for k in range(m_buf.shape[0]):
        acc = acc + weights[k] * m_buf[k]
    return g + (1.0 / n_nodes) * acc
