"""The op layer the engine calls for Algorithm 1 lines 9-11, and the
async server for its commit.

The port of ``repro/kernels/ops.py:76-115`` and ``:177-186``.  Each op looks at where its
tensors lie: on the CPU it runs the kernel's plain version
(:mod:`.ref`); on a CUDA device it launches the kernel
(:mod:`.dasha_update`), which raises if it cannot.  There is no other
switch, and no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import dasha_update as kernels
from repro_torch.kernels import ref

Tensor = torch.Tensor


def _on_cuda(x: Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def dasha_update_batched_op(gn: Tensor, go: Tensor, h: Tensor, gi: Tensor,
                            mask: Tensor, *, b: float, a: float, pa: float
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused Algs. 2/5 update over (n, d); ``mask`` (n,) bool or float.
    Returns ``(k, h_new, payload)``."""
    if _on_cuda(gn):
        return kernels.dasha_update_batched(
            gn, go, h, gi, mask.to(torch.float32), b=b, a=a, pa=pa)
    return ref.dasha_update_batched_ref(gn, go, h, gi, mask, b=b, a=a,
                                        pa=pa)


def dasha_page_update_op(gn: Tensor, go: Tensor, bn: Tensor, bo: Tensor,
                         h: Tensor, gi: Tensor, mask: Tensor, coin: Tensor,
                         *, b: float, a: float, pa: float, p_page: float
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused Alg. 3 update: both branches, the coin blend and lines
    10-11.  ``coin`` is a 0-d tensor on the same device."""
    if _on_cuda(gn):
        return kernels.dasha_page_update_batched(
            gn, go, bn, bo, h, gi, mask.to(torch.float32),
            coin.to(torch.float32).reshape(1), b=b, a=a, pa=pa,
            p_page=p_page)
    return ref.dasha_page_update_batched_ref(gn, go, bn, bo, h, gi, mask,
                                             coin, b=b, a=a, pa=pa,
                                             p_page=p_page)


def dasha_tail_op(k: Tensor, h: Tensor, gi: Tensor, mask: Tensor, *,
                  a: float, pa: float) -> Tuple[Tensor, Tensor]:
    """Fused lines 10-11 given ``k`` (Alg. 4).  Returns
    ``(h_new, payload)``."""
    if _on_cuda(k):
        return kernels.dasha_tail_batched(k, h, gi, mask.to(torch.float32),
                                          a=a, pa=pa)
    return ref.dasha_tail_batched_ref(k, h, gi, mask, a=a, pa=pa)


def buffered_commit_op(g: Tensor, m_buf: Tensor, weights: Tensor, *,
                       n_nodes: int) -> Tensor:
    """The async server step ``g + (1/n_nodes) (weights @ m_buf)`` in one
    pass over the (K, d) buffer of arrived messages."""
    if _on_cuda(g):
        return kernels.buffered_commit(g, m_buf,
                                       weights.to(torch.float32),
                                       n_nodes=n_nodes)
    return ref.buffered_commit_ref(g, m_buf, weights, n_nodes=n_nodes)
