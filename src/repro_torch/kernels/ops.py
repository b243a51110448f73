"""The op layer the engines call for Algorithm 1 lines 9-11 (dense, and
split for the sparse wire), the async server for its commit, the
sharded engine for BlockRandK's block gather and scatter, and the
serving models for their paged attention (GQA and MLA).

The port of ``repro/kernels/ops.py:63-186``; the flat ops there
(``dasha_update_op``, the sharded engine's per-leaf forms) are the
batched ones here with one row per node.  Each op looks at where its
tensors lie: on the CPU it runs the kernel's plain version
(:mod:`.ref`); on a CUDA device it launches the kernel
(:mod:`.dasha_update`, :mod:`.randk`, :mod:`.paged_attention`), which
raises if it cannot.
There is no other switch, and no fallback from the kernel to the plain
version.  Each op runs inside :func:`repro_torch.obs.trace.kernel_scope`,
so ``torch.profiler`` traces name it (``repro.kernel.<name>``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import dasha_update as kernels
from repro_torch.kernels import paged_attention, randk, ref
from repro_torch.obs.trace import kernel_scope

Tensor = torch.Tensor


def _on_cuda(x: Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _scoped(name: str):
    """Run the op inside ``kernel_scope(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with kernel_scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@_scoped("dasha_update_batched")
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


@_scoped("dasha_page_update")
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


@_scoped("dasha_tail")
def dasha_tail_op(k: Tensor, h: Tensor, gi: Tensor, mask: Tensor, *,
                  a: float, pa: float) -> Tuple[Tensor, Tensor]:
    """Fused lines 10-11 given ``k`` (Alg. 4).  Returns
    ``(h_new, payload)``."""
    if _on_cuda(k):
        return kernels.dasha_tail_batched(k, h, gi, mask.to(torch.float32),
                                          a=a, pa=pa)
    return ref.dasha_tail_batched_ref(k, h, gi, mask, a=a, pa=pa)


@_scoped("buffered_commit")
def buffered_commit_op(g: Tensor, m_buf: Tensor, weights: Tensor, *,
                       n_nodes: int) -> Tensor:
    """The async server step ``g + (1/n_nodes) (weights @ m_buf)`` in one
    pass over the (K, d) buffer of arrived messages."""
    if _on_cuda(g):
        return kernels.buffered_commit(g, m_buf,
                                       weights.to(torch.float32),
                                       n_nodes=n_nodes)
    return ref.buffered_commit_ref(g, m_buf, weights, n_nodes=n_nodes)


@_scoped("dasha_h_update")
def dasha_h_update_op(gn: Tensor, go: Tensor, h: Tensor, mask: Tensor, *,
                      b: float, pa: float) -> Tensor:
    """Line 10 alone over (n, d), Algs. 2/5: ``h_new``."""
    if _on_cuda(gn):
        return kernels.dasha_h_update(gn, go, h, mask.to(torch.float32),
                                      b=b, pa=pa)
    return ref.dasha_h_update_ref(gn, go, h, mask, b=b, pa=pa)


@_scoped("dasha_page_h_update")
def dasha_page_h_update_op(gn: Tensor, go: Tensor, bn: Tensor, bo: Tensor,
                           h: Tensor, mask: Tensor, coin: Tensor, *,
                           b: float, pa: float, p_page: float) -> Tensor:
    """Line 10 alone over (n, d), Alg. 3; ``coin`` a 0-d tensor on the
    same device."""
    if _on_cuda(gn):
        return kernels.dasha_page_h_update(
            gn, go, bn, bo, h, mask.to(torch.float32),
            coin.to(torch.float32).reshape(1), b=b, pa=pa, p_page=p_page)
    return ref.dasha_page_h_update_ref(gn, go, bn, bo, h, mask, coin, b=b,
                                       pa=pa, p_page=p_page)


@_scoped("dasha_payload_blocks")
def dasha_payload_blocks_op(gn: Tensor, go: Tensor, h: Tensor, gi: Tensor,
                            block_idx: Tensor, *, b: float, a: float,
                            pa: float, scale: float, block_size: int
                            ) -> Tensor:
    """The Algs. 2/5 payload at the (n, kb) selected blocks, times
    ``scale``: (n, kb, block_size)."""
    if _on_cuda(gn):
        return kernels.dasha_payload_blocks(
            gn, go, h, gi, block_idx.to(torch.int32), b=b, a=a, pa=pa,
            scale=scale, block_size=block_size)
    return ref.dasha_payload_blocks_ref(gn, go, h, gi, block_idx, b=b, a=a,
                                        pa=pa, scale=scale,
                                        block_size=block_size)


@_scoped("dasha_page_payload_blocks")
def dasha_page_payload_blocks_op(gn: Tensor, go: Tensor, bn: Tensor,
                                 bo: Tensor, h: Tensor, gi: Tensor,
                                 block_idx: Tensor, coin: Tensor, *,
                                 b: float, a: float, pa: float,
                                 p_page: float, scale: float,
                                 block_size: int) -> Tensor:
    """The Alg. 3 payload at the selected blocks, times ``scale``."""
    if _on_cuda(gn):
        return kernels.dasha_page_payload_blocks(
            gn, go, bn, bo, h, gi, block_idx.to(torch.int32),
            coin.to(torch.float32).reshape(1), b=b, a=a, pa=pa,
            p_page=p_page, scale=scale, block_size=block_size)
    return ref.dasha_page_payload_blocks_ref(
        gn, go, bn, bo, h, gi, block_idx, coin, b=b, a=a, pa=pa,
        p_page=p_page, scale=scale, block_size=block_size)


@_scoped("block_gather")
def block_gather_op(payload: Tensor, block_idx: Tensor, *, scale: float,
                    block_size: int) -> Tensor:
    """The (n, kb, block_size) blocks of the (n, d) rows at the (n, kb)
    int64 ``block_idx``, times ``scale``, zero past ``d``."""
    if _on_cuda(payload):
        return randk.block_gather(payload, block_idx, scale=scale,
                                  block_size=block_size)
    return ref.block_gather_ref(payload, block_idx, scale=scale,
                                block_size=block_size)


@_scoped("block_scatter")
def block_scatter_op(base: Tensor, vals: Tensor, rows: Tensor) -> Tensor:
    """``base`` (R, bs) plus ``vals`` (K, bs) at the int64 ``rows`` (K,),
    in place.  The rows must be distinct: the op does not check (a check
    would sync), and the kernel would race on a repeat."""
    if _on_cuda(base):
        return randk.block_scatter(base, vals, rows)
    return ref.block_scatter_ref(base, vals, rows)


@_scoped("paged_attention_batched")
def paged_attention_batched_op(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                               page_table: Tensor, start: Tensor,
                               q_lens: Tensor, *,
                               window: Optional[int] = None) -> Tensor:
    """The fused paged GQA attention of a serve pass: q (B, C, H, hd)
    against the pool pages (NP, P, kvH, hd) through the (B, M) table,
    query ``c`` of slot ``b`` at ``start[b] + c``; (B, C, H, hd) float32.
    Rows ``c >= q_lens`` are garbage by contract (the kernel writes 0
    there, the plain version attends as the reference's oracle does)."""
    if _on_cuda(q):
        return paged_attention.paged_attention_batched(
            q, k_pages, v_pages, page_table.to(torch.int32),
            start.to(torch.int32), q_lens.to(torch.int32), window=window)
    return ref.paged_attention_batched_ref(q, k_pages, v_pages, page_table,
                                           start, q_lens, window=window)


@_scoped("paged_attention")
def paged_attention_op(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                       page_table: Tensor, lens: Tensor, *,
                       window: Optional[int] = None) -> Tensor:
    """The single-query decode view: q (B, H, hd), ``lens`` (B,) tokens a
    slot holds counting the one just written; (B, H, hd) float32."""
    if _on_cuda(q):
        return paged_attention.paged_attention(
            q, k_pages, v_pages, page_table.to(torch.int32),
            lens.to(torch.int32), window=window)
    return ref.paged_attention_ref(q, k_pages, v_pages, page_table, lens,
                                   window=window)


@_scoped("paged_mla_attention")
def paged_mla_attention_op(q_abs: Tensor, q_rope: Tensor, ckv_pages: Tensor,
                           kr_pages: Tensor, page_table: Tensor,
                           start: Tensor, q_lens: Tensor, *, scale: float,
                           window: Optional[int] = None) -> Tensor:
    """The absorbed-form paged MLA read of a serve pass: q_abs (B, C, H, r)
    and q_rope (B, C, H, rope) against the latent pages (NP, P, r) and
    (NP, P, rope) through the (B, M) table, query ``c`` of slot ``b`` at
    ``start[b] + c``, scores ``(q_abs . c_kv + q_rope . k_rope) * scale``;
    the latent output (B, C, H, r) float32, to which the caller applies
    ``W_uv``.  Rows ``c >= q_lens`` are garbage by contract (the kernel
    writes 0 there, the plain version attends as the oracle does)."""
    if _on_cuda(q_abs):
        return paged_attention.paged_mla_attention(
            q_abs.float().contiguous(), q_rope.contiguous(), ckv_pages,
            kr_pages, page_table.to(torch.int32), start.to(torch.int32),
            q_lens.to(torch.int32), scale=scale, window=window)
    return ref.paged_mla_attention_ref(q_abs, q_rope, ckv_pages, kr_pages,
                                       page_table, start, q_lens,
                                       scale=scale, window=window)
