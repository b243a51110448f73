"""Plain PyTorch versions of the port's CUDA kernels: the three DASHA-PP
updates, the sparse wire's tracker and payload passes, the async
server's buffered commit, BlockRandK's block gather and scatter, and the
paged GQA and MLA attentions of serving.

Each follows its Pallas body's arithmetic operation for operation
(``repro/kernels/dasha_update.py:159-163``, ``:209-215``, ``:260-262``,
``:305-306``, ``:346-349``, ``:389-394``, ``:445-451``, ``:502-507``):
the hyperparameters enter as ``inv_pa = 1 / pa``,
``a * inv_pa``, ``b / p_page`` and ``inv_n = 1 / n`` formed in Python
double, and the PAGE coin blends the two branches arithmetically.  The
buffered commit sums its ``K`` rows one after another in order, as the
CUDA kernel does; ``w @ m``, whose order BLAS leaves open, would not
round the same way.  The CUDA kernels in ``csrc/dasha_update.cu``
round every operation the same way (built with ``--fmad=false``), so on
the card the two agree exactly.  The paged attentions are the exception:
their plain versions are the reference's oracles (a full softmax), and
the kernels in ``csrc/paged_attention.cu`` and
``csrc/paged_mla_attention.cu`` walk the pages with an online softmax,
summing in another order, so the two agree within a tolerance.

The main path calls these only for CPU tensors (:mod:`.ops`); the tests
and ``chip_smoke.py`` also call them on CUDA tensors to hold the kernels
to them.  ``mask`` is the (n,) participation indicator, bool or float.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _k_same_sample(gn: Tensor, go: Tensor, h: Tensor, b: float) -> Tensor:
    return gn - go - b * (h - go)


def _k_page(gn: Tensor, go: Tensor, bn: Tensor, bo: Tensor, h: Tensor,
            coin: Tensor, b: float, p_page: float) -> Tensor:
    c = coin.to(gn.dtype)
    k_full = gn - go - (b / p_page) * (h - go)
    k_mini = bn - bo
    return c * k_full + (1.0 - c) * k_mini


def dasha_update_batched_ref(gn: Tensor, go: Tensor, h: Tensor, gi: Tensor,
                             mask: Tensor, *, b: float, a: float, pa: float
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Algs. 2/5 + lines 10-11: ``k = gn - go - b (h - go)``, then
    ``h_new = h + mask k/pa`` and ``payload = k/pa - (a/pa)(gi - h)``."""
    k = _k_same_sample(gn, go, h, b)
    return (k,) + _tail(k, h, gi, mask, a=a, pa=pa)


def dasha_page_update_batched_ref(gn: Tensor, go: Tensor, bn: Tensor,
                                  bo: Tensor, h: Tensor, gi: Tensor,
                                  mask: Tensor, coin: Tensor, *, b: float,
                                  a: float, pa: float, p_page: float
                                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Alg. 3: ``k = coin k_full + (1 - coin) k_mini`` with the full
    branch ``gn - go - (b/p_page)(h - go)`` and the minibatch branch
    ``bn - bo``; ``coin`` is a 0-d tensor.  Then the same tail."""
    k = _k_page(gn, go, bn, bo, h, coin, b, p_page)
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


def dasha_h_update_ref(gn: Tensor, go: Tensor, h: Tensor, mask: Tensor, *,
                       b: float, pa: float) -> Tensor:
    """Line 10 alone, (n, d): ``h + mask (k (1/pa))`` with the Algs. 2/5
    ``k``."""
    part = mask.to(gn.dtype)[:, None]
    return h + part * (_k_same_sample(gn, go, h, b) * (1.0 / pa))


def dasha_page_h_update_ref(gn: Tensor, go: Tensor, bn: Tensor, bo: Tensor,
                            h: Tensor, mask: Tensor, coin: Tensor, *,
                            b: float, pa: float, p_page: float) -> Tensor:
    """Line 10 alone with the Alg. 3 ``k``; ``coin`` a 0-d tensor."""
    part = mask.to(gn.dtype)[:, None]
    k = _k_page(gn, go, bn, bo, h, coin, b, p_page)
    return h + part * (k * (1.0 / pa))


def block_positions(block_idx: Tensor, d: int, block_size: int
                    ) -> Tuple[Tensor, Tensor]:
    """The (..., kb, block_size) element positions of the selected
    blocks of a ``d``-row, clamped into the row, and the mask of those
    inside it (a block past ``d`` is the reference's zero padding)."""
    lane = torch.arange(block_size, device=block_idx.device)
    pos = block_idx.to(torch.int64)[..., None] * block_size + lane
    return pos.clamp(max=d - 1), pos < d


def _payload_blocks(k_fn, rows, gi: Tensor, h: Tensor, block_idx: Tensor,
                    *, a: float, pa: float, scale: float,
                    block_size: int) -> Tensor:
    n, d = h.shape
    pos, inside = block_positions(block_idx, d, block_size)
    flat = pos.reshape(n, -1)

    def at(x):
        return torch.gather(x, 1, flat).reshape(pos.shape)

    hb = at(h)
    k = k_fn(*(at(x) for x in rows), hb)
    inv_pa = 1.0 / pa
    payload = k * inv_pa - (a * inv_pa) * (at(gi) - hb)
    return torch.where(inside, payload * scale, torch.zeros_like(payload))


def dasha_payload_blocks_ref(gn: Tensor, go: Tensor, h: Tensor, gi: Tensor,
                             block_idx: Tensor, *, b: float, a: float,
                             pa: float, scale: float, block_size: int
                             ) -> Tensor:
    """The Algs. 2/5 line-11 payload at the selected blocks, times
    ``scale``: (n, kb, block_size) from (n, d) rows and (n, kb) block
    numbers, zero past ``d``."""
    return _payload_blocks(lambda gn_, go_, h_: _k_same_sample(gn_, go_, h_,
                                                               b),
                           (gn, go), gi, h, block_idx, a=a, pa=pa,
                           scale=scale, block_size=block_size)


def dasha_page_payload_blocks_ref(gn: Tensor, go: Tensor, bn: Tensor,
                                  bo: Tensor, h: Tensor, gi: Tensor,
                                  block_idx: Tensor, coin: Tensor, *,
                                  b: float, a: float, pa: float,
                                  p_page: float, scale: float,
                                  block_size: int) -> Tensor:
    """The Alg. 3 payload at the selected blocks, times ``scale``."""
    return _payload_blocks(
        lambda gn_, go_, bn_, bo_, h_: _k_page(gn_, go_, bn_, bo_, h_, coin,
                                               b, p_page),
        (gn, go, bn, bo), gi, h, block_idx, a=a, pa=pa, scale=scale,
        block_size=block_size)


def block_gather_ref(payload: Tensor, block_idx: Tensor, *, scale: float,
                     block_size: int) -> Tensor:
    """The (n, kb, block_size) blocks of the (n, d) rows named by
    ``block_idx`` (n, kb), times ``scale``, zero past ``d``
    (``repro/kernels/randk.py:31-33`` after ``_pad_to``)."""
    n, d = payload.shape
    pos, inside = block_positions(block_idx, d, block_size)
    vals = torch.gather(payload, 1, pos.reshape(n, -1)).reshape(pos.shape)
    return torch.where(inside, vals * scale, torch.zeros_like(vals))


def block_scatter_ref(base: Tensor, vals: Tensor, rows: Tensor) -> Tensor:
    """``base[rows[k]] += vals[k]`` in place over (R, bs) rows
    (``repro/kernels/randk.py:58-61``); ``index_add_`` also sums
    repeated rows, which the kernel's callers never pass."""
    return base.index_add_(0, rows, vals)


def paged_attention_batched_ref(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                                page_table: Tensor, start: Tensor,
                                q_lens: Tensor, *,
                                window: Optional[int] = None) -> Tensor:
    """Batched gather attention over a page pool
    (``repro/kernels/paged_attention.py:104-130``): q (B, C, H, hd), up to
    C queries a slot; ``k_pages``/``v_pages`` (NP, P, kvH, hd), cast to
    float32 whole as the oracle casts them; ``page_table`` (B, M);
    ``start`` (B,) tokens a slot holds before this pass's writes, so query
    ``c`` sits at ``start + c``; ``q_lens`` (B,) valid queries a slot
    (rows ``c >= q_lens`` are garbage by contract; here they attend like
    the others, as in the oracle).  Masked scores are -1e30 and the scale
    is ``/ sqrt(hd)``.  Returns (B, C, H, hd) float32."""
    del q_lens
    B, C, H, hd = q.shape
    P, kvh = k_pages.shape[1], k_pages.shape[2]
    M = page_table.shape[1]
    G = H // kvh
    table = page_table.long()
    k = k_pages[table].reshape(B, M * P, kvh, hd).float()
    v = v_pages[table].reshape(B, M * P, kvh, hd).float()
    idx = torch.arange(M * P, device=q.device)[None, None, :]    # (1, 1, S)
    q_pos = (start.long()[:, None]
             + torch.arange(C, device=q.device)[None, :])         # (B, C)
    valid = idx < (q_pos + 1)[:, :, None]
    if window is not None:
        valid &= idx > (q_pos[:, :, None] - window)
    qg = q.reshape(B, C, kvh, G, hd).float()
    s = torch.einsum("bckgh,bskh->bkgcs", qg, k) / math.sqrt(hd)
    s = torch.where(valid[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", p, v)
    return out.reshape(B, C, H, hd)


def paged_attention_ref(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                        page_table: Tensor, lens: Tensor, *,
                        window: Optional[int] = None) -> Tensor:
    """The single-query decode view (``paged_attention.py:133-143``):
    q (B, H, hd), ``lens`` (B,) tokens a slot holds counting the one just
    written, so ``start = lens - 1`` and one query a slot."""
    B = q.shape[0]
    out = paged_attention_batched_ref(
        q[:, None], k_pages, v_pages, page_table,
        torch.clamp(lens - 1, min=0),
        torch.ones(B, dtype=torch.int32, device=q.device), window=window)
    return out[:, 0]


def paged_mla_attention_ref(q_abs: Tensor, q_rope: Tensor, ckv_pages: Tensor,
                            kr_pages: Tensor, page_table: Tensor,
                            start: Tensor, q_lens: Tensor, *, scale: float,
                            window: Optional[int] = None) -> Tensor:
    """Absorbed-form MLA latent attention over a page pool
    (``repro/kernels/paged_attention.py:146-172``): q_abs (B, C, H, r),
    the nope query with ``W_uk`` folded in; q_rope (B, C, H, rope_hd);
    ``ckv_pages`` (NP, P, r) and ``kr_pages`` (NP, P, rope_hd), cast to
    float32 whole as the oracle casts them; query ``c`` of slot ``b``
    sits at ``start[b] + c`` (rows ``c >= q_lens`` are garbage by
    contract and attend like the others here, as in the oracle).  Scores
    are ``(q_abs . c_kv + q_rope . k_rope) * scale``, masked ones -1e30.
    Returns the latent output (B, C, H, r) float32; the caller applies
    ``W_uv``."""
    del q_lens
    B, C, H, r = q_abs.shape
    P = ckv_pages.shape[1]
    M = page_table.shape[1]
    table = page_table.long()
    ckv = ckv_pages[table].reshape(B, M * P, r).float()
    kr = kr_pages[table].reshape(B, M * P, -1).float()
    idx = torch.arange(M * P, device=q_abs.device)[None, None, :]
    q_pos = (start.long()[:, None]
             + torch.arange(C, device=q_abs.device)[None, :])     # (B, C)
    valid = idx < (q_pos + 1)[:, :, None]
    if window is not None:
        valid &= idx > (q_pos[:, :, None] - window)
    s = (torch.einsum("bchr,bsr->bhcs", q_abs.float(), ckv)
         + torch.einsum("bchx,bsx->bhcs", q_rope.float(), kr))
    s = s * scale
    s = torch.where(valid[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhcs,bsr->bchr", p, ckv)
