"""Core neural layers: RMSNorm, RoPE, GQA attention (the reference's
dense-mask and blockwise forms, and the decode reads of serving) and the
gated MLP.

The port of ``repro/models/layers.py``.  Functional, like the reference:
parameters are dicts of tensors and every matmul layout is
(in_features, out_features).  :func:`attention_block` is the
self-attention of training and prefill (``cache=None``,
``layers.py:289-300``); :func:`decode_attention_block` holds the three
decode branches (``:247-288``, ``:301-337``): the scalar-position ring
cache, the per-slot ring cache with its ``update`` mask, and the paged
write-then-attend pass with ``q_lens``.  Unlike the reference, the
decode branches write the caches in place (the reference's serving
engine donates them for the same effect).  Attention is plain PyTorch
with the reference's online-softmax blocking
(``blockwise_gqa_attention``), not a library attention call, so that a
later attention kernel has a baseline to beat; the paged read goes
through the port's paged-attention kernel op.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import paged_attention_batched_op

Tensor = torch.Tensor

NEG = -1e30      # the reference's masked score


# ----------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> Tensor:
    scale = 1.0 / math.sqrt(d_in)
    return (torch.randn(d_in, d_out, generator=generator, device=device)
            * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device) -> Tensor:
    return (torch.randn(vocab, d, generator=generator, device=device)
            * 0.02).to(dtype)


# ----------------------------------------------------------------------
# RMSNorm, RoPE
# ----------------------------------------------------------------------

def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_angles(positions: Tensor, hd: int, theta: float
                ) -> Tuple[Tensor, Tensor]:
    """``(cos, sin)`` of RoPE at ``positions`` (..., T), float32
    (..., T, 1, hd/2).  A decode pass computes them once for every
    layer."""
    freqs = rope_freqs(hd, theta, positions.device)
    ang = positions[..., :, None, None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               angles: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """x: (..., T, H, hd); positions: (..., T); ``angles`` their
    :func:`rope_angles`, where the caller has them."""
    cos, sin = (rope_angles(positions, x.shape[-1], theta) if angles is None
                else angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------

class KVCache(NamedTuple):
    """One layer's attention cache: dense ring rows ``(B, S, kvH, hd)``
    (S = cache capacity), or pool pages ``(NP + 1, P, kvH, hd)`` whose
    last page is the scratch page padded writes land in."""
    k: Tensor
    v: Tensor


def attention_weights_mask(q_pos: Tensor, k_pos: Tensor, causal: bool,
                           window: Optional[int],
                           full_prefix: int = 0) -> Tensor:
    """(Tq, Tk) boolean mask, True = attend; ``full_prefix`` marks the
    first positions as attendable from everywhere (prefix LM)."""
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        c = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            c &= q_pos[:, None] - k_pos[None, :] < window
        if full_prefix:
            c |= k_pos[None, :] < full_prefix
        m &= c
    elif window is not None:
        m &= torch.abs(q_pos[:, None] - k_pos[None, :]) < window
    m &= k_pos[None, :] >= 0          # negative k_pos marks empty slots
    return m


def _k_step(acc, m, l, qblk, kblk, vblk, qpos, kpos, causal, window,
            full_prefix, scale):
    """One key block of the online softmax (``layers.py:140-161``)."""
    s = torch.einsum("bqkgh,bskh->bkgqs", qblk, kblk) * scale
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=s.device)
    if causal:
        cm = qpos[:, None] >= kpos[None, :]
        if window is not None:
            cm &= qpos[:, None] - kpos[None, :] < window
        if full_prefix:
            cm |= kpos[None, :] < full_prefix
        mask &= cm
    mask &= kpos[None, :] >= 0
    mask &= qpos[:, None] >= 0
    s = torch.where(mask[None, None, None], s, NEG)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p,
                                                   vblk)
    return acc_new, m_new, l_new


def blockwise_gqa_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                            k_pos: Tensor, *, causal: bool,
                            window: Optional[int], full_prefix: int = 0,
                            q_block: int = 512, k_block: int = 1024,
                            ordered: bool = False) -> Tensor:
    """Flash-style attention (``layers.py:94``): an online softmax over
    key blocks, so the (Tq, Tk) score matrix never exists whole.  Each
    key block is recomputed in the backward pass, as the reference's
    ``jax.checkpoint`` on the block step does.

    q: (B, Tq, H, hd); k/v: (B, Tk, kvH, hd).  ``ordered`` says the
    positions are ``0..T-1`` (the training forward): a causal query
    block then skips the key blocks wholly after it.  That is exact:
    from the first key block on every real query row has a finite
    running max, so a wholly masked block leaves ``(acc, m, l)`` as
    they were, to the bit.
    """
    B, Tq, H, hd = q.shape
    Tk, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    qb = min(q_block, Tq)
    kb = min(k_block, Tk)
    pq, pk = (-Tq) % qb, (-Tk) % kb

    qf = F.pad(q, (0, 0, 0, 0, 0, pq))
    kf = F.pad(k, (0, 0, 0, 0, 0, pk))
    vf = F.pad(v, (0, 0, 0, 0, 0, pk))
    qp = F.pad(q_pos, (0, pq), value=-1)
    kp = F.pad(k_pos, (0, pk), value=-(1 << 30))
    nq, nk = qf.shape[1] // qb, kf.shape[1] // kb

    qf = qf.reshape(B, nq, qb, kvH, G, hd).float()
    kf = kf.reshape(B, nk, kb, kvH, hd).float()
    vf = vf.reshape(B, nk, kb, kvH, hd).float()
    qp = qp.reshape(nq, qb)
    kp = kp.reshape(nk, kb)
    scale = 1.0 / math.sqrt(hd)
    skip = ordered and causal and not full_prefix

    outs = []
    for i in range(nq):
        qblk = qf[:, i]
        acc = torch.zeros((B, kvH, G, qb, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, kvH, G, qb), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, kvH, G, qb), dtype=torch.float32,
                        device=q.device)
        for j in range(nk):
            if skip and j * kb > i * qb + qb - 1:
                break
            args = (acc, m, l, qblk, kf[:, j], vf[:, j], qp[i], kp[j],
                    causal, window, full_prefix, scale)
            if torch.is_grad_enabled():
                acc, m, l = checkpoint(_k_step, *args, use_reentrant=False)
            else:
                acc, m, l = _k_step(*args)
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,kvH,G,qb,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,qb,kvH,G,hd)
    out = torch.stack(outs, dim=1).reshape(B, nq * qb, H, hd)
    return out[:, :Tq].to(v.dtype)


def ring_cache_positions(cache_pos: Tensor, S: int) -> Tuple[Tensor, Tensor]:
    """Per-slot ring-buffer accounting of decode caches: ``cache_pos`` is
    the (B,) absolute next position of each slot; returns ``(slot,
    abs_pos)``, ``slot`` (B,) the ring slot to write and ``abs_pos``
    (B, S) the absolute position every ring slot holds after the write
    (never-written slots negative, which the masks treat as empty)."""
    slot = cache_pos % S
    wraps = cache_pos // S
    slots = torch.arange(S, device=cache_pos.device)
    abs_pos = torch.where(slots[None, :] <= slot[:, None],
                          wraps[:, None] * S + slots[None, :],
                          (wraps[:, None] - 1) * S + slots[None, :])
    return slot, abs_pos


def decode_attention_mask(q_pos: Tensor, k_pos: Tensor, causal: bool,
                          window: Optional[int]) -> Tensor:
    """Batched decode mask: ``q_pos`` (B, T), ``k_pos`` (B, S) ->
    (B, T, S) boolean, the per-slot form of
    :func:`attention_weights_mask` (negative ``k_pos`` = empty slot)."""
    m = torch.ones((q_pos.shape[0], q_pos.shape[1], k_pos.shape[1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        c = q_pos[:, :, None] >= k_pos[:, None, :]
        if window is not None:
            c &= q_pos[:, :, None] - k_pos[:, None, :] < window
        m &= c
    m &= k_pos[:, None, :] >= 0
    return m


def paged_gather(pages: Tensor, page_table: Tensor) -> Tensor:
    """One contiguous (B, M * P, ...) view of each slot's pages, from the
    pool ``pages`` (NP, P, ...) and the (B, M) ``page_table``; padded
    table entries give rows past the slot's length, which the caller
    masks."""
    B, M = page_table.shape
    g = pages[page_table.long()]                # (B, M, P, ...)
    return g.reshape((B, M * pages.shape[1]) + tuple(pages.shape[2:]))


def gqa_attention(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """q: (B, Tq, H, hd); k/v: (B, Tk, kvH, hd); mask: (Tq, Tk) or
    (B, Tq, Tk).  Grouped-query: H = G * kvH."""
    B, Tq, H, hd = q.shape
    kvH = k.shape[2]
    G = H // kvH
    q = q.reshape(B, Tq, kvH, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    logits = logits / math.sqrt(hd)
    mask_b = mask[None, None, None] if mask.dim() == 2 else mask[:, None,
                                                                 None]
    logits = torch.where(mask_b, logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Tq, H, hd)


def init_attention(generator: torch.Generator, cfg, device) -> dict:
    hd, dt = cfg.hd, cfg.param_dtype
    p = {
        "wq": dense_init(generator, cfg.d_model, cfg.num_heads * hd, dt,
                         device),
        "wk": dense_init(generator, cfg.d_model, cfg.num_kv_heads * hd, dt,
                         device),
        "wv": dense_init(generator, cfg.d_model, cfg.num_kv_heads * hd, dt,
                         device),
        "wo": dense_init(generator, cfg.num_heads * hd, cfg.d_model, dt,
                         device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros(width * hd, dtype=dt, device=device)
    return p


def _project(p: dict, x: Tensor, positions: Tensor, cfg,
             angles: Optional[Tuple[Tensor, Tensor]] = None):
    """q (B, T, H, hd), k, v (B, T, kvH, hd), RoPE applied to q and k
    (``angles``: the positions' :func:`rope_angles`)."""
    B, T, D = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.num_heads, hd)
    k = k.reshape(B, T, cfg.num_kv_heads, hd)
    v = v.reshape(B, T, cfg.num_kv_heads, hd)
    if angles is None:
        angles = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, positions, cfg.rope_theta, angles)
    k = apply_rope(k, positions, cfg.rope_theta, angles)
    return q, k, v


def attention_block(p: dict, x: Tensor, positions: Tensor, cfg,
                    causal: bool = True, *, with_cache: bool = False):
    """Self-attention over x (B, T, D), pre-norm residual left to the
    caller; ``positions`` (T,) are ``0..T-1``.  Returns the output, and
    with ``with_cache`` also the layer's ``KVCache`` of k and v
    (B, T, kvH, hd), which prefill hands to decode."""
    B, T, D = x.shape
    q, k, v = _project(p, x, positions, cfg)
    if T > 1024:
        # flash-style blockwise path: O(block^2) memory
        out = blockwise_gqa_attention(
            q, k, v, positions, positions, causal=causal,
            window=cfg.attention_window, ordered=True)
    else:
        mask = attention_weights_mask(positions, positions, causal,
                                      cfg.attention_window)
        out = gqa_attention(q, k, v, mask)
    out = out.reshape(B, T, cfg.num_heads * cfg.hd) @ p["wo"]
    return (out, KVCache(k=k, v=v)) if with_cache else out


class PagedPlan(NamedTuple):
    """The indices of one paged pass, the same in every layer: the int32
    table, starts and valid lengths the read takes, and where each of
    the (B, T) tokens is written (``pid``, ``slot``: the scratch page for
    padding) at its absolute position ``pos``."""
    table: Tensor
    start: Tensor
    q_lens: Tensor
    pid: Tensor
    slot: Tensor
    pos: Tensor


def paged_plan(page_table: Tensor, start: Tensor, q_lens: Tensor, T: int,
               page_size: int, scratch: int) -> PagedPlan:
    """Token ``c`` of slot ``b`` sits at ``start[b] + c`` and is written
    into page ``page_table[b, pos // P]`` slot ``pos % P``, or, for
    ``c >= q_lens[b]``, into page ``scratch``."""
    M = page_table.shape[1]
    table = page_table.to(torch.int32)
    start, q_lens = start.to(torch.int32), q_lens.to(torch.int32)
    steps = torch.arange(T, dtype=torch.int32, device=start.device)
    pos = start[:, None] + steps[None]                         # (B, T)
    pid = torch.gather(table.long(), 1,
                       torch.clamp(pos.long() // page_size, max=M - 1))
    pid = torch.where(steps[None] < q_lens[:, None], pid, scratch)
    return PagedPlan(table=table, start=start, q_lens=q_lens, pid=pid,
                     slot=(pos % page_size).long(), pos=pos)


def decode_attention_block(p: dict, x: Tensor, positions: Tensor, cfg,
                           cache: KVCache, cache_pos: Tensor, *,
                           causal: bool = True,
                           update: Optional[Tensor] = None,
                           paged_table: Optional[Tensor] = None,
                           paged_kernel: bool = True,
                           q_lens: Optional[Tensor] = None,
                           angles: Optional[Tuple[Tensor, Tensor]] = None,
                           plan: Optional[PagedPlan] = None
                           ) -> Tuple[Tensor, KVCache]:
    """The decode branches of the reference's ``attention_block``; each
    writes ``cache`` in place and returns ``(output, cache)``.

    * Ring cache, ``cache_pos`` a 0-d tensor: every slot writes its one
      token at ``cache_pos % S`` (slots in lockstep).
    * Ring cache, ``cache_pos`` (B,): each slot writes at its own ring
      position; slots where ``update`` is False keep their bytes (they
      rewrite what they hold) and their outputs are garbage.
    * Paged (``paged_table`` (B, M) given): ``cache`` holds pool pages;
      token ``c`` of slot ``b`` sits at ``cache_pos[b] + c``, is written
      into page ``paged_table[b, pos // P]`` slot ``pos % P``, and then
      attends every position up to itself: through the paged-attention
      kernel op with ``paged_kernel``, else by gathering the slot's pages
      (the reference's ``use_kernel=False`` read).  Tokens
      ``c >= q_lens[b]`` are padding: their writes go to the scratch
      page (the pool's last) and their outputs are garbage.  Without
      ``q_lens`` one token a slot, masked by ``update``.
    """
    B, T, D = x.shape
    hd = cfg.hd
    q, k, v = _project(p, x, positions, cfg, angles)
    window = cfg.attention_window
    if paged_table is not None:
        NP, P = cache.k.shape[0] - 1, cache.k.shape[1]   # NP: the scratch
        if plan is None:
            qlens = (q_lens if q_lens is not None
                     else torch.ones(B, dtype=torch.int32, device=x.device)
                     if update is None else update.to(torch.int32))
            plan = paged_plan(paged_table, cache_pos, qlens, T, P, NP)
        cache.k[plan.pid, plan.slot] = k.to(cache.k.dtype)
        cache.v[plan.pid, plan.slot] = v.to(cache.v.dtype)
        if paged_kernel:
            out = paged_attention_batched_op(
                q, cache.k, cache.v, plan.table, plan.start, plan.q_lens,
                window=window).to(v.dtype)
        else:
            kg = paged_gather(cache.k, paged_table)         # (B, M*P, ...)
            vg = paged_gather(cache.v, paged_table)
            k_pos = torch.arange(kg.shape[1], device=x.device)[None].expand(
                B, kg.shape[1])
            mask = decode_attention_mask(plan.pos, k_pos, causal, window)
            out = gqa_attention(q, kg, vg, mask)
    elif cache_pos.dim() == 0:
        S = cache.k.shape[1]
        slot = (cache_pos.long() % S).reshape(1)
        cache.k.index_copy_(1, slot, k.to(cache.k.dtype))
        cache.v.index_copy_(1, slot, v.to(cache.v.dtype))
        # absolute positions of the ring's slots
        slots = torch.arange(S, device=x.device)
        wraps = cache_pos // S
        abs_pos = torch.where(slots <= slot, wraps * S + slots,
                              (wraps - 1) * S + slots)
        mask = attention_weights_mask(cache_pos.reshape(1), abs_pos, causal,
                                      window)
        out = gqa_attention(q, cache.k, cache.v, mask)
    else:
        S = cache.k.shape[1]
        slot, abs_pos = ring_cache_positions(cache_pos.long(), S)
        row = torch.arange(B, device=x.device)
        k_w, v_w = k[:, 0].to(cache.k.dtype), v[:, 0].to(cache.v.dtype)
        if update is not None:
            keep = ~update[:, None, None]
            k_w = torch.where(keep, cache.k[row, slot], k_w)
            v_w = torch.where(keep, cache.v[row, slot], v_w)
        cache.k[row, slot] = k_w
        cache.v[row, slot] = v_w
        mask = decode_attention_mask(cache_pos[:, None], abs_pos, causal,
                                     window)
        out = gqa_attention(q, cache.k, cache.v, mask)
    out = out.reshape(B, T, cfg.num_heads * hd)
    return out @ p["wo"], cache


# ----------------------------------------------------------------------
# Gated MLP (SwiGLU; the vision model's GeGLU comes with it)
# ----------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype,
             device) -> dict:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype, device),
        "w_up": dense_init(generator, d_model, d_ff, dtype, device),
        "w_down": dense_init(generator, d_ff, d_model, dtype, device),
    }


def mlp_block(p: dict, x: Tensor) -> Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
