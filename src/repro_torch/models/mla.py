"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), the port
of ``repro/models/mla.py``.

K and V are compressed through a low-rank latent ``c_kv = x W_dkv``
(rank ``kv_lora_rank``); the per-head nope keys and the values are
up-projected from it, and one shared rope key ``k_rope`` is computed from
x directly.  The decode cache holds only ``(c_kv, k_rope)``:
``kv_lora_rank + qk_rope_head_dim`` values a token in place of
``2 kvH hd``.

:func:`mla_block` keeps every branch of the reference's (``mla.py:55``):
training and prefill (``cache=None``; the blockwise path past 1,024
tokens), the lockstep ring decode (a 0-d ``cache_pos``), the per-slot
ring decode with its ``update`` mask, and the paged pass, which writes
the tokens' latents into the pool and then reads either in the
ABSORBED form through the paged MLA kernel op (``W_uk`` folded into the
query, the output accumulated in latent space and ``W_uv`` applied
after: the up-projected K and V never exist) or by gathering the pages
into the unabsorbed math.  Unlike the reference, the decode branches
write the caches in place, and padded tokens of the paged pass write
into the pool's scratch page (its last) rather than being dropped.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import paged_mla_attention_op
from repro_torch.models.layers import (NEG, PagedPlan, apply_rope,
                                       attention_weights_mask,
                                       blockwise_gqa_attention,
                                       decode_attention_mask, dense_init,
                                       paged_gather, paged_plan,
                                       ring_cache_positions)

Tensor = torch.Tensor


def v_pad_to_match(v: Tensor, q: Tensor) -> Tensor:
    """Zero-pad v's head dim to q's (the blockwise core takes equal
    dims)."""
    pad = q.shape[-1] - v.shape[-1]
    return v if pad <= 0 else F.pad(v, (0, pad))


class MLACache(NamedTuple):
    """One layer's latent cache: dense ring rows ``c_kv`` (B, S, r) and
    ``k_rope`` (B, S, rope_hd), or pool pages (NP + 1, P, r) and
    (NP + 1, P, rope_hd) whose last page is the scratch page."""
    c_kv: Tensor
    k_rope: Tensor


def init_mla(generator: torch.Generator, cfg, device) -> dict:
    a = cfg.mla
    dt = cfg.param_dtype
    H, D = cfg.num_heads, cfg.d_model
    qk_hd = a.qk_nope_head_dim + a.qk_rope_head_dim
    return {
        "w_q": dense_init(generator, D, H * qk_hd, dt, device),
        "w_dkv": dense_init(generator, D, a.kv_lora_rank, dt, device),
        "w_uk": dense_init(generator, a.kv_lora_rank,
                           H * a.qk_nope_head_dim, dt, device),
        "w_uv": dense_init(generator, a.kv_lora_rank, H * a.v_head_dim, dt,
                           device),
        "w_kr": dense_init(generator, D, a.qk_rope_head_dim, dt, device),
        "w_o": dense_init(generator, H * a.v_head_dim, D, dt, device),
    }


def mla_block(p: dict, x: Tensor, positions: Tensor, cfg,
              cache: Optional[MLACache] = None,
              cache_pos: Optional[Tensor] = None,
              update: Optional[Tensor] = None,
              paged_table: Optional[Tensor] = None,
              paged_kernel: bool = False,
              q_lens: Optional[Tensor] = None,
              angles: Optional[Tuple[Tensor, Tensor]] = None,
              plan: Optional[PagedPlan] = None
              ) -> Tuple[Tensor, MLACache]:
    """x (B, T, D) -> (output (B, T, D), cache).  Without ``cache`` the
    training and prefill pass (``positions`` (T,) ``0..T-1``), whose
    cache is the tokens' ``MLACache``; otherwise the decode branch that
    ``cache_pos`` and ``paged_table`` select, writing ``cache`` in place
    (see the module docstring).  ``angles``: RoPE's angles at the rope
    width for ``positions``; ``plan``: the paged pass's write and read
    indices (:func:`~repro_torch.models.layers.paged_plan`), both computed
    here when not given."""
    a = cfg.mla
    B, T, D = x.shape
    H = cfg.num_heads
    nope, rope_hd = a.qk_nope_head_dim, a.qk_rope_head_dim
    qk_hd = nope + rope_hd
    window = cfg.attention_window

    q = (x @ p["w_q"]).reshape(B, T, H, qk_hd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, angles)
    c_kv = x @ p["w_dkv"]                                    # (B, T, r)
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta, angles)[:, :, 0]     # (B, T, rope)

    if cache is not None and paged_table is not None:
        NP, P = cache.c_kv.shape[0] - 1, cache.c_kv.shape[1]  # NP: scratch
        if plan is None:
            qlens = (q_lens if q_lens is not None
                     else torch.ones(B, dtype=torch.int32, device=x.device)
                     if update is None else update.to(torch.int32))
            plan = paged_plan(paged_table, cache_pos, qlens, T, P, NP)
        cache.c_kv[plan.pid, plan.slot] = c_kv.to(cache.c_kv.dtype)
        cache.k_rope[plan.pid, plan.slot] = k_rope.to(cache.k_rope.dtype)
        if paged_kernel:
            r = a.kv_lora_rank
            w_uk = p["w_uk"].reshape(r, H, nope)
            q_abs = torch.einsum("bthx,rhx->bthr", q_nope.float(),
                                 w_uk.float())
            o_lat = paged_mla_attention_op(
                q_abs, q_rope, cache.c_kv, cache.k_rope, plan.table,
                plan.start, plan.q_lens, scale=1.0 / math.sqrt(qk_hd),
                window=window)
            w_uv = p["w_uv"].reshape(r, H, a.v_head_dim)
            out = torch.einsum("bthr,rhx->bthx", o_lat,
                               w_uv.float()).to(x.dtype)
            return out.reshape(B, T, H * a.v_head_dim) @ p["w_o"], cache
        kv_lat = paged_gather(cache.c_kv, paged_table)       # (B, M P, r)
        kr = paged_gather(cache.k_rope, paged_table)
        k_pos = torch.arange(kv_lat.shape[1], device=x.device)[None].expand(
            B, kv_lat.shape[1])
        q_pos = plan.pos
        new_cache = cache
    elif cache is None:
        kv_lat, kr = c_kv, k_rope
        k_pos = positions[0] if positions.dim() > 1 else positions
        q_pos = k_pos
        # prefill and training hand the latent cache to decode
        new_cache = MLACache(c_kv=c_kv, k_rope=k_rope)
    elif cache_pos.dim() == 0:
        S = cache.c_kv.shape[1]
        slot = (cache_pos.long() % S).reshape(1)
        cache.c_kv.index_copy_(1, slot, c_kv.to(cache.c_kv.dtype))
        cache.k_rope.index_copy_(1, slot, k_rope.to(cache.k_rope.dtype))
        kv_lat, kr = cache.c_kv, cache.k_rope
        slots = torch.arange(S, device=x.device)
        wraps = cache_pos.long() // S
        k_pos = torch.where(slots <= slot, wraps * S + slots,
                            (wraps - 1) * S + slots)
        q_pos = cache_pos.long().reshape(1)
        new_cache = cache
    else:
        # per-slot decode: the slots where ``update`` is False rewrite
        # the bytes they hold
        S = cache.c_kv.shape[1]
        slot, k_pos = ring_cache_positions(cache_pos.long(), S)
        row = torch.arange(B, device=x.device)
        kv_w = c_kv[:, 0].to(cache.c_kv.dtype)
        kr_w = k_rope[:, 0].to(cache.k_rope.dtype)
        if update is not None:
            keep = ~update[:, None]
            kv_w = torch.where(keep, cache.c_kv[row, slot], kv_w)
            kr_w = torch.where(keep, cache.k_rope[row, slot], kr_w)
        cache.c_kv[row, slot] = kv_w
        cache.k_rope[row, slot] = kr_w
        kv_lat, kr = cache.c_kv, cache.k_rope
        q_pos = cache_pos.long()[:, None]
        new_cache = cache

    Bk, S = kv_lat.shape[0], kv_lat.shape[1]
    k_nope = (kv_lat @ p["w_uk"]).reshape(Bk, S, H, nope)
    v = (kv_lat @ p["w_uv"]).reshape(Bk, S, H, a.v_head_dim)

    if cache is None and T > 1024:
        # the blockwise path of long prefill: the shared rope key folded
        # into per-head keys, the blockwise GQA core reused (its scale
        # 1/sqrt(qk_hd) from the head dim)
        q_cat = torch.cat([q_nope, q_rope], dim=-1)
        kr_b = kr[:, :, None, :].expand(Bk, S, H, rope_hd)
        k_cat = torch.cat([k_nope, kr_b], dim=-1)
        out = blockwise_gqa_attention(
            q_cat, k_cat, v_pad_to_match(v, q_cat), q_pos, k_pos,
            causal=True, window=window, ordered=True)
        out = out[..., :a.v_head_dim]
    else:
        if q_pos.dim() == 2:      # per-slot and paged: (B, T) against (B, S)
            mask_b = decode_attention_mask(q_pos, k_pos, True,
                                           window)[:, None]
        else:
            mask_b = attention_weights_mask(q_pos, k_pos, True,
                                            window)[None, None]
        logits = (torch.einsum("bqhx,bshx->bhqs", q_nope, k_nope)
                  + torch.einsum("bqhx,bsx->bhqs", q_rope, kr)).float()
        logits = logits * (1.0 / math.sqrt(qk_hd))
        logits = torch.where(mask_b, logits, NEG)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqs,bshx->bqhx", probs, v)
    out = out.reshape(B, T, H * a.v_head_dim)
    return out @ p["w_o"], new_cache
