"""Core neural layers for training: RMSNorm, RoPE, GQA attention (the
reference's dense-mask and blockwise forms) and the gated MLP.

The port of the training subset of ``repro/models/layers.py``: the
``cache=None`` branch of ``attention_block`` (``:247-300``); the decode
caches and paged reads come with serving.  Functional, like the
reference: parameters are dicts of tensors and every matmul layout is
(in_features, out_features).  Training attention is plain PyTorch with
the reference's online-softmax blocking (``blockwise_gqa_attention``),
not a library attention call, so that a later attention kernel has a
baseline to beat.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., T, H, hd); positions: (..., T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------

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


def attention_block(p: dict, x: Tensor, positions: Tensor, cfg,
                    causal: bool = True) -> Tensor:
    """Self-attention over x (B, T, D), pre-norm residual left to the
    caller; ``positions`` (T,) are ``0..T-1``."""
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
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if T > 1024:
        # flash-style blockwise path: O(block^2) memory
        out = blockwise_gqa_attention(
            q, k, v, positions, positions, causal=causal,
            window=cfg.attention_window, ordered=True)
    else:
        mask = attention_weights_mask(positions, positions, causal,
                                      cfg.attention_window)
        out = gqa_attention(q, k, v, mask)
    out = out.reshape(B, T, cfg.num_heads * hd)
    return out @ p["wo"]


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
