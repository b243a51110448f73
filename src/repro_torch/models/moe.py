"""Mixture-of-Experts layer: a top-k router and the sort-based capacity
dispatch (the port of ``repro/models/moe.py``).

Algorithm, as in the reference (``moe.py:61-115``):
  1. router logits in float32 -> softmax -> top-k (expert, weight) per
     token, the weights renormalised;
  2. the (token, k) choices sorted by expert (a stable sort);
  3. each choice ranked within its expert; ranks >= the capacity are
     dropped;
  4. the kept tokens placed in an (E, C, D) buffer, the experts' gated
     MLPs run as batched matrix products over it;
  5. the outputs weighted by the router and summed back per token; the
     shared experts (DeepSeek) added.

The Switch load-balance loss is ``router_aux_loss * E * sum_e f_e p_e``
(f: the fraction of tokens whose first choice is ``e``, p: the mean
router probability).

Where the port differs: nothing syncs with the host and nothing is
indexed by a boolean mask.  A dropped choice is placed in a dump row past
the buffer, which no expert reads, and gathers its output from a zero row
(the reference adds zeros at slot ``e C``).  The combine does not
scatter-add: it unsorts the weighted outputs to (N, K, D) and sums over
K, the same sum in the same order on every run (``index_add_`` on the
card would add a token's K outputs in atomic order).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

Tensor = torch.Tensor


def init_moe(generator: torch.Generator, cfg, device) -> dict:
    """The layer's weights: the float32 router (D, E), the experts'
    stacked (E, D, F), (E, D, F), (E, F, D) and, with shared experts,
    their dense gated MLP of width ``d_expert * num_shared_experts``."""
    m = cfg.moe
    dt = cfg.param_dtype
    E, D, Fe = m.num_experts, cfg.d_model, m.d_expert
    p = {
        "router": dense_init(generator, D, E, torch.float32, device),
        "w_gate": (torch.randn(E, D, Fe, generator=generator, device=device)
                   / math.sqrt(D)).to(dt),
        "w_up": (torch.randn(E, D, Fe, generator=generator, device=device)
                 / math.sqrt(D)).to(dt),
        "w_down": (torch.randn(E, Fe, D, generator=generator, device=device)
                   / math.sqrt(Fe)).to(dt),
    }
    if m.num_shared_experts:
        Fs = m.d_expert * m.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(generator, D, Fs, dt, device),
            "w_up": dense_init(generator, D, Fs, dt, device),
            "w_down": dense_init(generator, Fs, D, dt, device),
        }
    return p


def _capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.experts_per_token / m.num_experts
                      * m.capacity_factor))
    return max(8, -(-c // 8) * 8)   # a multiple of 8, as the reference pads


def moe_block(p: dict, x: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """x (B, T, D) -> (out (B, T, D), aux loss, a 0-d float32 tensor).
    ``p`` holds the layer's weights as :func:`init_moe` makes them
    (``p["shared"]`` a dict)."""
    m = cfg.moe
    B, T, D = x.shape
    N = B * T
    E, K = m.num_experts, m.experts_per_token
    C = _capacity(N, cfg)
    dev = x.device
    xf = x.reshape(N, D)

    logits = xf.float() @ p["router"]                        # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)              # (N, K)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # ---- the Switch load-balance loss ---------------------------------
    frac = torch.mean(F.one_hot(top_e[:, 0], E).float(), dim=0)
    mean_p = torch.mean(probs, dim=0)
    aux = m.router_aux_loss * E * torch.sum(frac * mean_p)

    # ---- sort-based dispatch ------------------------------------------
    flat_e = top_e.reshape(-1)                               # (N K,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    sw = top_w.reshape(-1)[order]
    stok = order // K                                        # the token
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev))
    rank = torch.arange(N * K, device=dev) - seg_start[se]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)           # E C: dump row

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[slot] = xf[stok]
    buf = buf[:E * C].reshape(E, C, D)

    # ---- the experts: batched products over the buffer ------------------
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).reshape(E * C, D)

    # ---- combine: weighted outputs unsorted to (N, K, D), summed over K -
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, D))])
    weight = torch.where(keep, sw, torch.zeros_like(sw)).to(x.dtype)
    gathered = out_buf[slot] * weight[:, None]
    per_choice = torch.empty_like(gathered)
    per_choice[order] = gathered
    out = per_choice.reshape(N, K, D).sum(dim=1).reshape(B, T, D)

    # ---- shared experts (DeepSeek) --------------------------------------
    if "shared" in p:
        s = p["shared"]
        out = out + (F.silu(x @ s["w_gate"]) * (x @ s["w_up"])) @ s["w_down"]
    return out, aux
