"""The decoder LM of the port: the dense and the MLA + MoE paths of
``repro/models/model.py`` (``Model.init_params``, ``_embed``,
``forward``, ``loss``, and the decode methods of serving; ``:38-58``,
``:94-239``, ``:259-763``).

:class:`Model` is an ``nn.Module`` whose parameters carry the
reference's names, dotted (``layers.attn.wq``), and its stacked
``(num_layers, ...)`` layer shapes.  :func:`leaf_names` gives them in
the reference's ``jax.tree.leaves`` order (keys sorted at every level),
which the sharded engine walks leaf by leaf.  The forward is functional
over a flat ``{name: tensor}`` dict, so that the trainer evaluates it at
two points of a round without touching the module.  The reference's
scan over layers under ``jax.checkpoint`` is a loop over layer slices,
each under ``torch.utils.checkpoint`` when ``cfg.remat``.

Two layer kinds are ported: ``dense`` (GQA attention and the gated
MLP: granite) and ``moe`` with the ``mla`` sub-config (Multi-head Latent
Attention and the routed experts: deepseek-v2-lite), every layer of a
model of one kind, as in the reference.  The MoE layers' load-balance
losses add up to the ``aux`` that :meth:`Model.loss` adds to the cross
entropy.

Decode state is held in one layout: a tuple with one attention cache per
layer (the reference stacks them ``(L, ...)`` under its scan, or keeps a
tuple when it unrolls), a :class:`~repro_torch.models.layers.KVCache`
or an :class:`~repro_torch.models.mla.MLACache`.  Dense ring caches are
``(B, S, ...)``; paged caches are the pool's ``(num_pages + 1, P, ...)``
pages, the last of them the scratch page that padded writes land in, so
that no write is ever filtered on the host.  The decode methods write
the caches in place and return them in the new state.  MoE without MLA
and recurrent (SSM/hybrid) decode state come with those blocks (ROADMAP
queue 1, slice 3 item 7); :func:`_check_ported` refuses them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (KVCache, attention_block,
                                       decode_attention_block, embed_init,
                                       init_attention, init_mlp, mlp_block,
                                       paged_plan, rmsnorm, rope_angles)
from repro_torch.models.mla import MLACache, init_mla, mla_block
from repro_torch.models.moe import init_moe, moe_block

Tensor = torch.Tensor
Params = Dict[str, Tensor]
Caches = Tuple[Any, ...]        # one KVCache or MLACache a layer
CACHE_TYPES = (KVCache, MLACache)


class DecodeState(NamedTuple):
    """Dense decode state: one ring cache (B, S, ...) a layer, and the
    next absolute position, a 0-d tensor (slots in lockstep) or (B,) per
    slot."""
    caches: Caches
    position: Tensor


class PagedDecodeState(NamedTuple):
    """Decode state over a shared page pool: one cache of pool pages
    (num_pages + 1, P, ...) a layer, addressed through one page table
    that every layer shares (all layers allocate alike, so one logical
    page maps to the same physical row in each)."""
    caches: Caches
    page_table: Tensor    # (B, max_pages) int32 physical page ids
    seq_lens: Tensor      # (B,) int32 tokens written a slot


def _flatten(tree: dict, prefix: str = "") -> Params:
    """Nested dict -> flat dotted dict, keys sorted at every level (the
    order of ``jax.tree.leaves``)."""
    flat: Params = {}
    for key in sorted(tree):
        name = prefix + key
        if isinstance(tree[key], dict):
            flat.update(_flatten(tree[key], name + "."))
        else:
            flat[name] = tree[key]
    return flat


def _check_ported(cfg: ArchConfig) -> None:
    """Raise unless the config is a dense decoder or an MLA + MoE one."""
    dense = cfg.arch_type == "dense"
    mla_moe = cfg.arch_type == "moe" and cfg.mla is not None
    if not (dense or mla_moe) or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: only the dense and the MLA + MoE decoders are "
            "ported (ROADMAP queue 1, slice 3 item 7 brings MoE without "
            "MLA, ssm, hybrid, audio and vlm blocks)")


def map_cache_tree(tree: Any, on_attention: Callable, on_leaf: Callable,
                   other: Any = None) -> Any:
    """The decode-cache tree walk (``model.py:195-216``): ``on_attention``
    handles whole ``KVCache`` and ``MLACache`` nodes, ``on_leaf`` every
    other tensor leaf (recurrent state, which the port has none of yet);
    tuples and NamedTuples recurse, keeping their type.  With ``other``,
    walks two trees of the same structure zipped and the callbacks take
    ``(node, other_node)``."""
    zipped = other is not None

    def rec(c, o):
        if isinstance(c, CACHE_TYPES):
            return on_attention(c, o) if zipped else on_attention(c)
        if isinstance(c, tuple):
            pairs = zip(c, o) if zipped else ((e, None) for e in c)
            merged = tuple(rec(e, oe) for e, oe in pairs)
            return type(c)(*merged) if hasattr(c, "_fields") else merged
        return on_leaf(c, o) if zipped else on_leaf(c)

    return rec(tree, other)


def _pad_cache_capacity(caches: Any, extra: int) -> Any:
    """Grow the sequence axis of every attention cache by ``extra`` empty
    slots: axis -3 of a ``KVCache``'s (B, S, kvH, hd), -2 of an
    ``MLACache``'s (B, S, r)."""
    def pad(x, axis):
        widths = [0, 0] * (-axis - 1) + [0, extra]
        return torch.nn.functional.pad(x, widths)

    def grow(c):
        axis = -3 if isinstance(c, KVCache) else -2
        return type(c)(*(pad(x, axis) for x in c))

    return map_cache_tree(caches, on_attention=grow, on_leaf=lambda c: c)


def _layer_init(cfg: ArchConfig, generator: torch.Generator,
                device) -> dict:
    """One layer's weights, nested as the reference's ``_block_init``
    nests them."""
    dt, D = cfg.param_dtype, cfg.d_model
    lp = {"ln1": torch.ones(D, dtype=dt, device=device),
          "ln2": torch.ones(D, dtype=dt, device=device)}
    if cfg.mla is not None:
        lp["attn"] = init_mla(generator, cfg, device)
    else:
        lp["attn"] = init_attention(generator, cfg, device)
    if cfg.moe is not None:
        lp["moe"] = init_moe(generator, cfg, device)
    else:
        lp["mlp"] = init_mlp(generator, D, cfg.d_ff, dt, device)
    return lp


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Fresh weights from ``generator``, in the reference's layout (its
    values come from JAX keys; convert them with
    :func:`repro_torch.convert.params_from_jax` to start from the same
    point).  Each stacked ``(L, ...)`` leaf is allocated once and filled
    layer by layer, so the device holds the weights and one layer's
    draws at a time, never two copies of the stack."""
    _check_ported(cfg)
    dt, D, L = cfg.param_dtype, cfg.d_model, cfg.num_layers
    tree: dict = {
        "final_norm": torch.ones(D, dtype=dt, device=device),
        "embed": embed_init(generator, cfg.padded_vocab, D, dt, device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = embed_init(generator, cfg.padded_vocab, D, dt,
                                     device).T.contiguous()
    stacked: Params = {}
    for i in range(L):
        for name, leaf in _flatten(_layer_init(cfg, generator,
                                               device)).items():
            if name not in stacked:
                stacked[name] = torch.empty((L,) + tuple(leaf.shape),
                                            dtype=leaf.dtype, device=device)
            stacked[name][i] = leaf
    tree["layers"] = stacked
    return _flatten(tree)


def param_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """Every parameter's shape, in ``jax.tree.leaves`` order."""
    _check_ported(cfg)
    D, F, hd, V = cfg.d_model, cfg.d_ff, cfg.hd, cfg.padded_vocab
    H = cfg.num_heads
    q, kv = H * hd, cfg.num_kv_heads * hd
    layer: dict = {"ln1": (D,), "ln2": (D,)}
    if cfg.mla is not None:
        a = cfg.mla
        r, nope, rope = a.kv_lora_rank, a.qk_nope_head_dim, a.qk_rope_head_dim
        layer["attn"] = {"w_q": (D, H * (nope + rope)), "w_dkv": (D, r),
                         "w_uk": (r, H * nope), "w_uv": (r, H * a.v_head_dim),
                         "w_kr": (D, rope), "w_o": (H * a.v_head_dim, D)}
    else:
        layer["attn"] = {"wq": (D, q), "wk": (D, kv), "wv": (D, kv),
                         "wo": (q, D)}
        if cfg.qkv_bias:
            layer["attn"].update(bq=(q,), bk=(kv,), bv=(kv,))
    if cfg.moe is not None:
        m = cfg.moe
        E, Fe = m.num_experts, m.d_expert
        layer["moe"] = {"router": (D, E), "w_gate": (E, D, Fe),
                        "w_up": (E, D, Fe), "w_down": (E, Fe, D)}
        if m.num_shared_experts:
            Fs = Fe * m.num_shared_experts
            layer["moe"]["shared"] = {"w_gate": (D, Fs), "w_up": (D, Fs),
                                      "w_down": (Fs, D)}
    else:
        layer["mlp"] = {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
    tree: dict = {"embed": (V, D), "final_norm": (D,),
                  "layers": {k: (cfg.num_layers,) + v
                             for k, v in _flatten(layer).items()}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (D, V)
    return _flatten(tree)


def leaf_names(cfg: ArchConfig) -> List[str]:
    """The parameter names in ``jax.tree.leaves`` order."""
    return list(param_shapes(cfg))


def _sub(p: Params, prefix: str) -> dict:
    """The weights under ``prefix`` (``"attn."``, ``"moe."``), nested
    again at the dots (``moe.shared.w_up`` -> ``{"shared": {"w_up"}}``)."""
    out: dict = {}
    for key, value in p.items():
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[last] = value
    return out


def _ffn(p: Params, x: Tensor, cfg: ArchConfig
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """The layer's second half on the normed x: the gated MLP, or the
    routed experts and their load-balance loss."""
    if cfg.moe is not None:
        return moe_block(_sub(p, "moe."), x, cfg)
    return mlp_block(_sub(p, "mlp."), x), None


def _block(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
           with_cache: bool = False):
    """One layer of the training and prefill forward (``model.py:94-138``)
    -> (x, its cache with ``with_cache`` (prefill) else None, the MoE
    load-balance loss or None)."""
    xn = rmsnorm(x, p["ln1"], cfg.rms_eps)
    if cfg.mla is not None:
        h, cache = mla_block(_sub(p, "attn."), xn, positions, cfg)
    else:
        h = attention_block(_sub(p, "attn."), xn, positions, cfg,
                            causal=not cfg.is_encoder, with_cache=with_cache)
        h, cache = h if with_cache else (h, None)
    x = x + h
    out, aux = _ffn(p, rmsnorm(x, p["ln2"], cfg.rms_eps), cfg)
    return x + out, cache if with_cache else None, aux


def _block_decode(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
                  cache, **decode) -> Tuple[Tensor, Any]:
    """One layer of a decode pass (``model.py:94-138``: the dense kind,
    and the moe kind with MLA)."""
    xn = rmsnorm(x, p["ln1"], cfg.rms_eps)
    if cfg.mla is not None:
        h, cache = mla_block(_sub(p, "attn."), xn, positions, cfg,
                             cache=cache, **decode)
    else:
        h, cache = decode_attention_block(
            _sub(p, "attn."), xn, positions, cfg, cache,
            causal=not cfg.is_encoder, **decode)
    x = x + h
    return x + _ffn(p, rmsnorm(x, p["ln2"], cfg.rms_eps), cfg)[0], cache


class Model(nn.Module):
    """The decoder.  ``Model(cfg, params)`` holds ``params`` (a flat dict
    as :func:`init_params` makes) as its parameters; :meth:`loss` and
    :meth:`forward` take any such dict."""

    def __init__(self, cfg: ArchConfig, params: Params):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.names = names = leaf_names(cfg)
        if list(params) != names:
            raise ValueError(f"expected parameters {names}, got "
                             f"{list(params)}")
        for name in names:
            owner = self
            *path, last = name.split(".")
            for part in path:
                if not hasattr(owner, part):
                    owner.add_module(part, nn.Module())
                owner = getattr(owner, part)
            owner.register_parameter(
                last, nn.Parameter(params[name], requires_grad=False))

    @classmethod
    def create(cls, cfg: ArchConfig, generator: torch.Generator,
               device="cuda") -> "Model":
        return cls(cfg, init_params(cfg, generator, device))

    def params(self) -> Params:
        """The module's weights as a flat dict in leaf order (no
        copies)."""
        return {k: self.get_parameter(k).detach() for k in self.names}

    # -- embedding -------------------------------------------------------
    def _embed(self, params: Params, batch: dict):
        """-> (x (B, T, D), positions (T,))."""
        x = self._embed_tokens(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        return x, positions

    @property
    def attention_only(self) -> bool:
        """Every layer's decode state is attention cache only, so prompts
        may be padded to a bucket and fed in chunks (tail padding sits
        behind the causal mask).  True of every ported kind."""
        return self.cfg.arch_type in ("dense", "moe", "audio", "vlm")

    @property
    def rope_dim(self) -> int:
        """The width RoPE rotates: the head dim, or MLA's rope part."""
        mla = self.cfg.mla
        return mla.qk_rope_head_dim if mla is not None else self.cfg.hd

    @property
    def device(self) -> torch.device:
        return self.get_parameter("embed").device

    def _layer(self, params: Params, i: int) -> Params:
        return {k[len("layers."):]: v[i] for k, v in params.items()
                if k.startswith("layers.")}

    def _head(self, params: Params) -> Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                and "lm_head" not in params else params["lm_head"])

    def _embed_tokens(self, params: Params, tokens: Tensor) -> Tensor:
        x = params["embed"][tokens.long()]
        return x * torch.full((), self.cfg.d_model, dtype=x.dtype,
                              device=x.device).sqrt()

    # -- forward ---------------------------------------------------------
    def forward(self, batch: dict, params: Optional[Params] = None, *,
                collect_caches: bool = False, last_token_only: bool = False,
                last_index: Optional[Tensor] = None):
        """Training and prefill forward -> logits (B, T, padded vocab),
        and with ``collect_caches`` also the layers' cache tuple.
        ``last_index`` (bucketed prefill): the true prompt length, a 0-d
        tensor; the head then runs on the hidden state at
        ``last_index - 1`` alone, so a prompt padded to its bucket gives
        the logits of the unpadded one."""
        logits, caches, _ = self._forward(
            batch, params, collect_caches=collect_caches,
            last_token_only=last_token_only, last_index=last_index)
        return (logits, caches) if collect_caches else logits

    def _forward(self, batch: dict, params: Optional[Params], *,
                 collect_caches: bool = False,
                 last_token_only: bool = False,
                 last_index: Optional[Tensor] = None):
        """-> (logits, the caches or None, the summed MoE load-balance
        loss or None)."""
        cfg = self.cfg
        params = self.params() if params is None else params
        x, positions = self._embed(params, batch)
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once, where an index per layer would add L full-size
        # zero-padded gradients
        layer = {k[len("layers."):]: v.unbind(0) for k, v in params.items()
                 if k.startswith("layers.")}
        caches, aux = [], None
        for i in range(cfg.num_layers):
            lp = {k: v[i] for k, v in layer.items()}
            if cfg.remat and torch.is_grad_enabled() and not collect_caches:
                x, _, a = checkpoint(_block, lp, x, positions, cfg,
                                     use_reentrant=False)
            else:
                x, c, a = _block(lp, x, positions, cfg,
                                 with_cache=collect_caches)
                caches.append(c)
            if a is not None:
                aux = a if aux is None else aux + a
        x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
        if last_index is not None:
            idx = torch.clamp(torch.as_tensor(last_index, device=x.device)
                              - 1, min=0).reshape(1)
            x = x.index_select(1, idx)
        elif last_token_only:
            x = x[:, -1:]
        logits = x @ self._head(params)
        return logits, tuple(caches) if collect_caches else None, aux

    def prefill(self, params: Params, batch: dict, extra_capacity: int = 0,
                true_len: Optional[Tensor] = None
                ) -> Tuple[Tensor, DecodeState]:
        """Run a whole prompt once: the last position's logits (B, vocab)
        and a :class:`DecodeState` of the layers' caches, capacity the
        prompt length plus ``extra_capacity``.  ``true_len`` (bucketed
        prefill): the prompt is padded to a bucket and this is its real
        length; the logits come from position ``true_len - 1`` and the
        decode position starts there."""
        cfg = self.cfg
        logits, caches = self.forward(batch, params, collect_caches=True,
                                      last_token_only=true_len is None,
                                      last_index=true_len)
        if extra_capacity:
            caches = _pad_cache_capacity(caches, extra_capacity)
        dev = logits.device
        pos = (torch.tensor(batch["tokens"].shape[1], device=dev)
               if true_len is None
               else torch.as_tensor(true_len, device=dev).long())
        return (logits[:, 0, :cfg.vocab_size],
                DecodeState(caches=caches, position=pos))

    # -- loss ------------------------------------------------------------
    def loss(self, params: Params, batch: dict) -> Tensor:
        """Next-token cross entropy over ``batch["tokens"]`` (B, T), the
        logits taken in float32 (``model.py:413-435``), plus the MoE
        layers' summed load-balance loss."""
        logits, _, aux = self._forward(batch, params)
        logits = logits[:, :-1].float()
        targets = batch["tokens"][:, 1:].long()
        mask = (targets >= 0).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           torch.clamp(targets, min=0)[..., None])[..., 0]
        ce = (torch.sum((lse - tgt) * mask)
              / torch.clamp(torch.sum(mask), min=1.0))
        return ce if aux is None else ce + aux

    # -- decode ----------------------------------------------------------
    def cache_capacity(self, seq_len: int) -> int:
        w = self.cfg.attention_window
        return min(seq_len, w) if w else seq_len

    def _zeros_cache(self, rows: int, width: int):
        """One layer's empty cache of ``rows`` x ``width`` token slots:
        K and V heads, or MLA's latent and rope key."""
        cfg = self.cfg

        def zeros(*tail):
            return torch.zeros((rows, width) + tail, dtype=cfg.param_dtype,
                               device=self.device)

        if cfg.mla is not None:
            return MLACache(c_kv=zeros(cfg.mla.kv_lora_rank),
                            k_rope=zeros(cfg.mla.qk_rope_head_dim))
        return KVCache(k=zeros(cfg.num_kv_heads, cfg.hd),
                       v=zeros(cfg.num_kv_heads, cfg.hd))

    def init_decode_state(self, batch: int, seq_len: int,
                          position: Optional[int] = None) -> DecodeState:
        """Empty ring caches for ``seq_len`` tokens of context;
        ``position`` is the next absolute position (default ``seq_len``,
        the reference's 'cache already full')."""
        S = self.cache_capacity(seq_len)
        caches = tuple(self._zeros_cache(batch, S)
                       for _ in range(self.cfg.num_layers))
        pos = seq_len if position is None else position
        return DecodeState(caches=caches,
                           position=torch.tensor(pos, device=self.device))

    def serve_step(self, params: Params, tokens: Tensor, state: DecodeState,
                   update: Optional[Tensor] = None
                   ) -> Tuple[Tensor, DecodeState]:
        """One decode step, tokens (B, 1) -> logits (B, vocab).
        ``state.position`` is 0-d (slots in lockstep) or (B,) per slot,
        each slot then writing at its own ring position; ``update``
        (per-slot positions only) leaves the slots where it is False as
        they were (caches and positions; their logits are garbage)."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        pos = state.position
        per_slot = pos.dim() == 1
        if update is not None and not per_slot:
            raise ValueError("serve_step(update=...) needs per-slot "
                             "positions: state.position must be (B,)")
        positions = pos[:, None] if per_slot else pos.reshape(1)
        angles = rope_angles(positions, self.rope_dim, cfg.rope_theta)
        caches = []
        for i in range(cfg.num_layers):
            x, c = _block_decode(self._layer(params, i), x, positions, cfg,
                                 state.caches[i], cache_pos=pos,
                                 update=update, angles=angles)
            caches.append(c)
        x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
        logits = (x @ self._head(params))[:, 0, :cfg.vocab_size]
        new_pos = (pos + 1 if update is None
                   else torch.where(update, pos + 1, pos))
        return logits, DecodeState(caches=tuple(caches), position=new_pos)

    # -- paged decode ----------------------------------------------------
    def init_paged_state(self, batch: int, num_pages: int, page_size: int,
                         max_pages: int) -> PagedDecodeState:
        """An empty pool of ``num_pages`` pages a layer, plus the scratch
        page, and a zero (B, max_pages) page table and (B,) lengths.  The
        serving engine owns the allocator; the model reads and writes
        through the table it is handed."""
        caches = tuple(self._zeros_cache(num_pages + 1, page_size)
                       for _ in range(self.cfg.num_layers))
        return PagedDecodeState(
            caches=caches,
            page_table=torch.zeros((batch, max_pages), dtype=torch.int32,
                                   device=self.device),
            seq_lens=torch.zeros(batch, dtype=torch.int32,
                                 device=self.device))

    def paged_fused_step(self, params: Params, tokens: Tensor,
                         state: PagedDecodeState, q_lens: Tensor,
                         use_kernel: bool = True
                         ) -> Tuple[Tensor, PagedDecodeState]:
        """THE paged forward: one pass over every slot, each carrying up
        to C tokens.  tokens (B, C): slot ``b``'s tokens land at positions
        ``seq_lens[b] + c`` for ``c < q_lens[b]``; the rest are padding.
        A decode pass is C = 1 with ``q_lens`` of ones; a chunked-prefill
        pass folds prompt chunks into the same pass.  Each layer reads
        through the paged-attention kernel op (``use_kernel``), else
        through the gather.  Returns the logits of each slot's last valid
        token (B, vocab), garbage where ``q_lens == 0``, and the state
        with ``seq_lens + q_lens`` (the pool written in place).  The head
        runs on those last hidden states only (the reference runs it on
        all C and then picks)."""
        cfg = self.cfg
        B, C = tokens.shape
        x = self._embed_tokens(params, tokens)
        start = state.seq_lens
        q_lens = q_lens.to(torch.int32)
        positions = start[:, None] + torch.arange(
            C, dtype=start.dtype, device=start.device)[None]
        table = state.page_table
        # what every layer shares: RoPE's angles, the write and read
        # indices
        angles = rope_angles(positions, self.rope_dim, cfg.rope_theta)
        pages = state.caches[0][0]      # any cache's first field: the pages
        plan = paged_plan(table, start, q_lens, C, pages.shape[1],
                          pages.shape[0] - 1)
        caches = []
        for i in range(cfg.num_layers):
            x, c = _block_decode(self._layer(params, i), x, positions, cfg,
                                 state.caches[i], cache_pos=start,
                                 paged_table=table, paged_kernel=use_kernel,
                                 q_lens=q_lens, angles=angles, plan=plan)
            caches.append(c)
        x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
        last = torch.clamp(q_lens.long() - 1, min=0)
        x = torch.gather(x, 1, last[:, None, None].expand(B, 1, x.shape[2]))
        logits = (x @ self._head(params))[:, 0, :cfg.vocab_size]
        return logits, PagedDecodeState(caches=tuple(caches),
                                        page_table=table,
                                        seq_lens=start + q_lens)

    def paged_serve_step(self, params: Params, tokens: Tensor,
                         state: PagedDecodeState,
                         update: Optional[Tensor] = None,
                         use_kernel: bool = True
                         ) -> Tuple[Tensor, PagedDecodeState]:
        """One decode step against the pool: the C = 1 view of
        :meth:`paged_fused_step`, with :meth:`serve_step`'s ``update``."""
        B = tokens.shape[0]
        q_lens = (torch.ones(B, dtype=torch.int32, device=tokens.device)
                  if update is None else update.to(torch.int32))
        return self.paged_fused_step(params, tokens, state, q_lens,
                                     use_kernel=use_kernel)

    def write_prefill_to_pages(self, caches: Caches, prefill_caches: Caches,
                               table_row: Tensor, shared_len, slot, *,
                               page_size: int,
                               true_len: Optional[Tensor] = None) -> Caches:
        """Scatter a bulk prefill (:meth:`prefill` of one (1, T) prompt)
        into the pool, in place: the cache of positions ``[shared_len, T)``
        (K and V, or the latent and rope key) goes to the pages of
        ``table_row``; the shared-prefix positions
        (already in shared pages) and, with ``true_len``, the bucket
        padding past it go to the scratch page.  ``slot`` would place
        recurrent state, which the dense port has none of."""
        del slot
        P = page_size

        def write(pages: Tensor, seq: Tensor) -> Tensor:
            NP = pages.shape[0] - 1
            pos = torch.arange(seq.shape[1], device=pages.device)
            idx = torch.clamp(pos // P, max=table_row.shape[0] - 1)
            pid = table_row.long()[idx]
            keep = pos >= torch.as_tensor(shared_len, device=pages.device)
            if true_len is not None:
                keep &= pos < torch.as_tensor(true_len, device=pages.device)
            pages[torch.where(keep, pid, NP), pos % P] = seq[0].to(
                pages.dtype)
            return pages

        return map_cache_tree(
            caches, on_attention=lambda c, pc: type(c)(
                *(write(a, b) for a, b in zip(c, pc))),
            on_leaf=lambda c, pc: c, other=prefill_caches)

    def copy_cache_page(self, caches: Caches, src: int, dst: int) -> Caches:
        """Copy-on-write: physical page ``src`` into ``dst`` in every
        layer, in place (unwritten slots carry stale bytes along; they
        stay behind the validity mask)."""
        def cp(c):
            for pages in c:
                pages[dst] = pages[src]
            return c

        return map_cache_tree(caches, on_attention=cp, on_leaf=lambda c: c)
