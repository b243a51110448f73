"""The decoder LM of the port: the dense path of ``repro/models/model.py``
(``Model.init_params``, ``_embed``, ``forward``, ``loss``, and the
decode methods of serving; ``:38-58``, ``:171-239``, ``:259-763``).

:class:`Model` is an ``nn.Module`` whose parameters carry the
reference's names, dotted (``layers.attn.wq``), and its stacked
``(num_layers, ...)`` layer shapes.  :func:`leaf_names` gives them in
the reference's ``jax.tree.leaves`` order (keys sorted at every level),
which the sharded engine walks leaf by leaf.  The forward is functional
over a flat ``{name: tensor}`` dict, so that the trainer evaluates it at
two points of a round without touching the module.  The reference's
scan over layers under ``jax.checkpoint`` is a loop over layer slices,
each under ``torch.utils.checkpoint`` when ``cfg.remat``.

Decode state is held in one layout: a tuple with one
:class:`~repro_torch.models.layers.KVCache` per layer (the reference
stacks them ``(L, ...)`` under its scan, or keeps a tuple when it
unrolls).  Dense ring caches are ``(B, S, kvH, hd)``; paged caches are
the pool's ``(num_pages + 1, P, kvH, hd)`` pages, the last of them the
scratch page that padded writes land in, so that no write is ever
filtered on the host.  The decode methods write the caches in place and
return them in the new state.  Recurrent (SSM/hybrid) decode state comes
with those blocks (ROADMAP queue 1, slice 3 item 7); :func:`_check_dense`
refuses them.
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

Tensor = torch.Tensor
Params = Dict[str, Tensor]
Caches = Tuple[KVCache, ...]


class DecodeState(NamedTuple):
    """Dense decode state: one ring ``KVCache`` (B, S, kvH, hd) a layer,
    and the next absolute position, a 0-d tensor (slots in lockstep) or
    (B,) per slot."""
    caches: Caches
    position: Tensor


class PagedDecodeState(NamedTuple):
    """Decode state over a shared page pool: one ``KVCache`` of pool
    pages (num_pages + 1, P, kvH, hd) a layer, addressed through one page
    table that every layer shares (all layers allocate alike, so one
    logical page maps to the same physical row in each)."""
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


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.arch_type != "dense" or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder is ported (ROADMAP queue "
            "1, slice 3 item 7 brings moe, mla, ssm, hybrid, audio and "
            "vlm blocks)")


def map_cache_tree(tree: Any, on_attention: Callable, on_leaf: Callable,
                   other: Any = None) -> Any:
    """The decode-cache tree walk (``model.py:195-216``): ``on_attention``
    handles whole ``KVCache`` nodes, ``on_leaf`` every other tensor leaf
    (recurrent state, which the dense port has none of); tuples and
    NamedTuples recurse, keeping their type.  With ``other``, walks two
    trees of the same structure zipped and the callbacks take
    ``(node, other_node)``."""
    zipped = other is not None

    def rec(c, o):
        if isinstance(c, KVCache):
            return on_attention(c, o) if zipped else on_attention(c)
        if isinstance(c, tuple):
            pairs = zip(c, o) if zipped else ((e, None) for e in c)
            merged = tuple(rec(e, oe) for e, oe in pairs)
            return type(c)(*merged) if hasattr(c, "_fields") else merged
        return on_leaf(c, o) if zipped else on_leaf(c)

    return rec(tree, other)


def _pad_cache_capacity(caches: Any, extra: int) -> Any:
    """Grow the sequence axis (-3) of every ``KVCache`` by ``extra`` empty
    slots."""
    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, extra))

    return map_cache_tree(
        caches, on_attention=lambda c: KVCache(k=pad(c.k), v=pad(c.v)),
        on_leaf=lambda c: c)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Fresh weights from ``generator``, in the reference's layout (its
    values come from JAX keys; convert them with
    :func:`repro_torch.convert.params_from_jax` to start from the same
    point)."""
    _check_dense(cfg)
    dt, D, L = cfg.param_dtype, cfg.d_model, cfg.num_layers
    tree: dict = {
        "final_norm": torch.ones(D, dtype=dt, device=device),
        "embed": embed_init(generator, cfg.padded_vocab, D, dt, device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = embed_init(generator, cfg.padded_vocab, D, dt,
                                     device).T.contiguous()
    layers = [{"ln1": torch.ones(D, dtype=dt, device=device),
               "attn": init_attention(generator, cfg, device),
               "ln2": torch.ones(D, dtype=dt, device=device),
               "mlp": init_mlp(generator, D, cfg.d_ff, dt, device)}
              for _ in range(L)]
    flat_layers = [_flatten(lp) for lp in layers]
    tree["layers"] = {name: torch.stack([lp[name] for lp in flat_layers])
                      for name in flat_layers[0]}
    return _flatten(tree)


def param_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """Every parameter's shape, in ``jax.tree.leaves`` order."""
    _check_dense(cfg)
    D, F, hd, V = cfg.d_model, cfg.d_ff, cfg.hd, cfg.padded_vocab
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    layer = {"ln1": (D,), "ln2": (D,),
             "attn": {"wq": (D, q), "wk": (D, kv), "wv": (D, kv),
                      "wo": (q, D)},
             "mlp": {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}}
    if cfg.qkv_bias:
        layer["attn"].update(bq=(q,), bk=(kv,), bv=(kv,))
    tree: dict = {"embed": (V, D), "final_norm": (D,),
                  "layers": {k: (cfg.num_layers,) + v
                             for k, v in _flatten(layer).items()}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (D, V)
    return _flatten(tree)


def leaf_names(cfg: ArchConfig) -> List[str]:
    """The parameter names in ``jax.tree.leaves`` order."""
    return list(param_shapes(cfg))


def _split(p: Params):
    attn = {k[len("attn."):]: v for k, v in p.items()
            if k.startswith("attn.")}
    mlp = {k[len("mlp."):]: v for k, v in p.items() if k.startswith("mlp.")}
    return attn, mlp


def _block(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
           with_cache: bool = False):
    """One layer of the training and prefill forward; with
    ``with_cache`` also its ``KVCache`` (prefill)."""
    attn, mlp = _split(p)
    h = attention_block(attn, rmsnorm(x, p["ln1"], cfg.rms_eps), positions,
                        cfg, causal=not cfg.is_encoder, with_cache=with_cache)
    h, cache = h if with_cache else (h, None)
    x = x + h
    x = x + mlp_block(mlp, rmsnorm(x, p["ln2"], cfg.rms_eps))
    return (x, cache) if with_cache else x


def _block_decode(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
                  cache: KVCache, **decode) -> Tuple[Tensor, KVCache]:
    """One layer of a decode pass (``model.py:94-119``, dense kind)."""
    attn, mlp = _split(p)
    h, cache = decode_attention_block(
        attn, rmsnorm(x, p["ln1"], cfg.rms_eps), positions, cfg, cache,
        causal=not cfg.is_encoder, **decode)
    x = x + h
    return x + mlp_block(mlp, rmsnorm(x, p["ln2"], cfg.rms_eps)), cache


class Model(nn.Module):
    """The dense decoder.  ``Model(cfg, params)`` holds ``params`` (a
    flat dict as :func:`init_params` makes) as its parameters;
    :meth:`loss` and :meth:`forward` take any such dict."""

    def __init__(self, cfg: ArchConfig, params: Params):
        super().__init__()
        _check_dense(cfg)
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
        behind the causal mask).  Always true of the dense port."""
        return self.cfg.arch_type in ("dense", "moe", "audio", "vlm")

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
        and with ``collect_caches`` also the layers' ``KVCache`` tuple.
        ``last_index`` (bucketed prefill): the true prompt length, a 0-d
        tensor; the head then runs on the hidden state at
        ``last_index - 1`` alone, so a prompt padded to its bucket gives
        the logits of the unpadded one."""
        cfg = self.cfg
        params = self.params() if params is None else params
        x, positions = self._embed(params, batch)
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once, where an index per layer would add L full-size
        # zero-padded gradients
        layer = {k[len("layers."):]: v.unbind(0) for k, v in params.items()
                 if k.startswith("layers.")}
        caches = []
        for i in range(cfg.num_layers):
            lp = {k: v[i] for k, v in layer.items()}
            if collect_caches:
                x, c = _block(lp, x, positions, cfg, with_cache=True)
                caches.append(c)
            elif cfg.remat and torch.is_grad_enabled():
                x = checkpoint(_block, lp, x, positions, cfg,
                               use_reentrant=False)
            else:
                x = _block(lp, x, positions, cfg)
        x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
        if last_index is not None:
            idx = torch.clamp(torch.as_tensor(last_index, device=x.device)
                              - 1, min=0).reshape(1)
            x = x.index_select(1, idx)
        elif last_token_only:
            x = x[:, -1:]
        logits = x @ self._head(params)
        return (logits, tuple(caches)) if collect_caches else logits

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
        """Next-token cross entropy over ``batch["tokens"]`` (B, T); the
        logits are taken in float32 (``model.py:430``)."""
        logits = self.forward(batch, params)[:, :-1].float()
        targets = batch["tokens"][:, 1:].long()
        mask = (targets >= 0).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           torch.clamp(targets, min=0)[..., None])[..., 0]
        return (torch.sum((lse - tgt) * mask)
                / torch.clamp(torch.sum(mask), min=1.0))

    # -- decode ----------------------------------------------------------
    def cache_capacity(self, seq_len: int) -> int:
        w = self.cfg.attention_window
        return min(seq_len, w) if w else seq_len

    def _zeros_cache(self, rows: int, width: int) -> KVCache:
        cfg = self.cfg
        shape = (rows, width, cfg.num_kv_heads, cfg.hd)
        return KVCache(
            k=torch.zeros(shape, dtype=cfg.param_dtype, device=self.device),
            v=torch.zeros(shape, dtype=cfg.param_dtype, device=self.device))

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
        angles = rope_angles(positions, cfg.hd, cfg.rope_theta)
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
        angles = rope_angles(positions, cfg.hd, cfg.rope_theta)
        pages = state.caches[0].k
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
        into the pool, in place: the KV of positions ``[shared_len, T)``
        goes to the pages of ``table_row``; the shared-prefix positions
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
            caches, on_attention=lambda c, pc: KVCache(
                k=write(c.k, pc.k), v=write(c.v, pc.v)),
            on_leaf=lambda c, pc: c, other=prefill_caches)

    def copy_cache_page(self, caches: Caches, src: int, dst: int) -> Caches:
        """Copy-on-write: physical page ``src`` into ``dst`` in every
        layer, in place (unwritten slots carry stale bytes along; they
        stay behind the validity mask)."""
        def cp(c: KVCache) -> KVCache:
            c.k[dst] = c.k[src]
            c.v[dst] = c.v[src]
            return c

        return map_cache_tree(caches, on_attention=cp, on_leaf=lambda c: c)
