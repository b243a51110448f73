"""The decoder LM of the port: the dense path of ``repro/models/model.py``
(``Model.init_params``, ``_embed``, ``forward``, ``loss``;
``:259-436``).

:class:`Model` is an ``nn.Module`` whose parameters carry the
reference's names, dotted (``layers.attn.wq``), and its stacked
``(num_layers, ...)`` layer shapes.  :func:`leaf_names` gives them in
the reference's ``jax.tree.leaves`` order (keys sorted at every level),
which the sharded engine walks leaf by leaf.  The forward is functional
over a flat ``{name: tensor}`` dict, so that the trainer evaluates it at
two points of a round without touching the module.  The reference's
scan over layers under ``jax.checkpoint`` is a loop over layer slices,
each under ``torch.utils.checkpoint`` when ``cfg.remat``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (attention_block, embed_init,
                                       init_attention, init_mlp, mlp_block,
                                       rmsnorm)

Tensor = torch.Tensor
Params = Dict[str, Tensor]


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


def _block(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig
           ) -> Tensor:
    attn = {k[len("attn."):]: v for k, v in p.items()
            if k.startswith("attn.")}
    mlp = {k[len("mlp."):]: v for k, v in p.items() if k.startswith("mlp.")}
    x = x + attention_block(attn, rmsnorm(x, p["ln1"], cfg.rms_eps),
                            positions, cfg, causal=not cfg.is_encoder)
    return x + mlp_block(mlp, rmsnorm(x, p["ln2"], cfg.rms_eps))


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
        tokens = batch["tokens"]
        x = params["embed"][tokens.long()]
        x = x * torch.full((), self.cfg.d_model, dtype=x.dtype,
                           device=x.device).sqrt()
        positions = torch.arange(x.shape[1], device=x.device)
        return x, positions

    # -- forward ---------------------------------------------------------
    def forward(self, batch: dict, params: Optional[Params] = None
                ) -> Tensor:
        """Training forward -> logits (B, T, padded vocab)."""
        cfg = self.cfg
        params = self.params() if params is None else params
        x, positions = self._embed(params, batch)
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once, where an index per layer would add L full-size
        # zero-padded gradients
        layer = {k[len("layers."):]: v.unbind(0) for k, v in params.items()
                 if k.startswith("layers.")}
        for i in range(cfg.num_layers):
            lp = {k: v[i] for k, v in layer.items()}
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(_block, lp, x, positions, cfg,
                               use_reentrant=False)
            else:
                x = _block(lp, x, positions, cfg)
        x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
        head = (params["embed"].T if cfg.tie_embeddings
                and "lm_head" not in params else params["lm_head"])
        return x @ head

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
