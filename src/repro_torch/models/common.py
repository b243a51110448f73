"""Shared model configuration (the port of ``repro/models/common.py``).

One :class:`ArchConfig` describes an architecture; its fields, the
sub-configs and :meth:`ArchConfig.smoke` are the reference's.  Layer
parameters are stored **stacked**: every per-layer leaf carries a
leading ``num_layers`` dimension, as in the reference, because the
sharded engine's per-leaf draws see each leaf whole.  The reference's
``PartitionSpec`` helpers (``common.py:170-214``) serve its mesh and are
left out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_expert: int                  # per-expert FFN hidden size
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01  # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 => dense q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    expand: int = 2                # d_inner = expand * d_model
    conv_width: int = 4
    dt_rank: int = 0               # 0 => ceil(d_model / 16)
    chunk: int = 256               # chunked associative scan length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4           # every k-th block is sLSTM, rest mLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    is_encoder: bool = False           # bidirectional, no decode shapes
    frontend: Optional[str] = None     # 'audio' | 'vision' (stubbed embeds)
    frontend_tokens: int = 256         # prefix length provided by the stub
    attention_window: Optional[int] = None   # native sliding-window attn
    long_context_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    scan_layers: bool = True
    remat: bool = True
    dtype: str = "bfloat16"
    source: str = ""                   # citation bracket from the assignment

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256, as the reference pads
        its embedding and head (its reason is the model axis; the port
        keeps the shapes so that weights carry across)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def sub_quadratic(self) -> bool:
        """True if long_500k is natively supported (SSM/hybrid) or via the
        sliding-window variant."""
        return (self.arch_type in ("ssm", "hybrid")
                or self.attention_window is not None
                or self.long_context_window is not None)

    def for_long_context(self) -> "ArchConfig":
        """The variant lowered for long_500k: enable the SWA window for
        full-attention archs (no-op for SSM/hybrid/native-SWA)."""
        if self.attention_window is None and self.long_context_window:
            return self.with_overrides(
                attention_window=self.long_context_window)
        return self

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- reduced variant for CPU smoke tests ---------------------------
    def smoke(self) -> "ArchConfig":
        kw = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=32,
            frontend_tokens=8 if self.frontend else self.frontend_tokens,
            scan_layers=False,
            remat=False,
            dtype="float32",
            attention_window=(16 if self.attention_window else None),
            long_context_window=(16 if self.long_context_window else None),
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4,
                experts_per_token=min(2, self.moe.experts_per_token),
                d_expert=64,
                num_shared_experts=min(1, self.moe.num_shared_experts),
                capacity_factor=4.0)
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=32,
                                  qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=8, chunk=16)
        if self.xlstm:
            kw["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2)
        return self.with_overrides(**kw)


def count_params(params: Mapping[str, torch.Tensor]) -> int:
    return sum(int(math.prod(p.shape)) for p in params.values())
