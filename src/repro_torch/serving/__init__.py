"""repro_torch.serving — batched decode serving, the port of
``repro/serving``.

Two engines over one model decode contract:

* :class:`~repro_torch.serving.decode.DecodeServer` — dense per-slot
  ring caches, token-by-token prefill; the simple parity anchor.
* :class:`~repro_torch.serving.engine.PagedEngine` — the paged KV-cache
  pool (:mod:`repro_torch.serving.pages`, a copy of the reference's),
  chunked or bucketed bulk prefill, continuous batching with preemption
  and prefix sharing; its passes read through the paged-attention
  kernel.
"""
from repro_torch.serving.decode import BOS_TOKEN, DecodeServer, Request
from repro_torch.serving.engine import PagedEngine, RequestStats
from repro_torch.serving.pages import PagePool, PoolMetrics, PrefixCache

__all__ = [
    "BOS_TOKEN", "DecodeServer", "Request", "PagedEngine", "RequestStats",
    "PagePool", "PoolMetrics", "PrefixCache",
]
