"""Lightweight metrics logging: stdout + JSONL sink.

The port's copy of ``repro/training/metrics.py``, equal to it but for
its imports (the port imports nothing of the JAX package);
``tests/test_torch_core.py`` holds the two copies equal.

A thin shim over the observability layer
(``repro_torch.obs.metrics``): the jsonl file goes through
:class:`~repro_torch.obs.metrics.JsonlSink` and every numeric field is
mirrored into the metrics registry as a ``<name>.<field>`` gauge, so a
``--metrics-out`` snapshot sees whatever was logged.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from repro_torch.obs.metrics import JsonlSink, Registry, get_registry


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, name: str = "train",
                 print_every: int = 1,
                 registry: Optional[Registry] = None):
        self.out_dir = out_dir
        self.name = name
        self.print_every = print_every
        self._t0 = time.time()
        self._sink: Optional[JsonlSink] = None
        self._registry = registry
        if out_dir:
            self._sink = JsonlSink(os.path.join(out_dir, f"{name}.jsonl"))

    def log(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {"step": step,
                               "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        reg = self._registry if self._registry is not None else get_registry()
        reg.gauge(f"{self.name}.step").set(float(step))
        for k, v in rec.items():
            if k != "step" and isinstance(v, float):
                reg.gauge(f"{self.name}.{k}").set(v)
        if self._sink is not None:
            self._sink.write(rec)
        if step % self.print_every == 0:
            kv = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in rec.items() if k != "step")
            print(f"[step {step:>6d}] {kv}", flush=True)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
