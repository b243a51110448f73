"""repro_torch.obs — the observability layer of the port.

``trace`` (spans on dual wall/virtual clocks, Chrome trace export),
``metrics`` (counter/gauge/histogram registry, JSONL sink) and
``monitors`` (live invariant checks) are copies of their namesakes in
``repro/obs``.  :func:`start_run` / :func:`add_cli_flags` give the launch
CLIs ``--trace-out`` and ``--metrics-out``; ``--profile-dir``
(``torch.profiler``) waits for the port's tooling slice.
"""
from __future__ import annotations

import platform
import sys
from typing import Any, Dict, Optional

from repro_torch.obs import metrics, monitors, trace
from repro_torch.obs.metrics import get_registry

__all__ = ["metrics", "monitors", "trace", "ObsRun", "start_run",
           "add_cli_flags", "provenance"]


def provenance() -> Dict[str, Any]:
    """What produced an artifact: torch, CUDA and Python versions, the
    platform and the first card's name (None without one)."""
    import torch
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else None),
            "python": sys.version.split()[0],
            "platform": platform.platform()}


class ObsRun:
    """Handle for one observed run; ``finish()`` writes the artifacts."""

    def __init__(self, trace_out: Optional[str] = None,
                 metrics_out: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.trace_out = trace_out
        self.metrics_out = metrics_out
        self._finished = False
        self.provenance = provenance()
        if meta:
            self.provenance.update(meta)
        self.tracer = (trace.configure(meta=self.provenance)
                       if trace_out else None)

    def finish(self) -> "ObsRun":
        """Export the trace and the metrics snapshot; idempotent."""
        if self._finished:
            return self
        self._finished = True
        if self.tracer is not None:
            if trace.get_tracer() is self.tracer:
                trace.uninstall()
            self.tracer.export_chrome(self.trace_out)
            print(f"[obs] trace -> {self.trace_out} "
                  f"({len(self.tracer.events)} events)")
        if self.metrics_out:
            reg = get_registry()
            reg.write_snapshot(self.metrics_out,
                               extra={"provenance": self.provenance})
            print(f"[obs] metrics -> {self.metrics_out} "
                  f"({len(reg.names())} metrics)")
        return self


def start_run(trace_out: Optional[str] = None,
              metrics_out: Optional[str] = None,
              meta: Optional[Dict[str, Any]] = None) -> ObsRun:
    """Begin an observed run (a no-op handle when both outputs are None)."""
    return ObsRun(trace_out=trace_out, metrics_out=metrics_out, meta=meta)


def add_cli_flags(ap) -> None:
    """Attach ``--trace-out`` / ``--metrics-out``."""
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON (open in "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics registry snapshot JSON")
