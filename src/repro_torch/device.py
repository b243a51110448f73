"""Device resolution for the port's entry points.

Every entry point that creates tensors takes ``device=`` and defaults to
``"cuda"``: the port exists to run on the GPU, so a missing card is an
error, never a silent move to the CPU.  Callers that mean the CPU (the
tests, the CPU half of a card-vs-CPU comparison) say so.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device` (``"cuda"`` becomes the
    current CUDA device); raises when it names CUDA and no CUDA device is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU through the kernels' plain versions")
        if dev.index is None:   # compare equal to a tensor's device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
