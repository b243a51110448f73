"""The training loop: batches -> step -> metrics and checkpoints (the
port of ``repro/training/loop.py``).

Both the round's randomness and the checkpoint numbering derive from the
GLOBAL step carried in ``state.step``: round ``t`` draws from a
``torch.Generator`` seeded ``seed + t`` (the reference's
``round_train_key``, ``loop.py:25``), and the state after round ``t`` is
saved as step ``t + 1``, so a run resumed from a restored state
continues the stream instead of replaying round 0, and its checkpoints
extend the earlier run's files instead of overwriting them.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.training.checkpoints import save_checkpoint
from repro_torch.training.metrics import MetricsLogger
from repro_torch.training.trainer import Trainer, TrainState


def round_generator(seed: int, global_step: int,
                    device="cpu") -> torch.Generator:
    """The generator of round ``global_step``'s draws, on ``device``."""
    return torch.Generator(device=device).manual_seed(seed + global_step)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in batch.items()}


def train(trainer: Trainer, state: TrainState,
          batches: Iterator[Dict[str, np.ndarray]], num_steps: int,
          logger: Optional[MetricsLogger] = None, log_every: int = 10,
          seed: int = 0, device="cuda",
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0) -> TrainState:
    logger = logger or MetricsLogger(print_every=log_every)
    dev = torch.device(device)
    start = state.step
    # per-step device scalars, summed once at the end: publishing the
    # wire ledger forces no host sync per step
    bits_seen, parts_seen = [], []
    metrics = None
    for i in range(num_steps):
        gstep = start + i
        batch = to_device(next(batches), dev)
        draws = trainer.engine.draw(round_generator(seed, gstep, dev))
        with obs_trace.span("train.step", track="train", step=gstep):
            state, metrics = trainer.train_step(state, batch, draws)
        bits_seen.append(metrics.bits_sent)
        parts_seen.append(metrics.participants)
        if i % log_every == 0 or i == num_steps - 1:
            logger.log(gstep, loss=metrics.loss, grad_norm=metrics.grad_norm,
                       bits_sent=metrics.bits_sent,
                       participants=metrics.participants)
        if checkpoint_dir and checkpoint_every \
                and (gstep + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state, gstep + 1)
    if metrics is not None:
        reg = obs_metrics.get_registry()
        reg.gauge("train.bits_sent").set(float(np.sum(
            torch.stack(bits_seen).cpu().numpy(), dtype=np.float64)))
        # one oracle call per participating node per round
        reg.gauge("train.oracle_calls").set(float(np.sum(
            torch.stack(parts_seen).cpu().numpy(), dtype=np.float64)))
        reg.gauge("train.steps").set(float(num_steps))
        reg.gauge("train.loss").set(float(metrics.loss))
    return state
