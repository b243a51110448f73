"""Batched decode serving over dense ring caches: the port of
``repro/serving/decode.py``, and the paged engine's parity anchor.

``serve_step(params, tokens, state, update)`` advances the unmasked
slots by one token against their KV caches.  The server keeps PER-SLOT
cache positions (``DecodeState.position`` (B,)), so that

* prefilling a freed slot touches ONLY that slot: in-flight decodes on
  the other slots keep their caches as they were (the ``update`` mask);
* a reused slot restarts its ring position at 0 and its cache rows are
  zeroed, their initial value, so nothing of the previous occupant
  leaks into the new request;
* an empty prompt is decoded from a BOS-0 seed token.

The server lives on the model's device; it raises without a card unless
``device="cpu"`` is asked for.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import DecodeState, Model
from repro_torch.obs import trace as obs_trace

BOS_TOKEN = 0   # seed for empty prompts


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


def engine_device(model: Model, device) -> torch.device:
    """``device`` resolved (raising without a card where it names CUDA),
    checked against where the model's weights lie."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model's weights lie on {model.device}, the "
                         f"server was asked to run on {dev}")
    return dev


class DecodeServer:
    """Greedy batched decoding with static batch slots (an idle slot is
    masked out, so shapes stay fixed)."""

    def __init__(self, model: Model, params, batch_size: int,
                 max_seq_len: int, device="cuda"):
        self.device = engine_device(model, device)
        self.model = model
        self.params = model.params() if params is None else params
        self.batch = batch_size
        self.max_seq = max_seq_len
        self.state = model.init_decode_state(
            batch_size, max_seq_len, position=0)._replace(
            position=torch.zeros(batch_size, dtype=torch.long,
                                 device=self.device))
        self.slots: List[Optional[Request]] = [None] * batch_size
        self._next_tok = np.zeros((batch_size, 1), np.int32)
        self.decode_seconds = 0.0   # wall time of decode step() passes
        self.decode_tokens = 0      # tokens generated in those passes

    def reset_perf_counters(self) -> None:
        """Zero the decode-throughput counters (a warm-up run first)."""
        self.decode_seconds = 0.0
        self.decode_tokens = 0

    def _reset_slot(self, slot: int) -> None:
        """Zero one slot's cache rows (their initial value) and restart
        its ring position at 0."""
        for c in self.state.caches:
            for rows in c:
                rows[slot] = 0
        self.state.position[slot] = 0

    def _tokens(self) -> torch.Tensor:
        # a copy: the host buffer is mutated before the next step
        return torch.from_numpy(self._next_tok.copy()).to(self.device)

    @torch.no_grad()
    def prefill(self, slot: int, req: Request) -> None:
        """Token-by-token prefill (teacher-forcing the prompt) MASKED to
        ``slot``: the other slots' caches and positions are untouched, so
        a refill in the middle of decoding cannot corrupt them."""
        with obs_trace.span("serve.dense.prefill", track="serve",
                            uid=req.uid, slot=slot,
                            tokens=len(req.prompt) or 1):
            self.slots[slot] = req
            self._reset_slot(slot)
            upd = torch.zeros(self.batch, dtype=torch.bool,
                              device=self.device)
            upd[slot] = True
            prompt = req.prompt if req.prompt else [BOS_TOKEN]
            for t in prompt:
                self._next_tok[slot, 0] = t
                logits, self.state = self.model.serve_step(
                    self.params, self._tokens(), self.state, upd)
            self._next_tok[slot, 0] = int(torch.argmax(logits[slot]))

    @torch.no_grad()
    def step(self) -> None:
        active = np.asarray([r is not None and not r.done
                             for r in self.slots])
        if not active.any():
            return
        t0 = time.perf_counter()
        with obs_trace.span("serve.dense.pass", track="serve",
                            active=int(active.sum())):
            logits, self.state = self.model.serve_step(
                self.params, self._tokens(), self.state,
                torch.from_numpy(active).to(self.device))
            # repro: ignore[host-sync] -- greedy decode IS the sync
            # point: the argmax token feeds the next step's inputs
            nxt = np.asarray(torch.argmax(logits, dim=-1).cpu())
        self.decode_seconds += time.perf_counter() - t0
        for i, req in enumerate(self.slots):
            if active[i]:
                req.generated.append(int(self._next_tok[i, 0]))
                self._next_tok[i, 0] = nxt[i]
                self.decode_tokens += 1

    def run(self, requests: List[Request]) -> List[Request]:
        pending = list(requests)
        for i in range(min(self.batch, len(pending))):
            self.prefill(i, pending.pop(0))
        while any(r is not None and not r.done for r in self.slots):
            self.step()
            for i, r in enumerate(self.slots):
                if r is not None and r.done and pending:
                    self.prefill(i, pending.pop(0))
        return requests
