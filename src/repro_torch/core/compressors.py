"""Unbiased communication compressors (paper Definition 1), and TopK.

The port of ``repro/core/compressors.py``'s :class:`Identity`,
:class:`RandK`, :class:`BlockRandK`, :class:`TopK` (biased, a baseline)
and :class:`RandomDithering`, with :func:`make_compressor`.
``NaturalCompression``, ``Composed`` and
``PartialParticipationCompressor`` wait for a later slice.

The reference compresses one flat vector per call from a JAX key.  Here
the randomness is split from the arithmetic, so that a parity test can
hand the reference's draw to the port:

* ``draw(generator, n, d)``  – every node's randomness for one round:
  the kept indices, ``(n, k)`` coordinates or ``(n, kb)`` blocks, or for
  dithering the ``(n, d)`` uniforms of the rounding (``None`` when the
  compressor draws nothing);
* ``compress(x, idx)``       – node-major ``(n, d)`` -> dense ``(n, d)``
  with the dropped coordinates zero;
* ``omega(d)`` / ``wire_bits(d)`` – the variance parameter and the bits
  of one message, equal to the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import wire
from repro_torch.core.variants import block_plan, message_bits

Tensor = torch.Tensor

_FLOAT_BITS = int(wire.FLOAT_BITS)


def _uniform_subsets(generator: torch.Generator, n: int, d: int,
                     k: int) -> Tensor:
    """(n, k) distinct indices per row, a uniform k-subset of range(d):
    the positions of the k largest of d uniform keys."""
    keys = torch.rand(n, d, generator=generator, device=generator.device)
    return torch.topk(keys, k, dim=1).indices


class Compressor:
    """Base interface (see module docstring)."""

    name: str = "base"

    def omega(self, d: int) -> float:
        raise NotImplementedError

    def draw(self, generator: torch.Generator, n: int,
             d: int) -> Optional[Tensor]:
        raise NotImplementedError

    def compress(self, x: Tensor, idx: Optional[Tensor]) -> Tensor:
        raise NotImplementedError

    def wire_bits(self, d: int) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """No compression: C(x) = x, omega = 0."""

    name: str = "identity"

    def omega(self, d: int) -> float:
        return 0.0

    def draw(self, generator, n, d):
        return None

    def compress(self, x, idx):
        return x

    def wire_bits(self, d: int) -> float:
        return d * _FLOAT_BITS


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Definition 5: keep K uniformly-random coordinates (w/o replacement),
    scaled by d/K.  ``C in U(d/K - 1)`` (Theorem 6)."""

    k: int
    name: str = "randk"

    def omega(self, d: int) -> float:
        return d / self.k - 1.0

    def draw(self, generator, n, d):
        k = min(self.k, d)
        if k == d:
            return None
        return _uniform_subsets(generator, n, d, k)

    def compress(self, x, idx):
        if idx is None:
            return x
        d = x.shape[-1]
        scale = d / idx.shape[-1]
        out = torch.zeros_like(x)
        return out.scatter_(-1, idx, torch.gather(x, -1, idx) * scale)

    def wire_bits(self, d: int) -> float:
        k = min(self.k, d)
        return k * (_FLOAT_BITS + wire.index_bits(d))


@dataclasses.dataclass(frozen=True)
class BlockRandK(Compressor):
    """RandK at block granularity: choose ``kb`` of the ``nb``
    (block_size,)-blocks u.a.r. without replacement and scale by
    ``nb/kb``; unbiased with ``omega = nb/kb - 1``.  The last block is
    zero-padded, as in the reference's ``variants.block_randk_dense``."""

    ratio: float
    block_size: int = 128
    name: str = "block_randk"

    def _plan(self, d: int):
        return block_plan(d, self.block_size, self.ratio)

    def omega(self, d: int) -> float:
        _, nb, kb = self._plan(d)
        return nb / kb - 1.0

    def draw(self, generator, n, d):
        _, nb, kb = self._plan(d)
        return _uniform_subsets(generator, n, nb, kb)

    def compress(self, x, idx):
        n, d = x.shape
        bs, nb, kb = self._plan(d)
        blocks = F.pad(x, (0, nb * bs - d)).reshape(n, nb, bs)
        index = idx[:, :, None].expand(n, kb, bs)
        vals = torch.gather(blocks, 1, index) * (nb / kb)
        out = torch.zeros_like(blocks).scatter_(1, index, vals)
        return out.reshape(n, nb * bs)[:, :d]

    def wire_bits(self, d: int) -> float:
        return message_bits(d, aggregation="sparse_allgather",
                            compression_ratio=self.ratio,
                            block_size=self.block_size)


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Greedy Top-K by magnitude.  *Biased* (contractive), a baseline
    only: ``||C(x) - x||^2 <= (1 - k/d) ||x||^2``.  It draws nothing."""

    k: int
    name: str = "topk"

    def omega(self, d: int) -> float:  # contraction factor, not Def.1 omega
        return 1.0 - self.k / d

    def draw(self, generator, n, d):
        return None

    def compress(self, x, idx):
        k = min(self.k, x.shape[-1])
        top = torch.topk(x.abs(), k, dim=-1).indices
        return torch.zeros_like(x).scatter_(-1, top, torch.gather(x, -1, top))

    def wire_bits(self, d: int) -> float:
        k = min(self.k, d)
        return k * (_FLOAT_BITS + wire.index_bits(d))


@dataclasses.dataclass(frozen=True)
class RandomDithering(Compressor):
    """QSGD-style random dithering with ``s`` levels (Alistarh et al.
    2017): ``C(x) = ||x|| sign(x) xi(x, s) / s`` with ``xi`` the level
    rounded up with probability equal to its fractional part, one
    ``(n, d)`` block of uniforms a round.  ``omega <= min(d/s^2,
    sqrt(d)/s)``."""

    s: int = 4
    name: str = "dithering"

    def omega(self, d: int) -> float:
        # the reference takes sqrt(d) in float32 (jnp.sqrt of an int)
        return min(d / self.s**2, float(np.sqrt(np.float32(d))) / self.s)

    def draw(self, generator, n, d):
        return torch.rand(n, d, generator=generator, device=generator.device)

    def compress(self, x, idx):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        safe_norm = torch.where(norm > 0, norm, 1.0)
        level = x.abs() / safe_norm * self.s
        floor = torch.floor(level)
        q = floor + (idx < level - floor).to(x.dtype)
        out = norm * torch.sign(x) * q / self.s
        return torch.where(norm > 0, out, 0.0)

    def wire_bits(self, d: int) -> float:
        return _FLOAT_BITS + d * (1 + math.ceil(math.log2(self.s + 1)))


_REGISTRY = {
    "identity": lambda d, **kw: Identity(),
    "randk": lambda d, **kw: RandK(k=kw.get("k", max(1, d // 100))),
    "block_randk": lambda d, **kw: BlockRandK(
        ratio=kw.get("ratio", 0.01), block_size=kw.get("block_size", 128)),
    "topk": lambda d, **kw: TopK(k=kw.get("k", max(1, d // 100))),
    "dithering": lambda d, **kw: RandomDithering(s=kw.get("s", 4)),
}


def make_compressor(name: str, d: int, **kwargs) -> Compressor:
    """The compressor registered under ``name``, with the reference's
    defaults (``repro/core/compressors.py:313``)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](d, **kwargs)
