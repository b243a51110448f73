"""PyTorch wrappers of BlockRandK's block gather and block scatter
kernels (``csrc/randk.cu``), built and loaded by :mod:`.build` at first
use.

Each wrapper checks its tensors (CUDA, type, shape, contiguity) and
raises on anything else, allocates its output (the gather) or updates
``base`` in place (the scatter, as the Pallas kernel aliases its base),
launches on the current stream, raises if the launch failed, and counts
the launch in :data:`repro_torch.kernels.dasha_update.launches`.  They
take CUDA tensors only; :mod:`.ops` routes CPU tensors to the plain
versions in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dasha_update import _check_operands, _launch

Tensor = torch.Tensor

LIBRARY = "randk"

_P, _F, _I64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # x, idx, out, n, d, kb, bs, scale, stream
    "block_gather": [_P] * 3 + [_I64] * 4 + [_F, _P],
    # base, vals, rows, r, k, bs, stream
    "block_scatter": [_P] * 3 + [_I64] * 3 + [_P],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use), its C functions
    typed."""
    lib = build.load(LIBRARY)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.randk_error_string.argtypes = [ctypes.c_int]
    lib.randk_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.randk_error_string
    return lib


def block_gather(payload: Tensor, block_idx: Tensor, *, scale: float,
                 block_size: int) -> Tensor:
    """``out[i, j, :] = payload[i, block_idx[i, j] * bs : + bs] * scale``,
    zero past the end of the row: (n, d) float32 rows and (n, kb) int64
    block numbers give (n, kb, block_size)."""
    if payload.dim() != 2 or block_idx.dim() != 2:
        raise ValueError(f"expected (n, d) payload and (n, kb) indices, got "
                         f"{tuple(payload.shape)} and "
                         f"{tuple(block_idx.shape)}")
    if block_size < 1:
        raise ValueError(f"block_size must be positive, got {block_size}")
    (n, d), kb = payload.shape, block_idx.shape[1]
    _check_operands(dict(payload=(payload, (n, d)),
                         block_idx=(block_idx, (n, kb))),
                    dict(block_idx=torch.int64))
    out = torch.empty((n, kb, block_size), dtype=payload.dtype,
                      device=payload.device)
    _launch("block_gather", payload.device, payload.data_ptr(),
            block_idx.data_ptr(), out.data_ptr(), n, d, kb, block_size,
            scale, lib=library())
    return out


def block_scatter(base: Tensor, vals: Tensor, rows: Tensor) -> Tensor:
    """``base[rows[k]] += vals[k]`` in place and returned: ``base`` (R, bs)
    and ``vals`` (K, bs) float32, ``rows`` (K,) int64.  The rows must be
    distinct and in ``[0, R)`` (BlockRandK draws without replacement);
    the kernel does not check that, since a check would sync."""
    if base.dim() != 2 or vals.dim() != 2:
        raise ValueError(f"expected base (R, bs) and vals (K, bs), got "
                         f"{tuple(base.shape)} and {tuple(vals.shape)}")
    (r, bs), k = base.shape, vals.shape[0]
    _check_operands(dict(base=(base, (r, bs)), vals=(vals, (k, bs)),
                         rows=(rows, (k,))), dict(rows=torch.int64))
    _launch("block_scatter", base.device, base.data_ptr(), vals.data_ptr(),
            rows.data_ptr(), r, k, bs, lib=library())
    return base
