"""PyTorch wrappers of the fused multi-request GQA paged-attention kernel
(``csrc/paged_attention.cu``), built and loaded by :mod:`.build` at
first use.

:func:`paged_attention_batched` is the one launch of a serve pass:
queries ``(B, C, H, hd)`` in float32 or bf16 against the pool pages
``(NP, P, kvH, hd)`` in float32 or bf16 (read in their own type, never
copied to float32), through the ``(B, M)`` page table, with the ``(B,)``
``start`` and ``q_lens``; ``M`` is a launch argument, so every table
width the engine slices runs the same build.  :func:`paged_attention`
is its ``C = 1`` decode view.  Rows ``c >= q_lens`` are garbage by
contract; the kernel writes 0 there.  Each wrapper checks its tensors
(CUDA, types, shapes, contiguity) and raises on anything else, launches
on the current stream, raises if the launch failed, and counts the
launch in :data:`repro_torch.kernels.dasha_update.launches`: a launch
with ``C = 1`` (a pure-decode pass of the engine, and the decode view)
counts under ``paged_attention`` (the TPU's ``paged_attention_pallas``),
one with ``C > 1`` (a chunked-prefill pass) under
``paged_attention_batched``.  They take CUDA tensors only; :mod:`.ops`
routes CPU tensors to the plain versions in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dasha_update import _check_operands, _launch

Tensor = torch.Tensor

LIBRARY = "paged_attention"
MAX_HEAD_DIM = 64          # the kernel's staged tiles hold 64 head dims

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, q_bf16, k, v, kv_bf16, table, start, q_lens, out, ws, B, C, H, kvH,
# hd, P, M, window, splits, stream
_SIGNATURE = [_P, _I, _P, _P, _I] + [_P] * 5 + [_I64] * 8 + [_I, _P]
# B, C, H, kvH, P, M
_SPLITS_SIGNATURE = [_I64] * 6
_TYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use), its C functions
    typed."""
    lib = build.load(LIBRARY)
    lib.paged_attention.argtypes = _SIGNATURE
    lib.paged_attention.restype = ctypes.c_int
    lib.paged_attention_splits.argtypes = _SPLITS_SIGNATURE
    lib.paged_attention_splits.restype = ctypes.c_int
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.paged_attention_error_string
    return lib


def paged_attention_batched(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                            page_table: Tensor, start: Tensor,
                            q_lens: Tensor, *,
                            window: Optional[int] = None) -> Tensor:
    """The fused launch of a serve pass (the contract of
    :func:`repro_torch.kernels.ref.paged_attention_batched_ref`; rows
    ``c >= q_lens`` come out 0): (B, C, H, hd) float32.  ``page_table``,
    ``start`` and ``q_lens`` are int32."""
    if q.dim() != 4 or k_pages.dim() != 4 or page_table.dim() != 2:
        raise ValueError(f"expected q (B, C, H, hd), pages (NP, P, kvH, hd) "
                         f"and a (B, M) table, got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)} and "
                         f"{tuple(page_table.shape)}")
    B, C, H, hd = q.shape
    NP, P, kvh, _ = k_pages.shape
    M = page_table.shape[1]
    if H % kvh or hd > MAX_HEAD_DIM:
        raise ValueError(f"expected H a multiple of kvH and hd <= "
                         f"{MAX_HEAD_DIM}, got H={H}, kvH={kvh}, hd={hd}")
    if q.dtype not in _TYPES or k_pages.dtype not in _TYPES:
        raise TypeError(f"expected float32 or bfloat16 q and pages, got "
                        f"{q.dtype} and {k_pages.dtype}")
    _check_operands(dict(q=(q, (B, C, H, hd)),
                         k_pages=(k_pages, (NP, P, kvh, hd)),
                         v_pages=(v_pages, (NP, P, kvh, hd)),
                         page_table=(page_table, (B, M)),
                         start=(start, (B,)), q_lens=(q_lens, (B,))),
                    dict(q=q.dtype, k_pages=k_pages.dtype,
                         v_pages=k_pages.dtype, page_table=torch.int32,
                         start=torch.int32, q_lens=torch.int32))
    lib = library()
    out = torch.empty((B, C, H, hd), dtype=torch.float32, device=q.device)
    # a launch of few blocks splits each walk; its runs' partials go to a
    # workspace that the same call merges
    splits = lib.paged_attention_splits(B, C, H, kvh, P, M)
    ws = (torch.empty(splits * B * C * H * (hd + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    _launch("paged_attention", q.device, q.data_ptr(),
            int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
            v_pages.data_ptr(), int(k_pages.dtype == torch.bfloat16),
            page_table.data_ptr(), start.data_ptr(), q_lens.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), B, C, H,
            kvh, hd, P, M, 0 if window is None else int(window), splits,
            lib=lib,
            count="paged_attention" if C == 1 else "paged_attention_batched")
    return out


def paged_attention(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                    page_table: Tensor, lens: Tensor, *,
                    window: Optional[int] = None) -> Tensor:
    """The single-query decode view: q (B, H, hd), ``lens`` (B,) int32
    tokens a slot holds counting the one just written; (B, H, hd)
    float32."""
    B = q.shape[0]
    start = torch.clamp(lens - 1, min=0).to(torch.int32)
    ones = torch.ones(B, dtype=torch.int32, device=q.device)
    return paged_attention_batched(q[:, None], k_pages, v_pages, page_table,
                                   start, ones, window=window)[:, 0]
