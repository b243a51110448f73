"""PyTorch wrappers of serving's paged-attention kernels: the fused
multi-request GQA kernel (``csrc/paged_attention.cu``) and the
absorbed-form MLA kernel (``csrc/paged_mla_attention.cu``), built and
loaded by :mod:`.build` at first use.

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
``paged_attention_batched``.

:func:`paged_mla_attention` is the MLA model's read of its latent pages:
``q_abs`` ``(B, C, H, r)`` float32 (the nope query with ``W_uk`` folded
in) and ``q_rope`` ``(B, C, H, rope)`` in float32 or bf16 against the
``c_kv`` ``(NP, P, r)`` and ``k_rope`` ``(NP, P, rope)`` pages in float32
or bf16, with the same table, ``start`` and ``q_lens``, the softmax
``scale`` and ``window`` as runtime arguments; it counts under
``paged_mla_attention`` and returns the latent output ``(B, C, H, r)``
float32, 0 in rows ``c >= q_lens``.

They take CUDA tensors only; :mod:`.ops` routes CPU tensors to the plain
versions in :mod:`.ref`.
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
MLA_LIBRARY = "paged_mla_attention"
MAX_HEAD_DIM = 64          # the kernel's staged tiles hold 64 head dims
MAX_RANK = 512             # the MLA kernel's threads own 512 latent dims

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, q_bf16, k, v, kv_bf16, table, start, q_lens, out, ws, B, C, H, kvH,
# hd, P, M, window, splits, stream
_SIGNATURE = [_P, _I, _P, _P, _I] + [_P] * 5 + [_I64] * 8 + [_I, _P]
# B, C, H, kvH, P, M
_SPLITS_SIGNATURE = [_I64] * 6
_TYPES = (torch.float32, torch.bfloat16)
# q_abs, q_rope, q_rope_bf16, c_kv, k_rope, pages_bf16, table, start,
# q_lens, out, ws, B, C, H, r, rope, P, M, window, scale, splits, stream
_MLA_SIGNATURE = ([_P, _P, _I, _P, _P, _I] + [_P] * 5 + [_I64] * 8
                  + [ctypes.c_float, _I, _P])
# B, C, H, P, M
_MLA_SPLITS_SIGNATURE = [_I64] * 5


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


@functools.lru_cache(maxsize=None)
def mla_library() -> ctypes.CDLL:
    """The loaded MLA kernel library (built at first use), typed."""
    lib = build.load(MLA_LIBRARY)
    lib.paged_mla_attention.argtypes = _MLA_SIGNATURE
    lib.paged_mla_attention.restype = ctypes.c_int
    lib.paged_mla_attention_splits.argtypes = _MLA_SPLITS_SIGNATURE
    lib.paged_mla_attention_splits.restype = ctypes.c_int
    lib.paged_mla_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_mla_attention_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.paged_mla_attention_error_string
    return lib


def paged_mla_attention(q_abs: Tensor, q_rope: Tensor, ckv_pages: Tensor,
                        kr_pages: Tensor, page_table: Tensor, start: Tensor,
                        q_lens: Tensor, *, scale: float,
                        window: Optional[int] = None) -> Tensor:
    """The MLA read of a serve pass (the contract of
    :func:`repro_torch.kernels.ref.paged_mla_attention_ref`; rows
    ``c >= q_lens`` come out 0): (B, C, H, r) float32.  ``page_table``,
    ``start`` and ``q_lens`` are int32."""
    if q_abs.dim() != 4 or ckv_pages.dim() != 3 or page_table.dim() != 2:
        raise ValueError(f"expected q_abs (B, C, H, r), c_kv pages (NP, P, "
                         f"r) and a (B, M) table, got {tuple(q_abs.shape)}, "
                         f"{tuple(ckv_pages.shape)} and "
                         f"{tuple(page_table.shape)}")
    B, C, H, r = q_abs.shape
    NP, P, _ = ckv_pages.shape
    rr = q_rope.shape[-1]
    M = page_table.shape[1]
    if r > MAX_RANK or r % 4 or rr % 4:
        raise ValueError(f"expected r <= {MAX_RANK}, r and rope multiples "
                         f"of 4, got r={r}, rope={rr}")
    if q_rope.dtype not in _TYPES or ckv_pages.dtype not in _TYPES:
        raise TypeError(f"expected float32 or bfloat16 q_rope and pages, "
                        f"got {q_rope.dtype} and {ckv_pages.dtype}")
    _check_operands(dict(q_abs=(q_abs, (B, C, H, r)),
                         q_rope=(q_rope, (B, C, H, rr)),
                         ckv_pages=(ckv_pages, (NP, P, r)),
                         kr_pages=(kr_pages, (NP, P, rr)),
                         page_table=(page_table, (B, M)),
                         start=(start, (B,)), q_lens=(q_lens, (B,))),
                    dict(q_abs=torch.float32, q_rope=q_rope.dtype,
                         ckv_pages=ckv_pages.dtype,
                         kr_pages=ckv_pages.dtype, page_table=torch.int32,
                         start=torch.int32, q_lens=torch.int32))
    lib = mla_library()
    out = torch.empty((B, C, H, r), dtype=torch.float32, device=q_abs.device)
    splits = lib.paged_mla_attention_splits(B, C, H, P, M)
    ws = (torch.empty(splits * B * C * H * (r + 2), dtype=torch.float32,
                      device=q_abs.device) if splits > 1 else None)
    _launch("paged_mla_attention", q_abs.device, q_abs.data_ptr(),
            q_rope.data_ptr(), int(q_rope.dtype == torch.bfloat16),
            ckv_pages.data_ptr(), kr_pages.data_ptr(),
            int(ckv_pages.dtype == torch.bfloat16), page_table.data_ptr(),
            start.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, C, H, r, rr, P, M,
            0 if window is None else int(window), float(scale), splits,
            lib=lib)
    return out
