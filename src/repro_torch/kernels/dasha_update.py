"""PyTorch wrappers of the fused DASHA-PP update kernels, the sparse
wire's tracker and payload passes, and the async server's buffered
commit.

The kernels are CUDA C++ (``csrc/dasha_update.cu``), built and loaded by
:mod:`.build` at first use.  Each wrapper checks its tensors (CUDA,
float32, shapes, contiguity) and raises on anything else, allocates the
outputs with ``torch.empty_like``, forms the hyperparameter coefficients
in Python double exactly as the Pallas body does (``inv_pa = 1/pa``,
``a * inv_pa``, ``b / p_page``, ``inv_n = 1/n``), launches on the current stream, raises
if the launch failed, and counts the launch in :data:`launches`.

They take CUDA tensors only; :mod:`.ops` routes CPU tensors to the plain
versions in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

LIBRARY = "dasha_update"

launches: Dict[str, int] = {"dasha_update_batched": 0,
                            "dasha_page_update_batched": 0,
                            "dasha_tail_batched": 0,
                            "buffered_commit": 0,
                            "dasha_h_update": 0,
                            "dasha_page_h_update": 0,
                            "dasha_payload_blocks": 0,
                            "dasha_page_payload_blocks": 0,
                            "block_gather": 0,
                            "block_scatter": 0,
                            "paged_attention_batched": 0,
                            "paged_attention": 0,
                            "paged_mla_attention": 0}
"""Kernel launches since the last :func:`reset_launches`, by kernel: this
module's, :mod:`.randk`'s and :mod:`.paged_attention`'s (whose GQA
kernel counts its decode view apart)."""


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_P, _F, _I64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # pointers (inputs, mask[, coin], outputs), n, d, coefficients, stream
    "dasha_update_batched": [_P] * 8 + [_I64, _I64] + [_F] * 3 + [_P],
    "dasha_page_update_batched": [_P] * 11 + [_I64, _I64] + [_F] * 3 + [_P],
    "dasha_tail_batched": [_P] * 6 + [_I64, _I64] + [_F] * 2 + [_P],
    # g, m_buf, weights, out, K, d, inv_n, stream
    "buffered_commit": [_P] * 4 + [_I64, _I64, _F, _P],
    # inputs, mask[, coin], h_new, n, d, b (or b/p_page), inv_pa, stream
    "dasha_h_update": [_P] * 5 + [_I64, _I64] + [_F] * 2 + [_P],
    "dasha_page_h_update": [_P] * 8 + [_I64, _I64] + [_F] * 2 + [_P],
    # inputs, idx[, coin], out, n, d, kb, bs, b, inv_pa, a_inv_pa, scale,
    # stream
    "dasha_payload_blocks": [_P] * 6 + [_I64] * 4 + [_F] * 4 + [_P],
    "dasha_page_payload_blocks": [_P] * 9 + [_I64] * 4 + [_F] * 4 + [_P],
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
    lib.dasha_error_string.argtypes = [ctypes.c_int]
    lib.dasha_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.dasha_error_string
    return lib


def _check(arrays: Dict[str, Tensor], mask: Tensor,
           coin: "Tensor | None" = None) -> Tuple[int, int]:
    """(n, d) of the node-major operands; raises on what the kernels do
    not take."""
    first = next(iter(arrays.values()))
    if first.dim() != 2:
        raise ValueError(f"expected (n, d) operands, got {tuple(first.shape)}")
    n, d = first.shape
    operands = {name: (t, (n, d)) for name, t in arrays.items()}
    operands["mask"] = (mask, (n,))
    if coin is not None:
        operands["coin"] = (coin, (1,))
    _check_operands(operands)
    return n, d


def _check_operands(operands: Dict[str, Tuple[Tensor, Tuple[int, ...]]],
                    dtypes: Optional[Dict[str, torch.dtype]] = None
                    ) -> None:
    """Raise unless every tensor is a contiguous tensor of its shape and
    type (float32 unless ``dtypes`` names another) on the first one's
    CUDA device (shapes and types are checked for all operands before
    devices)."""
    first = next(iter(operands.values()))[0]
    for name, (t, shape) in operands.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        dtype = (dtypes or {}).get(name, torch.float32)
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    for name, (t, _) in operands.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: expected a tensor on {first.device} "
                             f"(CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(name: str, device: torch.device, *args,
            lib: Optional[ctypes.CDLL] = None,
            count: Optional[str] = None) -> None:
    """Launch C function ``name`` of ``lib`` (this module's library by
    default) on the current stream, raise if the launch failed, and count
    it (under ``count`` where that is given)."""
    lib = library() if lib is None else lib
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.error_string(err).decode()}")
    launches[count or name] += 1


def dasha_update_batched(gn: Tensor, go: Tensor, h: Tensor, gi: Tensor,
                         mask: Tensor, *, b: float, a: float, pa: float
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Algs. 2/5 + lines 10-11 over (n, d); ``mask`` (n,) float32.
    Returns ``(k, h_new, payload)``."""
    n, d = _check(dict(gn=gn, go=go, h=h, gi=gi), mask)
    inv_pa = 1.0 / pa
    k, h_new, payload = (torch.empty_like(gn) for _ in range(3))
    _launch("dasha_update_batched", gn.device,
            gn.data_ptr(), go.data_ptr(), h.data_ptr(), gi.data_ptr(),
            mask.data_ptr(), k.data_ptr(), h_new.data_ptr(),
            payload.data_ptr(), n, d, b, inv_pa, a * inv_pa)
    return k, h_new, payload


def dasha_page_update_batched(gn: Tensor, go: Tensor, bn: Tensor,
                              bo: Tensor, h: Tensor, gi: Tensor,
                              mask: Tensor, coin: Tensor, *, b: float,
                              a: float, pa: float, p_page: float
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Alg. 3 + lines 10-11; ``coin`` is a (1,) float32 on the device,
    read by the kernel (no host sync).  Returns ``(k, h_new, payload)``."""
    n, d = _check(dict(gn=gn, go=go, bn=bn, bo=bo, h=h, gi=gi), mask, coin)
    inv_pa = 1.0 / pa
    k, h_new, payload = (torch.empty_like(gn) for _ in range(3))
    _launch("dasha_page_update_batched", gn.device,
            gn.data_ptr(), go.data_ptr(), bn.data_ptr(), bo.data_ptr(),
            h.data_ptr(), gi.data_ptr(), mask.data_ptr(), coin.data_ptr(),
            k.data_ptr(), h_new.data_ptr(), payload.data_ptr(), n, d,
            b / p_page, inv_pa, a * inv_pa)
    return k, h_new, payload


def dasha_tail_batched(k: Tensor, h: Tensor, gi: Tensor, mask: Tensor, *,
                       a: float, pa: float) -> Tuple[Tensor, Tensor]:
    """Lines 10-11 given ``k`` (Alg. 4).  Returns ``(h_new, payload)``."""
    n, d = _check(dict(k=k, h=h, gi=gi), mask)
    inv_pa = 1.0 / pa
    h_new, payload = (torch.empty_like(k) for _ in range(2))
    _launch("dasha_tail_batched", k.device,
            k.data_ptr(), h.data_ptr(), gi.data_ptr(), mask.data_ptr(),
            h_new.data_ptr(), payload.data_ptr(), n, d, inv_pa, a * inv_pa)
    return h_new, payload


def buffered_commit(g: Tensor, m_buf: Tensor, weights: Tensor, *,
                    n_nodes: int) -> Tensor:
    """The async server step: ``g + (1/n_nodes) sum_k weights[k] m_buf[k]``
    with ``g`` (d,), ``m_buf`` (K, d) and ``weights`` (K,).  Returns a new
    (d,) tensor."""
    if g.dim() != 1 or m_buf.dim() != 2:
        raise ValueError(f"expected g (d,) and m_buf (K, d), got "
                         f"{tuple(g.shape)} and {tuple(m_buf.shape)}")
    (d,), kk = g.shape, m_buf.shape[0]
    _check_operands(dict(g=(g, (d,)), m_buf=(m_buf, (kk, d)),
                         weights=(weights, (kk,))))
    out = torch.empty_like(g)
    _launch("buffered_commit", g.device, g.data_ptr(), m_buf.data_ptr(),
            weights.data_ptr(), out.data_ptr(), kk, d, 1.0 / n_nodes)
    return out


def dasha_h_update(gn: Tensor, go: Tensor, h: Tensor, mask: Tensor, *,
                   b: float, pa: float) -> Tensor:
    """Line 10 alone over (n, d): ``h + mask k/pa`` with the Algs. 2/5
    ``k`` formed in registers and never written.  Returns ``h_new``."""
    n, d = _check(dict(gn=gn, go=go, h=h), mask)
    h_new = torch.empty_like(h)
    _launch("dasha_h_update", gn.device, gn.data_ptr(), go.data_ptr(),
            h.data_ptr(), mask.data_ptr(), h_new.data_ptr(), n, d, b,
            1.0 / pa)
    return h_new


def dasha_page_h_update(gn: Tensor, go: Tensor, bn: Tensor, bo: Tensor,
                        h: Tensor, mask: Tensor, coin: Tensor, *, b: float,
                        pa: float, p_page: float) -> Tensor:
    """Line 10 alone with the Alg. 3 ``k``; ``coin`` a (1,) float32 on
    the device.  Returns ``h_new``."""
    n, d = _check(dict(gn=gn, go=go, bn=bn, bo=bo, h=h), mask, coin)
    h_new = torch.empty_like(h)
    _launch("dasha_page_h_update", gn.device, gn.data_ptr(), go.data_ptr(),
            bn.data_ptr(), bo.data_ptr(), h.data_ptr(), mask.data_ptr(),
            coin.data_ptr(), h_new.data_ptr(), n, d, b / p_page, 1.0 / pa)
    return h_new


def _check_blocks(arrays: Dict[str, Tensor], block_idx: Tensor,
                  coin: "Tensor | None", block_size: int
                  ) -> Tuple[int, int, int]:
    """(n, d, kb) of the payload-blocks operands; raises on what the
    kernels do not take."""
    first = next(iter(arrays.values()))
    if first.dim() != 2 or block_idx.dim() != 2:
        raise ValueError(f"expected (n, d) operands and (n, kb) indices, "
                         f"got {tuple(first.shape)} and "
                         f"{tuple(block_idx.shape)}")
    if block_size < 1:
        raise ValueError(f"block_size must be positive, got {block_size}")
    n, d = first.shape
    kb = block_idx.shape[1]
    operands = {name: (t, (n, d)) for name, t in arrays.items()}
    operands["block_idx"] = (block_idx, (n, kb))
    if coin is not None:
        operands["coin"] = (coin, (1,))
    _check_operands(operands, dict(block_idx=torch.int32))
    return n, d, kb


def dasha_payload_blocks(gn: Tensor, go: Tensor, h: Tensor, gi: Tensor,
                         block_idx: Tensor, *, b: float, a: float,
                         pa: float, scale: float, block_size: int
                         ) -> Tensor:
    """The line-11 payload of Algs. 2/5 at the selected blocks only,
    times ``scale``: row ``i`` of ``out`` (n, kb, block_size) holds
    block ``block_idx[i, j]`` of node ``i``'s payload, zero past ``d``.
    ``block_idx`` is (n, kb) int32 on the device."""
    n, d, kb = _check_blocks(dict(gn=gn, go=go, h=h, gi=gi), block_idx,
                             None, block_size)
    inv_pa = 1.0 / pa
    out = torch.empty((n, kb, block_size), dtype=gn.dtype, device=gn.device)
    _launch("dasha_payload_blocks", gn.device, gn.data_ptr(), go.data_ptr(),
            h.data_ptr(), gi.data_ptr(), block_idx.data_ptr(),
            out.data_ptr(), n, d, kb, block_size, b, inv_pa, a * inv_pa,
            scale)
    return out


def dasha_page_payload_blocks(gn: Tensor, go: Tensor, bn: Tensor,
                              bo: Tensor, h: Tensor, gi: Tensor,
                              block_idx: Tensor, coin: Tensor, *, b: float,
                              a: float, pa: float, p_page: float,
                              scale: float, block_size: int) -> Tensor:
    """The Alg. 3 payload at the selected blocks, times ``scale``;
    ``coin`` a (1,) float32 on the device."""
    n, d, kb = _check_blocks(dict(gn=gn, go=go, bn=bn, bo=bo, h=h, gi=gi),
                             block_idx, coin, block_size)
    inv_pa = 1.0 / pa
    out = torch.empty((n, kb, block_size), dtype=gn.dtype, device=gn.device)
    _launch("dasha_page_payload_blocks", gn.device, gn.data_ptr(),
            go.data_ptr(), bn.data_ptr(), bo.data_ptr(), h.data_ptr(),
            gi.data_ptr(), block_idx.data_ptr(), coin.data_ptr(),
            out.data_ptr(), n, d, kb, block_size, b / p_page, inv_pa,
            a * inv_pa, scale)
    return out
