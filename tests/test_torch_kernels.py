"""The port's kernels on the CPU (the three updates, the async server's
buffered commit, the sparse wire's passes, BlockRandK's block gather
and scatter, and serving's paged attention): their plain PyTorch
versions against the JAX package's Pallas kernels run in interpret
mode, the op layer's routing, and the wrappers' refusals.

The CUDA kernels themselves build and run only on a card; there
``chip_smoke.py`` holds each to its plain version.  Here the same CUDA
source is compiled for the host with a stub CUDA header that runs every
kernel as one thread, which checks its index arithmetic (float4 chunks
that cross rows, the scalar tail, the misaligned path) against the plain
versions bit for bit.

Tolerance (kernel level): rtol = atol = 1e-6.  Both sides compute the
Pallas body's operations in float32 from the same inputs and the same
coefficients; the only freedom is XLA's fusion of the interpret-mode
body, worth an ulp on values of order one.  The buffered commit sums
``K`` rows, which XLA's ``jnp.sum`` orders as it likes and the plain
version takes in order; there rtol = 1e-5, atol = 1e-6, as the
reference's own test of its kernel against ``g + (w @ m) / n``
(tests/test_fl.py).  The paged attention is held at rtol = atol = 1e-5,
as the reference holds its own kernel to its oracle
(tests/test_chunked_prefill.py): the oracle's full softmax and the
Pallas body's online softmax sum in other orders.  Its CUDA source, in
the host build, computes the valid rows (``c < q_lens``) within the same
tolerance of the plain version and writes 0 in the others.
"""
import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_host_cuda
from _hypo import given, settings, st
from _torch_parity import numpy_inputs, to_numpy, torch_one_thread  # noqa: F401

from repro.core import variants as ref_variants
from repro.kernels import dasha_update as pallas
from repro.kernels import ops as pallas_ops
from repro.kernels import paged_attention as pallas_paged
from repro.kernels import randk as pallas_randk
from repro_torch.core import variants as port_variants
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import dasha_update as kernels
from repro_torch.kernels import paged_attention as paged_kernels
from repro_torch.kernels import randk as randk_kernels

RTOL = ATOL = 1e-6
HP = dict(b=0.3, a=0.07, pa=0.37)
MASK = np.array([1.0, 0.0, 1.0], np.float32)   # both participation values


def _close(outs, refs):
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(to_numpy(o), to_numpy(r),
                                   rtol=RTOL, atol=ATOL)


# d not a multiple of 4 or of 128: the float4 tail and the TPU padding
@pytest.mark.parametrize("d", [7, 129, 1000])
def test_update_plain_version_matches_pallas(d):
    xs = numpy_inputs(d, 4, (3, d))
    outs = ref.dasha_update_batched_ref(
        *map(torch.from_numpy, xs), torch.from_numpy(MASK), **HP)
    refs = pallas.dasha_update_batched_pallas(*xs, MASK, **HP,
                                              interpret=True)
    _close(outs, refs)


@pytest.mark.parametrize("d", [7, 129, 1000])
@pytest.mark.parametrize("coin", [0.0, 1.0])
def test_page_update_plain_version_matches_pallas(d, coin):
    xs = numpy_inputs(d + 1, 6, (3, d))
    c = np.array(coin, np.float32)
    outs = ref.dasha_page_update_batched_ref(
        *map(torch.from_numpy, xs), torch.from_numpy(MASK),
        torch.tensor(coin), **HP, p_page=0.21)
    refs = pallas.dasha_page_update_batched_pallas(
        *xs, MASK, c, **HP, p_page=0.21, interpret=True)
    _close(outs, refs)


@pytest.mark.parametrize("d", [7, 129, 1000])
def test_tail_plain_version_matches_pallas(d):
    xs = numpy_inputs(d + 2, 3, (3, d))
    outs = ref.dasha_tail_batched_ref(*map(torch.from_numpy, xs),
                                      torch.from_numpy(MASK), a=0.07,
                                      pa=0.37)
    refs = pallas.dasha_tail_batched_pallas(*xs, MASK, a=0.07, pa=0.37,
                                            interpret=True)
    _close(outs, refs)


COMMIT_TOL = dict(rtol=1e-5, atol=1e-6)


def _commit_inputs(seed, kk, d, zero_rows):
    g, = numpy_inputs(seed, 1, (d,))
    m_buf, = numpy_inputs(seed + 1, 1, (kk, d))
    w = np.random.default_rng(seed).uniform(0.2, 1.0, kk).astype(np.float32)
    w[kk - zero_rows:] = 0.0            # the reference's padding rows
    return g, m_buf, w


@pytest.mark.parametrize("kk", [1, 5, 17])
@pytest.mark.parametrize("d", [1, 7, 129, 2051])
def test_buffered_commit_plain_version_matches_pallas(d, kk):
    """Against ``repro.kernels.ops.buffered_commit_op`` (the Pallas kernel
    in interpret mode) and against the reference's jnp formula."""
    g, m_buf, w = _commit_inputs(d + kk, kk, d, zero_rows=kk // 3)
    got = to_numpy(ref.buffered_commit_ref(
        torch.from_numpy(g), torch.from_numpy(m_buf), torch.from_numpy(w),
        n_nodes=6))
    np.testing.assert_allclose(
        got, to_numpy(pallas_ops.buffered_commit_op(g, m_buf, w, n_nodes=6)),
        **COMMIT_TOL)
    np.testing.assert_allclose(got, g + (w @ m_buf) / 6.0, **COMMIT_TOL)


def test_buffered_commit_zero_weight_rows_add_exact_zeros():
    """A weight-0 row leaves the sum as it was, to the bit: the port's
    server commits only the rows it takes where the reference pads a
    capacity-n buffer with weight-0 rows."""
    g, m_buf, w = map(torch.from_numpy, _commit_inputs(3, 9, 300, 4))
    full = ref.buffered_commit_ref(g, m_buf, w, n_nodes=9)
    taken = ref.buffered_commit_ref(g, m_buf[:5], w[:5], n_nodes=9)
    assert torch.equal(full, taken)
    assert torch.equal(ref.buffered_commit_ref(g, m_buf[:0], w[:0],
                                               n_nodes=9), g)


def test_buffered_commit_op_routes_cpu_tensors_to_the_plain_version():
    g, m_buf, w = map(torch.from_numpy, _commit_inputs(4, 5, 40, 1))
    kernels.reset_launches()
    assert torch.equal(ops.buffered_commit_op(g, m_buf, w, n_nodes=5),
                       ref.buffered_commit_ref(g, m_buf, w, n_nodes=5))
    assert kernels.launches["buffered_commit"] == 0


def test_buffered_commit_wrapper_takes_cuda_tensors_only():
    g, m_buf, w = torch.zeros(8), torch.zeros(3, 8), torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.buffered_commit(g, m_buf, w, n_nodes=4)
    with pytest.raises(ValueError, match=r"\(K, d\)"):
        kernels.buffered_commit(g, torch.zeros(24), w, n_nodes=4)
    with pytest.raises(ValueError, match="shape"):
        kernels.buffered_commit(g, m_buf, torch.ones(2), n_nodes=4)
    with pytest.raises(TypeError, match="float32"):
        kernels.buffered_commit(g, m_buf, w.double(), n_nodes=4)


def test_plain_versions_freeze_non_participants_bitwise():
    """``h + 0 * x == h`` exactly: a node outside the round keeps its
    tracker to the bit."""
    gn, go, bn, bo, h, gi = map(torch.from_numpy,
                                numpy_inputs(3, 6, (3, 33)))
    mask = torch.tensor([0.0, 1.0, 0.0])
    frozen = mask == 0
    _, h_new, _ = ref.dasha_update_batched_ref(gn, go, h, gi, mask, **HP)
    assert torch.equal(h_new[frozen], h[frozen])
    for coin in (torch.tensor(0.0), torch.tensor(1.0)):
        _, h_new, _ = ref.dasha_page_update_batched_ref(
            gn, go, bn, bo, h, gi, mask, coin, **HP, p_page=0.5)
        assert torch.equal(h_new[frozen], h[frozen])
    h_new, _ = ref.dasha_tail_batched_ref(gn, h, gi, mask, a=0.07, pa=0.37)
    assert torch.equal(h_new[frozen], h[frozen])
    assert not torch.equal(h_new[~frozen], h[~frozen])


def test_ops_route_cpu_tensors_to_the_plain_versions():
    gn, go, bn, bo, h, gi = map(torch.from_numpy,
                                numpy_inputs(4, 6, (3, 10)))
    mask = torch.tensor([True, False, True])
    coin = torch.tensor(True)
    kernels.reset_launches()
    pairs = [
        (ops.dasha_update_batched_op(gn, go, h, gi, mask, **HP),
         ref.dasha_update_batched_ref(gn, go, h, gi, mask, **HP)),
        (ops.dasha_page_update_op(gn, go, bn, bo, h, gi, mask, coin, **HP,
                                  p_page=0.3),
         ref.dasha_page_update_batched_ref(gn, go, bn, bo, h, gi, mask,
                                           coin, **HP, p_page=0.3)),
        (ops.dasha_tail_op(gn, h, gi, mask, a=0.07, pa=0.37),
         ref.dasha_tail_batched_ref(gn, h, gi, mask, a=0.07, pa=0.37)),
    ]
    for outs, refs in pairs:
        assert all(torch.equal(o, r) for o, r in zip(outs, refs))
    assert sum(kernels.launches.values()) == 0


def test_ops_refuse_devices_without_a_kernel_or_plain_version():
    x = torch.empty(2, 3, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.dasha_tail_op(x, x, x, torch.empty(2, device="meta"),
                          a=0.1, pa=0.5)


def test_wrappers_take_cuda_tensors_only():
    """The kernel wrappers check before they build or launch anything:
    a CPU tensor is refused, never handed to the plain version."""
    x = torch.zeros(2, 3)
    mask = torch.ones(2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dasha_update_batched(x, x, x, x, mask, **HP)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dasha_page_update_batched(x, x, x, x, x, x, mask,
                                          torch.ones(1), **HP, p_page=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dasha_tail_batched(x, x, x, mask, a=0.1, pa=0.5)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        kernels.dasha_tail_batched(torch.zeros(6), x, x, mask, a=0.1,
                                   pa=0.5)


def test_build_targets_hopper_and_rounds_each_operation():
    cmd = build.nvcc_command("nvcc", build.CSRC / "dasha_update.cu",
                             build.BUILD_DIR / "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--fmad=false" in cmd
    assert (build.CSRC / "dasha_update.cu").is_file()


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_kernel_sources_name_the_tpu_kernels_they_replace():
    src = (build.CSRC / "dasha_update.cu").read_text()
    for fn in ("dasha_update_batched_pallas",
               "dasha_page_update_batched_pallas",
               "dasha_tail_batched_pallas", "buffered_commit_pallas"):
        assert fn in src and hasattr(pallas, fn)


# One host thread plays the whole grid: blockIdx = threadIdx = 0 and
# gridDim = blockDim = 1, so each kernel's grid-stride loop covers every
# element in order.
_HOST_CUDA_STUB = r"""
#pragma once
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct dim3 { unsigned x; };
static const dim3 blockIdx = {0}, threadIdx = {0}, blockDim = {1},
                  gridDim = {1};
typedef void* cudaStream_t;
typedef int cudaError_t;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "ok"; }
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the CUDA source for the host")
    out = tmp_path_factory.mktemp("host_cuda")
    (out / "cuda_runtime.h").write_text(_HOST_CUDA_STUB)
    src = (build.CSRC / "dasha_update.cu").read_text()
    (out / "host.cpp").write_text(re.sub(r"<<<[^>]*>>>", "", src))
    lib = out / "libhost.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(out), "-o", str(lib),
                    str(out / "host.cpp")], check=True, capture_output=True,
                   timeout=300)
    host = ctypes.CDLL(str(lib))
    for name, argtypes in kernels._SIGNATURES.items():
        getattr(host, name).argtypes = argtypes
        getattr(host, name).restype = ctypes.c_int
    return host


def _operands(n, d, count, offset, seed):
    """``count`` (n, d) float32 views whose data starts ``offset``
    elements into their buffer (offset 1: not 16-byte aligned)."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(n * d + offset, generator=gen)[offset:].view(n, d)
            for _ in range(count)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n, d", [(1, 1), (3, 1), (3, 3), (2, 7), (3, 129),
                                  (5, 1000), (2, 20958)])
def test_cuda_source_on_the_host_matches_plain_versions(host_build, n, d,
                                                        offset):
    b, a, pa, p_page = 0.3, 0.07, 0.37, 0.21
    inv_pa = 1.0 / pa
    gn, go, bn, bo, h, gi = _operands(n, d, 6, offset, n * d)
    mask = torch.tensor([float(i % 2 == 0) for i in range(n)])
    outs = _operands(n, d, 3, offset, 0)
    ptr = [t.data_ptr() for t in outs]

    def same(count, refs):
        assert all(torch.equal(o, r) for o, r in zip(outs[:count], refs))

    host_build.dasha_update_batched(
        gn.data_ptr(), go.data_ptr(), h.data_ptr(), gi.data_ptr(),
        mask.data_ptr(), *ptr, n, d, b, inv_pa, a * inv_pa, None)
    same(3, ref.dasha_update_batched_ref(gn, go, h, gi, mask, b=b, a=a,
                                         pa=pa))
    for coin in (torch.zeros(1), torch.ones(1)):
        host_build.dasha_page_update_batched(
            gn.data_ptr(), go.data_ptr(), bn.data_ptr(), bo.data_ptr(),
            h.data_ptr(), gi.data_ptr(), mask.data_ptr(), coin.data_ptr(),
            *ptr, n, d, b / p_page, inv_pa, a * inv_pa, None)
        same(3, ref.dasha_page_update_batched_ref(
            gn, go, bn, bo, h, gi, mask, coin[0], b=b, a=a, pa=pa,
            p_page=p_page))
    host_build.dasha_tail_batched(
        gn.data_ptr(), h.data_ptr(), gi.data_ptr(), mask.data_ptr(),
        *ptr[:2], n, d, inv_pa, a * inv_pa, None)
    same(2, ref.dasha_tail_batched_ref(gn, h, gi, mask, a=a, pa=pa))


@pytest.mark.parametrize("kk", [0, 1, 5, 17, 100])
@pytest.mark.parametrize("d", [1, 7, 129, 20958])
def test_buffered_commit_source_on_the_host_matches_plain_version(
        host_build, d, kk):
    """The column loop and the row stride, against the plain version bit
    for bit, zero-weight rows included."""
    g, m_buf, w = map(torch.from_numpy,
                      _commit_inputs(d + kk, kk, d, zero_rows=kk // 5))
    out = torch.full((d,), float("nan"))
    assert host_build.buffered_commit(
        g.data_ptr(), m_buf.data_ptr(), w.data_ptr(), out.data_ptr(), kk, d,
        1.0 / 7, None) == 0
    assert torch.equal(out, ref.buffered_commit_ref(g, m_buf, w, n_nodes=7))


# ----------------------------------------------------------------------
# The sparse wire's split (the sharded engine's BlockRandK path): the
# tracker pass and the payload at the selected blocks.  The Pallas
# kernels are flat, one node's (D,) leaf per call; the port's take the
# node-major (n, D) rows, so each node's row is held to its own call.
# Tolerance: rtol = 1e-6 and atol = 1e-6 x the payload's scale, as for
# the dense updates above.  Both sides take the Pallas body's operations
# in float32 from the same coefficients, but XLA on the CPU may contract
# a multiply and an add of the interpret-mode body into one rounding: an
# ulp of the terms, which the payload's difference can cancel down to.
# ----------------------------------------------------------------------


def _ulp(got, want, scale=1.0):
    np.testing.assert_allclose(to_numpy(got), np.array(want), rtol=RTOL,
                               atol=ATOL * scale)

SPARSE_HP = dict(b=0.3, a=0.07, pa=0.37)
P_PAGE = 0.21


def _sparse_inputs(seed, n, d, kb, nb):
    xs = numpy_inputs(seed, 6, (n, d))
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(nb)[:kb] for _ in range(n)])
    return xs, idx.astype(np.int32)


def _plan(d, block_size):
    bs = min(block_size, d)
    return bs, -(-d // bs)


@pytest.mark.parametrize("d", [1, 7, 129, 2051])
@pytest.mark.parametrize("part", [0.0, 1.0])
def test_h_update_plain_versions_match_pallas(d, part):
    xs, _ = _sparse_inputs(d, 2, d, 1, 1)
    gn, go, bn, bo, h, _ = xs
    mask = np.full(2, part, np.float32)
    got = ref.dasha_h_update_ref(*map(torch.from_numpy, (gn, go, h)),
                                 torch.from_numpy(mask), b=0.3, pa=0.37)
    for coin in (0.0, 1.0):
        got_page = ref.dasha_page_h_update_ref(
            *map(torch.from_numpy, (gn, go, bn, bo, h)),
            torch.from_numpy(mask), torch.tensor(coin), b=0.3, pa=0.37,
            p_page=P_PAGE)
        for i in range(2):
            want = pallas.dasha_h_update_pallas(
                gn[i], go[i], h[i], np.float32(part), b=0.3, pa=0.37,
                interpret=True)
            _ulp(got[i], want)
            want = pallas.dasha_page_h_update_pallas(
                gn[i], go[i], bn[i], bo[i], h[i], np.float32(part),
                np.float32(coin), b=0.3, pa=0.37, p_page=P_PAGE,
                interpret=True)
            _ulp(got_page[i], want)


@pytest.mark.parametrize("d", [1, 7, 129, 2051])
@pytest.mark.parametrize("block_size", [128, 50])
@pytest.mark.parametrize("kb", [1, 5])
def test_payload_blocks_plain_versions_match_pallas(d, block_size, kb):
    """``bs = min(block_size, d)``; block size 50 does not divide 129 or
    2051, so the last block runs past the row (zero there)."""
    bs, nb = _plan(d, block_size)
    kb = min(kb, nb)
    xs, idx = _sparse_inputs(d + kb, 2, d, kb, nb)
    gn, go, bn, bo, h, gi = xs
    scale = nb / kb
    kw = dict(SPARSE_HP, scale=scale, block_size=bs)
    got = ref.dasha_payload_blocks_ref(
        *map(torch.from_numpy, (gn, go, h, gi)), torch.from_numpy(idx), **kw)
    for coin in (0.0, 1.0):
        got_page = ref.dasha_page_payload_blocks_ref(
            *map(torch.from_numpy, xs), torch.from_numpy(idx),
            torch.tensor(coin), **kw, p_page=P_PAGE)
        for i in range(2):
            want = pallas.dasha_payload_blocks_pallas(
                gn[i], go[i], h[i], gi[i], idx[i], **kw, interpret=True)
            _ulp(got[i], want, scale)
            want = pallas.dasha_page_payload_blocks_pallas(
                *(x[i] for x in xs), idx[i], np.float32(coin), **kw,
                p_page=P_PAGE, interpret=True)
            _ulp(got_page[i], want, scale)


def test_sparse_ops_route_cpu_tensors_to_the_plain_versions():
    xs, idx = _sparse_inputs(5, 3, 300, 2, 3)
    gn, go, bn, bo, h, gi = map(torch.from_numpy, xs)
    idx = torch.from_numpy(idx)
    mask = torch.tensor([True, False, True])
    coin = torch.tensor(True)
    kw = dict(SPARSE_HP, scale=1.5, block_size=128)
    kernels.reset_launches()
    assert torch.equal(ops.dasha_h_update_op(gn, go, h, mask, b=0.3, pa=0.37),
                       ref.dasha_h_update_ref(gn, go, h, mask, b=0.3,
                                              pa=0.37))
    assert torch.equal(
        ops.dasha_page_h_update_op(gn, go, bn, bo, h, mask, coin, b=0.3,
                                   pa=0.37, p_page=P_PAGE),
        ref.dasha_page_h_update_ref(gn, go, bn, bo, h, mask, coin, b=0.3,
                                    pa=0.37, p_page=P_PAGE))
    assert torch.equal(
        ops.dasha_payload_blocks_op(gn, go, h, gi, idx, **kw),
        ref.dasha_payload_blocks_ref(gn, go, h, gi, idx, **kw))
    assert torch.equal(
        ops.dasha_page_payload_blocks_op(gn, go, bn, bo, h, gi, idx, coin,
                                         **kw, p_page=P_PAGE),
        ref.dasha_page_payload_blocks_ref(gn, go, bn, bo, h, gi, idx, coin,
                                          **kw, p_page=P_PAGE))
    assert sum(kernels.launches.values()) == 0


def test_sparse_wrappers_take_cuda_tensors_only():
    x = torch.zeros(2, 300)
    mask = torch.ones(2)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    kw = dict(SPARSE_HP, scale=1.0, block_size=128)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dasha_h_update(x, x, x, mask, b=0.3, pa=0.37)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dasha_page_h_update(x, x, x, x, x, mask, torch.ones(1),
                                    b=0.3, pa=0.37, p_page=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dasha_payload_blocks(x, x, x, x, idx, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dasha_page_payload_blocks(x, x, x, x, x, x, idx,
                                          torch.ones(1), **kw, p_page=0.5)
    with pytest.raises(TypeError, match="int32"):
        kernels.dasha_payload_blocks(x, x, x, x, idx.long(), **kw)
    with pytest.raises(ValueError, match=r"\(n, kb\)"):
        kernels.dasha_payload_blocks(x, x, x, x, idx[0], **kw)
    with pytest.raises(ValueError, match="shape"):
        kernels.dasha_payload_blocks(x, x, x, x, idx[:1], **kw)


def test_sparse_kernel_sources_name_the_tpu_kernels_they_replace():
    src = (build.CSRC / "dasha_update.cu").read_text()
    for fn in ("dasha_h_update_pallas", "dasha_page_h_update_pallas",
               "dasha_payload_blocks_pallas",
               "dasha_page_payload_blocks_pallas", "dasha_update_pallas"):
        assert fn in src and hasattr(pallas, fn)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n, d, block_size, kb", [
    (1, 1, 128, 1), (3, 7, 128, 1), (2, 129, 128, 2), (3, 129, 50, 3),
    (2, 2051, 128, 5), (4, 20958, 128, 3)])
def test_sparse_cuda_source_on_the_host_matches_plain_versions(
        host_build, n, d, block_size, kb, offset):
    """The h passes' float4 chunks and tails, and the payload gathers'
    block arithmetic and zero tail, bit for bit."""
    b, a, pa = 0.3, 0.07, 0.37
    inv_pa = 1.0 / pa
    bs, nb = _plan(d, block_size)
    gn, go, bn, bo, h, gi = _operands(n, d, 6, offset, n * d + kb)
    mask = torch.tensor([float(i % 2 == 0) for i in range(n)])
    gen = torch.Generator().manual_seed(d)
    idx = torch.stack([torch.randperm(nb, generator=gen)[:kb]
                       for _ in range(n)]).to(torch.int32)
    scale = nb / kb
    h_new, = _operands(n, d, 1, offset, 0)
    out = torch.full((n, kb, bs), float("nan"))
    assert host_build.dasha_h_update(
        gn.data_ptr(), go.data_ptr(), h.data_ptr(), mask.data_ptr(),
        h_new.data_ptr(), n, d, b, inv_pa, None) == 0
    assert torch.equal(h_new, ref.dasha_h_update_ref(gn, go, h, mask, b=b,
                                                     pa=pa))
    assert host_build.dasha_payload_blocks(
        gn.data_ptr(), go.data_ptr(), h.data_ptr(), gi.data_ptr(),
        idx.data_ptr(), out.data_ptr(), n, d, kb, bs, b, inv_pa,
        a * inv_pa, scale, None) == 0
    assert torch.equal(out, ref.dasha_payload_blocks_ref(
        gn, go, h, gi, idx, b=b, a=a, pa=pa, scale=scale, block_size=bs))
    for coin in (torch.zeros(1), torch.ones(1)):
        assert host_build.dasha_page_h_update(
            gn.data_ptr(), go.data_ptr(), bn.data_ptr(), bo.data_ptr(),
            h.data_ptr(), mask.data_ptr(), coin.data_ptr(), h_new.data_ptr(),
            n, d, b / P_PAGE, inv_pa, None) == 0
        assert torch.equal(h_new, ref.dasha_page_h_update_ref(
            gn, go, bn, bo, h, mask, coin[0], b=b, pa=pa, p_page=P_PAGE))
        assert host_build.dasha_page_payload_blocks(
            gn.data_ptr(), go.data_ptr(), bn.data_ptr(), bo.data_ptr(),
            h.data_ptr(), gi.data_ptr(), idx.data_ptr(), coin.data_ptr(),
            out.data_ptr(), n, d, kb, bs, b / P_PAGE, inv_pa, a * inv_pa,
            scale, None) == 0
        assert torch.equal(out, ref.dasha_page_payload_blocks_ref(
            gn, go, bn, bo, h, gi, idx, coin[0], b=b, a=a, pa=pa,
            p_page=P_PAGE, scale=scale, block_size=bs))


# ----------------------------------------------------------------------
# BlockRandK's block gather and block scatter (``kernels/randk.py``):
# the finite-MVR sparse wire's gather of the payload's selected blocks,
# and the scatter of every compressed wire's blocks into each node's
# zero row.  The Pallas kernels are flat, one node's (nb, bs) blocks
# per call; the port's gather takes node-major (n, d) rows and (n, kb)
# indices, so each node's row is held to its own call.  Tolerance:
# exact.  The gather is one float32 multiply per element on both sides,
# the scatter one float32 add, from the same operands.
# ----------------------------------------------------------------------

def _gather_case(seed, n, d, block_size, kb):
    bs, nb = _plan(d, block_size)
    kb = min(kb, nb)
    x, = numpy_inputs(seed, 1, (n, d))
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(nb)[:kb] for _ in range(n)])
    return x, idx.astype(np.int64), bs, nb, kb


def _assert_gather_matches_pallas(x, idx, bs, nb, kb, scale):
    got = ref.block_gather_ref(torch.from_numpy(x), torch.from_numpy(idx),
                               scale=scale, block_size=bs)
    assert got.shape == (x.shape[0], kb, bs)
    for i in range(x.shape[0]):
        blocks = np.pad(x[i], (0, nb * bs - x.shape[1])).reshape(nb, bs)
        want = pallas_randk.block_gather_pallas(
            blocks, idx[i].astype(np.int32), k_blocks=kb, scale=scale,
            interpret=True)
        np.testing.assert_array_equal(to_numpy(got[i]), np.array(want))


# 192 = 128 + 64: the smoke model's layer norms, a tail block half full
@pytest.mark.parametrize("d", [1, 7, 129, 192, 2051])
@pytest.mark.parametrize("block_size", [128, 50])
@pytest.mark.parametrize("kb", [1, 5])
def test_block_gather_plain_version_matches_pallas(d, block_size, kb):
    x, idx, bs, nb, kb = _gather_case(d + kb, 3, d, block_size, kb)
    _assert_gather_matches_pallas(x, idx, bs, nb, kb, nb / kb)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 4), d=st.integers(1, 3000),
       block_size=st.sampled_from([4, 50, 64, 128]), kb=st.integers(1, 9),
       scale=st.floats(0.5, 100.0))
def test_block_gather_plain_version_matches_pallas_drawn_shapes(
        n, d, block_size, kb, scale):
    x, idx, bs, nb, kb = _gather_case(n * d + kb, n, d, block_size, kb)
    _assert_gather_matches_pallas(x, idx, bs, nb, kb, scale)


def _assert_scatter_matches_pallas(seed, r, bs, k):
    base, = numpy_inputs(seed, 1, (r, bs))
    vals, = numpy_inputs(seed + 1, 1, (k, bs))
    rows = np.random.default_rng(seed).permutation(r)[:k]
    got = ref.block_scatter_ref(torch.from_numpy(base.copy()),
                                torch.from_numpy(vals),
                                torch.from_numpy(rows.astype(np.int64)))
    want = pallas_randk.block_scatter_pallas(base, vals,
                                             rows.astype(np.int32),
                                             interpret=True)
    np.testing.assert_array_equal(to_numpy(got), np.array(want))


@pytest.mark.parametrize("r, bs, k", [(1, 1, 1), (5, 7, 2), (9, 128, 9),
                                      (40, 64, 13)])
def test_block_scatter_plain_version_matches_pallas(r, bs, k):
    _assert_scatter_matches_pallas(r * bs + k, r, bs, k)


@settings(max_examples=25, deadline=None)
@given(r=st.integers(1, 60), bs=st.sampled_from([1, 4, 50, 128]),
       k=st.integers(1, 60))
def test_block_scatter_plain_version_matches_pallas_drawn_shapes(r, bs, k):
    _assert_scatter_matches_pallas(r + 7 * bs + k, r, bs, min(k, r))


@pytest.mark.parametrize("d, block_size", [(7, 128), (192, 128), (300, 64),
                                           (2051, 50)])
def test_block_scatter_rows_equals_per_node_block_scatter_add(d, block_size):
    """The rows the scatter kernel fills (``block_idx + nb * node`` of
    one zero buffer) are each node's ``block_scatter_add`` into zeros,
    bit for bit, in the port and in the reference."""
    n, kb = 3, 2
    bs, nb = _plan(d, block_size)
    kb = min(kb, nb)
    vals, = numpy_inputs(d, 1, (n, kb, bs))
    rng = np.random.default_rng(d)
    idx = np.stack([rng.permutation(nb)[:kb] for _ in range(n)])
    got = port_variants.block_scatter_rows(torch.from_numpy(vals),
                                           torch.from_numpy(idx), d, bs)
    for i in range(n):
        want = port_variants.block_scatter_add(
            torch.zeros(d), torch.from_numpy(vals[i]),
            torch.from_numpy(idx[i]), bs)
        assert torch.equal(got[i], want)
        np.testing.assert_array_equal(
            to_numpy(got[i]), np.array(ref_variants.block_scatter_add(
                jnp.zeros(d, jnp.float32), jnp.asarray(vals[i]),
                jnp.asarray(idx[i]), bs)))


def test_randk_ops_route_cpu_tensors_to_the_plain_versions():
    x, idx, bs, _, kb = _gather_case(3, 2, 300, 128, 2)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    base = torch.zeros(6, 128)
    vals = torch.ones(2, 128)
    rows = torch.tensor([4, 1])
    kernels.reset_launches()
    assert torch.equal(ops.block_gather_op(xt, it, scale=1.5, block_size=bs),
                       ref.block_gather_ref(xt, it, scale=1.5,
                                            block_size=bs))
    out = ops.block_scatter_op(base, vals, rows)
    assert out is base                                 # in place
    assert torch.equal(out, ref.block_scatter_ref(torch.zeros(6, 128), vals,
                                                  rows))
    assert kernels.launches["block_gather"] == 0
    assert kernels.launches["block_scatter"] == 0


def test_randk_wrappers_take_cuda_tensors_only():
    x = torch.zeros(2, 300)
    idx = torch.zeros(2, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        randk_kernels.block_gather(x, idx, scale=1.0, block_size=128)
    with pytest.raises(TypeError, match="int64"):
        randk_kernels.block_gather(x, idx.int(), scale=1.0, block_size=128)
    with pytest.raises(ValueError, match=r"\(n, kb\)"):
        randk_kernels.block_gather(x, idx[0], scale=1.0, block_size=128)
    with pytest.raises(ValueError, match="positive"):
        randk_kernels.block_gather(x, idx, scale=1.0, block_size=0)
    base, vals = torch.zeros(6, 128), torch.zeros(2, 128)
    rows = torch.tensor([4, 1])
    with pytest.raises(ValueError, match="CUDA"):
        randk_kernels.block_scatter(base, vals, rows)
    with pytest.raises(TypeError, match="int64"):
        randk_kernels.block_scatter(base, vals, rows.int())
    with pytest.raises(ValueError, match="shape"):
        randk_kernels.block_scatter(base, torch.zeros(2, 64), rows)
    with pytest.raises(ValueError, match=r"\(K, bs\)"):
        randk_kernels.block_scatter(base, torch.zeros(256), rows)


def test_randk_source_names_the_tpu_kernels_it_replaces():
    src = (build.CSRC / "randk.cu").read_text()
    for fn in ("block_gather_pallas", "block_scatter_pallas"):
        assert fn in src and hasattr(pallas_randk, fn)
    cmd = build.nvcc_command("nvcc", build.CSRC / "randk.cu",
                             build.BUILD_DIR / "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd


@pytest.fixture(scope="module")
def randk_host_build(tmp_path_factory):
    """``csrc/randk.cu`` compiled for the host with the stub CUDA header
    (one thread plays the grid, as for ``dasha_update.cu``)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the CUDA source for the host")
    out = tmp_path_factory.mktemp("host_randk")
    (out / "cuda_runtime.h").write_text(_HOST_CUDA_STUB)
    src = (build.CSRC / "randk.cu").read_text()
    (out / "host.cpp").write_text(re.sub(r"<<<[^>]*>>>", "", src))
    lib = out / "libhost.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(out), "-o", str(lib),
                    str(out / "host.cpp")], check=True, capture_output=True,
                   timeout=300)
    host = ctypes.CDLL(str(lib))
    for name, argtypes in randk_kernels._SIGNATURES.items():
        getattr(host, name).argtypes = argtypes
        getattr(host, name).restype = ctypes.c_int
    return host


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n, d, block_size, kb", [
    (1, 1, 128, 1), (3, 7, 128, 1), (2, 129, 128, 2), (3, 192, 128, 2),
    (3, 129, 50, 3), (2, 2048, 128, 5), (4, 20958, 128, 3)])
def test_randk_source_on_the_host_matches_plain_versions(
        randk_host_build, n, d, block_size, kb, offset):
    """The gather's block arithmetic, float4 path (offset 0, ``bs`` and
    ``d`` multiples of 4) and scalar path, and zero tail; the scatter's
    row offsets: bit for bit against the plain versions."""
    bs, nb = _plan(d, block_size)
    x, = _operands(n, d, 1, offset, n * d + kb)
    gen = torch.Generator().manual_seed(d)
    idx = torch.stack([torch.randperm(nb, generator=gen)[:kb]
                       for _ in range(n)])
    out, = _operands(n * kb, bs, 1, offset, 0)
    out.fill_(float("nan"))
    scale = nb / kb
    assert randk_host_build.block_gather(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), n, d, kb, bs, scale,
        None) == 0
    want = ref.block_gather_ref(x, idx, scale=scale, block_size=bs)
    assert torch.equal(out.view(n, kb, bs), want)
    rows = (idx + nb * torch.arange(n)[:, None]).reshape(-1)
    base, = _operands(n * nb, bs, 1, offset, 1)
    expect = ref.block_scatter_ref(base.clone(), want.reshape(-1, bs), rows)
    vals = _operands(n * kb, bs, 1, offset, 2)[0]
    vals.copy_(want.reshape(-1, bs))
    assert randk_host_build.block_scatter(
        base.data_ptr(), vals.data_ptr(), rows.data_ptr(), n * nb, n * kb,
        bs, None) == 0
    assert torch.equal(base, expect)



# ----------------------------------------------------------------------
# The paged GQA attention (serving)
# ----------------------------------------------------------------------

PAGED_TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_case(seed, *, B=2, C=3, H=4, kvh=2, hd=8, P=4, NP=16, M=4,
                bf16=False, q_lens_lo=1):
    """Inputs from a numpy seed at the reference test's shapes
    (tests/test_chunked_prefill.py): random distinct pages, ``start``
    and ``q_lens``; pages rounded to bfloat16 with ``bf16``.  Returns
    the JAX arrays and the port's tensors."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, hd), np.float32)
    k = rng.standard_normal((NP, P, kvh, hd), np.float32)
    v = rng.standard_normal((NP, P, kvh, hd), np.float32)
    table = rng.permutation(NP)[:B * M].reshape(B, M).astype(np.int32)
    start = rng.integers(0, M * P - C + 1, B).astype(np.int32)
    q_lens = rng.integers(q_lens_lo, C + 1, B).astype(np.int32)
    jx = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
          jnp.asarray(start), jnp.asarray(q_lens)]
    tx = [torch.from_numpy(a) for a in (q, k, v, table, start, q_lens)]
    if bf16:
        jx[1], jx[2] = jx[1].astype(jnp.bfloat16), jx[2].astype(jnp.bfloat16)
        tx[1], tx[2] = tx[1].to(torch.bfloat16), tx[2].to(torch.bfloat16)
    return jx, tx


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 1000), windowed=st.booleans(),
       bf16=st.booleans())
def test_paged_attention_plain_version_matches_oracle_and_pallas(
        seed, windowed, bf16):
    """#12: the plain version against the reference's oracle and its
    Pallas kernel in interpret mode, the whole array (rows past
    ``q_lens`` attend like the others in all three)."""
    window = 5 if windowed else None
    jx, tx = _paged_case(seed, bf16=bf16)
    got = ref.paged_attention_batched_ref(*tx, window=window)
    oracle = pallas_paged.paged_attention_batched_ref(*jx, window=window)
    pallas_out = pallas_paged.paged_attention_batched_pallas(
        *jx, window=window, interpret=True)
    assert got.dtype == torch.float32 and got.shape == tx[0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **PAGED_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas_out),
                               **PAGED_TOL)


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("page_size", [4, 8])
def test_paged_attention_decode_view_matches_oracle_and_pallas(page_size,
                                                               windowed):
    """#13, the C = 1 view with ``lens`` counting the token just
    written, at the reference test's shapes (tests/test_paged_engine.py)."""
    window = 5 if windowed else None
    B, H, kvh, hd, NP, M = 3, 4, 2, 8, 12, 3
    rng = np.random.default_rng(page_size + 7 * windowed)
    q = rng.standard_normal((B, H, hd), np.float32)
    k = rng.standard_normal((NP, page_size, kvh, hd), np.float32)
    v = rng.standard_normal((NP, page_size, kvh, hd), np.float32)
    table = rng.permutation(NP)[:B * M].reshape(B, M).astype(np.int32)
    lens = rng.integers(1, M * page_size + 1, B).astype(np.int32)
    args = (q, k, v, table, lens)
    got = ref.paged_attention_ref(*map(torch.from_numpy, args),
                                  window=window)
    oracle = pallas_paged.paged_attention_ref(*map(jnp.asarray, args),
                                              window=window)
    pallas_out = pallas_paged.paged_attention_pallas(
        *map(jnp.asarray, args), window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **PAGED_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas_out),
                               **PAGED_TOL)


def test_paged_attention_ops_route_by_device(monkeypatch):
    """A CPU tensor reaches the plain version; a CUDA tensor reaches the
    kernel's wrapper (a spy stands in for it here), int32 indices."""
    _, (q, k, v, table, start, q_lens) = _paged_case(3)
    assert torch.equal(
        ops.paged_attention_batched_op(q, k, v, table, start, q_lens),
        ref.paged_attention_batched_ref(q, k, v, table, start, q_lens))
    lens = start + 1
    assert torch.equal(ops.paged_attention_op(q[:, 0], k, v, table, lens),
                       ref.paged_attention_ref(q[:, 0], k, v, table, lens))
    assert kernels.launches["paged_attention_batched"] == 0
    assert kernels.launches["paged_attention"] == 0
    calls = []

    def spy(name):
        def record(*args, **kwargs):
            calls.append((name, [a.dtype for a in args[3:]], kwargs))
            return "launched"
        return record

    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(paged_kernels, "paged_attention_batched",
                        spy("batched"))
    monkeypatch.setattr(paged_kernels, "paged_attention", spy("decode"))
    assert ops.paged_attention_batched_op(
        q, k, v, table.long(), start.long(), q_lens, window=5) == "launched"
    assert ops.paged_attention_op(q[:, 0], k, v, table, lens) == "launched"
    assert calls == [("batched", [torch.int32] * 3, {"window": 5}),
                     ("decode", [torch.int32] * 2, {"window": None})]


def test_paged_attention_wrappers_take_cuda_tensors_only():
    _, (q, k, v, table, start, q_lens) = _paged_case(4)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernels.paged_attention_batched(q, k, v, table, start, q_lens)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernels.paged_attention(q[:, 0], k, v, table, start + 1)
    with pytest.raises(TypeError, match="int32"):
        paged_kernels.paged_attention_batched(q, k, v, table.long(), start,
                                              q_lens)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_kernels.paged_attention_batched(q.double(), k, v, table,
                                              start, q_lens)
    with pytest.raises(ValueError, match="hd <= 64"):
        big = torch.zeros(2, 1, 4, 128)
        pages = torch.zeros(4, 4, 2, 128)
        paged_kernels.paged_attention_batched(big, pages, pages, table,
                                              start, q_lens)
    with pytest.raises(ValueError, match="shape"):
        paged_kernels.paged_attention_batched(q, k, v[:, :2], table, start,
                                              q_lens)


def test_paged_attention_source_names_the_tpu_kernels_it_replaces():
    src = (build.CSRC / "paged_attention.cu").read_text()
    for fn in ("paged_attention_batched_pallas", "paged_attention_pallas"):
        assert fn in src and hasattr(pallas_paged, fn)
    cmd = build.nvcc_command("nvcc", build.CSRC / "paged_attention.cu",
                             build.BUILD_DIR / "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd


@pytest.fixture(scope="module")
def paged_host_build(tmp_path_factory):
    """``csrc/paged_attention.cu`` compiled for the host: one thread plays
    the grid and the tensor-core fragments are plain loops in which one
    lane owns the whole fragment (``tests/_torch_host_cuda.py``); the
    real fragment layout is checked only on the card."""
    host = _torch_host_cuda.host_library(
        tmp_path_factory.mktemp("host_paged"), "paged_attention")
    host.paged_attention.argtypes = paged_kernels._SIGNATURE
    host.paged_attention.restype = ctypes.c_int
    host.paged_attention_splits.argtypes = paged_kernels._SPLITS_SIGNATURE
    host.paged_attention_splits.restype = ctypes.c_int
    return host


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("dtypes", ["f32", "bf16", "bf16-q", "bf16-pages"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [
    # B, C, H, kvH, hd, P, NP, M, window
    (2, 3, 4, 2, 8, 4, 16, 4, None), (2, 3, 4, 2, 8, 4, 16, 4, 5),
    (3, 17, 4, 2, 32, 16, 20, 5, None), (3, 17, 4, 2, 32, 16, 20, 5, 7),
    (2, 1, 32, 8, 64, 16, 40, 9, None), (2, 70, 32, 8, 64, 16, 40, 12, 100),
    (1, 5, 2, 1, 64, 3, 10, 7, 4),
    # the last block's rows not a whole 64-row tile (C G = 148, 60, 27,
    # not multiples of 16), hd padded to 16s, walks ending mid-tile
    (2, 37, 8, 2, 64, 16, 24, 6, None), (1, 20, 12, 4, 16, 5, 12, 7, 9),
    (2, 9, 6, 2, 24, 7, 12, 5, None)])
def test_paged_attention_source_on_the_host_matches_plain_version(
        paged_host_build, shape, offset, dtypes, splits):
    """The kernel's page walk (table lookups, pages that do not divide the
    tile, windows that skip tiles), its row tiles over (c, g), the 16-byte
    and scalar load paths (offset 1: pages not 16-byte aligned), the
    float32/bf16 reads, and the walk split in runs whose partials a
    second kernel merges (runs left empty among them): the valid rows
    within the tolerance of the plain version, the others 0, with idle
    slots (``q_lens`` 0) among them."""
    B, C, H, kvh, hd, P, NP, M, window = shape
    gen = torch.Generator().manual_seed(sum(shape[:8]) + offset)
    q_dt = torch.bfloat16 if dtypes in ("bf16", "bf16-q") else torch.float32
    kv_dt = (torch.bfloat16 if dtypes in ("bf16", "bf16-pages")
             else torch.float32)
    q = torch.randn(B, C, H, hd, generator=gen).to(q_dt)
    n = NP * P * kvh * hd
    k = torch.randn(n + offset, generator=gen).to(kv_dt)[offset:].view(
        NP, P, kvh, hd)
    v = torch.randn(n + offset, generator=gen).to(kv_dt)[offset:].view(
        NP, P, kvh, hd)
    table = torch.randint(0, NP, (B, M), generator=gen, dtype=torch.int32)
    start = torch.randint(0, M * P - C + 1, (B,), generator=gen,
                          dtype=torch.int32)
    q_lens = torch.randint(0, C + 1, (B,), generator=gen, dtype=torch.int32)
    out = torch.full((B, C, H, hd), float("nan"))
    ws = torch.full((splits * B * C * H * (hd + 2),), float("nan"))
    assert paged_host_build.paged_attention(
        q.data_ptr(), int(q_dt == torch.bfloat16), k.data_ptr(),
        v.data_ptr(), int(kv_dt == torch.bfloat16), table.data_ptr(),
        start.data_ptr(), q_lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
        B, C, H, kvh, hd, P, M, window or 0, splits, None) == 0
    want = ref.paged_attention_batched_ref(q, k, v, table, start, q_lens,
                                           window=window)
    valid = torch.arange(C)[None, :] < q_lens[:, None]
    np.testing.assert_allclose(out[valid].numpy(), want[valid].numpy(),
                               **PAGED_TOL)
    assert torch.equal(out[~valid], torch.zeros_like(out[~valid]))


@pytest.mark.parametrize("dtypes", ["f32", "bf16"])
def test_paged_attention_source_on_the_host_holds_near_tied_scores(
        paged_host_build, dtypes):
    """Precision: 1,120 positions whose keys differ by 1e-4 (scores tied
    to about that), values from 1e-3 to 1e2 in magnitude with both signs,
    every row valid: the three-term products of the float32 operands and
    of p keep the rows within rtol = atol = 1e-5 of the plain version."""
    B, C, H, kvh, hd, P, M = 1, 4, 4, 2, 64, 16, 70
    NP = M + 2
    dt = torch.bfloat16 if dtypes == "bf16" else torch.float32
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    k = (rng.standard_normal(hd)
         + 1e-4 * rng.standard_normal((NP, P, kvh, hd))).astype(np.float32)
    v = (rng.choice([-1.0, 1.0], (NP, P, kvh, hd))
         * 10.0 ** rng.uniform(-3, 2, (NP, P, kvh, hd))).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    table = torch.from_numpy(
        rng.permutation(NP)[:M].reshape(B, M).astype(np.int32))
    start = torch.tensor([M * P - C], dtype=torch.int32)
    q_lens = torch.tensor([C], dtype=torch.int32)
    out = torch.full((B, C, H, hd), float("nan"))
    assert paged_host_build.paged_attention(
        q.data_ptr(), int(dt == torch.bfloat16), k.data_ptr(), v.data_ptr(),
        int(dt == torch.bfloat16), table.data_ptr(), start.data_ptr(),
        q_lens.data_ptr(), out.data_ptr(), None, B, C, H, kvh, hd, P, M, 0,
        1, None) == 0
    want = ref.paged_attention_batched_ref(q, k, v, table, start, q_lens)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **PAGED_TOL)


def test_paged_attention_splits_only_launches_of_few_blocks(
        paged_host_build):
    """A decode pass of 16 slots and 8 kv heads (128 blocks) splits each
    walk; a chunked-prefill pass (2,048 blocks) and a short table do
    not."""
    splits = paged_host_build.paged_attention_splits
    assert splits(16, 1, 32, 8, 16, 128) == 9
    assert splits(16, 1, 32, 8, 16, 4) == 1
    assert splits(16, 256, 32, 8, 16, 128) == 1
    assert 1 < splits(2, 1, 4, 2, 16, 64) <= 32
