"""The port's kernels on the CPU (the three updates and the async
server's buffered commit): their plain PyTorch versions against the JAX
package's Pallas kernels run in interpret mode, the op layer's routing,
and the wrappers' refusals.

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
(tests/test_fl.py).
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from _torch_parity import numpy_inputs, to_numpy, torch_one_thread  # noqa: F401

from repro.kernels import dasha_update as pallas
from repro.kernels import ops as pallas_ops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import dasha_update as kernels

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
