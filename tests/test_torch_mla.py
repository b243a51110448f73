"""The port's MLA + MoE model (deepseek-v2-lite-16b) and its serving path
on the CPU against the JAX package: the paged MLA kernel's plain version
and its CUDA source compiled for the host, ``moe_block``, every branch
of ``mla_block``, the model's loss, prefill and decode steps, both
engines and the serve CLI, the serve memory estimate and the train
CLI's refusal.

Both sides start from the same inputs: numpy draws, or the reference's
weights carried over by ``convert.params_from_jax``, at smoke size in
float32.  The reference's engines and decode steps read their pages by
gathering (``use_kernel=False``), which keeps Pallas interpret-mode
compiles out of all but the kernel test.

Tolerances (float32 on both sides, summed in other orders by XLA and by
PyTorch):

* the kernel's plain version against the oracle and the Pallas kernel in
  interpret mode, and the host build of the CUDA source against the
  plain version: rtol = atol = 1e-5 (the online softmax sums its tiles
  in another order than a full softmax);
* ``moe_block``: rtol 1e-5, atol 1e-6 on outputs and aux (the same
  products; the combine's sum of a token's K outputs is the reference's
  in the same order);
* ``mla_block`` and the model steps: rtol 1e-4, atol 1e-5 on outputs,
  logits and caches (the absorbed read against the reference's
  unabsorbed one regroups the products: ``q W_uk^T c_kv`` against
  ``q (c_kv W_uk)^T``);
* engines: generated tokens equal, request for request, and
  ``metrics()`` equal apart from the seconds.
"""
import contextlib
import ctypes
import dataclasses
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_host_cuda
from _torch_parity import (flat_tree, process_hygiene, to_numpy,  # noqa: F401
                           torch_one_thread)

from repro.kernels import ops as ref_ops
from repro.kernels.paged_attention import (paged_mla_attention_ref as
                                           ref_paged_mla)
from repro.models import Model as RefModel
from repro.models import get_config as ref_config
from repro.models import get_smoke_config as ref_smoke
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro.obs import metrics as ref_metrics
from repro.serving import DecodeServer as RefDecodeServer
from repro.serving import PagedEngine as RefPagedEngine
from repro.serving import Request as RefRequest
from repro_torch import convert
from repro_torch.kernels import build, ref
from repro_torch.kernels import dasha_update as kernel_counts
from repro_torch.kernels import paged_attention as paged_kernels
from repro_torch.kernels.ops import paged_mla_attention_op
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import (Model, get_config, get_smoke_config,
                                leaf_names, param_shapes)
from repro_torch.models import mla, moe
from repro_torch.obs import metrics as port_metrics
from repro_torch.serving import DecodeServer, PagedEngine, Request

pytestmark = pytest.mark.usefixtures("process_hygiene")

ARCH = "deepseek-v2-lite-16b"
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(to_numpy(a), np.asarray(b), **tol)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, the port's model on the CPU)."""
    ref_model = RefModel(ref_smoke(ARCH))
    rparams = ref_model.init_params(jax.random.key(0))
    port = Model(get_smoke_config(ARCH),
                 convert.params_from_jax(rparams, device="cpu"))
    return ref_model, rparams, port


@pytest.fixture
def fresh_registries():
    """Fresh metrics registries on both sides: the engines publish their
    metrics at the end of ``run``."""
    old = (ref_metrics.get_registry(), port_metrics.get_registry())
    ref_metrics.set_registry(ref_metrics.Registry())
    port_metrics.set_registry(port_metrics.Registry())
    yield
    ref_metrics.set_registry(old[0])
    port_metrics.set_registry(old[1])


# ----------------------------------------------------------------------
# The paged MLA kernel: its plain version, and its source on the host
# ----------------------------------------------------------------------

def _mla_inputs(seed, B, C, H, r, rr, P, NP, M, *, distinct=True):
    """Latent pages, absorbed queries, a table, starts and ``q_lens``
    from a numpy seed (``start + C <= M P``)."""
    rng = np.random.default_rng(seed)
    q_abs = rng.standard_normal((B, C, H, r), np.float32)
    q_rope = rng.standard_normal((B, C, H, rr), np.float32)
    ckv = rng.standard_normal((NP, P, r), np.float32)
    kr = rng.standard_normal((NP, P, rr), np.float32)
    table = (rng.permutation(NP)[:B * M] if distinct
             else rng.integers(0, NP, B * M)).reshape(B, M).astype(np.int32)
    start = rng.integers(0, M * P - C + 1, B).astype(np.int32)
    q_lens = rng.integers(0, C + 1, B).astype(np.int32)
    return q_abs, q_rope, ckv, kr, table, start, q_lens


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mla_plain_version_matches_oracle_and_pallas_kernel(seed, window):
    """``ref.paged_mla_attention_ref`` against the JAX oracle (every row)
    and the Pallas kernel in interpret mode (the rows ``c < q_lens``;
    the others are garbage by contract), over random tables, starts,
    ``q_lens`` and windows."""
    args = _mla_inputs(seed, 2, 3, 4, 8, 4, 4, 16, 4)
    scale = 1.0 / math.sqrt(12.0)
    got = ref.paged_mla_attention_ref(
        *(torch.from_numpy(a) for a in args), scale=scale, window=window)
    oracle = ref_paged_mla(*(jnp.asarray(a) for a in args), scale=scale,
                           window=window)
    _close(got, oracle, KERNEL_TOL)
    pallas = ref_ops.paged_mla_attention_op(
        *(jnp.asarray(a) for a in args), scale=scale, window=window,
        interpret=True)
    valid = np.arange(3)[None] < args[-1][:, None]
    _close(got.numpy()[valid], np.asarray(pallas)[valid], KERNEL_TOL)


def test_mla_op_routes_cpu_tensors_to_the_plain_version():
    args = [torch.from_numpy(a) for a in _mla_inputs(3, 2, 2, 4, 8, 4, 4,
                                                       12, 3)]
    kernel_counts.reset_launches()
    got = paged_mla_attention_op(*args, scale=0.3, window=None)
    want = ref.paged_mla_attention_ref(*args, scale=0.3)
    assert torch.equal(got, want)
    assert kernel_counts.launches["paged_mla_attention"] == 0


def test_mla_wrapper_takes_cuda_tensors_only():
    """The kernel wrapper checks before it builds or launches anything:
    a CPU tensor is refused, never handed to the plain version; so are
    wrong types, shapes and a rank past the kernel's."""
    q_abs, q_rope, ckv, kr, table, start, q_lens = (
        torch.from_numpy(a) for a in _mla_inputs(4, 2, 1, 4, 8, 4, 4, 8, 2))
    kw = dict(scale=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernels.paged_mla_attention(q_abs, q_rope, ckv, kr, table,
                                          start, q_lens, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_kernels.paged_mla_attention(q_abs, q_rope.double(), ckv, kr,
                                          table, start, q_lens, **kw)
    with pytest.raises(ValueError, match="r <= 512"):
        paged_kernels.paged_mla_attention(
            torch.zeros(2, 1, 4, 640), q_rope, torch.zeros(8, 4, 640), kr,
            table, start, q_lens, **kw)
    with pytest.raises(ValueError, match="multiples of 4"):
        paged_kernels.paged_mla_attention(q_abs, q_rope[..., :3], ckv,
                                          kr[..., :3], table, start, q_lens,
                                          **kw)
    with pytest.raises(ValueError, match="shape"):
        paged_kernels.paged_mla_attention(q_abs, q_rope, ckv, kr[:, :2],
                                          table, start, q_lens, **kw)
    with pytest.raises(TypeError, match="int32"):
        paged_kernels.paged_mla_attention(q_abs, q_rope, ckv, kr,
                                          table.long(), start, q_lens, **kw)


def test_mla_launches_are_counted_and_reset():
    kernel_counts.launches["paged_mla_attention"] = 3
    kernel_counts.reset_launches()
    assert kernel_counts.launches["paged_mla_attention"] == 0


def test_mla_source_names_the_tpu_kernel_it_replaces():
    from repro.kernels import paged_attention as pallas_paged
    src = (build.CSRC / "paged_mla_attention.cu").read_text()
    assert "paged_mla_attention_pallas" in src
    assert hasattr(pallas_paged, "paged_mla_attention_pallas")
    cmd = build.nvcc_command("nvcc", build.CSRC / "paged_mla_attention.cu",
                             build.BUILD_DIR / "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd


@pytest.fixture(scope="module")
def mla_host_build(tmp_path_factory):
    """``csrc/paged_mla_attention.cu`` compiled for the host: one thread
    plays the grid and the tensor-core fragments are plain loops in which
    one lane owns the whole fragment (``tests/_torch_host_cuda.py``); the
    real fragment layout is checked only on the card."""
    host = _torch_host_cuda.host_library(tmp_path_factory.mktemp("host_mla"),
                                         "paged_mla_attention")
    host.paged_mla_attention.argtypes = paged_kernels._MLA_SIGNATURE
    host.paged_mla_attention.restype = ctypes.c_int
    host.paged_mla_attention_splits.argtypes = \
        paged_kernels._MLA_SPLITS_SIGNATURE
    host.paged_mla_attention_splits.restype = ctypes.c_int
    return host


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("dtypes", ["f32", "bf16", "bf16-rope",
                                    "bf16-pages"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [
    # B, C, H, r, rope, P, NP, M, window
    (2, 3, 4, 8, 4, 4, 16, 4, None), (2, 3, 4, 8, 4, 4, 16, 4, 6),
    (3, 9, 4, 32, 16, 16, 20, 5, None), (3, 9, 4, 32, 16, 16, 20, 5, 7),
    (2, 1, 16, 64, 16, 16, 30, 9, None), (2, 5, 16, 48, 8, 8, 40, 12, 40),
    (1, 5, 2, 24, 8, 3, 10, 7, 4),
    # the last block's rows not a whole 64-row tile (C H = 112, 15, 60),
    # r and rope padded to 16s, walks ending mid-tile, both warps of a row
    # tile with latent dims (r > 256)
    (2, 7, 16, 64, 16, 8, 40, 12, None), (1, 3, 5, 40, 12, 5, 12, 7, 6),
    (1, 4, 15, 264, 8, 16, 6, 4, None)])
def test_mla_source_on_the_host_matches_plain_version(
        mla_host_build, shape, offset, dtypes, splits):
    """The kernel's page walk (table lookups, pages that do not divide the
    tile, windows that skip tiles), its row tiles over (c, h) (several
    query positions a tile, a ragged last tile), the 16-byte and scalar
    load paths (offset 1: pages not 16-byte aligned), the float32/bf16
    reads, and the walk split in runs whose partials a second kernel
    merges (runs left empty among them): the valid rows within the
    tolerance of the plain version, the others 0, with idle slots
    (``q_lens`` 0) among them."""
    B, C, H, r, rr, P, NP, M, window = shape
    gen = torch.Generator().manual_seed(sum(shape[:8]) + offset)
    qr_dt = (torch.bfloat16 if dtypes in ("bf16", "bf16-rope")
             else torch.float32)
    pg_dt = (torch.bfloat16 if dtypes in ("bf16", "bf16-pages")
             else torch.float32)
    q_abs = torch.randn(B, C, H, r, generator=gen)
    q_rope = torch.randn(B, C, H, rr, generator=gen).to(qr_dt)

    def pages(width):
        n = NP * P * width
        return torch.randn(n + offset, generator=gen).to(pg_dt)[
            offset:].view(NP, P, width)

    ckv, kr = pages(r), pages(rr)
    table = torch.randint(0, NP, (B, M), generator=gen, dtype=torch.int32)
    start = torch.randint(0, M * P - C + 1, (B,), generator=gen,
                          dtype=torch.int32)
    q_lens = torch.randint(0, C + 1, (B,), generator=gen, dtype=torch.int32)
    scale = 1.0 / math.sqrt(r / 4 + rr)
    out = torch.full((B, C, H, r), float("nan"))
    ws = torch.full((splits * B * C * H * (r + 2),), float("nan"))
    assert mla_host_build.paged_mla_attention(
        q_abs.data_ptr(), q_rope.data_ptr(), int(qr_dt == torch.bfloat16),
        ckv.data_ptr(), kr.data_ptr(), int(pg_dt == torch.bfloat16),
        table.data_ptr(), start.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), ws.data_ptr(), B, C, H, r, rr, P, M, window or 0,
        scale, splits, None) == 0
    want = ref.paged_mla_attention_ref(q_abs, q_rope, ckv, kr, table, start,
                                       q_lens, scale=scale, window=window)
    valid = torch.arange(C)[None, :] < q_lens[:, None]
    np.testing.assert_allclose(out[valid].numpy(), want[valid].numpy(),
                               **KERNEL_TOL)
    assert torch.equal(out[~valid], torch.zeros_like(out[~valid]))


@pytest.mark.parametrize("dtypes", ["bf16", "f32"])
def test_mla_source_on_the_host_holds_near_tied_scores(mla_host_build,
                                                       dtypes):
    """Precision: 1,120 positions whose latent rows differ by 1e-4
    (scores tied to about that) and whose values span 1e-3 to 1e2 in
    magnitude with both signs, every row valid: the three-term products
    of q_abs, of p (and of float32 pages) keep the rows within
    rtol = atol = 1e-5 of the plain version."""
    B, C, H, r, rr, P, M = 1, 2, 16, 64, 16, 16, 70
    NP = M + 2
    dt = torch.bfloat16 if dtypes == "bf16" else torch.float32
    rng = np.random.default_rng(12)
    q_abs = torch.from_numpy(
        rng.standard_normal((B, C, H, r)).astype(np.float32))
    q_rope = torch.from_numpy(
        rng.standard_normal((B, C, H, rr)).astype(np.float32)).to(dt)
    mag = 10.0 ** rng.uniform(-3, 2, r)
    ckv = torch.from_numpy((rng.choice([-1.0, 1.0], r) * mag * (
        1 + 1e-4 * rng.standard_normal((NP, P, r)))).astype(
            np.float32)).to(dt)
    kr = torch.from_numpy((rng.standard_normal(rr) + 1e-4 * (
        rng.standard_normal((NP, P, rr)))).astype(np.float32)).to(dt)
    table = torch.from_numpy(
        rng.permutation(NP)[:M].reshape(B, M).astype(np.int32))
    start = torch.tensor([M * P - C], dtype=torch.int32)
    q_lens = torch.tensor([C], dtype=torch.int32)
    scale = 1e-2
    out = torch.full((B, C, H, r), float("nan"))
    assert mla_host_build.paged_mla_attention(
        q_abs.data_ptr(), q_rope.data_ptr(), int(dt == torch.bfloat16),
        ckv.data_ptr(), kr.data_ptr(), int(dt == torch.bfloat16),
        table.data_ptr(), start.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), None, B, C, H, r, rr, P, M, 0, scale, 1,
        None) == 0
    want = ref.paged_mla_attention_ref(q_abs, q_rope, ckv, kr, table, start,
                                       q_lens, scale=scale)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **KERNEL_TOL)


def test_mla_splits_only_launches_of_few_blocks(mla_host_build):
    """A decode pass of 16 slots and 16 heads (16 blocks) splits each
    walk (into one wave of 256 blocks, two an SM); a chunked-prefill
    pass (1,024 blocks) and a short table do
    not."""
    splits = mla_host_build.paged_mla_attention_splits
    assert splits(16, 1, 16, 16, 128) == 16
    assert splits(16, 1, 16, 16, 4) == 1
    assert splits(16, 256, 16, 16, 128) == 1
    assert 1 < splits(2, 1, 4, 16, 64) <= 32


# ----------------------------------------------------------------------
# moe_block
# ----------------------------------------------------------------------

def _moe_params(cfg, seed):
    m, D = cfg.moe, cfg.d_model
    E, Fe, Fs = m.num_experts, m.d_expert, m.d_expert * m.num_shared_experts
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    return {"router": w(D, E), "w_gate": w(E, D, Fe), "w_up": w(E, D, Fe),
            "w_down": w(E, Fe, D),
            "shared": {"w_gate": w(D, Fs), "w_up": w(D, Fs),
                       "w_down": w(Fs, D)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_moe_block_matches_reference(capacity_factor):
    """At the smoke config (capacity 4.0: dropless) and with the capacity
    factor cut to 0.25, where choices ARE dropped (64 tokens x 2 choices
    over 4 experts of capacity 8): outputs and the aux loss."""
    rcfg, cfg = ref_smoke(ARCH), get_smoke_config(ARCH)
    B, T = (2, 5) if capacity_factor is None else (2, 32)
    if capacity_factor is not None:
        rcfg = rcfg.with_overrides(moe=dataclasses.replace(
            rcfg.moe, capacity_factor=capacity_factor))
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    p = _moe_params(cfg, 5)
    x = np.random.default_rng(6).standard_normal((B, T, cfg.d_model),
                                                 np.float32)
    want, want_aux = jax.jit(lambda p_, x_: ref_moe.moe_block(p_, x_, rcfg))(
        p, x)
    got, aux = moe.moe_block(_torch_tree(p), torch.from_numpy(x), cfg)
    _close(got, want, MOE_TOL)
    _close(aux, want_aux, MOE_TOL)
    C = moe._capacity(B * T, cfg)
    assert C == ref_moe._capacity(B * T, rcfg)
    probs = torch.softmax(torch.from_numpy(x).reshape(B * T, -1)
                          @ torch.from_numpy(p["router"]), dim=-1)
    load = torch.bincount(torch.topk(probs, cfg.moe.experts_per_token)[1]
                          .reshape(-1), minlength=cfg.moe.num_experts)
    assert bool((load > C).any()) == (capacity_factor is not None)


# ----------------------------------------------------------------------
# mla_block, every branch
# ----------------------------------------------------------------------

def _mla_params(cfg, seed):
    a, D, H = cfg.mla, cfg.d_model, cfg.num_heads
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    shapes = {"w_q": (D, H * qk), "w_dkv": (D, a.kv_lora_rank),
              "w_uk": (a.kv_lora_rank, H * a.qk_nope_head_dim),
              "w_uv": (a.kv_lora_rank, H * a.v_head_dim),
              "w_kr": (D, a.qk_rope_head_dim),
              "w_o": (H * a.v_head_dim, D)}
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


def _cfgs(windowed):
    rcfg, cfg = ref_smoke(ARCH), get_smoke_config(ARCH)
    if windowed:
        rcfg = rcfg.with_overrides(attention_window=5)
        cfg = cfg.with_overrides(attention_window=5)
    return rcfg, cfg


def _port_mla(p, x, positions, cfg, cache=None, **kw):
    return mla.mla_block({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), torch.from_numpy(positions),
                         cfg, cache, **kw)


@pytest.mark.parametrize("T", [8, 1030])
def test_mla_prefill_matches_reference(T):
    """Training and prefill: the dense-mask path, and the blockwise path
    past 1,024 tokens; the output and the latent cache."""
    rcfg, cfg = _cfgs(False)
    p = _mla_params(cfg, 7)
    x = np.random.default_rng(8).standard_normal((1, T, cfg.d_model),
                                                 np.float32)
    positions = np.arange(T, dtype=np.int32)
    want, want_cache = jax.jit(lambda p_, x_: ref_mla.mla_block(
        p_, x_, jnp.asarray(positions), rcfg))(p, x)
    with torch.no_grad():
        got, cache = _port_mla(p, x, positions, cfg)
    _close(got, want)
    _close(cache.c_kv, want_cache.c_kv)
    _close(cache.k_rope, want_cache.k_rope)


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("mode", ["lockstep", "per-slot", "per-slot-update"])
def test_mla_ring_decode_matches_reference(mode, windowed):
    """One token a slot against a latent ring cache of 8 whose position
    has wrapped: lockstep (0-d position), per slot, and per slot with the
    ``update`` mask (masked slots keep their bytes); written in place."""
    rcfg, cfg = _cfgs(windowed)
    a = cfg.mla
    p = _mla_params(cfg, 9)
    rng = np.random.default_rng(10)
    B, S = 3, 8
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    ckv = rng.standard_normal((B, S, a.kv_lora_rank), np.float32)
    kr = rng.standard_normal((B, S, a.qk_rope_head_dim), np.float32)
    update = None
    if mode == "lockstep":
        pos = np.int32(13)
        positions = pos[None]
    else:
        pos = np.array([3, 11, 17], np.int32)
        positions = pos[:, None]
        if mode == "per-slot-update":
            update = np.array([True, False, True])
    want, want_cache = jax.jit(lambda p_, x_, c_: ref_mla.mla_block(
        p_, x_, jnp.asarray(positions), rcfg, cache=c_,
        cache_pos=jnp.asarray(pos),
        update=None if update is None else jnp.asarray(update)))(
        p, x, ref_mla.MLACache(c_kv=ckv, k_rope=kr))
    cache = mla.MLACache(c_kv=torch.from_numpy(ckv.copy()),
                         k_rope=torch.from_numpy(kr.copy()))
    with torch.no_grad():
        got, got_cache = _port_mla(
            p, x, positions, cfg, cache, cache_pos=torch.from_numpy(
                np.array(pos)),
            update=None if update is None else torch.from_numpy(update))
    _close(got, want)
    _close(got_cache.c_kv, want_cache.c_kv)
    _close(got_cache.k_rope, want_cache.k_rope)
    assert got_cache.c_kv is cache.c_kv            # written in place


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("windowed", [False, True])
def test_mla_paged_branch_matches_reference(kernel, windowed):
    """The write-then-read pass over latent pool pages with ``q_lens``
    (C = 3, one slot idle): the port's absorbed read through the kernel
    op (its plain version here) and its gather read, both against the
    reference's gather read; padded writes land in the scratch page and
    nowhere else, and the written pages equal the reference's."""
    rcfg, cfg = _cfgs(windowed)
    a = cfg.mla
    p = _mla_params(cfg, 11)
    rng = np.random.default_rng(12)
    NP, P, B, C = 10, 4, 3, 3
    x = rng.standard_normal((B, C, cfg.d_model), np.float32)
    ckv = rng.standard_normal((NP, P, a.kv_lora_rank), np.float32)
    kr = rng.standard_normal((NP, P, a.qk_rope_head_dim), np.float32)
    table = np.array([[4, 1, 7], [2, 9, 0], [5, 3, 8]], np.int32)
    start = np.array([2, 7, 0], np.int32)
    q_lens = np.array([3, 1, 0], np.int32)
    positions = start[:, None] + np.arange(C, dtype=np.int32)[None]
    want, want_cache = jax.jit(lambda p_, x_, c_: ref_mla.mla_block(
        p_, x_, jnp.asarray(positions), rcfg, cache=c_,
        cache_pos=jnp.asarray(start), paged_table=jnp.asarray(table),
        q_lens=jnp.asarray(q_lens)))(
        p, x, ref_mla.MLACache(c_kv=ckv, k_rope=kr))

    def scratch(pages):
        return torch.from_numpy(np.concatenate(
            [pages, np.zeros((1,) + pages.shape[1:], np.float32)]))

    cache = mla.MLACache(c_kv=scratch(ckv), k_rope=scratch(kr))
    with torch.no_grad():
        got, got_cache = _port_mla(
            p, x, positions, cfg, cache, cache_pos=torch.from_numpy(start),
            paged_table=torch.from_numpy(table), paged_kernel=kernel,
            q_lens=torch.from_numpy(q_lens))
    valid = np.arange(C)[None] < q_lens[:, None]
    _close(got.numpy()[valid], np.asarray(want)[valid])
    # the written rows hold each framework's x W_dkv and x W_kr (equal
    # within the tolerance); every other row of the pool is untouched
    written = np.zeros((NP, P), bool)
    for b in range(B):
        for c in range(q_lens[b]):
            pos = start[b] + c
            written[table[b, pos // P], pos % P] = True
    for got_pages, want_pages, before in (
            (got_cache.c_kv, want_cache.c_kv, ckv),
            (got_cache.k_rope, want_cache.k_rope, kr)):
        _close(got_pages[:NP], want_pages)
        np.testing.assert_array_equal(got_pages[:NP].numpy()[~written],
                                      before[~written])


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

def test_config_copy_and_registry():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        ref_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(
        ref_smoke(ARCH))


def test_moe_without_mla_is_refused():
    """MoE with GQA attention (dbrx) is the next slice's: the model
    refuses it and names the ROADMAP item."""
    cfg = get_smoke_config(ARCH).with_overrides(mla=None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model.create(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        param_shapes(cfg)


@pytest.mark.parametrize("full", [False, True])
def test_leaf_order_and_shapes_match_reference(full):
    """The MoE/MLA leaves in ``jax.tree.leaves`` order, at smoke size and
    at full width and depth (shapes only; the router float32)."""
    rcfg = ref_config(ARCH) if full else ref_smoke(ARCH)
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    shapes = jax.eval_shape(RefModel(rcfg).init_params, jax.random.key(0))
    names = list(flat_tree(jax.tree.map(lambda s: np.zeros(0), shapes)))
    want = {k: tuple(s.shape)
            for k, s in zip(names, jax.tree.leaves(shapes))}
    assert param_shapes(cfg) == want
    assert leaf_names(cfg) == names
    if full:
        assert sum(math.prod(s) for s in want.values()) == 16_210_311_168
    else:
        port = Model.create(cfg, torch.Generator().manual_seed(0), "cpu")
        dtypes = {k: str(v.dtype).split(".")[-1]
                  for k, v in port.params().items()}
        want_dt = {k: str(s.dtype) for k, s in
                   zip(names, jax.tree.leaves(shapes))}
        assert dtypes == want_dt
        assert port.params()["layers.moe.router"].dtype == torch.float32


def test_loss_with_aux_matches_reference(pair):
    """Next-token cross entropy plus the layers' summed load-balance
    loss."""
    ref_model, rparams, port = pair
    toks = np.random.default_rng(13).integers(1, 500, (2, 12)).astype(
        np.int32)
    want = jax.jit(ref_model.loss)(rparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = port.loss(port.params(), {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    logits, aux = ref_model.forward(rparams, {"tokens": jnp.asarray(toks)})
    assert float(aux) > 0


def _tokens(seed, shape, vocab=500):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_matches_reference(pair, bucketed):
    ref_model, rparams, port = pair
    toks = _tokens(14, (2, 8))
    want_logits, want = ref_model.prefill(
        rparams, {"tokens": jnp.asarray(toks)},
        **({"true_len": jnp.asarray(6)} if bucketed
           else {"extra_capacity": 4}))
    with torch.no_grad():
        got_logits, got = port.prefill(
            port.params(), {"tokens": torch.from_numpy(toks)},
            **({"true_len": torch.tensor(6)} if bucketed
               else {"extra_capacity": 4}))
    _close(got_logits, want_logits)
    assert int(got.position) == int(want.position)
    for gc, wc in zip(got.caches, want.caches):
        assert isinstance(gc, mla.MLACache)
        _close(gc.c_kv, wc.c_kv)
        _close(gc.k_rope, wc.k_rope)


@pytest.mark.parametrize("per_slot", [False, True])
def test_serve_step_matches_reference(pair, per_slot):
    """Three decode steps from the reference's prefill state (converted
    by ``convert.decode_state_from_jax``): lockstep, or per-slot
    positions with an ``update`` mask."""
    ref_model, rparams, port = pair
    _, state = ref_model.prefill(
        rparams, {"tokens": jnp.asarray(_tokens(15, (3, 5)))},
        extra_capacity=8)
    update = None
    if per_slot:
        state = state._replace(position=jnp.asarray([5, 2, 4], jnp.int32))
        update = np.array([True, False, True])
    pstate = convert.decode_state_from_jax(state, device="cpu")
    step = jax.jit(ref_model.serve_step)
    for t in range(3):
        toks = _tokens(16 + t, (3, 1))
        want, state = step(rparams, jnp.asarray(toks), state,
                           None if update is None else jnp.asarray(update))
        with torch.no_grad():
            got, pstate = port.serve_step(
                port.params(), torch.from_numpy(toks), pstate,
                None if update is None else torch.from_numpy(update))
        if update is not None:
            want, got = np.asarray(want)[update], got[update]
        _close(got, want)
    np.testing.assert_array_equal(pstate.position.numpy(),
                                  np.asarray(state.position))
    for gc, wc in zip(pstate.caches, state.caches):
        _close(gc.c_kv, wc.c_kv)
        _close(gc.k_rope, wc.k_rope)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("C", [1, 4])
def test_paged_fused_step_matches_reference(pair, C, kernel):
    """Two fused passes over a latent pool (``paged_state_from_jax`` adds
    the scratch page): C = 1 decode and C = 4 chunks with ragged
    ``q_lens`` (one slot idle); the port reads through the kernel op
    (its plain version here) or the gather, the reference through its
    gather.  Logits of the slots' last valid tokens and the pages."""
    ref_model, rparams, port = pair
    B, NP, P, M = 3, 12, 4, 4
    table = np.array([[3, 7, 0, 0], [1, 4, 9, 0], [2, 5, 6, 8]], np.int32)
    rstate = ref_model.init_paged_state(B, NP, P, M)._replace(
        page_table=jnp.asarray(table),
        seq_lens=jnp.asarray([1, 5, 0], jnp.int32))
    pstate = convert.paged_state_from_jax(rstate, device="cpu")
    assert pstate.caches[0].c_kv.shape[0] == NP + 1
    q_lens = (np.array([1, 1, 0], np.int32) if C == 1
              else np.array([4, 2, 0], np.int32))
    step = jax.jit(ref_model.paged_fused_step)
    for t in range(2):
        toks = _tokens(20 + t, (B, C))
        want, rstate = step(rparams, jnp.asarray(toks), rstate,
                            jnp.asarray(q_lens))
        with torch.no_grad():
            got, pstate = port.paged_fused_step(
                port.params(), torch.from_numpy(toks), pstate,
                torch.from_numpy(q_lens), use_kernel=kernel)
        live = q_lens > 0
        _close(got[torch.from_numpy(live)], np.asarray(want)[live])
    np.testing.assert_array_equal(pstate.seq_lens.numpy(),
                                  np.asarray(rstate.seq_lens))
    for gc, wc in zip(pstate.caches, rstate.caches):
        _close(gc.c_kv[:NP], wc.c_kv)
        _close(gc.k_rope[:NP], wc.k_rope)


def test_decode_states_from_stacked_reference_layout():
    """A scanned reference (latent caches stacked (L, ...)) converts to
    one ``MLACache`` a layer, ring and paged."""
    cfg = ref_smoke(ARCH).with_overrides(scan_layers=True)
    ref_model = RefModel(cfg)
    a = cfg.mla
    state = convert.decode_state_from_jax(
        ref_model.init_decode_state(2, 8, position=3), device="cpu")
    assert len(state.caches) == cfg.num_layers
    assert state.caches[1].c_kv.shape == (2, 8, a.kv_lora_rank)
    assert int(state.position) == 3
    paged = convert.paged_state_from_jax(
        ref_model.init_paged_state(2, 6, 4, 3), device="cpu")
    assert isinstance(paged.caches[0], mla.MLACache)
    assert paged.caches[0].k_rope.shape == (7, 4, a.qk_rope_head_dim)


# ----------------------------------------------------------------------
# The engines
# ----------------------------------------------------------------------

def _requests(cls, n, seed=0, new=6, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(1, 512, int(rng.integers(
        lo, hi))).tolist(), max_new_tokens=new) for i in range(n)]


ENGINE_CASES = {
    "chunked": (dict(page_size=4), dict(n=6, new=8)),
    "bulk": (dict(page_size=4, prefill_chunk_tokens=0), dict(n=5, new=6)),
    "bucketed": (dict(page_size=4, prefill_chunk_tokens=0,
                      bucket_sizes=[8, 16]), dict(n=5, new=6)),
    "preemption": (dict(page_size=4, num_pages=6, prefill_chunk_tokens=0),
                   dict(n=6, new=8)),
    "preemption-mid-prefill": (dict(page_size=4, num_pages=7,
                                    prefill_chunk_tokens=1),
                               dict(n=6, seed=1, new=8, lo=10, hi=13)),
}


@pytest.fixture(scope="module")
def reference_runs(pair):
    """The reference engine's tokens and metrics per case, run once."""
    ref_model, rparams, _ = pair
    runs = {}

    def get(case):
        if case not in runs:
            kw, req_kw = ENGINE_CASES[case]
            old = ref_metrics.get_registry()
            ref_metrics.set_registry(ref_metrics.Registry())
            try:
                eng = RefPagedEngine(ref_model, rparams, batch_size=3,
                                     max_seq_len=32, **kw)
                out = eng.run(_requests(RefRequest, **req_kw))
            finally:
                ref_metrics.set_registry(old)
            runs[case] = ([r.generated for r in out],
                          {k: v for k, v in eng.metrics().items()
                           if "seconds" not in k})
        return runs[case]

    return get


@pytest.mark.parametrize("case, kernel", [
    *((case, False) for case in sorted(ENGINE_CASES)),
    ("chunked", True), ("preemption-mid-prefill", True)])
def test_paged_engine_matches_reference(pair, reference_runs,
                                        fresh_registries, case, kernel):
    """The port's engine on the CPU against the reference's, same weights
    and requests: equal tokens and metrics, reading through the gather
    or through the MLA kernel op's plain version."""
    _, _, port = pair
    kw, req_kw = ENGINE_CASES[case]
    tokens, metrics = reference_runs(case)
    eng = PagedEngine(port, None, batch_size=3, max_seq_len=32,
                      use_kernel=kernel, device="cpu", **kw)
    out = eng.run(_requests(Request, **req_kw))
    assert [r.generated for r in out] == tokens
    assert {k: v for k, v in eng.metrics().items()
            if "seconds" not in k} == metrics
    if case.startswith("preemption"):
        assert eng.pool.metrics.preemptions >= 1
    if case == "preemption-mid-prefill":
        assert eng.mid_prefill_preemptions >= 1
    eng.pool.check_invariants()
    eng.prefix.drop_all()
    assert eng.pool.in_use == 0


def test_shared_prefix_and_copy_on_write_match_reference(pair,
                                                         fresh_registries):
    """Two prompts sharing a prefix (a full page and part of the next,
    COW'd on write), then an identical prompt sharing every page: the
    port's tokens and pool accounting equal the reference's, and sharing
    changes no token."""
    ref_model, rparams, port = pair
    base = [5, 9, 3, 7, 2]

    def reqs(cls):
        return [cls(uid=0, prompt=base + [11], max_new_tokens=5),
                cls(uid=1, prompt=base + [12], max_new_tokens=5),
                cls(uid=2, prompt=base + [11], max_new_tokens=5)]

    kw = dict(batch_size=2, max_seq_len=32, page_size=4)
    ref_eng = RefPagedEngine(ref_model, rparams, **kw)
    eng = PagedEngine(port, None, device="cpu", **kw)
    a, b = ref_eng.run(reqs(RefRequest)), eng.run(reqs(Request))
    assert [r.generated for r in b] == [r.generated for r in a]
    assert ({k: v for k, v in eng.metrics().items() if "seconds" not in k}
            == {k: v for k, v in ref_eng.metrics().items()
                if "seconds" not in k})
    assert eng.pool.metrics.prefix_hits >= 2
    assert eng.pool.metrics.cow_copies >= 1
    alone = PagedEngine(port, None, device="cpu", share_prefixes=False,
                        **kw).run(reqs(Request))
    assert [r.generated for r in alone] == [r.generated for r in b]


@pytest.mark.parametrize("kernel", [False, True])
def test_decode_server_and_parity_anchor_match_reference(pair,
                                                         fresh_registries,
                                                         kernel):
    """The dense ring-cache server (more requests than slots) against the
    reference's, and the paged engine with one page a sequence equal to
    it (the reference's parity anchor, ``test_paged_engine.py:58-75``)."""
    ref_model, rparams, port = pair
    want = RefDecodeServer(ref_model, rparams, batch_size=2,
                           max_seq_len=32).run(_requests(RefRequest, 5))
    dense = DecodeServer(port, None, batch_size=2, max_seq_len=32,
                         device="cpu").run(_requests(Request, 5))
    assert [r.generated for r in dense] == [r.generated for r in want]
    paged = PagedEngine(port, None, batch_size=2, max_seq_len=32,
                        page_size=32, num_pages=2, use_kernel=kernel,
                        device="cpu")
    out = paged.run(_requests(Request, 5))
    assert [r.generated for r in out] == [r.generated for r in dense]
    assert 0 < paged.prefill_forwards <= 5
    assert paged.pool.metrics.preemptions == 0


def test_engine_pool_bytes_leave_out_the_scratch_page(pair):
    _, _, port = pair
    eng = PagedEngine(port, None, batch_size=2, max_seq_len=16, page_size=4,
                      device="cpu")
    cfg, a = port.cfg, port.cfg.mla
    assert eng._caches[0].c_kv.shape[0] == eng.num_pages + 1
    assert eng.cache_hbm_bytes() == (cfg.num_layers * eng.num_pages * 4
                                     * (a.kv_lora_rank
                                        + a.qk_rope_head_dim) * 4)


# ----------------------------------------------------------------------
# The CLIs and the memory estimate
# ----------------------------------------------------------------------

def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve_cli.main(argv) == 0
    return out.getvalue().splitlines()


def test_serve_cli_paged_prints_the_reference_rows(pair, fresh_registries):
    """``--arch deepseek-v2-lite-16b --device cpu --engine paged`` (smoke):
    the reference's ``served ...`` row and the paged metrics rows, whose
    numbers equal a reference engine's on the CLI's requests."""
    ref_model, rparams, _ = pair
    rows = _cli(["--arch", ARCH, "--engine", "paged", "--device", "cpu"])
    assert rows[0].startswith("served 8 requests, 128 tokens, ")
    assert rows[0].endswith(" tok/s (engine=paged, batch=4)")
    eng = RefPagedEngine(ref_model, rparams, batch_size=4, max_seq_len=128,
                         page_size=16)
    rng = np.random.default_rng(0)
    eng.run([RefRequest(uid=i, prompt=rng.integers(1, 102400, 4).tolist(),
                        max_new_tokens=16) for i in range(8)])
    m = eng.metrics()
    assert rows[1:] == [
        f"  prefill_forwards={m['prefill_forwards']} "
        f"decode_steps={m['decode_steps']} "
        f"pool_util={m['pool_utilization']:.2f} "
        f"cache_hbm_bytes={m['cache_hbm_bytes']}",
        f"  latency p50={m['latency_p50']:.0f} p95={m['latency_p95']:.0f} "
        f"serve-passes; ttft p50={m['ttft_p50']:.0f} "
        f"p95={m['ttft_p95']:.0f}"]


def test_serve_estimate_covers_weights_and_the_latent_pool(monkeypatch):
    """Full width: the 16.2 B parameters in bf16 (the routers in
    float32) and the latent pool of 4,096 pages (27 x 576 values a
    token) lie inside the estimate, with under 4 GB of pass tensors; a
    card smaller than it is refused before anything is allocated."""
    arch = get_config(ARCH)
    weights = 2 * sum(math.prod(s) for s in param_shapes(arch).values())
    weights += 27 * 2048 * 64 * 2                       # float32 routers
    assert 32.4e9 < weights < 32.5e9
    pool = 4097 * 16 * 27 * (512 + 64) * 2
    est = serve_cli.estimate_serve_bytes(arch, engine="paged", batch=16,
                                         max_seq=4096, page_size=16,
                                         pages=4096, chunk=256)
    assert weights + pool < est < weights + pool + 4e9
    gather = serve_cli.estimate_serve_bytes(
        arch, engine="paged", batch=16, max_seq=4096, page_size=16,
        pages=4096, chunk=256, use_kernel=False)
    assert gather > est
    args = serve_cli.build_parser().parse_args(
        ["--arch", ARCH, "--no-smoke", "--engine", "paged"])
    assert serve_cli.estimate_for(args) > weights
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, est - 1))
    with pytest.raises(RuntimeError, match="cut --batch"):
        serve_cli.check_fits(est, torch.device("cuda"))


def test_train_cli_refuses_mla_moe_before_it_allocates(monkeypatch):
    """Training deepseek is a later slice: the CLI refuses, naming the
    ROADMAP item, before it resolves the device or builds a model."""
    def no_model(*args, **kwargs):
        raise AssertionError("a model was built")

    monkeypatch.setattr(Model, "create", no_model)
    for extra in (["--smoke", "--device", "cpu"], []):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_cli.main(["--arch", ARCH, *extra])
