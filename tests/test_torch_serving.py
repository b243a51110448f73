"""The port's serving path on the CPU against the JAX package: the decode
branches of ``attention_block``, the model's prefill and decode steps,
``PagedEngine`` and ``DecodeServer``, and the serve CLI.

Both sides start from the same weights (the reference's, carried over by
``convert.params_from_jax``) at smoke size in float32.  The reference's
engines read their pages by gathering (``use_kernel=False``), which
keeps Pallas interpret-mode compiles out of these tests; its kernel is
held to the port's plain version in ``tests/test_torch_kernels.py``.

Tolerances.  Layers and model steps: rtol = atol = 1e-5 on outputs,
logits and caches; both sides run the same float32 operations, summed
in other orders by XLA and by PyTorch (observed differences below
2e-6).  Engines: generated tokens equal, request for request, and
``metrics()`` equal apart from the seconds.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (process_hygiene, to_numpy,  # noqa: F401
                           torch_one_thread)

from repro.models import Model as RefModel
from repro.models import get_smoke_config as ref_smoke
from repro.models import layers as ref_layers
from repro.obs import metrics as ref_metrics
from repro.serving import DecodeServer as RefDecodeServer
from repro.serving import PagedEngine as RefPagedEngine
from repro.serving import Request as RefRequest
from repro_torch import convert
from repro_torch.launch import serve as serve_cli
from repro_torch.models import (Model, get_config, get_smoke_config, layers,
                                param_shapes)
from repro_torch.models.model import PagedDecodeState
from repro_torch.obs import metrics as port_metrics
from repro_torch.serving import DecodeServer, PagedEngine, Request

pytestmark = pytest.mark.usefixtures("process_hygiene")

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, the port's model on the CPU)."""
    rcfg = ref_smoke("granite-3-2b")
    ref = RefModel(rcfg)
    rparams = ref.init_params(jax.random.key(0))
    port = Model(get_smoke_config("granite-3-2b"),
                 convert.params_from_jax(rparams, device="cpu"))
    return ref, rparams, port


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


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(to_numpy(a), np.asarray(b), **tol)


# ----------------------------------------------------------------------
# The decode branches of attention_block
# ----------------------------------------------------------------------

def _attn_inputs(seed, B, T, NP=None, P=None, S=None):
    cfg = ref_smoke("granite-3-2b")
    rng = np.random.default_rng(seed)
    D, H, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    # scaled as dense_init scales them (1/sqrt(d_in))
    shapes = {"wq": (D, H * hd), "wk": (D, kvh * hd), "wv": (D, kvh * hd),
              "wo": (H * hd, D)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.standard_normal((B, T, D), np.float32)
    rows = NP if NP is not None else B
    width = P if P is not None else S
    kc = rng.standard_normal((rows, width, kvh, hd), np.float32)
    vc = rng.standard_normal((rows, width, kvh, hd), np.float32)
    return cfg, p, x, kc, vc


def _port_cfg(windowed):
    cfg = get_smoke_config("granite-3-2b")
    return cfg.with_overrides(attention_window=5) if windowed else cfg


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_ring_cache_decode_branches_match_reference(per_slot, windowed):
    """One token a slot against a ring cache of 8 whose position has
    wrapped: lockstep (0-d position) and per slot with the ``update``
    mask (masked slots keep their bytes)."""
    cfg, p, x, kc, vc = _attn_inputs(1, 3, 1, S=8)
    if windowed:
        cfg = cfg.with_overrides(attention_window=5)
    if per_slot:
        pos = np.array([3, 11, 17], np.int32)
        update = np.array([True, False, True])
        positions = pos[:, None]
    else:
        pos, update = np.int32(13), None
        positions = pos[None]
    want, want_cache = jax.jit(
        lambda p_, x_, c_: ref_layers.attention_block(
            p_, x_, jnp.asarray(positions), cfg, cache=c_,
            cache_pos=jnp.asarray(pos),
            update=None if update is None else jnp.asarray(update)))(
        p, x, ref_layers.KVCache(k=kc, v=vc))
    cache = layers.KVCache(k=torch.from_numpy(kc.copy()),
                           v=torch.from_numpy(vc.copy()))
    got, got_cache = layers.decode_attention_block(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        torch.from_numpy(np.array(positions)), _port_cfg(windowed), cache,
        torch.from_numpy(np.array(pos)),
        update=None if update is None else torch.from_numpy(update))
    _close(got, want)
    _close(got_cache.k, want_cache.k)
    _close(got_cache.v, want_cache.v)
    assert got_cache.k is cache.k          # written in place


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("windowed", [False, True])
def test_paged_decode_branch_matches_reference(kernel, windowed):
    """The write-then-attend pass over pool pages with ``q_lens`` (C = 3,
    one slot idle): the port's kernel op (its plain version here) and
    its gather read both against the reference's gather read; padded
    writes land in the scratch page and nowhere else."""
    NP, P, M, B, C = 10, 4, 3, 3, 3
    cfg, p, x, kc, vc = _attn_inputs(2, B, C, NP=NP, P=P)
    if windowed:
        cfg = cfg.with_overrides(attention_window=5)
    table = np.array([[4, 1, 7], [2, 9, 0], [5, 3, 8]], np.int32)
    start = np.array([2, 7, 0], np.int32)
    q_lens = np.array([3, 1, 0], np.int32)
    positions = start[:, None] + np.arange(C, dtype=np.int32)[None]
    want, want_cache = jax.jit(
        lambda p_, x_, c_: ref_layers.attention_block(
            p_, x_, jnp.asarray(positions), cfg, cache=c_,
            cache_pos=jnp.asarray(start), paged_table=jnp.asarray(table),
            q_lens=jnp.asarray(q_lens)))(p, x, ref_layers.KVCache(k=kc, v=vc))
    scratch = np.zeros((1, P) + kc.shape[2:], np.float32)
    cache = layers.KVCache(k=torch.from_numpy(np.concatenate([kc, scratch])),
                           v=torch.from_numpy(np.concatenate([vc, scratch])))
    got, got_cache = layers.decode_attention_block(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        torch.from_numpy(positions), _port_cfg(windowed), cache,
        torch.from_numpy(start), paged_table=torch.from_numpy(table),
        paged_kernel=kernel, q_lens=torch.from_numpy(q_lens))
    valid = np.arange(C)[None] < q_lens[:, None]
    _close(got.numpy()[valid], np.asarray(want)[valid])
    _close(got_cache.k[:NP], want_cache.k)
    _close(got_cache.v[:NP], want_cache.v)


# ----------------------------------------------------------------------
# The model's prefill and decode steps
# ----------------------------------------------------------------------

def _tokens(seed, shape, vocab=500):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_matches_reference(pair, bucketed):
    """Exact-length prefill with spare capacity, and a prompt padded to
    its bucket with the true length given."""
    ref, rparams, port = pair
    toks = _tokens(3, (2, 8))
    kw = {"true_len": 6} if bucketed else {"extra_capacity": 4}
    want_logits, want = ref.prefill(
        rparams, {"tokens": jnp.asarray(toks)},
        **({"true_len": jnp.asarray(6)} if bucketed else kw))
    with torch.no_grad():
        got_logits, got = port.prefill(
            port.params(), {"tokens": torch.from_numpy(toks)},
            **({"true_len": torch.tensor(6)} if bucketed else kw))
    _close(got_logits, want_logits)
    assert int(got.position) == int(want.position)
    for gc, wc in zip(got.caches, want.caches):
        _close(gc.k, wc.k)
        _close(gc.v, wc.v)


@pytest.mark.parametrize("per_slot", [False, True])
def test_serve_step_matches_reference(pair, per_slot):
    """Three decode steps from the reference's prefill state (carried
    over by ``convert.decode_state_from_jax``): slots in lockstep, or
    per-slot positions with an ``update`` mask."""
    ref, rparams, port = pair
    _, state = ref.prefill(rparams, {"tokens": jnp.asarray(_tokens(4, (3, 5)))},
                           extra_capacity=8)
    update = None
    if per_slot:
        state = state._replace(position=jnp.asarray([5, 2, 4], jnp.int32))
        update = np.array([True, False, True])
    pstate = convert.decode_state_from_jax(state, device="cpu")
    step = jax.jit(ref.serve_step)
    for t in range(3):
        toks = _tokens(10 + t, (3, 1))
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
        _close(gc.k, wc.k)
        _close(gc.v, wc.v)


@pytest.mark.parametrize("C", [1, 4])
def test_paged_fused_step_matches_reference(pair, C):
    """Two fused passes over a pool (convert.paged_state_from_jax adds
    the scratch page): C = 1 decode and C = 4 chunks with ragged
    ``q_lens`` (one slot idle); logits of the slots' last valid tokens
    and the pool's pages.  The port reads through the kernel op (its
    plain version here), the reference through its gather."""
    ref, rparams, port = pair
    B, NP, P, M = 3, 12, 4, 4
    rstate = ref.init_paged_state(B, NP, P, M)
    table = np.array([[3, 7, 0, 0], [1, 4, 9, 0], [2, 5, 6, 8]], np.int32)
    rstate = rstate._replace(page_table=jnp.asarray(table),
                             seq_lens=jnp.asarray([1, 5, 0], jnp.int32))
    pstate = convert.paged_state_from_jax(rstate, device="cpu")
    assert pstate.caches[0].k.shape[0] == NP + 1
    q_lens = (np.array([1, 1, 0], np.int32) if C == 1
              else np.array([4, 2, 0], np.int32))
    step = jax.jit(ref.paged_fused_step)
    for t in range(2):
        toks = _tokens(20 + t, (B, C))
        want, rstate = step(rparams, jnp.asarray(toks), rstate,
                            jnp.asarray(q_lens))
        with torch.no_grad():
            got, pstate = port.paged_fused_step(
                port.params(), torch.from_numpy(toks), pstate,
                torch.from_numpy(q_lens))
        live = q_lens > 0
        _close(got[torch.from_numpy(live)], np.asarray(want)[live])
    np.testing.assert_array_equal(pstate.seq_lens.numpy(),
                                  np.asarray(rstate.seq_lens))
    for gc, wc in zip(pstate.caches, rstate.caches):
        _close(gc.k[:NP], wc.k)
        _close(gc.v[:NP], wc.v)


def test_paged_serve_step_matches_reference(pair):
    """The C = 1 view with an ``update`` mask: masked slots advance
    nothing and write nothing."""
    ref, rparams, port = pair
    B, NP, P, M = 3, 9, 4, 3
    table = np.array([[3, 7, 0], [1, 4, 8], [2, 5, 6]], np.int32)
    rstate = ref.init_paged_state(B, NP, P, M)._replace(
        page_table=jnp.asarray(table),
        seq_lens=jnp.asarray([2, 6, 3], jnp.int32))
    pstate = convert.paged_state_from_jax(rstate, device="cpu")
    update = np.array([True, False, True])
    toks = _tokens(30, (B, 1))
    want, rstate = jax.jit(ref.paged_serve_step)(
        rparams, jnp.asarray(toks), rstate, jnp.asarray(update))
    with torch.no_grad():
        got, pstate = port.paged_serve_step(
            port.params(), torch.from_numpy(toks), pstate,
            torch.from_numpy(update))
    _close(got[torch.from_numpy(update)], np.asarray(want)[update])
    np.testing.assert_array_equal(pstate.seq_lens.numpy(), [3, 6, 4])
    for gc, wc in zip(pstate.caches, rstate.caches):
        _close(gc.k[:NP], wc.k)


def test_decode_state_from_stacked_reference_layout():
    """A scanned reference (caches stacked (L, ...)) converts to one
    KVCache a layer."""
    cfg = ref_smoke("granite-3-2b").with_overrides(scan_layers=True)
    ref = RefModel(cfg)
    state = ref.init_decode_state(2, 8, position=3)
    port = convert.decode_state_from_jax(state, device="cpu")
    assert len(port.caches) == cfg.num_layers
    assert port.caches[1].k.shape == (2, 8, cfg.num_kv_heads, cfg.hd)
    assert int(port.position) == 3
    paged = convert.paged_state_from_jax(ref.init_paged_state(2, 6, 4, 3),
                                         device="cpu")
    assert paged.caches[0].v.shape == (7, 4, cfg.num_kv_heads, cfg.hd)
    assert paged.page_table.dtype == torch.int32


# ----------------------------------------------------------------------
# The engines
# ----------------------------------------------------------------------

def _requests(cls, n, seed=0, new=6, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(1, 512, int(rng.integers(
        lo, hi))).tolist(), max_new_tokens=new) for i in range(n)]


def _same_runs(ref_eng, port_eng, ref_reqs, port_reqs):
    a, b = ref_eng.run(ref_reqs), port_eng.run(port_reqs)
    assert [r.generated for r in b] == [r.generated for r in a]
    if isinstance(ref_eng, RefPagedEngine):
        want = {k: v for k, v in ref_eng.metrics().items()
                if "seconds" not in k}
        got = {k: v for k, v in port_eng.metrics().items()
               if "seconds" not in k}
        assert got == want
    return a, b


ENGINE_CASES = {
    "chunked": (dict(page_size=4), dict(n=6, new=8)),
    "bulk": (dict(page_size=4, prefill_chunk_tokens=0), dict(n=6, new=8)),
    "bucketed": (dict(page_size=4, prefill_chunk_tokens=0,
                      bucket_sizes=[8, 16]), dict(n=5, new=6)),
    "small-pages": (dict(page_size=2), dict(n=7, new=6)),
    "preemption": (dict(page_size=4, num_pages=6, prefill_chunk_tokens=0),
                   dict(n=6, new=8)),
    "preemption-mid-prefill": (dict(page_size=4, num_pages=7,
                                    prefill_chunk_tokens=1),
                               dict(n=6, seed=1, new=8, lo=10, hi=13)),
    "anchor": (dict(page_size=32, num_pages=3), dict(n=5)),
}


@pytest.fixture(scope="module")
def reference_runs(pair):
    """The reference engine's tokens and metrics per case, run once (its
    jit compiles are the costly part of these tests)."""
    ref, rparams, _ = pair
    runs = {}

    def get(case):
        if case not in runs:
            kw, req_kw = ENGINE_CASES[case]
            old = ref_metrics.get_registry()
            ref_metrics.set_registry(ref_metrics.Registry())
            try:
                eng = RefPagedEngine(ref, rparams, batch_size=3,
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
    ("chunked", True), ("preemption-mid-prefill", True), ("anchor", True)])
def test_paged_engine_matches_reference(pair, reference_runs,
                                        fresh_registries, case, kernel):
    """The port's engine on the CPU against the reference's, same weights
    and requests: equal tokens and metrics, reading through the gather
    or through the kernel op's plain version."""
    _, _, port = pair
    kw, req_kw = ENGINE_CASES[case]
    tokens, metrics = reference_runs(case)
    port_eng = PagedEngine(port, None, batch_size=3, max_seq_len=32,
                           use_kernel=kernel, device="cpu", **kw)
    out = port_eng.run(_requests(Request, **req_kw))
    assert [r.generated for r in out] == tokens
    assert {k: v for k, v in port_eng.metrics().items()
            if "seconds" not in k} == metrics
    if case.startswith("preemption"):
        assert port_eng.pool.metrics.preemptions >= 1
    if case == "preemption-mid-prefill":
        assert port_eng.mid_prefill_preemptions >= 1
    port_eng.pool.check_invariants()
    port_eng.prefix.drop_all()
    assert port_eng.pool.in_use == 0


def test_shared_prefix_and_copy_on_write_match_reference(pair,
                                                         fresh_registries):
    """Two prompts sharing a prefix (a full page and part of the next,
    COW'd on write), then an identical prompt sharing every page: the
    port's tokens and pool accounting (prefix hits, COW copies, allocs)
    equal the reference's, and sharing changes no token."""
    ref, rparams, port = pair
    base = [5, 9, 3, 7, 2]

    def reqs(cls):
        return [cls(uid=0, prompt=base + [11], max_new_tokens=5),
                cls(uid=1, prompt=base + [12], max_new_tokens=5),
                cls(uid=2, prompt=base + [11], max_new_tokens=5)]

    kw = dict(batch_size=2, max_seq_len=32, page_size=4)
    eng = PagedEngine(port, None, device="cpu", **kw)
    _, shared = _same_runs(RefPagedEngine(ref, rparams, **kw), eng,
                           reqs(RefRequest), reqs(Request))
    assert eng.pool.metrics.prefix_hits >= 2
    assert eng.pool.metrics.cow_copies >= 1
    alone = PagedEngine(port, None, device="cpu", share_prefixes=False,
                        **kw).run(reqs(Request))
    assert [r.generated for r in alone] == [r.generated for r in shared]


def test_bucketed_prefill_counts_one_program_per_bucket(pair,
                                                        fresh_registries):
    """Prompt lengths 3-7 share bucket 8; 10 and 12 share bucket 16."""
    _, _, port = pair
    eng = PagedEngine(port, None, batch_size=2, max_seq_len=32, page_size=4,
                      prefill_chunk_tokens=0, bucket_sizes=[8, 16],
                      device="cpu")
    eng.run([Request(uid=i, prompt=[3 + i] * (3 + i), max_new_tokens=2)
             for i in range(5)])
    assert eng.prefill_cache_size() == 1
    eng.run([Request(uid=10, prompt=[7] * 10, max_new_tokens=2)])
    assert eng.prefill_cache_size() == 2
    eng.run([Request(uid=11, prompt=[2] * 12, max_new_tokens=2)])
    assert eng.prefill_cache_size() == 2


def test_decode_server_matches_reference(pair, fresh_registries):
    """The dense ring-cache server, more requests than slots, and the
    port's paged engine with one page a sequence equal to it (the
    reference's parity anchor)."""
    ref, rparams, port = pair
    dense = RefDecodeServer(ref, rparams, batch_size=2, max_seq_len=32)
    mine = DecodeServer(port, None, batch_size=2, max_seq_len=32,
                        device="cpu")
    _, out = _same_runs(dense, mine, _requests(RefRequest, 5),
                        _requests(Request, 5))
    paged = PagedEngine(port, None, batch_size=2, max_seq_len=32,
                        page_size=32, num_pages=2, device="cpu").run(
        _requests(Request, 5))
    assert [r.generated for r in paged] == [r.generated for r in out]


def test_engines_refuse_a_missing_card_and_a_foreign_device(pair):
    _, _, port = pair
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PagedEngine(port, None, batch_size=2, max_seq_len=16)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DecodeServer(port, None, batch_size=2, max_seq_len=16)
    with pytest.raises(ValueError, match="lie on cpu"):
        PagedEngine(port, None, batch_size=2, max_seq_len=16,
                    device="meta")


# ----------------------------------------------------------------------
# The serve CLI
# ----------------------------------------------------------------------

def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve_cli.main(argv) == 0
    return out.getvalue().splitlines()


def test_serve_cli_paged_prints_the_reference_rows(pair, fresh_registries):
    """``--device cpu --smoke --engine paged``: the reference's
    ``served ...`` row and the paged metrics rows, whose numbers equal a
    reference engine's on the CLI's requests (the tokens differ: each
    side draws its own weights)."""
    ref, rparams, _ = pair
    rows = _cli(["--arch", "granite-3-2b", "--engine", "paged", "--device",
                 "cpu"])
    assert rows[0].startswith("served 8 requests, 128 tokens, ")
    assert rows[0].endswith(" tok/s (engine=paged, batch=4)")
    eng = RefPagedEngine(ref, rparams, batch_size=4, max_seq_len=128,
                         page_size=16)
    rng = np.random.default_rng(0)
    eng.run([RefRequest(uid=i, prompt=rng.integers(1, 49155, 4).tolist(),
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


def test_serve_cli_dense_and_the_default_device(fresh_registries):
    rows = _cli(["--arch", "granite-3-2b", "--device", "cpu",
                 "--requests", "3", "--new-tokens", "4"])
    assert rows == [rows[0]] and rows[0].startswith(
        "served 3 requests, 12 tokens, ")
    assert rows[0].endswith(" tok/s (engine=dense, batch=4)")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_cli.main(["--arch", "granite-3-2b"])


def test_serve_estimate_counts_weights_pool_and_a_pass(monkeypatch):
    """Full width: the weights (2.53 B parameters in bf16) and the
    dense-equivalent pool (80 KiB a token over 40 layers) lie inside the
    estimate; a card smaller than it is refused before anything is
    allocated."""
    arch = get_config("granite-3-2b")
    weights = 2 * sum(int(np.prod(s)) for s in param_shapes(arch).values())
    assert 5.0e9 < weights < 5.1e9
    pool = 4097 * 16 * 40 * 2 * 8 * 64 * 2
    est = serve_cli.estimate_serve_bytes(arch, engine="paged", batch=16,
                                         max_seq=4096, page_size=16,
                                         pages=4096, chunk=256)
    assert weights + pool < est < weights + pool + 4e9
    args = serve_cli.build_parser().parse_args(
        ["--arch", "granite-3-2b", "--no-smoke", "--engine", "paged"])
    assert serve_cli.estimate_for(args) > weights
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, est - 1))
    with pytest.raises(RuntimeError, match="cut --batch"):
        serve_cli.check_fits(est, torch.device("cuda"))
    serve_cli.check_fits(est, torch.device("cpu"))


def test_paged_state_rows_past_num_pages_are_the_scratch_page(pair):
    """The engine's pool holds one page past ``num_pages``, which its
    byte accounting leaves out (the reference's number)."""
    _, _, port = pair
    eng = PagedEngine(port, None, batch_size=2, max_seq_len=16, page_size=4,
                      device="cpu")
    cfg = port.cfg
    assert eng._caches[0].k.shape[0] == eng.num_pages + 1
    assert eng.cache_hbm_bytes() == (cfg.num_layers * 2 * eng.num_pages * 4
                                     * cfg.num_kv_heads * cfg.hd * 4)
    state = port.init_paged_state(2, eng.num_pages, 4, eng.max_pages)
    assert isinstance(state, PagedDecodeState)
    assert state.page_table.shape == (2, eng.max_pages)
