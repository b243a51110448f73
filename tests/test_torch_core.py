"""The port's core modules against the JAX package: problems and their
oracles, the copies of the JAX package's stdlib and numpy modules,
samplers and compressors by distribution and given the reference's
draws, the device guard, and the rule that the port imports neither JAX
nor the JAX package.

Tolerances: problem oracles rtol = 1e-5, atol = 1e-6 (float32 sums in
another order: the port's gradient is a batched product over the
features where the reference averages materialised per-component
gradients); compressors given the same indices, bit counts and theory
formulas exactly; dithering given the same uniforms rtol = 1e-6,
atol = 1e-7 (the row norm is a float32 sum in another order).
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import numpy_inputs, to_numpy, torch_one_thread  # noqa: F401

import repro.core as R
from repro.core import theory as ref_theory
from repro.core import variants as ref_variants
from repro.core import wire as ref_wire
import repro_torch as T
from repro_torch import convert
from repro_torch.core import theory, variants, wire

REPO = Path(__file__).resolve().parents[1]
ORACLE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ref_problems():
    feats, y = R.make_synthetic_classification(jax.random.key(3), 5, 7, 19,
                                               density=0.3)
    return {"logistic": R.LogisticSigmoidProblem(feats, y),
            "softmax": R.NonconvexSoftmaxProblem(feats, y, lam=1e-2),
            "quadratic": R.QuadraticProblem.random(jax.random.key(4), 5, 19)}


@pytest.mark.parametrize("name", ["logistic", "softmax", "quadratic"])
def test_problem_oracles_match_reference(ref_problems, name):
    rp = ref_problems[name]
    tp = convert.problem(rp, device="cpu")
    assert (tp.n, tp.m, tp.d) == (rp.n, rp.m, rp.d)
    x = numpy_inputs(5, 1, (rp.d,))[0]
    idx = np.random.default_rng(0).integers(0, rp.m, (rp.n, 3))
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    for fn, args_ref, args_t in [
            ("loss", (x,), (xt,)),
            ("grad", (x,), (xt,)), ("full_grad", (x,), (xt,)),
            ("component_grads", (x, idx), (xt, it)),
            ("batch_grad", (x, idx), (xt, it))]:
        np.testing.assert_allclose(
            to_numpy(getattr(tp, fn)(*args_t)),
            to_numpy(getattr(rp, fn)(*args_ref)), err_msg=fn, **ORACLE_TOL)
    if name != "quadratic":
        all_idx = np.broadcast_to(np.arange(rp.m), (rp.n, rp.m))
        np.testing.assert_allclose(to_numpy(tp.component_grad_all(xt)),
                                   to_numpy(rp.component_grads(x, all_idx)),
                                   **ORACLE_TOL)
    np.testing.assert_allclose(tp.smoothness(), rp.smoothness(), rtol=1e-5)


def test_synthetic_classification_shapes_and_labels():
    gen = torch.Generator().manual_seed(0)
    feats, y = T.make_synthetic_classification(gen, 4, 6, 50, density=0.2,
                                               device="cpu")
    assert feats.shape == (4, 6, 50) and y.shape == (4, 6)
    assert set(torch.unique(y).tolist()) <= {-1.0, 1.0}
    assert 0.1 < (feats != 0).float().mean().item() < 0.3


# The port's copies of the JAX package's modules that need neither JAX
# nor anything else of the package, with the functions whose bodies may
# differ: trace.kernel_scope names a torch.profiler range, not a
# jax.named_scope.
COPIES = {"core/wire.py": (), "core/theory.py": (), "fl/events.py": (),
          "fl/staleness.py": (), "fl/latency.py": (),
          "fl/client_store.py": (), "obs/trace.py": ("kernel_scope",),
          "obs/metrics.py": (), "obs/monitors.py": (),
          "training/metrics.py": (), "serving/pages.py": (),
          "configs/deepseek_v2_lite_16b.py": ()}


def _code_without_imports(path: Path, differing=()) -> str:
    """The module's AST without imports, docstrings and the named
    top-level functions, dumped."""
    tree = ast.parse(path.read_text(), str(path))

    class Strip(ast.NodeTransformer):
        def visit_Import(self, node):
            return None

        def visit_ImportFrom(self, node):
            return None

        def generic_visit(self, node):
            body = getattr(node, "body", None)
            if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef)) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:]
            if isinstance(node, ast.Module):
                node.body = [n for n in node.body
                             if getattr(n, "name", None) not in differing]
            return super().generic_visit(node)

    return ast.dump(Strip().visit(tree))


def test_wire_and_theory_copies_match_reference():
    for rel, differing in COPIES.items():
        copy = REPO / "src" / "repro_torch" / rel
        orig = REPO / "src" / "repro" / rel
        assert _code_without_imports(copy, differing) == \
            _code_without_imports(orig, differing), rel
        for name in differing:
            assert f"def {name}(" in copy.read_text(), (rel, name)
    for d in (1, 2, 3, 100, 20958, 1 << 20):
        assert wire.index_bits(d) == ref_wire.index_bits(d)
        for nnz in (0, 1, 17, d):
            assert wire.payload_bits(nnz, d) == ref_wire.payload_bits(nnz, d)
    assert (wire.FLOAT_BITS, wire.GROUP_HEADER_BITS) == (
        ref_wire.FLOAT_BITS, ref_wire.GROUP_HEADER_BITS)
    c = dict(L=1.3, L_hat=1.7, L_max=4.0, L_sigma=3.0, sigma=0.5, n=100,
             m=723, d=20958)
    tc, rc = theory.ProblemConstants(**c), ref_theory.ProblemConstants(**c)
    for omega, pa, paa in [(0.0, 1.0, 1.0), (19.0, 0.2, 0.2 * 19 / 99),
                           (3.0, 0.5, 0.25)]:
        pairs = [
            (theory.dasha_pp_gradient(tc, omega, pa, paa),
             ref_theory.dasha_pp_gradient(rc, omega, pa, paa)),
            (theory.dasha_pp_page(tc, omega, pa, paa, 16),
             ref_theory.dasha_pp_page(rc, omega, pa, paa, 16)),
            (theory.dasha_pp_finite_mvr(tc, omega, pa, paa, 16),
             ref_theory.dasha_pp_finite_mvr(rc, omega, pa, paa, 16)),
            (theory.dasha_pp_mvr(tc, omega, pa, paa, 16, eps=1e-3),
             ref_theory.dasha_pp_mvr(rc, omega, pa, paa, 16, eps=1e-3))]
        for t, r in pairs:
            assert dataclasses.astuple(t) == dataclasses.astuple(r)


@pytest.mark.parametrize("d", [1, 7, 128, 1000, 20958])
def test_wire_bits_match_reference_exactly(d):
    pairs = [(T.Identity(), R.Identity()),
             (T.TopK(k=3), R.TopK(k=3)),
             (T.TopK(k=d // 20 + 1), R.TopK(k=d // 20 + 1)),
             (T.RandomDithering(), R.RandomDithering()),
             (T.RandomDithering(s=16), R.RandomDithering(s=16)),
             (T.RandK(k=3), R.RandK(k=3)),
             (T.RandK(k=d // 20 + 1), R.RandK(k=d // 20 + 1)),
             (T.BlockRandK(ratio=0.1), R.BlockRandK(ratio=0.1)),
             (T.BlockRandK(ratio=0.3, block_size=16),
              R.BlockRandK(ratio=0.3, block_size=16))]
    for t, r in pairs:
        assert t.wire_bits(d) == r.wire_bits(d)
        assert t.omega(d) == r.omega(d)


def test_message_bits_match_reference_exactly():
    for d in (1, 64, 1000, 20958):
        for agg in ("sparse_allgather", "dense_psum"):
            for ratio in (None, 0.01, 0.5):
                for bs in (16, 128):
                    for fmt in variants.WIRE_FORMATS:
                        kw = dict(aggregation=agg, compression_ratio=ratio,
                                  block_size=bs, wire_format=fmt)
                        assert variants.message_bits(d, **kw) == \
                            ref_variants.message_bits(d, **kw)
    for d, bs, ratio in [(20958, 128, 0.05), (7, 128, 0.5), (1000, 33, 0.2)]:
        assert variants.block_plan(d, bs, ratio) == \
            ref_variants.block_plan(d, bs, ratio)


def test_sampler_rates_match_reference():
    pairs = [(T.SNice(n=100, s=20), R.SNice(n=100, s=20)),
             (T.SNice(n=1, s=1), R.SNice(n=1, s=1)),
             (T.Independent(n=10, p=0.3), R.Independent(n=10, p=0.3)),
             (T.FullParticipation(n=4), R.FullParticipation(n=4)),
             (T.make_sampler("s_nice", 8, s=3), R.make_sampler("s_nice", 8,
                                                               s=3))]
    for t, r in pairs:
        assert (t.p_a, t.p_aa) == (r.p_a, r.p_aa)


def test_snice_draws_exactly_s_and_uniformly():
    gen = torch.Generator().manual_seed(1)
    samp = T.SNice(n=10, s=3)
    masks = torch.stack([samp.sample(gen) for _ in range(4000)])
    assert masks.dtype == torch.bool and masks.shape == (4000, 10)
    assert torch.all(masks.sum(1) == 3)
    # each node in with prob 0.3: 4000 draws, 4 sigma ~ 0.03
    assert torch.allclose(masks.float().mean(0), torch.full((10,), 0.3),
                          atol=0.03)


def test_independent_has_mean_p_and_full_is_everyone():
    gen = torch.Generator().manual_seed(2)
    masks = torch.stack([T.Independent(n=50, p=0.2).sample(gen)
                         for _ in range(2000)])
    # 1e5 Bernoulli(0.2) draws: 4 sigma ~ 0.005
    assert abs(masks.float().mean().item() - 0.2) < 0.006
    assert torch.all(T.FullParticipation(n=5).sample(gen))


@pytest.mark.parametrize("comp", [T.RandK(k=4), T.BlockRandK(ratio=0.25,
                                                            block_size=3)])
def test_compressors_are_unbiased_with_distinct_indices(comp):
    gen = torch.Generator().manual_seed(3)
    n, d, draws = 4, 13, 6000
    x = torch.from_numpy(numpy_inputs(6, 1, (n, d))[0])
    total = torch.zeros(n, d)
    for _ in range(draws):
        idx = comp.draw(gen, n, d)
        assert all(len(set(row.tolist())) == idx.shape[1] for row in idx)
        total += comp.compress(x, idx)
    # E[C(x)] = x; the mean of 6000 draws sits within ~4 sigma
    sigma = x.abs() * np.sqrt(comp.omega(d) / draws)
    assert torch.all((total / draws - x).abs() <= 4 * sigma + 1e-6)


def test_compress_given_reference_indices_matches_reference():
    d = 37
    x = numpy_inputs(7, 1, (3, d))[0]
    keys = [jax.random.key(i) for i in range(3)]
    for tc, rc in [(T.RandK(k=5), R.RandK(k=5)),
                   (T.BlockRandK(ratio=0.3, block_size=8),
                    R.BlockRandK(ratio=0.3, block_size=8)),
                   (T.Identity(), R.Identity())]:
        if isinstance(rc, R.RandK):
            idx = np.stack([np.array(rc._indices(k, d)) for k in keys])
        elif isinstance(rc, R.BlockRandK):
            _, nb, kb = rc._plan(d)
            idx = np.stack([np.array(ref_variants.block_randk_indices(
                k, nb, kb)) for k in keys])
        else:
            idx = None
        ref = np.stack([np.array(rc.compress(k, jnp.asarray(x[i])))
                        for i, k in enumerate(keys)])
        got = tc.compress(torch.from_numpy(x),
                          None if idx is None else torch.from_numpy(idx))
        np.testing.assert_array_equal(to_numpy(got), ref)


def test_topk_and_dithering_given_reference_draws_match_reference():
    d = 37
    x = numpy_inputs(8, 1, (3, d))[0]
    x[1] = 0.0                       # a zero row: dithering sends zeros
    keys = [jax.random.key(10 + i) for i in range(3)]
    topk = np.stack([np.array(R.TopK(k=5).compress(k, jnp.asarray(x[i])))
                     for i, k in enumerate(keys)])
    comp = T.TopK(k=5)
    assert comp.draw(torch.Generator(), 3, d) is None
    np.testing.assert_array_equal(
        to_numpy(comp.compress(torch.from_numpy(x), None)), topk)
    rd = R.RandomDithering(s=4)
    dith = np.stack([np.array(rd.compress(k, jnp.asarray(x[i])))
                     for i, k in enumerate(keys)])
    u = np.stack([np.array(jax.random.uniform(k, (d,))) for k in keys])
    got = T.RandomDithering(s=4).compress(torch.from_numpy(x),
                                          torch.from_numpy(u))
    np.testing.assert_allclose(to_numpy(got), dith, rtol=1e-6, atol=1e-7)
    assert not np.any(to_numpy(got)[1])


def test_dithering_is_unbiased():
    gen = torch.Generator().manual_seed(5)
    comp = T.RandomDithering(s=2)
    n, d, draws = 3, 11, 6000
    x = torch.from_numpy(numpy_inputs(9, 1, (n, d))[0])
    total = torch.zeros(n, d)
    for _ in range(draws):
        u = comp.draw(gen, n, d)
        assert u.shape == (n, d) and u.dtype == torch.float32
        total += comp.compress(x, u)
    # each coordinate is norm/s times a Bernoulli step: variance <=
    # (norm/s)^2 / 4; 6000 draws, 5 sigma
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    assert torch.all((total / draws - x).abs()
                     <= 5 * (norm / 2) / 2 / np.sqrt(draws))


def test_make_compressor_matches_reference_registry():
    for name in ("identity", "randk", "block_randk", "topk", "dithering"):
        for kw in ({}, {"k": 7}, {"ratio": 0.2, "block_size": 16},
                   {"s": 8}):
            t, r = T.make_compressor(name, 500, **kw), R.make_compressor(
                name, 500, **kw)
            assert type(t).__name__ == type(r).__name__
            assert dataclasses.asdict(t) == dataclasses.asdict(r)
    with pytest.raises(ValueError, match="unknown compressor"):
        T.make_compressor("natural", 10)


def test_batch_indices_in_range_and_distinct_without_replacement():
    gen = torch.Generator().manual_seed(4)
    idx = T.sample_batch_indices(gen, 6, 9, 4, replace=False)
    assert idx.shape == (6, 4) and idx.dtype == torch.int64
    assert all(len(set(r.tolist())) == 4 for r in idx)
    idx = T.sample_batch_indices(gen, 6, 9, 20, replace=True)
    assert int(idx.min()) >= 0 and int(idx.max()) < 9


def test_convert_copies_reference_arrays():
    x = jnp.arange(6.0).reshape(2, 3)
    t = convert.tensor(x, device="cpu")
    t += 1        # writable and not aliasing the JAX buffer
    np.testing.assert_array_equal(np.array(x), np.arange(6.0).reshape(2, 3))
    dr = convert.round_draws(np.array([True, False]), np.zeros((2, 1)),
                             np.array(True), None, device="cpu")
    assert dr.mask.dtype == torch.bool and dr.batch_idx.dtype == torch.int64
    assert dr.coin.dtype == torch.bool and dr.comp_idx is None


def test_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.make_synthetic_classification(gen, 2, 2, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.QuadraticProblem.random(gen, 2, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.tensor(np.zeros(2))
    feats, y = T.make_synthetic_classification(gen, 2, 2, 3, device="cpu")
    prob = T.LogisticSigmoidProblem(feats, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.dasha_pp(prob, T.Identity(), T.FullParticipation(n=2), gamma=0.1,
                   a=1.0, b=1.0)
    assert T.dasha_pp(prob, T.Identity(), T.FullParticipation(n=2),
                      gamma=0.1, a=1.0, b=1.0,
                      device="cpu").device == torch.device("cpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for sub in ("core", "kernels", "fl", "obs", "launch", "training",
                "models", "configs", "data", "serving"):
        assert any(f.parent.name == sub for f in files), sub
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels.build, repro_torch.kernels.dasha_update, "
            "repro_torch.fl, repro_torch.obs, repro_torch.training.metrics, "
            "repro_torch.launch.async_train, repro_torch.models, "
            "repro_torch.data, repro_torch.core.sharded, "
            "repro_torch.training.trainer, repro_torch.training.loop, "
            "repro_torch.launch.train, repro_torch.serving, "
            "repro_torch.kernels.paged_attention, "
            "repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
