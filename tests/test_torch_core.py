"""The port's core modules against the JAX package: problems and their
oracles, the wire model and theory copies, samplers and compressors by
distribution and given the reference's draws, the device guard, and
the rule that the port imports neither JAX nor the JAX package.

Tolerances: problem oracles rtol = 1e-5, atol = 1e-6 (float32 sums in
another order: the port's gradient is a batched product over the
features where the reference averages materialised per-component
gradients); compressors given the same indices, bit counts and theory
formulas exactly.
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


def test_wire_and_theory_copies_match_reference():
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
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels.build, repro_torch.kernels.dasha_update; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
