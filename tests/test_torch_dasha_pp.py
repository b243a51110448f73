"""The port's DASHA-PP engine against ``repro.core.DashaPP``: 20-round
trajectories of all four variants, fused and unfused (against
``use_pallas`` True and False), from the reference's own draws; the
non-participant freeze; the bits and participants accounting; and the
port's own ``run`` drawing from a ``torch.Generator``.

Tolerance (trajectories): rtol = 1e-4, atol = 1e-6.  The two engines
apply the same float32 operations to the same draws, but the port's
gradients are batched products where the reference averages
materialised component gradients, and finite-MVR sums its ``B`` drawn
components where the reference sums a dense ``(n, m, d)`` scatter; those
last-ulp differences then travel through 20 rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import reference_draws, to_numpy, torch_one_thread  # noqa: F401

import repro.core as R
import repro_torch as T
from repro_torch import convert

TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
ROUNDS = 20
VARIANTS = ["gradient", "page", "finite_mvr", "mvr"]


@pytest.fixture(scope="module")
def ref_problem():
    feats, y = R.make_synthetic_classification(jax.random.key(0), n_nodes=10,
                                               m_per_node=8, d=24)
    return R.LogisticSigmoidProblem(feats, y)


def _make(pkg, prob, comp, samp, variant, **kw):
    kw.update(gamma=0.05, a=0.1, b=0.3)
    if variant == "gradient":
        return pkg.dasha_pp(prob, comp, samp, **kw)
    if variant == "page":
        return pkg.dasha_pp_page(prob, comp, samp, p_page=0.3, batch_size=2,
                                 **kw)
    if variant == "finite_mvr":
        return pkg.dasha_pp_finite_mvr(prob, comp, samp, batch_size=3, **kw)
    return pkg.dasha_pp_mvr(prob, comp, samp, batch_size=2, **kw)


def _pair(ref_problem, variant, fused, ref_comp=None, ref_samp=None):
    ref_comp = ref_comp or R.RandK(k=5)
    ref_samp = ref_samp or R.SNice(n=ref_problem.n, s=4)
    port_comp = getattr(T, type(ref_comp).__name__)(
        **{f: getattr(ref_comp, f) for f in ("k", "ratio", "block_size")
           if hasattr(ref_comp, f)})
    port_samp = {"SNice": lambda s: T.SNice(n=s.n, s=s.s),
                 "Independent": lambda s: T.Independent(n=s.n, p=s.p),
                 "FullParticipation": lambda s: T.FullParticipation(n=s.n)
                 }[type(ref_samp).__name__](ref_samp)
    ref_alg = _make(R, ref_problem, ref_comp, ref_samp, variant,
                    use_pallas=fused)
    port_alg = _make(T, convert.problem(ref_problem, device="cpu"),
                     port_comp, port_samp, variant, fused=fused,
                     device="cpu")
    return ref_alg, port_alg


def _run_port(alg, x0, draws):
    state = alg.init(x0)
    history = []
    for dr in draws:
        state, met = alg.step(state, convert.round_draws(**dr, device="cpu"))
        history.append(met)
    return state, T.StepMetrics(*(torch.stack(f) for f in zip(*history)))


def _assert_trajectory(ref_alg, port_alg, key):
    x0 = jnp.zeros(ref_alg.problem.d)
    st_ref, met_ref = jax.jit(lambda k: ref_alg.run(k, x0, ROUNDS))(key)
    st, met = _run_port(port_alg, torch.zeros(port_alg.problem.d),
                        reference_draws(ref_alg, key, ROUNDS))
    fields = ["x", "g", "h_i", "g_i"]
    if st_ref.h_ij is not None:
        fields.append("h_ij")
    for f in fields:
        np.testing.assert_allclose(to_numpy(getattr(st, f)),
                                   to_numpy(getattr(st_ref, f)),
                                   err_msg=f, **TRAJ_TOL)
    for f in ("loss", "grad_norm_sq", "x_norm"):
        np.testing.assert_allclose(to_numpy(getattr(met, f)),
                                   to_numpy(getattr(met_ref, f)),
                                   err_msg=f, **TRAJ_TOL)
    for f in ("bits_sent", "participants", "grad_oracle_calls"):
        np.testing.assert_array_equal(to_numpy(getattr(met, f)),
                                      to_numpy(getattr(met_ref, f)),
                                      err_msg=f)
    assert int(st.step) == int(st_ref.step) == ROUNDS


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_trajectory_matches_reference(ref_problem, variant, fused):
    """``fused=True`` runs the kernels' plain versions on the CPU and is
    held to ``use_pallas=True`` (the Pallas kernels in interpret mode);
    ``fused=False`` runs the unfused rule, held to ``use_pallas=False``."""
    _assert_trajectory(*_pair(ref_problem, variant, fused),
                       jax.random.key(11))


@pytest.mark.parametrize("comp, samp", [
    (R.BlockRandK(ratio=0.3, block_size=5), R.Independent(n=10, p=0.4)),
    (R.Identity(), R.FullParticipation(n=10))])
def test_trajectory_other_compressors_and_samplers(ref_problem, comp, samp):
    _assert_trajectory(*_pair(ref_problem, "page", True, comp, samp),
                       jax.random.key(12))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_nonparticipating_state_frozen(ref_problem, variant, fused):
    """Nodes outside S keep h_i, g_i and their h_ij rows to the bit
    (Alg. 1 lines 15-17); participants move."""
    _, alg = _pair(ref_problem, variant, fused)
    gen = torch.Generator().manual_seed(5)
    state = alg.init(torch.zeros(alg.problem.d))
    h_ij_before = None if state.h_ij is None else state.h_ij.clone()
    draws = alg.draw(gen)
    new, met = alg.step(state, draws)
    out = ~draws.mask
    assert torch.equal(new.h_i[out], state.h_i[out])
    assert torch.equal(new.g_i[out], state.g_i[out])
    assert not torch.equal(new.h_i[~out], state.h_i[~out])
    if h_ij_before is not None:
        assert torch.equal(new.h_ij[out], h_ij_before[out])
    assert int(met.participants) == 4


def test_metrics_accounting(ref_problem):
    _, alg = _pair(ref_problem, "mvr", True)
    gen = torch.Generator().manual_seed(6)
    _, met = alg.run(gen, torch.zeros(alg.problem.d), 5)
    assert met.participants.tolist() == [4] * 5
    assert met.bits_sent.tolist() == [4 * alg.compressor.wire_bits(24)] * 5
    assert met.grad_oracle_calls.tolist() == [2 * 2 * 10] * 5
    assert met.loss.shape == (5,)


def test_run_is_reproducible_and_converges():
    """The port's own draws: a fixed seed gives a fixed run, and theory
    hyperparameters drive the gradient norm down (Theorem 2)."""
    gen = torch.Generator().manual_seed(0)
    quad = T.QuadraticProblem.random(gen, n=8, d=12, cond=5.0, device="cpu")
    comp, samp = T.RandK(k=3), T.SNice(n=8, s=3)
    L, L_hat, L_max, L_sigma = quad.smoothness()
    c = T.theory.ProblemConstants(L=L, L_hat=L_hat, L_max=L_max,
                                  L_sigma=L_sigma, n=8, m=1, d=12)
    hp = T.theory.dasha_pp_gradient(c, comp.omega(12), samp.p_a, samp.p_aa)
    alg = T.dasha_pp(quad, comp, samp, gamma=hp.gamma, a=hp.a, b=hp.b,
                     device="cpu")
    runs = [alg.run(torch.Generator().manual_seed(1), torch.zeros(12), r)
            for r in (1500, 50)]
    assert torch.equal(runs[0][1].grad_norm_sq[:50], runs[1][1].grad_norm_sq)
    g = runs[0][1].grad_norm_sq
    assert torch.all(torch.isfinite(g))
    assert g[-1] < 1e-2 * g[0], (g[0], g[-1])


def test_mvr_b_init_uses_a_minibatch_estimate(ref_problem):
    _, alg = _pair(ref_problem, "mvr", True)
    idx = torch.zeros(10, 1, dtype=torch.int64)
    state = alg.init(torch.zeros(24), b_init_idx=idx)
    expected = alg.problem.batch_grad(torch.zeros(24), idx)
    assert torch.equal(state.h_i, expected)
    assert torch.allclose(state.g, expected.mean(0))


def test_converted_reference_state_continues_the_reference(ref_problem):
    """A finite-MVR reference state taken over mid-run (``convert.state``,
    ``h_ij`` included) and stepped by the port with the reference's next
    draws lands where the reference's own run does."""
    ref_alg, port_alg = _pair(ref_problem, "finite_mvr", True)
    key, x0 = jax.random.key(13), jnp.zeros(ref_problem.d)
    half, _ = jax.jit(lambda k: ref_alg.run(k, x0, 5))(key)
    full, _ = jax.jit(lambda k: ref_alg.run(k, x0, 10))(key)
    state = convert.state(half, device="cpu")
    assert int(state.step) == 5
    for dr in reference_draws(ref_alg, key, 10)[5:]:
        state, _ = port_alg.step(state, convert.round_draws(**dr,
                                                            device="cpu"))
    for f in ("x", "g", "h_i", "g_i", "h_ij"):
        np.testing.assert_allclose(to_numpy(getattr(state, f)),
                                   to_numpy(getattr(full, f)), err_msg=f,
                                   **TRAJ_TOL)
