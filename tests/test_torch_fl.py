"""The port's async federated runtime against ``repro.fl``: the
``AsyncDashaServer`` of both packages on the same problem and the
reference's own draws, in the sync limit and off it (lognormal latency,
a buffer smaller than the cohort, staleness discards, dropout with
rejoin, Poisson availability), for all four variants, fused and
unfused; replay determinism and the staleness policies on the port's
own generator; the fleet-wide-outage clock guard; the drain's staleness
clock; TopK and dithering transports; and the ``async_train`` CLI.

Tolerance (trajectories): rtol = 1e-4, atol = 1e-6, as slice 1's engine
parity.  The two servers apply the same float32 operations to the same
draws, but the port's gradients are batched products where the
reference averages materialised component gradients, the reference's
commit sums a capacity-``n`` buffer with ``jnp`` (in another order than
the port's in-order sum over the committed rows), and those last-ulp
differences travel through the run.  The schedule (event log, staleness
histogram, counts) does not depend on the numbers and is held equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import reference_draws, to_numpy, torch_one_thread  # noqa: F401

import repro.core as R
import repro.fl as RF
from repro.core.dasha_pp import DashaPPConfig as RefConfig
from repro.core.problems import sample_batch_indices
import repro_torch as T
import repro_torch.fl as TF
from repro_torch import convert
from repro_torch.kernels import dasha_update as kernels
from repro_torch.launch import async_train

TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
N, M, D, B = 6, 5, 16, 2
VARIANTS = ["gradient", "page", "finite_mvr", "mvr"]


@pytest.fixture(scope="module")
def ref_problem():
    feats, y = R.make_synthetic_classification(jax.random.key(0),
                                               n_nodes=N, m_per_node=M, d=D)
    return R.LogisticSigmoidProblem(feats, y)


@pytest.fixture(scope="module")
def port_problem(ref_problem):
    return convert.problem(ref_problem, device="cpu")


def _configs(variant, fused):
    kw = dict(gamma=0.02, a=0.1, b=0.3, p_page=0.4, batch_size=B)
    return (RefConfig(variant, use_pallas=fused, **kw),
            T.DashaPPConfig(variant, fused=fused, **kw))


def _servers(ref_problem, port_problem, variant, fused, acfg, latency,
             availability=None, comp=("RandK", dict(k=4))):
    rcfg, tcfg = _configs(variant, fused)
    kind, lat_kw = latency
    cname, ckw = comp
    ref = RF.AsyncDashaServer(
        ref_problem, getattr(R, cname)(**ckw), R.SNice(n=N, s=3), rcfg,
        RF.AsyncConfig(use_pallas=fused, **acfg), getattr(RF, kind)(**lat_kw),
        availability=(None if availability is None
                      else RF.PoissonAvailability(**availability)))
    port = TF.AsyncDashaServer(
        port_problem, getattr(T, cname)(**ckw), T.SNice(n=N, s=3), tcfg,
        TF.AsyncConfig(fused=fused, **acfg), getattr(TF, kind)(**lat_kw),
        availability=(None if availability is None
                      else TF.PoissonAvailability(**availability)),
        device="cpu")
    return ref, port


def _assert_parity(ref, port, rounds, key=7, b_init=None):
    """Both servers from the reference's draws: equal schedule, close
    trajectories and final state.  Returns the port's result."""
    st_r, res_r = ref.run(jax.random.key(key), jnp.zeros(D), rounds,
                          b_init=b_init)
    draws = [convert.round_draws(**dr, device="cpu")
             for dr in reference_draws(ref, jax.random.key(key), rounds)]
    b_init_idx = None
    if b_init is not None:     # the reference's init minibatch
        b_init_idx = torch.from_numpy(np.array(sample_batch_indices(
            jax.random.split(jax.random.key(key))[0], N, M, b_init,
            replace=True)))
    st, res = port.run(None, torch.zeros(D), rounds, draws=draws,
                       b_init=b_init_idx)
    assert res.event_log == res_r.event_log
    assert res.staleness_hist == res_r.staleness_hist
    assert (res.dropped, res.discarded_stale) == (res_r.dropped,
                                                  res_r.discarded_stale)
    for f in ("committed", "participants", "skipped_busy",
              "skipped_offline", "staleness_max"):
        np.testing.assert_array_equal(getattr(res, f), getattr(res_r, f),
                                      err_msg=f)
    for f in ("time", "bits_cum", "staleness_mean", "utilization"):
        np.testing.assert_allclose(getattr(res, f), getattr(res_r, f),
                                   rtol=1e-12, err_msg=f)
    for f in ("loss", "grad_norm_sq"):
        np.testing.assert_allclose(getattr(res, f), getattr(res_r, f),
                                   err_msg=f, **TRAJ_TOL)
    for f in ("x", "g", "g_i", "h_i", "h_ij"):
        if getattr(st_r, f) is None:
            continue
        np.testing.assert_allclose(to_numpy(getattr(st, f)),
                                   to_numpy(getattr(st_r, f)), err_msg=f,
                                   **TRAJ_TOL)
    return res


# ----------------------------------------------------------------------
# Parity with the reference server
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_sync_limit_matches_reference(ref_problem, port_problem, variant,
                                      fused):
    """Zero jitter and buffer = cohort: every job commits in its own
    round with weight 1; ``fused=True`` against ``use_pallas=True``
    (interpret-mode Pallas dispatch and commit), ``False`` against the
    reference's jnp path."""
    ref, port = _servers(ref_problem, port_problem, variant, fused,
                         dict(buffer_size=3), ("ConstantLatency", {}))
    res = _assert_parity(ref, port, rounds=8)
    assert set(res.staleness_hist) == {0}


def test_mvr_init_minibatch_matches_reference(ref_problem, port_problem):
    """``b_init`` (Corollary 3): the port's server takes the reference's
    init indices as a tensor, or draws ``b_init`` per node itself."""
    ref, port = _servers(ref_problem, port_problem, "mvr", True,
                         dict(buffer_size=3), ("ConstantLatency", {}))
    _assert_parity(ref, port, rounds=6, b_init=3)
    st, _ = port.run(torch.Generator().manual_seed(0), torch.zeros(D), 2,
                     b_init=3)
    assert torch.all(torch.isfinite(st.x))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_stale_buffered_run_matches_reference(ref_problem, port_problem,
                                              variant, fused):
    """Off the sync limit: lognormal latency, a one-arrival buffer, a
    staleness bound that discards, and dropout with rejoin.  Jobs that
    are still in flight when later commits update ``g_i``/``h_i``/``h_ij``
    in place must not see those updates."""
    ref, port = _servers(
        ref_problem, port_problem, variant, fused,
        dict(buffer_size=1, max_staleness=1),
        ("LognormalLatency", dict(sigma=1.5, client_sigma=1.5, dropout=0.2,
                                  rejoin_s=2.0, bandwidth_bps=1e4, seed=4)))
    res = _assert_parity(ref, port, rounds=20)
    assert res.discarded_stale > 0 and res.dropped > 0
    assert max(res.staleness_hist) == 1
    assert any(e[2] == TF.REJOIN for e in res.event_log)


@pytest.mark.parametrize("variant", ["finite_mvr", "mvr"])
def test_adaptive_policy_with_availability_matches_reference(
        ref_problem, port_problem, variant):
    ref, port = _servers(
        ref_problem, port_problem, variant, True,
        dict(buffer_size=2, staleness_policy="adaptive", max_staleness=3),
        ("LognormalLatency", dict(sigma=1.2, client_sigma=1.2, dropout=0.1,
                                  seed=3)),
        availability=dict(rate=0.4, off_mean=3.0, seed=2))
    res = _assert_parity(ref, port, rounds=20)
    assert res.skipped_offline.sum() > 0
    assert any(s > 0 for s in res.staleness_hist)


@pytest.mark.parametrize("comp", [("TopK", dict(k=4)),
                                  ("RandomDithering", dict(s=4))])
def test_topk_and_dithering_transports_match_reference(ref_problem,
                                                       port_problem, comp):
    ref, port = _servers(
        ref_problem, port_problem, "mvr", True, dict(buffer_size=2),
        ("LognormalLatency", dict(sigma=0.5, client_sigma=0.5,
                                  bandwidth_bps=1e5, seed=1)), comp=comp)
    res = _assert_parity(ref, port, rounds=12)
    arrivals = sum(1 for e in res.event_log if e[2] == TF.ARRIVAL)
    assert res.bits_cum[-1] == pytest.approx(
        arrivals * port.compressor.wire_bits(D))


def test_drain_staleness_advances_per_chunk(ref_problem, port_problem):
    """Drain chunks are dispatch-free server steps, so late jobs carry
    their real staleness: with every job landing long after the run and
    ``max_staleness=0`` exactly round 0's own commit survives."""
    ref, port = _servers(ref_problem, port_problem, "mvr", True,
                         dict(buffer_size=1, max_staleness=0),
                         ("ConstantLatency", dict(compute_s=1000.0)))
    res = _assert_parity(ref, port, rounds=2)
    arrivals = sum(1 for e in res.event_log if e[2] == TF.ARRIVAL)
    assert int(res.committed.sum()) == 1
    assert res.staleness_hist == {0: 1}
    assert res.discarded_stale == arrivals - 1


# ----------------------------------------------------------------------
# The port's own draws
# ----------------------------------------------------------------------

def _port_run(port_problem, acfg, latency, rounds, seed=5, variant="mvr",
              availability=None):
    _, tcfg = _configs(variant, True)
    srv = TF.AsyncDashaServer(port_problem, T.RandK(k=4),
                              T.SNice(n=N, s=3), tcfg, acfg, latency,
                              availability=availability, device="cpu")
    return srv.run(torch.Generator().manual_seed(seed), torch.zeros(D),
                   rounds)


def test_replay_determinism(port_problem):
    """Same generator seed: the same event log and the same iterate, to
    the bit; another seed plays another schedule."""
    lat = TF.LognormalLatency(sigma=1.0, client_sigma=1.0, dropout=0.1,
                              bandwidth_bps=1e4, seed=3)
    acfg = TF.AsyncConfig(buffer_size=2)
    (s1, r1), (s2, r2) = [_port_run(port_problem, acfg, lat, 15)
                          for _ in range(2)]
    assert r1.event_log == r2.event_log and len(r1.event_log) > 0
    assert torch.equal(s1.x, s2.x) and torch.equal(s1.h_i, s2.h_i)
    np.testing.assert_array_equal(r1.grad_norm_sq, r2.grad_norm_sq)
    _, r3 = _port_run(port_problem, acfg, lat, 15, seed=6)
    assert r3.event_log != r1.event_log


def test_power_and_adaptive_policies(port_problem):
    """The power law and the delay-adaptive weights play the same
    schedule and give different iterates once commits are stale; in the
    sync limit both commit everything fresh."""
    lat = TF.LognormalLatency(sigma=1.2, client_sigma=1.2, seed=3)
    s_pow, r_pow = _port_run(port_problem, TF.AsyncConfig(buffer_size=1),
                             lat, 25)
    s_ada, r_ada = _port_run(
        port_problem,
        TF.AsyncConfig(buffer_size=1, staleness_policy="adaptive"), lat, 25)
    assert r_ada.event_log == r_pow.event_log
    assert any(s > 0 for s in r_ada.staleness_hist)
    assert not torch.allclose(s_ada.x, s_pow.x)
    for policy in TF.STALENESS_POLICIES:
        _, res = _port_run(port_problem,
                           TF.AsyncConfig(buffer_size=3,
                                          staleness_policy=policy),
                           TF.ConstantLatency(), 8)
        assert set(res.staleness_hist) == {0}


def test_server_clock_advances_through_fleet_wide_outage(port_problem):
    """Frozen-clock guard: with the whole fleet idle inside outage
    windows and nothing in flight, the server ticks the virtual clock so
    the windows end."""
    _, res = _port_run(
        port_problem, TF.AsyncConfig(buffer_size=2),
        TF.ConstantLatency(compute_s=0.5), 60, seed=1,
        availability=TF.PoissonAvailability(rate=5.0, off_mean=3.0, seed=7))
    assert res.skipped_offline.sum() > 0
    half = len(res.participants) // 2
    assert res.participants[half:].sum() > 0
    assert res.committed.sum() > 0
    assert res.total_time > 1.0


def test_conservation_and_host_device_traffic(port_problem):
    """Every dispatched job commits, drops or is discarded; no metric is
    read before the run ends; the traffic gauges count what crossed."""
    from repro_torch.obs import metrics
    _, res = _port_run(
        port_problem, TF.AsyncConfig(buffer_size=2, max_staleness=2),
        TF.LognormalLatency(sigma=1.0, client_sigma=1.0, dropout=0.2,
                            seed=9), 30)
    assert (res.committed.sum() + res.dropped + res.discarded_stale
            == res.participants.sum())
    assert np.all((res.utilization >= 0) & (res.utilization <= 1))
    reg = metrics.get_registry()
    steps, rounds = len(res.time), 30
    # down: the drawn mask each round, both metrics of each step once
    assert reg.gauge("fleet.async.d2h_bytes").value == N * rounds + 8 * steps
    # up: the effective mask and the cohort's indices each round, the
    # committed indices and weights each commit
    committed = int(res.committed.sum())
    assert reg.gauge("fleet.async.h2d_bytes").value == (
        N * rounds + 8 * int(res.participants.sum()) + 12 * committed)


def test_async_config_validation():
    with pytest.raises(ValueError):
        TF.AsyncConfig(buffer_size=0)
    with pytest.raises(ValueError):
        TF.AsyncConfig(staleness_policy="bogus")
    assert TF.AsyncConfig().fused


def test_server_refuses_short_draws(port_problem):
    _, tcfg = _configs("gradient", True)
    srv = TF.AsyncDashaServer(port_problem, T.RandK(k=4), T.SNice(n=N, s=3),
                              tcfg, TF.AsyncConfig(buffer_size=3),
                              TF.ConstantLatency(), device="cpu")
    with pytest.raises(ValueError, match="rounds of draws"):
        srv.run(None, torch.zeros(D), 3, draws=[])


def test_server_commit_goes_through_the_op(port_problem, monkeypatch):
    """``fused=True`` commits ``g`` through ``ops.buffered_commit_op``
    once per committing server step (on the CPU its plain version);
    ``fused=False`` never calls it."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.buffered_commit_op

    def spy(*a, **kw):
        calls.append(a[1].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "buffered_commit_op", spy)
    lat = TF.LognormalLatency(sigma=1.0, client_sigma=1.0, seed=2)
    kernels.reset_launches()
    _, res = _port_run(port_problem, TF.AsyncConfig(buffer_size=2), lat, 10)
    assert len(calls) == int((res.committed > 0).sum()) > 0
    assert calls == [int(c) for c in res.committed if c > 0]
    assert sum(kernels.launches.values()) == 0     # CPU: no kernel
    calls.clear()
    _port_run(port_problem, TF.AsyncConfig(buffer_size=2, fused=False),
              lat, 10)
    assert calls == []


# ----------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------

def test_async_train_cli_runs_on_the_cpu(capsys, tmp_path):
    rc = async_train.main(["--device", "cpu", "--rounds", "5", "--n", "8",
                           "--d", "32", "--log", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "final ||grad f||^2 = " in out and "staleness hist" in out
    assert "[step      0]" in out
    lines = (tmp_path / "async_train.jsonl").read_text().splitlines()
    assert len(lines) >= 5


def test_async_train_cli_flags_match_the_reference():
    """Same flags and defaults as ``repro.launch.async_train``, but
    ``--device`` and ``--unfused`` in place of ``--use-pallas``."""
    ap = async_train.build_parser()
    args = vars(ap.parse_args([]))
    assert args["device"] == "cuda" and args["unfused"] is False
    for flag, value in [("variant", "mvr"), ("rounds", 300), ("n", 50),
                        ("m", 24), ("d", 120), ("buffer", 5),
                        ("staleness_exponent", 0.5), ("latency", "lognormal"),
                        ("sigma", 0.8), ("bandwidth", 2e5),
                        ("compressor", "randk"), ("ratio", 0.05),
                        ("gamma", 0.05), ("a", 0.1), ("b", 0.3),
                        ("p_page", 0.25), ("batch_size", 2), ("seed", 0)]:
        assert args[flag] == value, flag
    assert async_train.build_server(
        ap.parse_args(["--device", "cpu", "--n", "12"])).sampler.s == 10
