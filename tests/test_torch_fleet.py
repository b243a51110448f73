"""The port's hierarchical fleet against ``repro.fl.HierarchicalFleet``:
the depth-1 zero-jitter barrier fleet for all four variants, fused on
and off, on the reference's draws; the exact wire-bits ledger; dropout,
discards and forced flushes on the port's own draws; a depth-2 fleet over
a memmap store; and ``EdgeSNice``'s draws by distribution.

Tolerance (trajectories): rtol = 1e-4, atol = 1e-6, as the async server's
parity (tests/test_torch_fl.py), for the same reasons; the fleet's
schedule, tier bits and message log are held equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import reference_draws, torch_one_thread  # noqa: F401

import repro.core as R
import repro.fl as RF
from repro.core.dasha_pp import DashaPPConfig as RefConfig
from repro.core.participation import EdgeSNice as RefEdgeSNice
import repro_torch as T
import repro_torch.fl as TF
from repro_torch import convert
from repro_torch.obs import monitors

TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
N, M, D = 6, 5, 16
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
    kw = dict(gamma=0.02, a=0.1, b=0.3, p_page=0.4, batch_size=2)
    return (RefConfig(variant, use_pallas=fused, **kw),
            T.DashaPPConfig(variant, fused=fused, **kw))


def _port_fleet(port_problem, variant, fcfg, latency, rounds, seed=7,
                s=3, **kw):
    _, tcfg = _configs(variant, True)
    wl = TF.DenseProblemWorkload(port_problem, T.RandK(k=4),
                                 T.SNice(n=N, s=s), tcfg, device="cpu")
    fleet = TF.HierarchicalFleet(wl, fcfg, latency, **kw)
    fs, res = fleet.run(torch.Generator().manual_seed(seed),
                        np.zeros(D, np.float32), rounds)
    return wl, fs, res


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_depth1_fleet_matches_reference(ref_problem, port_problem, variant,
                                        fused):
    """Depth 1, two edges, zero jitter, barrier buffers: the port's fleet
    on the reference's draws equals the reference fleet (``fused``
    against ``use_pallas``)."""
    rcfg, tcfg = _configs(variant, fused)
    rwl = RF.DenseProblemWorkload(ref_problem, R.RandK(k=4),
                                  R.SNice(n=N, s=3), rcfg)
    fs_r, res_r = RF.HierarchicalFleet(
        rwl, RF.FleetConfig(tiers=(RF.TierConfig(aggregators=2),)),
        RF.ConstantLatency(compute_s=1.0)).run(jax.random.key(7),
                                               jnp.zeros(D), 6)
    twl = TF.DenseProblemWorkload(port_problem, T.RandK(k=4),
                                  T.SNice(n=N, s=3), tcfg, device="cpu")
    draws = [convert.round_draws(**dr, device="cpu")
             for dr in reference_draws(rwl.engine, jax.random.key(7), 6)]
    fs, res = TF.HierarchicalFleet(
        twl, TF.FleetConfig(tiers=(TF.TierConfig(aggregators=2),)),
        TF.ConstantLatency(compute_s=1.0)).run(
            None, np.zeros(D, np.float32), 6, draws=draws)
    assert res.event_log == res_r.event_log
    assert res.message_log == res_r.message_log
    np.testing.assert_array_equal(res.tier_bits, res_r.tier_bits)
    np.testing.assert_array_equal(res.bits_cum, res_r.bits_cum)
    assert res.bits_cum[-1] == res.tier_bits.sum()
    assert set(res.staleness_hist) == {0}
    pairs = [("x", fs.x, fs_r.x), ("g", fs.g, fs_r.g)]
    pairs += [(f, fs.store.dense(f), fs_r.store.dense(f))
              for f in fs_r.store.fields]
    for name, a, b in pairs:
        np.testing.assert_allclose(a, b, err_msg=name, **TRAJ_TOL)
    for f in ("loss", "grad_norm_sq"):
        np.testing.assert_allclose(getattr(res, f), getattr(res_r, f),
                                   err_msg=f, **TRAJ_TOL)


def test_depth0_flat_fleet_prices_one_hop(port_problem):
    wl, fs, res = _port_fleet(port_problem, "mvr", TF.FleetConfig(),
                              TF.ConstantLatency(compute_s=1.0), 6)
    assert len(res.tier_bits) == 1 and len(res.message_log) == 0
    assert res.tier_bits[0] == res.root_bits_cum[-1] == res.bits_cum[-1]
    assert int(res.committed.sum()) == int(res.participants.sum())


def test_partial_dropout_conservation_ledger_and_replay(port_problem):
    """Every contribution commits, drops or is discarded; the ledger
    ``bits_cum == tier_bits.sum()`` holds exactly and the monitors agree;
    the same seed replays the same log and iterate."""
    fcfg = TF.FleetConfig(tiers=(TF.TierConfig(aggregators=2,
                                               buffer_size=2),),
                          buffer_size=2, max_staleness=3)
    lat = TF.LognormalLatency(compute_s=1.0, sigma=1.0, client_sigma=1.0,
                              dropout=0.3, seed=11)
    _, fs1, r1 = _port_fleet(port_problem, "mvr", fcfg, lat, 10)
    _, fs2, r2 = _port_fleet(port_problem, "mvr", fcfg, lat, 10)
    assert r1.dropped > 0
    assert (int(r1.committed.sum()) + r1.dropped + r1.discarded_stale
            == int(r1.participants.sum()))
    assert r1.bits_cum[-1] == r1.tier_bits.sum()
    assert monitors.check_fleet_ledger(r1).ok
    assert monitors.check_hops_monotone(r1.commit_log).ok
    assert r1.event_log == r2.event_log and len(r1.event_log) > 0
    np.testing.assert_array_equal(fs1.x, fs2.x)
    np.testing.assert_array_equal(fs1.g, fs2.g)
    assert np.all(np.isfinite(r1.loss))


def test_total_dropout_leaves_the_trackers_at_init(port_problem):
    """dropout = 1: nothing reaches the root, so ``g``, ``g_i`` and
    ``h_i`` stay at their init values to the bit while ``x`` walks and
    the clock advances through rejoins."""
    wl, fs, res = _port_fleet(
        port_problem, "gradient",
        TF.FleetConfig(tiers=(TF.TierConfig(aggregators=2),)),
        TF.ConstantLatency(compute_s=1.0, dropout=1.0, rejoin_s=2.0), 8)
    st0 = wl.engine.init(torch.zeros(D))
    np.testing.assert_array_equal(fs.g, st0.g.numpy().astype(np.float64))
    np.testing.assert_array_equal(fs.store.dense("g_i"), st0.g_i.numpy())
    np.testing.assert_array_equal(fs.store.dense("h_i"), st0.h_i.numpy())
    assert res.committed.sum() == 0
    assert res.dropped == int(res.participants.sum()) > 0
    assert (res.participants > 0).sum() > 1
    assert np.any(fs.x != 0.0)


def test_forced_flush_progress(port_problem):
    _, _, res = _port_fleet(
        port_problem, "gradient",
        TF.FleetConfig(tiers=(TF.TierConfig(aggregators=2, buffer_size=4),)),
        TF.ConstantLatency(compute_s=1.0), 5)
    assert res.forced_flushes > 0
    assert int(res.committed.sum()) == int(res.participants.sum())


def test_depth2_memmap_fleet_smoke(port_problem):
    """A depth-2 tree over a memmap-backed store on ``EdgeSNice``
    cohorts, with dropout and a staleness bound: conservation, every hop
    priced, pre-reduction cheaper than the client hop."""
    _, tcfg = _configs("gradient", True)
    bounds = TF.edge_partition(N, 3)
    wl = TF.DenseProblemWorkload(port_problem, T.RandK(k=4),
                                 T.EdgeSNice(bounds=tuple(bounds), s=1),
                                 tcfg, device="cpu")
    fleet = TF.HierarchicalFleet(
        wl, TF.FleetConfig(tiers=(TF.TierConfig(aggregators=3,
                                                buffer_size=1),
                                  TF.TierConfig(aggregators=1)),
                           buffer_size=2, max_staleness=4),
        TF.LognormalLatency(compute_s=1.0, sigma=0.6, client_sigma=0.6,
                            dropout=0.1, seed=3),
        store_backend="memmap")
    fs, res = fleet.run(torch.Generator().manual_seed(0),
                        np.zeros(D, np.float32), 8)
    assert fs.store.backend == "memmap" and fs.store.n == N
    total = int(res.participants.sum())
    assert total > 0
    assert (int(res.committed.sum()) + res.dropped + res.discarded_stale
            == total)
    assert len(res.tier_bits) == 3 and np.all(res.tier_bits > 0)
    assert res.bits_cum[-1] == res.tier_bits.sum()
    assert np.all(np.isfinite(res.loss))
    fs.store.close()


def test_fleet_refuses_short_draws(port_problem):
    _, tcfg = _configs("gradient", True)
    wl = TF.DenseProblemWorkload(port_problem, T.RandK(k=4),
                                 T.SNice(n=N, s=3), tcfg, device="cpu")
    fleet = TF.HierarchicalFleet(wl, TF.FleetConfig(), TF.ConstantLatency())
    with pytest.raises(ValueError, match="rounds of draws"):
        fleet.run(None, np.zeros(D, np.float32), 2, draws=[])


# ----------------------------------------------------------------------
# EdgeSNice
# ----------------------------------------------------------------------

def test_edge_snice_rates_match_reference():
    for bounds, s in [((0, 5, 10, 15), 2), ((0, 4, 7, 10), 3),
                      ((0, 1, 2), 1)]:
        t, r = T.EdgeSNice(bounds=bounds, s=s), RefEdgeSNice(bounds=bounds,
                                                              s=s)
        assert (t.n, t.num_edges) == (r.n, r.num_edges)
        assert (t.p_a, t.p_aa) == (r.p_a, r.p_aa)
    assert T.make_sampler("edge_s_nice", 15, bounds=(0, 5, 10, 15),
                          s=2) == T.EdgeSNice(bounds=(0, 5, 10, 15), s=2)
    with pytest.raises(ValueError):
        T.EdgeSNice(bounds=(0, 2, 4), s=3)
    with pytest.raises(ValueError):
        T.EdgeSNice(bounds=(0, 3, 3), s=1)


def test_edge_snice_draws_exactly_s_per_edge_with_rate_pa():
    samp = T.EdgeSNice(bounds=(0, 4, 7, 10), s=2)
    gen = torch.Generator().manual_seed(1)
    masks = torch.stack([samp.sample(gen) for _ in range(4000)])
    assert masks.dtype == torch.bool and masks.shape == (4000, 10)
    for lo, hi in zip(samp.bounds, samp.bounds[1:]):
        assert torch.all(masks[:, lo:hi].sum(1) == 2)
        # each client of the edge in with probability s / size; 4000
        # draws, 4 sigma <= 0.032
        want = torch.full((hi - lo,), 2 / (hi - lo))
        assert torch.allclose(masks[:, lo:hi].float().mean(0), want,
                              atol=0.032)
    # the fleet mean is p_a
    assert abs(masks.float().mean().item() - samp.p_a) < 0.01
    again = T.EdgeSNice(bounds=(0, 4, 7, 10), s=2).sample(
        torch.Generator().manual_seed(1))
    assert torch.equal(again, masks[0])
