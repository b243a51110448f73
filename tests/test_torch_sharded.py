"""The port's sharded engine (``repro_torch.core.sharded``) and its LM
trainer at one node, against the JAX package in this process.

* The trainer: ``repro.training.Trainer`` on a 1x1 mesh and the port's
  ``Trainer`` from the same weights, batches and draws (the reference's
  keys replayed by ``tests/_torch_parity.py``), 5 steps of gradient, MVR,
  PAGE and finite-MVR over the sparse, ``dense_psum`` and uncompressed
  wires, fused and unfused.  Tolerance: params, ``g``, ``g_i`` and ``h_i`` within
  rtol 1e-4 and atol 2e-5 x the leaf's largest magnitude (float32 on
  both sides; the gradients' sums run in another order in XLA's and
  torch's CPU kernels, and the differences travel through 5 steps:
  ``TRAINER_ATOL`` in ``tests/_torch_parity.py`` gives the measurement);
  bits and participants exactly equal.  Four nodes:
  ``tests/test_torch_trainer.py``.
* The trainer in bfloat16 (MVR and finite-MVR, the fused sparse wire,
  3 steps): its tolerance is the reference's own bfloat16 rounding,
  measured against the same run in float32 (see the test).
* The engine alone: one ``node_update`` of the reference's
  ``ShardedDasha`` and of the port's on the same gradients and draws;
  the bit accounting; the block helpers; the draws' distribution; and a
  spy on the op layer (the sparse wire goes through the two block ops,
  the dense wires through the batched update).
"""
import numpy as np
import pytest
import torch
from _torch_parity import (TRAINER_WIRES, assert_trainer_parity,  # noqa: F401
                           numpy_inputs, port_sharded_draws,
                           port_trainer_trajectory, process_hygiene,
                           reference_trainer_trajectory,
                           sharded_reference_draws, to_numpy,
                           torch_one_thread)

import jax
import jax.numpy as jnp

from repro.compat import make_mesh
from repro.core import sharded as ref_sharded
from repro.core import variants as ref_variants
from repro_torch.core import sharded, variants
from repro_torch.kernels import ops

pytestmark = pytest.mark.usefixtures("process_hygiene")


# ----------------------------------------------------------------------
# The trainer at one node
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_runs():
    """The reference's trajectories, each computed once per module."""
    runs = {}

    def get(variant, wire, server="paper"):
        key = (variant, wire, server)
        if key not in runs:
            runs[key] = reference_trainer_trajectory(1, variant, wire,
                                                     server)
        return runs[key]
    return get


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("wire", sorted(TRAINER_WIRES))
@pytest.mark.parametrize("variant", ["gradient", "mvr", "page",
                                     "finite_mvr"])
def test_trainer_matches_reference_one_node(reference_runs, variant, wire,
                                            fused):
    ref = reference_runs(variant, wire)
    assert sum(float(ref[f"s{t}/participants"]) for t in range(5)) > 0
    state, mets = port_trainer_trajectory(ref, 1, variant, wire, fused)
    assert_trainer_parity(ref, state, mets)


@pytest.mark.parametrize("server", ["paper", "adamw"])
def test_server_optimizers_match_reference(server):
    """Four updates of the server optimizer on the same estimators and
    params: deltas and moments within rtol 1e-6, atol 1e-7 (float32 on
    both sides; AdamW's bias corrections are a float32 power)."""
    from repro.training import optim as ref_optim
    from repro_torch.training import optim
    make = {"paper": lambda m: m.paper_server(0.05),
            "adamw": lambda m: m.adamw_server(3e-3, warmup=3)}[server]
    ref, port = make(ref_optim), make(optim)
    params = dict(zip("ab", numpy_inputs(1, 2, (5, 7))))
    rs = ref.init({k: jnp.asarray(v) for k, v in params.items()})
    ps = port.init({k: torch.from_numpy(v) for k, v in params.items()})
    for step in range(4):
        g = dict(zip("ab", numpy_inputs(10 + step, 2, (5, 7))))
        rd, rs = ref.update({k: jnp.asarray(v) for k, v in g.items()}, rs,
                            {k: jnp.asarray(v) for k, v in params.items()})
        pd, ps = port.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ps, {k: torch.from_numpy(v)
                                  for k, v in params.items()})
        assert ps.count == int(rs.count)
        for k in params:
            np.testing.assert_allclose(to_numpy(pd[k]), np.array(rd[k]),
                                       rtol=1e-6, atol=1e-7)
            if server == "adamw":
                for f in ("mu", "nu"):
                    np.testing.assert_allclose(
                        to_numpy(getattr(ps, f)[k]),
                        np.array(getattr(rs, f)[k]), rtol=1e-6, atol=1e-7)
            params[k] = params[k] + np.array(rd[k])


def test_page_runs_both_branches(reference_runs):
    """The PAGE trajectories above cover both coin values."""
    ref = reference_runs("page", "sparse")
    assert {bool(ref[f"s{t}/coin"]) for t in range(5)} == {True, False}


def test_finite_mvr_runs_draw_every_component(reference_runs):
    """The finite-MVR trajectories above draw both components of the
    node, and the node takes part in some rounds and not in others."""
    ref = reference_runs("finite_mvr", "sparse")
    assert {int(ref[f"s{t}/cidx"][0, 0]) for t in range(5)} == {0, 1}
    assert {float(ref[f"s{t}/participants"]) for t in range(5)} == {0.0,
                                                                    1.0}


# bfloat16 against the reference.  Both sides round the model's and the
# engine's bf16 values, at their own points: XLA on the CPU keeps fused
# elementwise chains in float32 where torch rounds every operation, and
# the two take their sums in other orders.  That is rounding, a unit
# roundoff of 2^-8 per operation, which the algorithm then amplifies
# (``k = gn - go - b (h - go)`` takes the difference of two gradient
# evaluations).  The yardstick is the reference's own bf16 error: per
# leaf, ``e_ref`` = its largest distance from the same run in float32
# (the port in float32 from the same bf16 weights, which agrees with the
# reference in float32 to 2e-5 of a leaf, above).  Two runs that each
# stay within ``e_ref`` of the float32 run lie within ``2 e_ref`` of each
# other; one unit roundoff of the leaf's largest magnitude covers leaves
# the float32 run matches closely.  So, per leaf, the port's bf16 state
# lies within ``2 e_ref + 2^-8 max|leaf|`` of the reference's and of the
# float32 run (it rounds no worse than the reference).  A bf16
# accumulation where the reference keeps float32, or a cast in another
# place, would carry the port past that.  Loss within rtol 2^-8 and grad
# norm within rtol 2^-6 at every step.  (Measured: the port's distance
# is at most 0.85 of the bound; CHANGES.md.)
BF16_UNIT = 2.0 ** -8
BF16_STEPS = 3


def _state_tree(state, part):
    return state.params if part == "params" else getattr(state.dasha, part)


@pytest.mark.parametrize("variant", ["mvr", "finite_mvr"])
def test_trainer_bf16_matches_reference_within_its_rounding(variant):
    ref = reference_trainer_trajectory(1, variant, "sparse",
                                       dtype="bfloat16", steps=BF16_STEPS)
    bf, mets = port_trainer_trajectory(ref, 1, variant, "sparse", True,
                                       dtype="bfloat16", steps=BF16_STEPS)
    f32, _ = port_trainer_trajectory(ref, 1, variant, "sparse", True,
                                     dtype="float32", steps=BF16_STEPS)
    assert sum(float(ref[f"s{t}/participants"])
               for t in range(BF16_STEPS)) > 0
    for t, m in enumerate(mets):
        for f in ("bits_sent", "participants"):
            assert float(getattr(m, f)) == float(ref[f"s{t}/{f}"]), (t, f)
        np.testing.assert_allclose(float(m.loss), float(ref[f"s{t}/loss"]),
                                   rtol=BF16_UNIT, err_msg=f"step {t}")
        np.testing.assert_allclose(float(m.grad_norm),
                                   float(ref[f"s{t}/grad_norm"]),
                                   rtol=4 * BF16_UNIT, err_msg=f"step {t}")
    parts = ("params", "g", "g_i", "h_i") + (
        ("h_ij",) if variant == "finite_mvr" else ())
    for part in parts:
        for name, got in _state_tree(bf, part).items():
            assert got.dtype == torch.bfloat16, (part, name)
            want = np.asarray(ref[f"{part}/{name}"], np.float32)
            exact = to_numpy(_state_tree(f32, part)[name])
            got = to_numpy(got.float())
            e_ref = float(np.max(np.abs(want - exact)))
            bound = 2 * e_ref + BF16_UNIT * float(np.max(np.abs(want)))
            assert float(np.max(np.abs(got - want))) <= bound, (part, name)
            assert float(np.max(np.abs(got - exact))) <= bound, (part, name)


# ----------------------------------------------------------------------
# The engine alone: one node_update on a (4, 1) view of the same rows
# ----------------------------------------------------------------------

SHAPES = {"a": (3, 50), "b": (7,), "c": (2, 129)}   # tails at bs = 64


def _engine_inputs(n, seed):
    rng = np.random.default_rng(seed)
    grads = [{k: rng.standard_normal((n,) + s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(4)]
    state = [{k: rng.standard_normal((n,) + s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(2)]
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    return grads, state, g


@pytest.mark.parametrize("wire", sorted(TRAINER_WIRES))
@pytest.mark.parametrize("variant", ["gradient", "mvr", "page"])
def test_node_update_matches_reference_engine(variant, wire):
    """One node: the reference's shard_map on a 1x1 mesh (jitted), given
    grads, state and key; the port, fused and unfused, given the same
    arrays and the replayed draws.  Tolerance rtol = atol = 1e-6 (the
    same float32 operations; ``k / pa`` against ``k * (1/pa)`` in the
    fused path)."""
    n = 1
    agg, ratio = TRAINER_WIRES[wire]
    kw = dict(gamma=0.1, a=0.07, b=0.3, p_a=0.8, sampler="independent",
              compression_ratio=ratio, block_size=64, aggregation=agg,
              variant=variant, p_page=0.4)
    rcfg = ref_sharded.ShardedDashaConfig(data_axes=("data",),
                                          use_pallas=False, **kw)
    (gn, go, bn, bo), (h, gi), g = _engine_inputs(n, 7)
    mesh = make_mesh((1, 1), ("data", "model"))
    specs = {k: jax.sharding.PartitionSpec() for k in SHAPES}
    eng = ref_sharded.ShardedDasha(mesh, specs, rcfg)
    rstate = ref_sharded.ShardedDashaState(
        g={k: jnp.asarray(v) for k, v in g.items()},
        g_i={k: jnp.asarray(v) for k, v in gi.items()},
        h_i={k: jnp.asarray(v) for k, v in h.items()},
        step=jnp.asarray(3, jnp.int32))
    key = jax.random.key(11)
    extra = {}
    if variant == "page":
        extra = dict(mini_new=bn, mini_old=bo)
    rnew, rwire = jax.jit(
        lambda gn_, go_, st, k, ex: eng.node_update(gn_, go_, st, k, **ex)
    )(gn, go, rstate, key, extra)
    draws = sharded_reference_draws(rcfg, n, [(k, int(np.prod(s)))
                                               for k, s in SHAPES.items()],
                                    key, 3)

    def t(tree):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}

    for fused in (True, False):
        port = sharded.ShardedDasha(sharded.ShardedDashaConfig(fused=fused,
                                                               **kw),
                                    n, SHAPES)
        pstate = sharded.ShardedDashaState(g=t(g), g_i=t(gi), h_i=t(h),
                                           step=3)
        pextra = {k: t(v) for k, v in extra.items()}
        pnew, pwire = port.node_update(t(gn), t(go), pstate,
                                       port_sharded_draws(draws), **pextra)
        assert pnew.step == 4
        assert float(pwire.bits_sent) == float(rwire.bits_sent)
        assert float(pwire.participants) == float(rwire.participants)
        for f in ("g", "g_i", "h_i"):
            for k in SHAPES:
                np.testing.assert_allclose(
                    to_numpy(getattr(pnew, f)[k]),
                    np.array(getattr(rnew, f)[k]), rtol=1e-6, atol=1e-6,
                    err_msg=f"fused={fused} {f}/{k}")


def _finite_mvr_inputs(n, m, B, seed):
    """Component gradients (n, B, *shape) at x^{t+1} and x^t, and the
    trackers h_ij (n, m, *shape)."""
    rng = np.random.default_rng(seed)
    gn, go = ({k: rng.standard_normal((n, B) + s).astype(np.float32)
               for k, s in SHAPES.items()} for _ in range(2))
    h_ij = {k: rng.standard_normal((n, m) + s).astype(np.float32)
            for k, s in SHAPES.items()}
    return gn, go, h_ij


@pytest.mark.parametrize("wire", sorted(TRAINER_WIRES))
def test_finite_mvr_node_update_matches_reference_engine(wire):
    """One node, m = 3 components of which B = 2 are drawn: the
    reference's shard_map on a 1x1 mesh (jitted) given the component
    gradients, the state with ``h_ij`` and the key; the port, fused and
    unfused, given the same arrays and the replayed draws (the
    trainer's ``component_idx``).  Tolerance rtol = atol = 1e-6, as for
    the other variants above."""
    n, m, B = 1, 3, 2
    agg, ratio = TRAINER_WIRES[wire]
    kw = dict(gamma=0.1, a=0.07, b=0.3, p_a=0.8, sampler="independent",
              compression_ratio=ratio, block_size=64, aggregation=agg,
              variant="finite_mvr")
    rcfg = ref_sharded.ShardedDashaConfig(data_axes=("data",),
                                          use_pallas=False, **kw)
    _, (h, gi), g = _engine_inputs(n, 7)
    gn, go, h_ij = _finite_mvr_inputs(n, m, B, 8)
    mesh = make_mesh((1, 1), ("data", "model"))
    specs = {k: jax.sharding.PartitionSpec() for k in SHAPES}
    eng = ref_sharded.ShardedDasha(mesh, specs, rcfg)
    key = jax.random.key(11)
    draws = sharded_reference_draws(
        rcfg, n, [(k, int(np.prod(s))) for k, s in SHAPES.items()], key, 3,
        num_components=m, component_batch=B)
    rstate = ref_sharded.ShardedDashaState(
        g={k: jnp.asarray(v) for k, v in g.items()},
        g_i={k: jnp.asarray(v) for k, v in gi.items()},
        h_i={k: jnp.asarray(v) for k, v in h.items()},
        step=jnp.asarray(3, jnp.int32),
        h_ij={k: jnp.asarray(v) for k, v in h_ij.items()})
    rnew, rwire = jax.jit(
        lambda gn_, go_, st, k, ci: eng.node_update(gn_, go_, st, k,
                                                    component_idx=ci)
    )(gn, go, rstate, key, jnp.asarray(draws["component_idx"]))

    def t(tree):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}

    for fused in (True, False):
        port = sharded.ShardedDasha(sharded.ShardedDashaConfig(fused=fused,
                                                               **kw),
                                    n, SHAPES, num_components=m,
                                    component_batch=B)
        pstate = sharded.ShardedDashaState(g=t(g), g_i=t(gi), h_i=t(h),
                                           step=3, h_ij=t(h_ij))
        pnew, pwire = port.node_update(t(gn), t(go), pstate,
                                       port_sharded_draws(draws))
        assert pnew.step == 4
        assert float(pwire.bits_sent) == float(rwire.bits_sent)
        for f in ("g", "g_i", "h_i", "h_ij"):
            for k in SHAPES:
                np.testing.assert_allclose(
                    to_numpy(getattr(pnew, f)[k]),
                    np.array(getattr(rnew, f)[k]), rtol=1e-6, atol=1e-6,
                    err_msg=f"fused={fused} {f}/{k}")


@pytest.mark.parametrize("variant", ["mvr", "finite_mvr"])
def test_node_update_frees_each_leaf_before_the_next(monkeypatch, variant):
    """``node_update`` applies a leaf and drops its float32 rows before it
    computes the next one: at granite-3-2b's width one leaf's rows are
    gigabytes, and two leaves' at once raised the train step's peak by
    4.8 GB on the H100 (PERF.md)."""
    import weakref
    n = 2
    (gn, go, _, _), (h, gi), g = _engine_inputs(n, 4)
    cn, co, h_ij = _finite_mvr_inputs(n, 2, 1, 4)
    finite = variant == "finite_mvr"
    cfg = sharded.ShardedDashaConfig(gamma=0.1, a=0.07, b=0.3, p_a=1.0,
                                     compression_ratio=1 / 4, block_size=64,
                                     variant=variant)
    eng = sharded.ShardedDasha(cfg, n, SHAPES, num_components=2)

    def t(tree):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}

    held, calls = [], []
    leaf = sharded.ShardedDasha._leaf

    def watched(self, *args):
        calls.append([r for r in held if r() is not None])
        out = leaf(self, *args)
        held[:] = [weakref.ref(x) for x in out if x is not None]
        return out

    monkeypatch.setattr(sharded.ShardedDasha, "_leaf", watched)
    eng.node_update(*map(t, (cn, co) if finite else (gn, go)),
                    sharded.ShardedDashaState(t(g), t(gi), t(h), 0,
                                              t(h_ij) if finite else None),
                    eng.draw(torch.Generator().manual_seed(0)))
    assert len(calls) == len(SHAPES)
    assert not any(calls), "a leaf's rows were alive at the next leaf"
    assert not [r for r in held if r() is not None]


def test_page_takes_only_the_coins_pair():
    """PAGE given only the pair its coin takes equals PAGE given both
    (the other pair as zeros), as the reference's ``lax.cond`` feeds
    the kernel."""
    n = 3
    cfg = sharded.ShardedDashaConfig(gamma=0.1, a=0.07, b=0.3, p_a=0.8,
                                     compression_ratio=1 / 4, block_size=64,
                                     variant="page", p_page=0.4)
    (gn, go, bn, bo), (h, gi), g = _engine_inputs(n, 3)
    eng = sharded.ShardedDasha(cfg, n, SHAPES)

    def t(tree):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}

    zeros = {k: np.zeros_like(v) for k, v in gn.items()}
    draws = eng.draw(torch.Generator().manual_seed(1))
    for coin in (True, False):
        d = draws._replace(coin=coin)
        full = (gn, go, zeros, zeros) if coin else (zeros, zeros, bn, bo)
        both = sharded.ShardedDashaState(t(g), t(gi), t(h), 0)
        both, _ = eng.node_update(t(full[0]), t(full[1]), both, d,
                                  mini_new=t(full[2]), mini_old=t(full[3]))
        only = sharded.ShardedDashaState(t(g), t(gi), t(h), 0)
        if coin:
            only, _ = eng.node_update(t(gn), t(go), only, d)
        else:
            only, _ = eng.node_update(None, None, only, d, mini_new=t(bn),
                                      mini_old=t(bo))
        for f in ("g", "g_i", "h_i"):
            for k in SHAPES:
                assert torch.equal(getattr(both, f)[k], getattr(only, f)[k])
        fresh = sharded.ShardedDashaState(t(g), t(gi), t(h), 0)
        with pytest.raises(ValueError, match="coin takes"):
            if coin:
                eng.node_update(None, None, fresh, d, mini_new=t(bn),
                                mini_old=t(bo))
            else:
                eng.node_update(t(gn), t(go), fresh, d)


def test_dispatch_then_commit_equals_node_update():
    """MVR, and finite-MVR with its ``h_ij`` rows (m = 3, B = 2)."""
    n = 4
    (gn, go, _, _), (h, gi), g = _engine_inputs(n, 5)
    cn, co, h_ij = _finite_mvr_inputs(n, 3, 2, 6)

    def t(tree):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}

    for variant in ("mvr", "finite_mvr"):
        cfg = sharded.ShardedDashaConfig(gamma=0.1, a=0.07, b=0.3, p_a=0.5,
                                         compression_ratio=1 / 4,
                                         block_size=64, variant=variant)
        eng = sharded.ShardedDasha(cfg, n, SHAPES, num_components=3,
                                   component_batch=2)
        grads = (gn, go) if variant == "mvr" else (cn, co)
        hij = None if variant == "mvr" else h_ij

        def state():
            return sharded.ShardedDashaState(
                t(g), t(gi), t(h), 0, None if hij is None else t(hij))

        draws = eng.draw(torch.Generator().manual_seed(2))
        a = state()
        disp, wire = eng.dispatch(*map(t, grads), a, draws)
        a = eng.commit(a, disp)
        b, wire_b = eng.node_update(*map(t, grads), state(), draws)
        assert torch.equal(wire.bits_sent, wire_b.bits_sent)
        fields = ("g", "g_i", "h_i") + (("h_ij",) if hij else ())
        for f in fields:
            for k in SHAPES:
                assert torch.equal(getattr(a, f)[k], getattr(b, f)[k]), \
                    (variant, f, k)
        if hij:
            # the drawn rows of the participating nodes moved, no other
            moved = sum(not torch.equal(b.h_ij[k], t(hij)[k])
                        for k in SHAPES)
            assert moved == len(SHAPES) or not draws.mask.any()


# ----------------------------------------------------------------------
# Accounting, block helpers, draws, config
# ----------------------------------------------------------------------

@pytest.mark.parametrize("wire", sorted(TRAINER_WIRES))
def test_bits_match_reference_accounting(wire):
    agg, ratio = TRAINER_WIRES[wire]
    kw = dict(gamma=0.1, a=0.1, b=0.1, p_a=0.3, compression_ratio=ratio,
              aggregation=agg)
    mesh = make_mesh((1, 1), ("data", "model"))
    specs = {k: jax.sharding.PartitionSpec() for k in SHAPES}
    ref = ref_sharded.ShardedDasha(
        mesh, specs, ref_sharded.ShardedDashaConfig(data_axes=("data",),
                                                    **kw))
    port = sharded.ShardedDasha(sharded.ShardedDashaConfig(**kw), 4, SHAPES)
    h_i = {k: jnp.zeros((1,) + s) for k, s in SHAPES.items()}
    assert port.message_bits_per_node() == ref._per_node_message_bits(h_i)
    assert port.uplink_bits_per_round(20958) == \
        ref.uplink_bits_per_round(20958)


@pytest.mark.parametrize("d, bs", [(7, 7), (129, 64), (300, 128), (50, 50)])
def test_block_helpers_match_reference(d, bs):
    n, kb = 3, 2
    x, base = numpy_inputs(d, 2, (n, d))
    nb = -(-d // bs)
    rng = np.random.default_rng(d)
    idx = np.stack([rng.permutation(nb)[:min(kb, nb)] for _ in range(n)])
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    sel = variants.block_select(xt, it, bs)
    for i in range(n):
        vals, _ = ref_variants.block_randk_select(
            jax.random.key(0), x[i], min(kb, nb), bs)  # shape reference
        assert sel[i].shape == vals.shape
        blocks = np.pad(x[i], (0, nb * bs - d)).reshape(nb, bs)
        np.testing.assert_array_equal(to_numpy(sel[i]), blocks[idx[i]])
        np.testing.assert_array_equal(
            to_numpy(variants.block_scatter_rows(sel, it, d, bs)[i]),
            np.array(ref_variants.block_scatter_add(
                jnp.zeros(d), jnp.asarray(blocks[idx[i]]), idx[i], bs)))
    np.testing.assert_allclose(
        to_numpy(variants.block_scatter_add(torch.from_numpy(base[0]), sel,
                                            it, bs)),
        np.array(ref_variants.block_scatter_add(
            jnp.asarray(base[0]), jnp.asarray(to_numpy(sel)), idx, bs)),
        rtol=1e-6, atol=1e-6)


def test_draws_are_distinct_blocks_and_fair_participation():
    shapes = {"w": (1000, 128), "v": (64,)}
    cfg = sharded.ShardedDashaConfig(gamma=0.1, a=0.1, b=0.1, p_a=0.3,
                                     compression_ratio=1 / 16,
                                     variant="page", p_page=0.25)
    eng = sharded.ShardedDasha(cfg, 8, shapes)
    gen = torch.Generator().manual_seed(0)
    masks, coins = [], []
    for _ in range(200):
        d = eng.draw(gen)
        masks.append(d.mask.float())
        coins.append(d.coin)
        for name, shape in shapes.items():
            _, nb, kb = variants.block_plan(int(np.prod(shape)), 128,
                                            1 / 16)
            idx = d.block_idx[name]
            assert idx.shape == (8, kb)
            assert all(len(set(r.tolist())) == kb for r in idx)
            assert int(idx.min()) >= 0 and int(idx.max()) < nb
    assert abs(float(torch.stack(masks).mean()) - 0.3) < 0.05
    assert abs(np.mean(coins) - 0.25) < 0.1


def test_finite_mvr_raises_and_init_copies_the_trackers():
    """finite-MVR is accepted; its trackers must be sized (``h_ij0`` or
    ``num_components``), as the reference requires."""
    fm = sharded.ShardedDasha(sharded.ShardedDashaConfig(
        gamma=0.1, a=0.1, b=0.1, variant="finite_mvr"), 3, SHAPES)
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    with pytest.raises(ValueError, match="num_components"):
        fm.init_zero(params)
    with pytest.raises(ValueError, match="h_ij0"):
        fm.init({k: torch.zeros((3,) + s) for k, s in SHAPES.items()})
    with pytest.raises(ValueError, match="num_components"):
        fm.draw(torch.Generator().manual_seed(0))
    zero = fm.init_zero(params, num_components=5)
    for k, s in SHAPES.items():
        assert zero.h_ij[k].shape == (3, 5) + s and not zero.h_ij[k].any()
    eng = sharded.ShardedDasha(sharded.ShardedDashaConfig(
        gamma=0.1, a=0.1, b=0.1), 3, SHAPES)
    grads = {k: torch.from_numpy(v) for k, v in _engine_inputs(3, 1)[0][0]
             .items()}
    st = eng.init(grads)
    for k in SHAPES:
        assert torch.equal(st.g[k], grads[k].mean(dim=0))
        assert st.g_i[k] is grads[k] and torch.equal(st.h_i[k], grads[k])
        assert st.h_i[k].data_ptr() != st.g_i[k].data_ptr()
    assert st.step == 0 and st.h_ij is None


@pytest.mark.parametrize("variant", ["gradient", "page", "finite_mvr"])
def test_sparse_wire_goes_through_the_block_ops(monkeypatch, variant):
    """A spy on the op layer: per leaf, the fused sparse wire calls the
    tracker op and the payload-blocks op (finite-MVR: the tail and the
    block gather), the dense wires the batched update (finite-MVR: the
    tail), and every compressed wire the block scatter of each node's
    blocks into its row; nothing else."""
    calls = []
    names = ["dasha_update_batched_op", "dasha_page_update_op",
             "dasha_h_update_op", "dasha_page_h_update_op",
             "dasha_payload_blocks_op", "dasha_page_payload_blocks_op",
             "dasha_tail_op", "block_gather_op", "block_scatter_op"]
    for name in names:
        fn = getattr(ops, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    (gn, go, bn, bo), (h, gi), g = _engine_inputs(2, 9)

    def t(tree):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}

    page, finite = variant == "page", variant == "finite_mvr"
    dense = ("dasha_page_update_op" if page else
             "dasha_tail_op" if finite else "dasha_update_batched_op")
    sparse = (["dasha_page_h_update_op", "dasha_page_payload_blocks_op"]
              if page else ["dasha_tail_op", "block_gather_op"] if finite
              else ["dasha_h_update_op", "dasha_payload_blocks_op"])
    expect = {"sparse": sparse + ["block_scatter_op"],
              "dense_psum": [dense, "block_scatter_op"],
              "uncompressed": [dense]}
    if finite:
        gn, go, h_ij = _finite_mvr_inputs(2, 2, 1, 9)
    for wire, (agg, ratio) in TRAINER_WIRES.items():
        cfg = sharded.ShardedDashaConfig(gamma=0.1, a=0.1, b=0.1, p_a=0.5,
                                         compression_ratio=ratio,
                                         aggregation=agg, variant=variant,
                                         block_size=64)
        eng = sharded.ShardedDasha(cfg, 2, SHAPES, num_components=2)
        draws = eng.draw(torch.Generator().manual_seed(0))
        calls.clear()
        eng.node_update(t(gn), t(go),
                        sharded.ShardedDashaState(
                            t(g), t(gi), t(h), 0,
                            t(h_ij) if finite else None),
                        draws, **({"mini_new": t(bn), "mini_old": t(bo)}
                                  if page else {}))
        assert calls == expect[wire] * len(SHAPES), (wire, calls)
