"""The port's LM trainer (``repro_torch.training``,
``python -m repro_torch.launch.train``) against the JAX package at four
nodes, and its loop, CLI (finite-MVR, the memory estimate) and state
conversion.

Four nodes: one module-scoped subprocess with four host devices (XLA
pinned to one thread, its own timeout) runs ``repro.training.Trainer``
on a (4, 1) mesh for every variant and wire and writes the trajectories
to ``.npz`` files in a temporary directory; the port then runs from the
same weights, batches and draws, fused and unfused.  Tolerance as in
``tests/test_torch_sharded.py``: params, ``g``, ``g_i`` and ``h_i``
within rtol 1e-4 and atol 2e-5 x the leaf's largest magnitude; bits and
participants exactly equal.
"""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import (TRAINER_WIRES, assert_trainer_parity,  # noqa: F401
                           fresh_port_registry, port_trainer_trajectory,
                           process_hygiene, to_numpy, torch_one_thread)

import jax

from repro_torch import convert
from repro_torch.launch import train as train_cli
from repro_torch.training import loop

pytestmark = pytest.mark.usefixtures("process_hygiene")

REPO = Path(__file__).resolve().parent.parent
NODES = 4
VARIANTS = ("gradient", "mvr", "page", "finite_mvr")


@pytest.fixture(scope="module")
def four_node_runs(tmp_path_factory):
    """{(variant, wire): reference trajectory} from one subprocess."""
    out = tmp_path_factory.mktemp("ref_trainer")
    code = f"""
        import sys
        sys.path.insert(0, {str(REPO / "tests")!r})
        import numpy as np
        from _torch_parity import TRAINER_WIRES, reference_trainer_trajectory
        for variant in {VARIANTS!r}:
            for wire in sorted(TRAINER_WIRES):
                run = reference_trainer_trajectory({NODES}, variant, wire)
                np.savez({str(out)!r} + f"/{{variant}}_{{wire}}.npz", **run)
        print("OK")
    """
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NODES} "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=900,
                          env=env, cwd=REPO)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr
    runs = {}
    for variant in VARIANTS:
        for wire in TRAINER_WIRES:
            with np.load(out / f"{variant}_{wire}.npz") as f:
                runs[variant, wire] = dict(f)
    return runs


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("wire", sorted(TRAINER_WIRES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_trainer_matches_reference_four_nodes(four_node_runs, variant, wire,
                                              fused):
    ref = four_node_runs[variant, wire]
    state, mets = port_trainer_trajectory(ref, NODES, variant, wire, fused)
    assert_trainer_parity(ref, state, mets)


def test_four_node_runs_cover_the_draws(four_node_runs):
    """Partial participation varies across nodes and steps, and PAGE
    takes both branches."""
    ref = four_node_runs["mvr", "sparse"]
    parts = [float(ref[f"s{t}/participants"]) for t in range(5)]
    assert 0 < min(parts) and len(set(parts)) > 1
    page = four_node_runs["page", "sparse"]
    assert {bool(page[f"s{t}/coin"]) for t in range(5)} == {True, False}


# ----------------------------------------------------------------------
# Loop, CLI, conversion
# ----------------------------------------------------------------------

def _smoke_args(*extra):
    return train_cli.build_parser().parse_args(
        ["--device", "cpu", "--smoke", *extra])


def test_loop_resumes_from_the_global_step(fresh_port_registry):
    """Three steps in one call equal two and then one: the round draws
    come from ``seed + global step``.  The ``train.*`` gauges add up the
    wire ledger."""
    args = _smoke_args("--variant", "page", "--p-page", "0.5")
    finals = []
    for chunks in ((3,), (2, 1)):
        trainer, state, data, arch = train_cli.build_trainer(args)
        stream = train_cli.batches(args, arch, data)
        for steps in chunks:
            state = loop.train(trainer, state, stream, steps, seed=5,
                               device="cpu", log_every=100)
        finals.append(state)
    assert finals[0].step == finals[1].step == 3
    for k in finals[0].params:
        assert torch.equal(finals[0].params[k], finals[1].params[k]), k
        assert torch.equal(finals[0].dasha.h_i[k], finals[1].dasha.h_i[k])
    reg = fresh_port_registry
    assert reg.gauge("train.steps").value == 1.0
    assert reg.gauge("train.oracle_calls").value >= 0.0
    assert np.isfinite(reg.gauge("train.loss").value)


def test_train_cli_prints_the_reference_rows(capsys, fresh_port_registry):
    assert train_cli.main(["--device", "cpu", "--smoke", "--steps",
                           "2"]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[step")]
    assert len(rows) == 1
    assert re.fullmatch(r"\[step +0\] wall_s=\S+ loss=\S+ grad_norm=\S+ "
                        r"bits_sent=\S+ participants=\S+", rows[0]), rows
    assert fresh_port_registry.gauge("train.steps").value == 2.0


def test_train_cli_defaults_to_the_card_and_refuses_finite_mvr():
    """The CLI runs on the card unless the CPU is asked for.  It no
    longer refuses finite-MVR: ``m`` is the global batch over the nodes
    and the trackers ``h_ij`` are zero."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.build_trainer(train_cli.build_parser().parse_args(
            ["--smoke"]))
    trainer, state, data, _ = train_cli.build_trainer(
        _smoke_args("--variant", "finite_mvr", "--component-batch", "2"))
    assert trainer.engine.num_components == data.per_node == 2
    assert trainer.engine.component_batch == 2
    for k, p in state.params.items():
        assert state.dasha.h_ij[k].shape == (4, 2) + tuple(p.shape)
        assert not state.dasha.h_ij[k].any()


def test_train_state_from_jax_continues_the_reference():
    """A reference TrainState after two gradient-variant steps (cache
    filled) converts, and one more step on each side agrees."""
    from repro.compat import make_mesh, use_mesh
    from repro.core.sharded import ShardedDashaConfig as RefDashaConfig
    from repro.data.sharding import place_batch
    from repro.data.synthetic import DataConfig, make_batch
    from repro.models import Model as RefModel
    from repro.models import get_smoke_config
    from repro.training.optim import adamw_server as ref_adamw
    from repro.training.trainer import Trainer as RefTrainer
    from repro.training.trainer import TrainerConfig as RefTrainerConfig
    from _torch_parity import (flat_tree, port_sharded_draws,
                               sharded_reference_draws)
    from repro_torch.core.sharded import ShardedDashaConfig
    from repro_torch.models import Model
    from repro_torch.models import get_smoke_config as port_smoke
    from repro_torch.training.optim import adamw_server
    from repro_torch.training.trainer import Trainer, TrainerConfig

    kw = dict(gamma=0.0, a=0.05, b=0.3, p_a=0.9, compression_ratio=1 / 8,
              block_size=64, variant="gradient")
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = get_smoke_config("granite-3-2b").with_overrides(d_model=64)
    rcfg = RefDashaConfig(data_axes=("data",), **kw)
    rtr = RefTrainer(RefModel(cfg), mesh, RefTrainerConfig(
        dasha=rcfg, server=ref_adamw(lr=3e-3, warmup=3)))
    state = rtr.init(jax.random.key(1))
    batch = make_batch(cfg, DataConfig(seq_len=16, global_batch=2,
                                       num_nodes=1,
                                       vocab_size=cfg.vocab_size), 0)
    step = rtr.jit_train_step(batch)
    with use_mesh(mesh):
        placed = place_batch(batch, mesh, ("data",))
        for t in range(2):
            state, _ = step(state, placed, jax.random.key(t))
        port_state = convert.train_state_from_jax(state, "cpu")
        assert port_state.step == 2 and port_state.dasha.step == 2
        assert port_state.cache is not None
        leaf_sizes = [(k, v.size) for k, v in flat_tree(state.params).items()]
        draws = sharded_reference_draws(rcfg, 1, leaf_sizes,
                                        jax.random.key(2), 2)
        state, m = step(state, placed, jax.random.key(2))
    trainer = Trainer(
        Model(port_smoke("granite-3-2b").with_overrides(d_model=64),
              port_state.params),
        TrainerConfig(dasha=ShardedDashaConfig(**kw),
                      server=adamw_server(lr=3e-3, warmup=3)), num_nodes=1)
    port_state, pm = trainer.train_step(
        port_state, {"tokens": torch.from_numpy(batch["tokens"])},
        port_sharded_draws(draws))
    assert float(pm.bits_sent) == float(m.bits_sent)
    for part, tree in (("params", port_state.params),
                       ("h_i", port_state.dasha.h_i)):
        want = flat_tree(state.params if part == "params"
                         else state.dasha.h_i)
        for k, got in tree.items():
            np.testing.assert_allclose(to_numpy(got), want[k], rtol=1e-4,
                                       atol=1e-5 * float(np.max(np.abs(
                                           want[k])) or 1.0), err_msg=k)


def test_train_cli_runs_finite_mvr(capsys, fresh_port_registry):
    assert train_cli.main(["--device", "cpu", "--smoke", "--variant",
                           "finite_mvr", "--steps", "2"]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[step")]
    assert len(rows) == 1
    assert re.fullmatch(r"\[step +0\] wall_s=\S+ loss=\S+ grad_norm=\S+ "
                        r"bits_sent=\S+ participants=\S+", rows[0]), rows


def test_finite_mvr_trains_on_a_fixed_batch_and_checks_its_components():
    """Finite-MVR's components are the examples of a node's fixed batch
    (as for the gradient variant); ``component_batch`` must lie in
    ``[1, m]``, as the reference requires."""
    args = _smoke_args("--variant", "finite_mvr")
    _, _, data, arch = train_cli.build_trainer(args)
    stream = train_cli.batches(args, arch, data)
    first = next(stream)["tokens"]
    assert np.array_equal(first, next(stream)["tokens"])
    with pytest.raises(ValueError, match="component_batch"):
        train_cli.build_trainer(_smoke_args("--variant", "finite_mvr",
                                            "--component-batch", "3"))


GB = 10 ** 9


def test_memory_estimate_refuses_the_whole_model_and_admits_the_cut():
    """40 layers at ``train_4k`` (global batch 256) need far more than an
    80 GB card; ``--layers 8 --global-batch 8`` fits, every variant and
    wire.  On a CUDA device ``build_trainer`` refuses, before it
    allocates, what the card cannot hold, naming both byte counts."""
    whole = train_cli.build_parser().parse_args([])
    assert train_cli.estimate_for(whole) > 80 * GB
    for variant in VARIANTS:
        for agg in ("sparse_allgather", "dense_psum"):
            cut = train_cli.build_parser().parse_args(
                ["--layers", "8", "--global-batch", "8", "--variant",
                 variant, "--aggregation", agg])
            est = train_cli.estimate_for(cut)
            assert 40 * GB < est < 80 * GB, (variant, agg, est)
    card = torch.device("cuda", 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "mem_get_info",
                   lambda device=None: (79 * GB, 80 * GB))
        train_cli.check_fits(train_cli.estimate_for(cut), card)
        with pytest.raises(RuntimeError, match=str(80 * GB)) as err:
            train_cli.check_fits(train_cli.estimate_for(whole), card)
        assert str(train_cli.estimate_for(whole)) in str(err.value)
    train_cli.check_fits(train_cli.estimate_for(whole),
                         torch.device("cpu"))


def test_memory_estimate_counts_the_state_it_names():
    """The estimate grows by exactly the bytes of what it names: a
    finite-MVR component tracker per node and example, a layer's
    parameters in every copy."""
    from repro_torch.models import count_params, get_smoke_config, \
        init_params
    arch = get_smoke_config("granite-3-2b").with_overrides(dtype="bfloat16")
    p = count_params(init_params(arch, torch.Generator().manual_seed(0),
                                 "cpu"))
    est = train_cli.estimate_train_bytes

    def fm(gbatch):
        return est(arch, 4, gbatch, 64, "finite_mvr", "sparse_allgather")

    # one more example per node: 4 more trackers h_ij (bf16) and one
    # more example's activations, which depend on the batch only
    # through the examples of one backward pass (one, for finite-MVR)
    assert fm(12) - fm(8) == 4 * p * 2
    two = est(arch.with_overrides(num_layers=2), 4, 8, 64, "mvr",
              "sparse_allgather")
    one = est(arch.with_overrides(num_layers=1), 4, 8, 64, "mvr",
              "sparse_allgather")
    assert two > one


def test_train_state_from_jax_carries_the_component_trackers():
    """A reference finite-MVR TrainState after two steps converts with its
    ``h_ij``, and one more step on each side agrees."""
    from repro.compat import make_mesh, use_mesh
    from repro.core.sharded import ShardedDashaConfig as RefDashaConfig
    from repro.data.sharding import place_batch
    from repro.data.synthetic import DataConfig, make_batch
    from repro.models import Model as RefModel
    from repro.models import get_smoke_config
    from repro.training.optim import paper_server as ref_paper
    from repro.training.trainer import Trainer as RefTrainer
    from repro.training.trainer import TrainerConfig as RefTrainerConfig
    from _torch_parity import (flat_tree, port_sharded_draws,
                               sharded_reference_draws)
    from repro_torch.core.sharded import ShardedDashaConfig
    from repro_torch.models import Model
    from repro_torch.models import get_smoke_config as port_smoke
    from repro_torch.training.optim import paper_server
    from repro_torch.training.trainer import Trainer, TrainerConfig

    kw = dict(gamma=0.05, a=0.05, b=0.3, p_a=0.9, compression_ratio=1 / 8,
              block_size=64, variant="finite_mvr")
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = get_smoke_config("granite-3-2b").with_overrides(d_model=64)
    rcfg = RefDashaConfig(data_axes=("data",), **kw)
    rtr = RefTrainer(RefModel(cfg), mesh, RefTrainerConfig(
        dasha=rcfg, server=ref_paper(0.05), num_components=2,
        component_batch=1))
    state = rtr.init(jax.random.key(1))
    batch = make_batch(cfg, DataConfig(seq_len=16, global_batch=2,
                                       num_nodes=1,
                                       vocab_size=cfg.vocab_size), 0)
    step = rtr.jit_train_step(batch)
    with use_mesh(mesh):
        placed = place_batch(batch, mesh, ("data",))
        for t in range(2):
            state, _ = step(state, placed, jax.random.key(t))
        port_state = convert.train_state_from_jax(state, "cpu")
        assert port_state.dasha.h_ij is not None
        leaf_sizes = [(k, v.size) for k, v in flat_tree(state.params).items()]
        draws = sharded_reference_draws(rcfg, 1, leaf_sizes,
                                        jax.random.key(2), 2,
                                        num_components=2)
        state, m = step(state, placed, jax.random.key(2))
    trainer = Trainer(
        Model(port_smoke("granite-3-2b").with_overrides(d_model=64),
              port_state.params),
        TrainerConfig(dasha=ShardedDashaConfig(**kw),
                      server=paper_server(0.05), num_components=2),
        num_nodes=1)
    port_state, pm = trainer.train_step(
        port_state, {"tokens": torch.from_numpy(batch["tokens"])},
        port_sharded_draws(draws))
    assert float(pm.bits_sent) == float(m.bits_sent)
    for part, tree in (("params", port_state.params),
                       ("h_ij", port_state.dasha.h_ij)):
        want = flat_tree(state.params if part == "params"
                         else state.dasha.h_ij)
        for k, got in tree.items():
            np.testing.assert_allclose(to_numpy(got), want[k], rtol=1e-4,
                                       atol=1e-5 * float(np.max(np.abs(
                                           want[k])) or 1.0), err_msg=k)
