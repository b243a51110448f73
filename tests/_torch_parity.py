"""Shared helpers of the PyTorch port's parity tests (not collected).

The reference draws all its randomness from JAX keys, which torch cannot
reproduce.  :func:`reference_draws` replays the reference engine's key
derivation (``DashaPP.run`` -> ``variants.round_keys`` -> sampler,
oracle and per-node compressor keys) and returns each round's draws as
numpy arrays, ready for :func:`repro_torch.convert.round_draws`.
"""
from __future__ import annotations

import os
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.core import variants as ref_variants
from repro.core.compressors import (BlockRandK, Identity, RandK,
                                    RandomDithering, TopK)
from repro.core.problems import sample_batch_indices


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One intra-op thread per xdist worker while a port test module
    runs, so the subprocess-mesh tests sharing the machine keep their
    headroom; the old value comes back afterwards."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def numpy_inputs(seed: int, count: int, shape) -> List[np.ndarray]:
    """``count`` float32 standard-normal arrays from one numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for _ in range(count)]


def _compressor_indices(comp, k_comp, n: int, d: int):
    keys = jax.vmap(lambda i: ref_variants.leaf_node_key(k_comp, 0, i))(
        jnp.arange(n))
    if isinstance(comp, (Identity, TopK)):
        return None
    if isinstance(comp, RandomDithering):
        return jax.vmap(lambda k: jax.random.uniform(k, (d,)))(keys)
    if isinstance(comp, RandK):
        if min(comp.k, d) == d:
            return None
        return jax.vmap(lambda k: comp._indices(k, d))(keys)
    if isinstance(comp, BlockRandK):
        _, nb, kb = comp._plan(d)
        return jax.vmap(
            lambda k: ref_variants.block_randk_indices(k, nb, kb))(keys)
    raise TypeError(f"no draw replay for {type(comp).__name__}")


def reference_draws(alg, key, num_rounds: int) -> List[Dict[str, object]]:
    """The draws ``alg.run(key, x0, num_rounds)`` consumes, per round, as
    keyword arguments of :func:`repro_torch.convert.round_draws`.  ``alg``
    is a ``DashaPP`` or anything with its ``problem``, ``cfg``,
    ``sampler`` and ``compressor`` that derives its round keys the same
    way (``AsyncDashaServer``; the fleet's ``DenseProblemWorkload``)."""
    p, cfg = alg.problem, alg.cfg
    _, run_key = jax.random.split(key)
    rounds = []
    for t in range(num_rounds):
        k_part, k_oracle, k_comp = ref_variants.round_keys(
            jax.random.fold_in(run_key, t))
        draws = {"mask": alg.sampler.sample(k_part)}
        if cfg.variant == "mvr":
            draws["batch_idx"] = sample_batch_indices(
                k_oracle, p.n, p.m, cfg.batch_size, replace=True)
        elif cfg.variant == "finite_mvr":
            draws["batch_idx"] = sample_batch_indices(
                k_oracle, p.n, p.m, cfg.batch_size, replace=False)
        elif cfg.variant == "page":
            k_coin, k_batch = ref_variants.page_keys(k_oracle)
            draws["coin"] = ref_variants.page_coin(k_coin, cfg.p_page)
            draws["batch_idx"] = sample_batch_indices(
                k_batch, p.n, p.m, cfg.batch_size, replace=cfg.replace)
        draws["comp_idx"] = _compressor_indices(alg.compressor, k_comp,
                                                p.n, p.d)
        rounds.append({k: None if v is None else np.array(v)
                       for k, v in draws.items()})
    return rounds


def to_numpy(x) -> np.ndarray:
    """A host copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.array(x)


# ----------------------------------------------------------------------
# Process state a test must leave as it found it
# ----------------------------------------------------------------------

def _process_state():
    """What one test could leak to the next test file of its xdist
    worker: the environment (``XLA_FLAGS`` above all), torch's default
    dtype and thread counts, and both packages' metrics registries and
    tracers (their identity and their contents)."""
    from repro.obs import metrics as ref_metrics
    from repro.obs import trace as ref_trace
    from repro_torch.obs import metrics as port_metrics
    from repro_torch.obs import trace as port_trace

    def registry(mod):
        reg = mod.get_registry()
        return id(reg), reg.snapshot()["metrics"]

    environ = dict(os.environ)
    environ.pop("PYTEST_CURRENT_TEST", None)   # pytest's own, per phase
    return {"environ": environ,
            "default_dtype": torch.get_default_dtype(),
            "threads": (torch.get_num_threads(),
                        torch.get_num_interop_threads()),
            "repro.obs registry": registry(ref_metrics),
            "repro_torch.obs registry": registry(port_metrics),
            "tracers": (id(ref_trace.get_tracer()),
                        id(port_trace.get_tracer()))}


@pytest.fixture
def process_hygiene():
    """Autouse it in a port test module (``pytestmark =
    pytest.mark.usefixtures("process_hygiene")``): the test fails if it
    leaves the process state of :func:`_process_state` changed.  What
    the two frameworks set once per process, whichever test comes
    first, is set before the snapshot: JAX's backend its ``TPU_*``
    variables, torch's non-reentrant checkpoint
    ``TORCHINDUCTOR_CACHE_DIR``."""
    jax.devices()
    x = torch.zeros(1, requires_grad=True)
    torch.utils.checkpoint.checkpoint(torch.exp, x,
                                      use_reentrant=False).backward()
    before = _process_state()
    yield
    after = _process_state()
    changed = sorted(k for k in before if before[k] != after[k])
    env = {k for k in set(before["environ"]) | set(after["environ"])
           if before["environ"].get(k) != after["environ"].get(k)}
    assert not changed, (f"the test left process state changed: "
                         f"{changed}; variables {sorted(env)}")


@pytest.fixture
def fresh_port_registry():
    """A fresh ``repro_torch.obs`` metrics registry for the test (the
    training loop sets ``train.*`` gauges); the old one comes back."""
    from repro_torch.obs import metrics as port_metrics
    old = port_metrics.get_registry()
    reg = port_metrics.set_registry(port_metrics.Registry())
    yield reg
    port_metrics.set_registry(old)


# ----------------------------------------------------------------------
# The sharded trainer's draws
# ----------------------------------------------------------------------

def sharded_reference_draws(dcfg, n: int, leaf_sizes, key, step: int, *,
                            num_components=None, component_batch: int = 1
                            ) -> Dict[str, object]:
    """The draws ``ShardedDasha.node_update(..., key)`` consumes at
    engine step ``step`` on a mesh with ``n`` nodes and model axis 1
    (``sharded.py:439-504``), as numpy arrays: ``mask`` (n,), ``coin``
    (PAGE), ``component_idx`` (n, B) (finite-MVR: the trainer's draw of
    ``component_batch`` of ``num_components`` examples per node,
    ``repro/training/trainer.py:251-256``), and ``block_idx`` {leaf:
    (n, kb)} for each of the ``(name, size)`` pairs of ``leaf_sizes`` in
    leaf order (compressed wires).  ``dcfg`` is the reference's
    ``ShardedDashaConfig``."""
    from repro.core import participation as ref_participation
    k_part, k_oracle, k_comp = ref_variants.round_keys(key,
                                                       jnp.asarray(step))
    nodes = jnp.arange(n)
    mask = jax.vmap(lambda i: ref_participation.participates(
        dcfg.sampler, k_part, i, n, dcfg.p_a))(nodes)
    out = {"mask": np.array(mask), "coin": None, "block_idx": None,
           "component_idx": None}
    if dcfg.variant == "page":
        out["coin"] = bool(ref_variants.page_coin(
            ref_variants.page_keys(k_oracle)[0], dcfg.p_page))
    if dcfg.variant == "finite_mvr":
        out["component_idx"] = np.array(sample_batch_indices(
            k_oracle, n, num_components, component_batch, replace=False))
    if dcfg.compression_ratio is not None:
        out["block_idx"] = {}
        for li, (name, size) in enumerate(leaf_sizes):
            _, nb, kb = ref_variants.block_plan(size, dcfg.block_size,
                                                dcfg.compression_ratio)
            out["block_idx"][name] = np.array(jax.vmap(
                lambda i: ref_variants.block_randk_indices(
                    ref_variants.leaf_node_key(k_comp, li, i), nb, kb)
            )(nodes))
    return out


def port_sharded_draws(draws: Dict[str, object], device="cpu"):
    """:func:`sharded_reference_draws`' arrays as the port's
    ``ShardedDraws``."""
    from repro_torch.core.sharded import ShardedDraws
    idx = draws["block_idx"]
    cidx = draws.get("component_idx")
    return ShardedDraws(
        mask=torch.from_numpy(np.array(draws["mask"], bool)).to(device),
        coin=draws["coin"],
        block_idx=None if idx is None else {
            k: torch.from_numpy(np.array(v, np.int64)).to(device)
            for k, v in idx.items()},
        component_idx=None if cidx is None else torch.from_numpy(
            np.array(cidx, np.int64)).to(device))


# ----------------------------------------------------------------------
# The LM trainer on both sides (tests/test_torch_sharded.py at one node,
# tests/test_torch_trainer.py at four, in a subprocess)
# ----------------------------------------------------------------------

TRAINER_SEED = 0
TRAINER_STEPS = 5
TRAINER_SEQ, TRAINER_PER_NODE = 32, 2
# smoke granite at d_model 96: the 192-element layer norms split into a
# full block of 128 and a tail of 64, so the wire's tail block is used
TRAINER_D_MODEL = 96
TRAINER_HP = dict(gamma=0.05, p_a=0.5, p_page=0.5, block_size=128)
# finite-MVR: each node's TRAINER_PER_NODE examples are its components,
# one drawn per round
TRAINER_COMPONENT_BATCH = 1
TRAINER_WIRES = {"sparse": ("sparse_allgather", 1 / 16),
                 "dense_psum": ("dense_psum", 1 / 16),
                 "uncompressed": ("sparse_allgather", None)}


def flat_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays as ``{dotted name: numpy copy}`` in
    ``jax.tree.leaves`` order."""
    out: Dict[str, np.ndarray] = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(flat_tree(tree[key], prefix + key + "."))
        else:
            out[prefix + key] = np.array(tree[key])
    return out


def _dasha_hp(ratio):
    omega = (1.0 / ratio - 1.0) if ratio else 0.0
    p_a = TRAINER_HP["p_a"]
    return dict(a=p_a / (2 * omega + 1), b=p_a / (2 - p_a))


def _fixed_batch(variant: str) -> bool:
    """The finite-sum variants train on one fixed batch per node."""
    return variant in ("gradient", "finite_mvr")


def _trainer_extra(variant: str) -> Dict[str, int]:
    """TrainerConfig fields of the variant: finite-MVR's ``m`` (the
    examples of a node) and ``B``."""
    if variant == "finite_mvr":
        return dict(num_components=TRAINER_PER_NODE,
                    component_batch=TRAINER_COMPONENT_BATCH)
    return {}


def reference_trainer_trajectory(n: int, variant: str, wire: str,
                                 server: str = "paper", *,
                                 dtype: str = "float32",
                                 steps: int = None
                                 ) -> Dict[str, np.ndarray]:
    """Run ``repro.training.Trainer`` for ``steps`` (default
    :data:`TRAINER_STEPS`) steps on an (n, 1) mesh in this process
    (which must hold ``n`` devices), the model in ``dtype``, and return,
    flat: ``init/<leaf>`` (the weights), per step ``t`` ``s<t>/mask``,
    ``s<t>/coin``, ``s<t>/cidx`` (finite-MVR), ``s<t>/idx/<leaf>``,
    ``s<t>/loss``, ``s<t>/grad_norm``, ``s<t>/bits_sent``,
    ``s<t>/participants``, and the final ``params/``, ``g/``, ``g_i/``,
    ``h_i/`` (and finite-MVR's ``h_ij/``) leaves."""
    from repro.compat import make_mesh, use_mesh
    from repro.core.sharded import ShardedDashaConfig
    from repro.data.sharding import place_batch
    from repro.data.synthetic import DataConfig, make_batch
    from repro.models import Model, get_smoke_config
    from repro.training.loop import round_train_key
    from repro.training.optim import adamw_server, paper_server
    from repro.training.trainer import Trainer, TrainerConfig

    mesh = make_mesh((n, 1), ("data", "model"))
    steps = TRAINER_STEPS if steps is None else steps
    cfg = get_smoke_config("granite-3-2b").with_overrides(
        d_model=TRAINER_D_MODEL, dtype=dtype)
    agg, ratio = TRAINER_WIRES[wire]
    dcfg = ShardedDashaConfig(
        gamma=TRAINER_HP["gamma"], p_a=TRAINER_HP["p_a"],
        sampler="independent", compression_ratio=ratio,
        block_size=TRAINER_HP["block_size"], aggregation=agg,
        data_axes=("data",), variant=variant, p_page=TRAINER_HP["p_page"],
        **_dasha_hp(ratio))
    opt = (paper_server(TRAINER_HP["gamma"]) if server == "paper"
           else adamw_server(lr=3e-3, warmup=3))
    tr = Trainer(Model(cfg), mesh, TrainerConfig(dasha=dcfg, server=opt,
                                                 **_trainer_extra(variant)))
    state = tr.init(jax.random.key(TRAINER_SEED))
    out = {f"init/{k}": v for k, v in flat_tree(state.params).items()}
    leaf_sizes = [(k, v.size) for k, v in flat_tree(state.params).items()]
    data = DataConfig(seq_len=TRAINER_SEQ, global_batch=TRAINER_PER_NODE * n,
                      num_nodes=n, vocab_size=cfg.vocab_size)
    step_fn = tr.jit_train_step(make_batch(cfg, data, 0))
    with use_mesh(mesh):
        for t in range(steps):
            batch = make_batch(cfg, data, 0 if _fixed_batch(variant) else t)
            key = round_train_key(TRAINER_SEED, t)
            draws = sharded_reference_draws(
                dcfg, n, leaf_sizes, key, t,
                num_components=TRAINER_PER_NODE,
                component_batch=TRAINER_COMPONENT_BATCH)
            out[f"s{t}/mask"] = draws["mask"]
            out[f"s{t}/coin"] = np.array(draws["coin"] is True)
            if draws["component_idx"] is not None:
                out[f"s{t}/cidx"] = draws["component_idx"]
            for k, v in (draws["block_idx"] or {}).items():
                out[f"s{t}/idx/{k}"] = v
            state, m = step_fn(state, place_batch(batch, mesh, ("data",)),
                               key)
            for f in ("loss", "grad_norm", "bits_sent", "participants"):
                out[f"s{t}/{f}"] = np.array(getattr(m, f))
    for part, tree in (("params", state.params), ("g", state.dasha.g),
                       ("g_i", state.dasha.g_i), ("h_i", state.dasha.h_i),
                       ("h_ij", state.dasha.h_ij)):
        if tree is not None:
            out.update({f"{part}/{k}": v
                        for k, v in flat_tree(tree).items()})
    return out


def port_trainer_trajectory(ref: Dict[str, np.ndarray], n: int,
                            variant: str, wire: str, fused: bool,
                            server: str = "paper", *,
                            dtype: str = "float32", steps: int = None):
    """The port's trainer from the reference's weights, on the CPU, fed
    the reference's batches and draws (the keys of ``ref``), for
    ``steps`` (default :data:`TRAINER_STEPS`) steps in ``dtype``.
    Returns ``(final TrainState, per-step metrics)``."""
    from repro_torch.core.sharded import ShardedDashaConfig
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.models import Model, get_smoke_config
    from repro_torch.training.loop import to_device
    from repro_torch.training.optim import adamw_server, paper_server
    from repro_torch.training.trainer import Trainer, TrainerConfig

    from repro_torch.convert import tensor

    steps = TRAINER_STEPS if steps is None else steps
    cfg = get_smoke_config("granite-3-2b").with_overrides(
        d_model=TRAINER_D_MODEL, dtype=dtype)
    agg, ratio = TRAINER_WIRES[wire]
    dcfg = ShardedDashaConfig(
        gamma=TRAINER_HP["gamma"], p_a=TRAINER_HP["p_a"],
        sampler="independent", compression_ratio=ratio,
        block_size=TRAINER_HP["block_size"], aggregation=agg,
        variant=variant, p_page=TRAINER_HP["p_page"], fused=fused,
        **_dasha_hp(ratio))
    opt = (paper_server(TRAINER_HP["gamma"]) if server == "paper"
           else adamw_server(lr=3e-3, warmup=3))
    params = {k[len("init/"):]: tensor(v, "cpu", cfg.param_dtype)
              for k, v in ref.items() if k.startswith("init/")}
    tr = Trainer(Model(cfg, params),
                 TrainerConfig(dasha=dcfg, server=opt,
                               **_trainer_extra(variant)), num_nodes=n)
    state = tr.init()
    data = DataConfig(seq_len=TRAINER_SEQ, global_batch=TRAINER_PER_NODE * n,
                      num_nodes=n, vocab_size=cfg.vocab_size)
    mets = []
    for t in range(steps):
        batch = to_device(make_batch(cfg, data,
                                     0 if _fixed_batch(variant) else t),
                          "cpu")
        prefix = f"s{t}/idx/"
        idx = {k[len(prefix):]: v for k, v in ref.items()
               if k.startswith(prefix)}
        draws = port_sharded_draws(dict(
            mask=ref[f"s{t}/mask"],
            coin=bool(ref[f"s{t}/coin"]) if variant == "page" else None,
            block_idx=idx or None, component_idx=ref.get(f"s{t}/cidx")))
        state, m = tr.train_step(state, batch, draws)
        mets.append(m)
    return state, mets


# The float32 noise of one per-node gradient is about 1.3e-6 of its
# leaf's largest value on either side (each against a float64 run of
# the port, smoke granite at four nodes).  It enters h_i and g_i through
# k / p_a twice a step (gn and go, p_a = 1/2) and adds over the five
# steps: about 1.6e-5 of the leaf's largest magnitude for the worst
# element.  At 1e-5 single elements of the four-node gradient variant
# fail by a few percent (1.03x); 2e-5 holds the rest of the bound.
TRAINER_ATOL = 2e-5


def assert_trainer_parity(ref: Dict[str, np.ndarray], state, mets) -> None:
    """Params, g, g_i, h_i (and finite-MVR's h_ij) within rtol 1e-4 and
    atol TRAINER_ATOL x the leaf's largest magnitude; loss and grad norm
    within rtol 1e-4; bits and participants equal."""
    for t, m in enumerate(mets):
        for f in ("bits_sent", "participants"):
            assert float(getattr(m, f)) == float(ref[f"s{t}/{f}"]), (t, f)
        for f in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(getattr(m, f)),
                                       float(ref[f"s{t}/{f}"]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {t} {f}")
    trees = {"params": state.params, "g": state.dasha.g,
             "g_i": state.dasha.g_i, "h_i": state.dasha.h_i}
    if state.dasha.h_ij is not None:
        trees["h_ij"] = state.dasha.h_ij
    for part, tree in trees.items():
        for name, got in tree.items():
            want = ref[f"{part}/{name}"]
            scale = max(float(np.max(np.abs(want))), 1e-30)
            np.testing.assert_allclose(to_numpy(got), want, rtol=1e-4,
                                       atol=TRAINER_ATOL * scale,
                                       err_msg=f"{part}/{name}")
