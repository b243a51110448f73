"""The port's model zoo (``repro_torch.models``, granite-3-2b) and its
data copy against the JAX package, on the CPU at smoke size.

Weights are the reference's (``Model.init_params``), carried across by
``repro_torch.convert.params_from_jax``.  Tolerances:

* logits and loss: rtol 1e-5, atol 1e-5 (float32 both sides; the
  matmuls sum in another order in XLA's and torch's CPU kernels);
* per-node gradients: rtol 1e-4, atol 1e-6 (the backward pass adds the
  same reordering once more and the loss is an average of 2 x 31
  cross entropies);
* attention, RMSNorm, RoPE: rtol 1e-5, atol 1e-6;
* the blockwise attention's skip of wholly future key blocks, and the
  layer checkpointing: exact.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_parity import (flat_tree, numpy_inputs, process_hygiene,  # noqa: F401
                           to_numpy, torch_one_thread)

import jax

from repro.core.sharded import per_node_value_and_grads as ref_pnvg
from repro.data import synthetic as ref_synthetic
from repro.models import Model as RefModel
from repro.models import common as ref_common
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro_torch import convert
from repro_torch.data import synthetic
from repro_torch.models import (INPUT_SHAPES, Model, count_params,
                                get_config, get_smoke_config, layers,
                                leaf_names, param_shapes)
from repro_torch.training.trainer import per_node_value_and_grads

pytestmark = pytest.mark.usefixtures("process_hygiene")

ARCH = "granite-3-2b"


def _cfgs(d_model):
    return (ref_registry.get_smoke_config(ARCH).with_overrides(
                d_model=d_model),
            get_smoke_config(ARCH).with_overrides(d_model=d_model))


@pytest.fixture(scope="module", params=[64, 128])
def smoke_pair(request):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg, pcfg = _cfgs(request.param)
    rparams = RefModel(rcfg).init_params(jax.random.key(request.param))
    return rcfg, pcfg, rparams, convert.params_from_jax(rparams, "cpu")


def _tokens(seed, n, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (n, b, t)).astype(
        np.int32)


# ----------------------------------------------------------------------
# Configs and parameters
# ----------------------------------------------------------------------

def test_config_and_shapes_match_reference():
    ref, port = ref_registry.get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert dataclasses.asdict(ref.smoke()) == dataclasses.asdict(
        get_smoke_config(ARCH))
    assert port.padded_vocab == ref.padded_vocab == 49408
    assert port.param_dtype == torch.bfloat16
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v)
         for k, v in ref_registry.INPUT_SHAPES.items()}


def test_unported_architectures_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("llama3-405b")
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("layers_", [2, 8])
def test_leaf_order_and_shapes_match_reference(layers_):
    """The names and shapes in ``jax.tree.leaves`` order, at smoke size
    and at granite-3-2b's full width (8 layers, shapes only)."""
    for cfg_ref, cfg in ((ref_registry.get_smoke_config(ARCH),
                          get_smoke_config(ARCH)),
                         (ref_registry.get_config(ARCH),
                          get_config(ARCH))):
        cfg_ref = cfg_ref.with_overrides(num_layers=layers_)
        cfg = cfg.with_overrides(num_layers=layers_)
        shapes = jax.eval_shape(RefModel(cfg_ref).init_params,
                                jax.random.key(0))
        want = {k: tuple(v.shape) for k, v in flat_tree(
            jax.tree.map(lambda s: np.zeros(0), shapes)).items()}
        want = {k: tuple(getattr(shapes_leaf, "shape"))
                for k, shapes_leaf in zip(want, jax.tree.leaves(shapes))}
        assert param_shapes(cfg) == want
        assert leaf_names(cfg) == list(want)
        assert count_params({k: SimpleNamespace(shape=s)
                             for k, s in want.items()}) == \
            ref_common.count_params(shapes)


def test_model_holds_the_reference_names(smoke_pair):
    _, pcfg, _, params = smoke_pair
    model = Model(pcfg, params)
    assert {k for k, _ in model.named_parameters()} == set(params)
    assert list(model.params()) == list(params)
    assert all(model.params()[k] is params[k] or torch.equal(
        model.params()[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="expected parameters"):
        Model(pcfg, dict(reversed(list(params.items()))))


# ----------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------

def test_rmsnorm_and_rope_match_reference():
    x, s = numpy_inputs(3, 2, (2, 5, 4, 16))
    np.testing.assert_allclose(
        to_numpy(layers.rmsnorm(torch.from_numpy(x),
                                torch.from_numpy(s[0, 0, 0]))),
        np.array(ref_layers.rmsnorm(x, s[0, 0, 0])), rtol=1e-5, atol=1e-6)
    pos = np.arange(5)
    np.testing.assert_allclose(
        to_numpy(layers.apply_rope(torch.from_numpy(x),
                                   torch.from_numpy(pos), 10_000.0)),
        np.array(ref_layers.apply_rope(x, pos, 10_000.0)), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("T", [40, 64])
def test_blockwise_attention_matches_reference(T, window):
    """Blocks of 16 queries and 16 keys (40 pads the last block);
    against the reference's blockwise form and the dense-mask form."""
    q, = numpy_inputs(T, 1, (2, T, 4, 8))
    k, v = numpy_inputs(T + 1, 2, (2, T, 2, 8))
    pos = np.arange(T)
    kw = dict(causal=True, window=window, q_block=16, k_block=16)
    want = np.array(jax.jit(lambda *a: ref_layers.blockwise_gqa_attention(
        *a, **kw))(q, k, v, pos, pos))
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    for ordered in (False, True):
        got = layers.blockwise_gqa_attention(tq, tk, tv, tp, tp,
                                             ordered=ordered, **kw)
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5,
                                   atol=1e-6)
    skipped = layers.blockwise_gqa_attention(tq, tk, tv, tp, tp,
                                             ordered=True, **kw)
    assert torch.equal(skipped, layers.blockwise_gqa_attention(
        tq, tk, tv, tp, tp, ordered=False, **kw))
    mask = layers.attention_weights_mask(tp, tp, True, window)
    np.testing.assert_allclose(
        to_numpy(layers.gqa_attention(tq, tk, tv, mask)), want, rtol=1e-5,
        atol=1e-6)


def test_blockwise_attention_gradients_match_dense_form():
    """The per-block checkpointed backward against autograd through the
    dense-mask form."""
    T = 40
    q, = numpy_inputs(5, 1, (1, T, 4, 8))
    k, v = numpy_inputs(6, 2, (1, T, 2, 8))
    pos = torch.arange(T)
    grads = []
    for blockwise in (True, False):
        ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        if blockwise:
            out = layers.blockwise_gqa_attention(
                *ins, pos, pos, causal=True, window=None, q_block=16,
                k_block=16, ordered=True)
        else:
            out = layers.gqa_attention(
                *ins, layers.attention_weights_mask(pos, pos, True, None))
        grads.append(torch.autograd.grad(torch.sum(out * out), ins))
    for a, b in zip(*grads):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=1e-5,
                                   atol=1e-6)


def test_attention_block_long_sequence_path():
    """T > 1024 takes the blockwise path on both sides."""
    rcfg, pcfg = _cfgs(64)
    rcfg = rcfg.with_overrides(num_heads=2, num_kv_heads=1, head_dim=8)
    pcfg = pcfg.with_overrides(num_heads=2, num_kv_heads=1, head_dim=8)
    T = 1100
    x, = numpy_inputs(8, 1, (1, T, 64))
    # weights scaled as dense_init scales them (1/sqrt(d_in))
    p = {k: v / 8 for k, v in zip(("wq", "wk", "wv", "wo"), numpy_inputs(
        9, 4, (64, 16)))}
    p["wk"], p["wv"] = p["wk"][:, :8], p["wv"][:, :8]
    p["wo"] = np.ascontiguousarray(p["wo"].T)
    pos = np.arange(T)
    want = np.array(jax.jit(lambda x_, p_: ref_layers.attention_block(
        p_, x_, pos, rcfg)[0])(x, p))
    got = layers.attention_block({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 torch.from_numpy(x), torch.arange(T), pcfg)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

def test_logits_and_loss_match_reference(smoke_pair):
    rcfg, pcfg, rparams, params = smoke_pair
    toks = _tokens(1, 1, 2, 32, rcfg.vocab_size)[0]
    ref = RefModel(rcfg)
    logits, _ = jax.jit(ref.forward)(rparams, {"tokens": toks})
    loss = jax.jit(ref.loss)(rparams, {"tokens": toks})
    model = Model(pcfg, params)
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        np.testing.assert_allclose(to_numpy(model(batch)), np.array(logits),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(model.loss(params, batch)),
                                   float(loss), rtol=1e-5, atol=1e-5)


def test_per_node_gradients_match_reference(smoke_pair):
    rcfg, pcfg, rparams, params = smoke_pair
    toks = _tokens(2, 3, 2, 32, rcfg.vocab_size)
    ref = RefModel(rcfg)
    losses, grads = jax.jit(lambda p, b: ref_pnvg(ref.loss, p, b))(
        rparams, {"tokens": toks})
    model = Model(pcfg, params)
    got_l, got_g = per_node_value_and_grads(
        model.loss, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(to_numpy(got_l), np.array(losses),
                               rtol=1e-4, atol=1e-6)
    want = flat_tree(grads)
    assert list(got_g) == list(want)
    for k, g in got_g.items():
        assert g.shape == want[k].shape
        np.testing.assert_allclose(to_numpy(g), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_layer_checkpointing_changes_nothing(smoke_pair):
    _, pcfg, _, params = smoke_pair
    toks = {"tokens": torch.from_numpy(_tokens(4, 2, 2, 16,
                                               pcfg.vocab_size))}
    plain = per_node_value_and_grads(Model(pcfg, params).loss, params, toks)
    remat_cfg = pcfg.with_overrides(remat=True)
    remat = per_node_value_and_grads(Model(remat_cfg, params).loss, params,
                                     toks)
    assert torch.equal(plain[0], remat[0])
    for k in params:
        assert torch.equal(plain[1][k], remat[1][k]), k


# ----------------------------------------------------------------------
# Data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 7])
def test_make_batch_matches_reference(step):
    rcfg, pcfg = _cfgs(64)
    kw = dict(seq_len=16, global_batch=8, num_nodes=4,
              vocab_size=pcfg.vocab_size, seed=3)
    got = synthetic.make_batch(pcfg, synthetic.DataConfig(**kw), step)
    want = ref_synthetic.make_batch(rcfg, ref_synthetic.DataConfig(**kw),
                                    step)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].dtype == np.int32


def test_token_batches_match_reference():
    kw = dict(seq_len=16, global_batch=6, num_nodes=3, vocab_size=100)
    ours = synthetic.token_batches(synthetic.DataConfig(**kw))
    theirs = ref_synthetic.token_batches(ref_synthetic.DataConfig(**kw))
    for _ in range(2):
        np.testing.assert_array_equal(next(ours)["tokens"],
                                      next(theirs)["tokens"])
    with pytest.raises(ValueError, match="divisible"):
        _ = synthetic.DataConfig(seq_len=4, global_batch=5, num_nodes=2,
                                 vocab_size=9).per_node
