"""Shared helpers of the PyTorch port's parity tests (not collected).

The reference draws all its randomness from JAX keys, which torch cannot
reproduce.  :func:`reference_draws` replays the reference engine's key
derivation (``DashaPP.run`` -> ``variants.round_keys`` -> sampler,
oracle and per-node compressor keys) and returns each round's draws as
numpy arrays, ready for :func:`repro_torch.convert.round_draws`.
"""
from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
