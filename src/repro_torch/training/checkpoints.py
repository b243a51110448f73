"""Dependency-free checkpoints of the trainer's state: ``.npz`` of the
leaves and a ``.json`` manifest (the port of
``repro/training/checkpoints.py``; the same file names).

A state is any nesting of NamedTuples, dicts, tuples and lists whose
leaves are tensors or Python ints (the step counters); ``None`` holds
no leaf.  The manifest lists each leaf's path, in the reference's
``keystr`` form (``.dasha.g_i['embed']``), and its dtype.  numpy has no
bfloat16, so a bfloat16 tensor is stored as its ``int16`` bit pattern
and restored exactly.

**The gradient variant's cache.**  :class:`~repro_torch.training.trainer.
TrainState` holds ``cache=None`` before the first step, where the
reference keeps a tree of zeros, so a fresh ``trainer.init()`` state has
fewer leaves than a state saved after a step.  The manifest records
``has_cache``; :func:`restore_checkpoint` restores the cache a
checkpoint holds onto the structure of ``state_like``'s parameters
(one ``(n,)`` loss row and one ``(n, *shape)`` gradient per leaf), and
``None`` where the checkpoint holds none.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class Like(NamedTuple):
    """A leaf to restore into: shape, dtype and device."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in order: NamedTuple fields, dict keys in
    their order, sequence items; tensors, ints and :class:`Like` are
    leaves, ``None`` is empty."""
    if tree is None:
        return []
    if isinstance(tree, (Tensor, int, Like)):
        return [(path, tree)]
    if _is_namedtuple(tree):
        return [pl for f in tree._fields
                for pl in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _flatten(v, f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, f"{path}[{i}]")]
    raise TypeError(f"no checkpoint form for {type(tree).__name__} at "
                    f"{path!r}")


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_flatten`'s order, by
    the items of the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, (Tensor, int, Like)):
        return next(leaves)
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    return type(tree)(_unflatten(v, leaves) for v in tree)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int64), "int"
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _manifest_name(path: str, step: int, ext: str) -> str:
    return os.path.join(path, f"ckpt_{step:08d}.{ext}")


def save_checkpoint(path: str, state, step: int) -> str:
    """Write ``state`` as ``ckpt_{step:08d}.npz`` and its ``.json``
    manifest under ``path``, and ``latest``; returns the ``.npz`` path."""
    os.makedirs(path, exist_ok=True)
    pairs = _flatten(state)
    arrays, dtypes = {}, []
    for i, (_, leaf) in enumerate(pairs):
        arrays[f"leaf_{i}"], dtype = _to_numpy(leaf)
        dtypes.append(dtype)
    fname = _manifest_name(path, step, "npz")
    np.savez(fname, **arrays)
    manifest = {"step": step, "paths": [p for p, _ in pairs],
                "dtypes": dtypes, "num_leaves": len(pairs),
                "has_cache": getattr(state, "cache", None) is not None}
    with open(_manifest_name(path, step, "json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(path, "latest"), "w") as f:
        f.write(str(step))
    return fname


def latest_step(path: str) -> Optional[int]:
    marker = os.path.join(path, "latest")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def _cache_like(state_like):
    """The structure of a gradient-variant cache for ``state_like``: the
    ``(n,)`` float32 losses and one ``(n, *shape)`` gradient per
    parameter, in the parameters' dtype and device."""
    n = next(iter(state_like.dasha.g_i.values())).shape[0]
    params = state_like.params
    dev = next(iter(params.values())).device
    return (Like((n,), torch.float32, dev),
            {k: Like((n,) + tuple(p.shape), p.dtype, p.device)
             for k, p in params.items()})


def _restore_leaf(arr: np.ndarray, dtype: str, like, where: str):
    if dtype == "int":
        return int(arr)
    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{where}: checkpoint shape {tuple(t.shape)}, "
                         f"state expects {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def restore_checkpoint(path: str, state_like, step: Optional[int] = None):
    """The state saved at ``step`` (default: ``latest``), on the devices
    and in the dtypes of ``state_like``'s leaves and in its structure,
    the gradient cache as the checkpoint holds it (module docstring)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    with open(_manifest_name(path, step, "json")) as f:
        manifest = json.load(f)
    if _is_namedtuple(state_like) and "cache" in state_like._fields:
        state_like = state_like._replace(
            cache=_cache_like(state_like) if manifest["has_cache"]
            else None)
    pairs = _flatten(state_like)
    with np.load(_manifest_name(path, step, "npz")) as data:
        if len(pairs) != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, state expects "
                f"{len(pairs)}")
        leaves = [_restore_leaf(data[f"leaf_{i}"], manifest["dtypes"][i],
                                like, where)
                  for i, (where, like) in enumerate(pairs)]
    return _unflatten(state_like, iter(leaves))
