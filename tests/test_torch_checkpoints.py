"""The port's checkpoints (``repro_torch.training.checkpoints``) and the
training loop's ``checkpoint_dir``/``checkpoint_every``, on the CPU at
smoke size: the resume contract of ``tests/test_training_resume.py``
(a restored state continues through ``train()`` bit for bit, and its
checkpoints extend the numbering), for the gradient variant (its cache
saved) and finite-MVR (its ``h_ij`` saved); bfloat16 leaves stored as
their bit patterns; both shapes of the cache; the reference's refusal
of a state with another number of leaves.
"""
import json
import os

import numpy as np
import pytest
import torch
from _torch_parity import (fresh_port_registry, process_hygiene,  # noqa: F401
                           torch_one_thread)

from repro_torch.launch import train as train_cli
from repro_torch.training import checkpoints, loop

pytestmark = pytest.mark.usefixtures("process_hygiene")

SEED = 5


def _trainer(variant, *extra):
    args = train_cli.build_parser().parse_args(
        ["--device", "cpu", "--smoke", "--variant", variant, *extra])
    trainer, state, data, arch = train_cli.build_trainer(args)
    return trainer, state, train_cli.batches(args, arch, data)


def _run(trainer, state, stream, steps, ckpt=None, every=0):
    return loop.train(trainer, state, stream, steps, seed=SEED,
                      device="cpu", log_every=100, checkpoint_dir=ckpt,
                      checkpoint_every=every)


def _leaves(state):
    return checkpoints._flatten(state)


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, int):
            assert x == y, path
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), path


def _files(path):
    return sorted(f for f in os.listdir(path) if f.startswith("ckpt_"))


@pytest.mark.parametrize("variant", ["gradient", "finite_mvr"])
def test_resume_through_train_is_bitwise(tmp_path, fresh_port_registry,
                                         variant):
    """Four steps straight equal two, a checkpoint, a restore onto a
    fresh ``trainer.init()`` (whose gradient cache is still None) and
    two more, to the bit; the resumed run's checkpoint is step 4 beside
    step 2, as the straight run's are."""
    straight_dir, resumed_dir = tmp_path / "straight", tmp_path / "resumed"
    trainer, state, stream = _trainer(variant)
    straight = _run(trainer, state, stream, 4, str(straight_dir), 2)

    trainer, state, stream = _trainer(variant)
    _run(trainer, state, stream, 2, str(resumed_dir), 2)
    assert checkpoints.latest_step(str(resumed_dir)) == 2
    trainer, like, stream = _trainer(variant)
    assert like.cache is None
    restored = checkpoints.restore_checkpoint(str(resumed_dir), like)
    assert restored.step == 2 and restored.dasha.step == 2
    if variant == "gradient":
        assert restored.cache is not None
    else:
        assert restored.dasha.h_ij is not None
    resumed = _run(trainer, restored, stream, 2, str(resumed_dir), 2)

    _assert_same_state(resumed, straight)
    assert _files(resumed_dir) == _files(straight_dir) == [
        "ckpt_00000002.json", "ckpt_00000002.npz", "ckpt_00000004.json",
        "ckpt_00000004.npz"]
    assert checkpoints.latest_step(str(resumed_dir)) == 4
    _assert_same_state(
        checkpoints.restore_checkpoint(str(resumed_dir), like, step=4),
        straight)


def test_bfloat16_leaves_round_trip_exactly(tmp_path, fresh_port_registry):
    """A bfloat16 model's state after a step (params, ``g``, ``g_i``,
    ``h_i``, ``h_ij``) comes back to the bit and in bfloat16; the
    manifest names each leaf's path and dtype."""
    trainer, state, stream = _trainer("finite_mvr")
    arch = trainer.model.cfg.with_overrides(dtype="bfloat16")
    from repro_torch.models import Model
    from repro_torch.training.trainer import Trainer
    bf = Trainer(Model(arch, {k: v.to(torch.bfloat16)
                              for k, v in state.params.items()}),
                 trainer.cfg, num_nodes=trainer.n_nodes)
    state = _run(bf, bf.init(), stream, 1)
    checkpoints.save_checkpoint(str(tmp_path), state, 1)
    back = checkpoints.restore_checkpoint(str(tmp_path), bf.init())
    _assert_same_state(back, state)
    assert back.dasha.h_ij["embed"].dtype == torch.bfloat16
    with open(tmp_path / "ckpt_00000001.json") as f:
        manifest = json.load(f)
    assert manifest["paths"][0] == ".params['embed']"
    assert manifest["dtypes"][0] == "bfloat16"
    assert manifest["num_leaves"] == len(_leaves(state))
    with np.load(tmp_path / "ckpt_00000001.npz") as data:
        assert data["leaf_0"].dtype == np.int16


def test_a_checkpoint_without_cache_restores_none(tmp_path,
                                                  fresh_port_registry):
    """The other shape of the cache trap: a gradient-variant state saved
    before its first step has no cache, and restores without one onto a
    state that has one."""
    trainer, state, stream = _trainer("gradient")
    checkpoints.save_checkpoint(str(tmp_path), state, 0)
    stepped = _run(trainer, trainer.init(), stream, 1)
    assert stepped.cache is not None
    back = checkpoints.restore_checkpoint(str(tmp_path), stepped, step=0)
    assert back.cache is None and back.step == 0
    _assert_same_state(back, state)


def test_restore_refuses_another_number_of_leaves(tmp_path,
                                                  fresh_port_registry):
    """As the reference's: a finite-MVR checkpoint (with ``h_ij``) does
    not restore onto an MVR state, nor a missing step."""
    trainer, state, stream = _trainer("finite_mvr")
    checkpoints.save_checkpoint(str(tmp_path), state, 0)
    _, mvr_like, _ = _trainer("mvr")
    with pytest.raises(ValueError, match="leaves"):
        checkpoints.restore_checkpoint(str(tmp_path), mvr_like)
    with pytest.raises(FileNotFoundError):
        checkpoints.restore_checkpoint(str(tmp_path / "none"), mvr_like)


def test_train_cli_checkpoints_every_fifty_steps(monkeypatch, tmp_path,
                                                 fresh_port_registry):
    """``--ckpt DIR`` hands the loop the directory and the reference's
    50 steps."""
    seen = {}

    def fake_train(trainer, state, batches, num_steps, **kw):
        seen.update(kw)
        return state

    monkeypatch.setattr(loop, "train", fake_train)
    assert train_cli.main(["--device", "cpu", "--smoke", "--steps", "1",
                           "--ckpt", str(tmp_path)]) == 0
    assert seen["checkpoint_dir"] == str(tmp_path)
    assert seen["checkpoint_every"] == 50
