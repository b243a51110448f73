"""Production training entry point of the port:

    python -m repro_torch.launch.train --arch granite-3-2b --shape train_4k \\
        [--steps N] [--smoke] [--variant mvr|gradient|page] \\
        [--aggregation sparse_allgather|dense_psum] [--device cuda|cpu]

The port of ``repro/launch/train.py``: DASHA-PP's sharded engine drives
the model, its nodes simulated node-major on one device.  Same flags and
defaults as the reference, except:

* ``--device`` (the card unless ``cpu`` is asked for);
* ``--unfused`` in place of ``--use-pallas``: the fused kernels are the
  default here;
* ``--nodes`` in place of the mesh (default 4, the data axis of the
  reference's smoke mesh; the reference's ``--multi-pod`` has no
  meaning on one card);
* the weights and the round draws come from ``torch.Generator`` seeds
  (the reference's key 0 and seed 0 become seed 0);
* ``--ckpt`` and ``--profile-dir`` are not offered yet (ROADMAP).

``--smoke`` shrinks to the reduced config in float32, sequences of 64,
a global batch of 8 (the reference's smoke path).  ``--variant
finite_mvr`` raises: it comes with the next slice.
"""
import argparse
from typing import Optional, Sequence

SEED = 0


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.obs import add_cli_flags
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--p-a", type=float, default=0.5)
    ap.add_argument("--ratio", type=float, default=1 / 64)
    ap.add_argument("--aggregation", default="sparse_allgather",
                    choices=["sparse_allgather", "dense_psum"])
    ap.add_argument("--variant", default="mvr",
                    choices=["mvr", "gradient", "page", "finite_mvr"],
                    help="k_i rule (core/variants.py); gradient is a "
                         "fixed-batch finite-sum setting")
    ap.add_argument("--p-page", type=float, default=1 / 8,
                    help="page variant: full-pass probability")
    ap.add_argument("--page-mini-batch", type=int, default=1,
                    help="page variant: per-node minibatch examples")
    ap.add_argument("--unfused", action="store_true",
                    help="the unfused rule and tail (no kernels)")
    ap.add_argument("--server", choices=["paper", "adamw"], default="paper")
    ap.add_argument("--gamma", type=float, default=1e-3)
    ap.add_argument("--nodes", type=int, default=4,
                    help="simulated nodes (the reference's data axis)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log", default=None)
    add_cli_flags(ap)
    return ap


def build_trainer(args: argparse.Namespace, cfg=None,
                  seq_len: Optional[int] = None,
                  global_batch: Optional[int] = None):
    """The trainer :func:`main` runs and its first state, on
    ``args.device``, with its data config.  ``cfg``, ``seq_len`` and
    ``global_batch`` replace the architecture and input shape the flags
    name (a caller that cuts depth passes ``cfg.with_overrides(...)``).
    Returns ``(trainer, state, data_config, arch_config)``."""
    import torch

    from repro_torch.core.sharded import ShardedDashaConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import (INPUT_SHAPES, Model, get_config,
                                    get_smoke_config)
    from repro_torch.training.optim import adamw_server, paper_server
    from repro_torch.training.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    if args.smoke:
        arch = get_smoke_config(args.arch).with_overrides(dtype="float32")
        seq, gbatch = 64, 8
    else:
        arch = get_config(args.arch)
        shp = INPUT_SHAPES[args.shape]
        seq, gbatch = shp.seq_len, shp.global_batch
    arch = cfg or arch
    seq = seq_len or seq
    gbatch = global_batch or gbatch
    omega = 1.0 / args.ratio - 1.0
    dcfg = ShardedDashaConfig(
        gamma=args.gamma, a=args.p_a / (2 * omega + 1),
        b=args.p_a / (2 - args.p_a), p_a=args.p_a, sampler="independent",
        compression_ratio=args.ratio, aggregation=args.aggregation,
        variant=args.variant, p_page=args.p_page, fused=not args.unfused)
    server = (paper_server(args.gamma) if args.server == "paper"
              else adamw_server(lr=3e-4))
    model = Model.create(arch, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    trainer = Trainer(model, TrainerConfig(
        dasha=dcfg, server=server, page_mini_batch=args.page_mini_batch),
        num_nodes=args.nodes)
    data = DataConfig(seq_len=seq, global_batch=gbatch,
                      num_nodes=args.nodes, vocab_size=arch.vocab_size)
    return trainer, trainer.init(), data, arch


def batches(args: argparse.Namespace, arch, data):
    """The gradient variant (Alg. 2) is a finite-sum setting: each node's
    batch is FIXED across rounds (what makes the old-gradient cache
    exact); mvr and page stream fresh batches."""
    from repro_torch.data.synthetic import make_batch
    if args.variant == "gradient":
        fixed = make_batch(arch, data, 0)
        while True:
            yield fixed
    i = 0
    while True:
        yield make_batch(arch, data, i)
        i += 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch.obs import start_run
    from repro_torch.training.loop import train
    from repro_torch.training.metrics import MetricsLogger

    trainer, state, data, arch = build_trainer(args)
    obsrun = start_run(trace_out=args.trace_out,
                       metrics_out=args.metrics_out,
                       meta={"cli": "train", "arch": args.arch,
                             "variant": args.variant})
    logger = MetricsLogger(args.log, print_every=10)
    train(trainer, state, batches(args, arch, data), num_steps=args.steps,
          logger=logger, seed=SEED,
          device=state.params["embed"].device)
    logger.close()
    obsrun.finish()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
