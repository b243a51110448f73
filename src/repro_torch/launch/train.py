"""Production training entry point of the port:

    python -m repro_torch.launch.train --arch granite-3-2b --shape train_4k \\
        [--steps N] [--smoke] [--variant mvr|gradient|page|finite_mvr] \\
        [--component-batch B] [--layers N] [--global-batch N] \\
        [--aggregation sparse_allgather|dense_psum] [--ckpt DIR] \\
        [--device cuda|cpu]

The port of ``repro/launch/train.py``: DASHA-PP's sharded engine drives
the model, its nodes simulated node-major on one device.  Same flags and
defaults as the reference, except:

* ``--device`` (the card unless ``cpu`` is asked for);
* ``--unfused`` in place of ``--use-pallas``: the fused kernels are the
  default here;
* ``--nodes``, ``--layers`` and ``--global-batch`` in place of the mesh:
  the simulated nodes (default 4, the data axis of the reference's smoke
  mesh), a cut of the architecture's depth and a global batch in place
  of ``--shape``'s (its sequence length stays), so that a full-width
  model fits one card (the reference's ``--multi-pod`` has no meaning
  there);
* the weights and the round draws come from ``torch.Generator`` seeds
  (the reference's key 0 and seed 0 become seed 0);
* ``--profile-dir`` is not offered yet (ROADMAP).

``--smoke`` shrinks to the reduced config in float32, sequences of 64,
a global batch of 8 (the reference's smoke path).  Before it allocates
anything on a card, :func:`build_trainer` estimates the run's device
memory (:func:`estimate_train_bytes`) and refuses a run that would not
fit.  ``--ckpt DIR`` saves the whole train state every 50 steps
(:mod:`repro_torch.training.checkpoints`).
"""
import argparse
import math
from typing import Optional, Sequence

SEED = 0
CHECKPOINT_EVERY = 50


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
                    help="k_i rule (core/variants.py); gradient and "
                         "finite_mvr are fixed-batch finite-sum settings")
    ap.add_argument("--p-page", type=float, default=1 / 8,
                    help="page variant: full-pass probability")
    ap.add_argument("--page-mini-batch", type=int, default=1,
                    help="page variant: per-node minibatch examples")
    ap.add_argument("--component-batch", type=int, default=1,
                    help="finite_mvr variant: components (examples) "
                         "sampled per node per round")
    ap.add_argument("--unfused", action="store_true",
                    help="the unfused rule and tail (no kernels)")
    ap.add_argument("--server", choices=["paper", "adamw"], default="paper")
    ap.add_argument("--gamma", type=float, default=1e-3)
    ap.add_argument("--nodes", type=int, default=4,
                    help="simulated nodes (the reference's data axis)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the architecture to its first N layers")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="sequences per step over all nodes, in place of "
                         "--shape's")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None,
                    help=f"save the train state here every "
                         f"{CHECKPOINT_EVERY} steps")
    ap.add_argument("--log", default=None)
    add_cli_flags(ap)
    return ap


# ----------------------------------------------------------------------
# Device memory of a run, counted before anything is allocated
# ----------------------------------------------------------------------

def _dtype_bytes(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]


def estimate_train_bytes(arch, nodes: int, global_batch: int, seq_len: int,
                         variant: str, aggregation: str, *,
                         compression_ratio: Optional[float] = 1 / 64,
                         component_batch: int = 1,
                         server: str = "paper") -> int:
    """Device bytes a training step of ``arch`` needs at most, counted from
    the shapes: the sum of what the step holds over its life.

    * parameters three times (the model's own weights ``x^0``, ``x^t``
      and ``x^{t+1}``) and the server optimizer's state (AdamW: two
      float32 moments);
    * ``g``, and ``n`` copies each of ``g_i`` and ``h_i``; finite-MVR
      adds ``n m`` copies of ``h_ij`` (``m = global_batch / n``);
    * the gradient sets the variant holds: two ``(n, *param)`` sets
      (``x^{t+1}`` and ``x^t``; the gradient variant's cache is the
      second), finite-MVR two ``(n, B, *param)`` sets;
    * the engine's float32 temporaries of the largest leaf, ``(n, D)``
      rows each: the float32 reads of ``h_i``, ``g_i`` and the rule's
      inputs, the update's outputs, and the wire's scattered rows;
    * one node's backward pass: the checkpointed layer inputs, one
      layer's recomputed activations and their gradients, the logits
      (in the model's dtype and in float32, each with its gradient, and
      the softmax's float32 temporaries), and the gradient set
      ``autograd.grad`` returns before it is copied into place.

    The engine and the backward pass never hold their buffers at once,
    so the sum is an upper bound (on the H100 it lies 1.2-1.3x above
    the measured peak; PERF.md).
    """
    from repro_torch.models import param_shapes
    from repro_torch.core.variants import get_rule

    rule = get_rule(variant)
    s = _dtype_bytes(arch.dtype)
    sizes = [math.prod(shape) for shape in param_shapes(arch).values()]
    p, d_max = sum(sizes), max(sizes)
    per_node = global_batch // nodes

    state = 3 * p * s + (2 * p * 4 if server == "adamw" else 0)
    state += p * s + 2 * nodes * p * s
    if rule.component_trackers:
        state += nodes * per_node * p * s
    sets = component_batch if rule.component_trackers else 1
    grads = 2 * nodes * sets * p * s

    compressed = compression_ratio is not None
    sparse = compressed and aggregation == "sparse_allgather"
    if rule.component_trackers:
        # the drawn rows of gn, go and h_ij, k_ij, the node mean k
        reads = 3 * component_batch + 1
    else:
        reads = 4 if rule.needs_minibatch else 2
    outs = 1 if sparse else 3           # h_new[, payload, k]
    wire = (1 if sparse else 2) if compressed else 1
    engine = (2 + reads + outs + wire) * nodes * d_max * 4

    # examples in one backward pass: finite-MVR's are one each
    tokens = (1 if rule.component_trackers else per_node) * seq_len
    hd, heads, kv = arch.hd, arch.num_heads, arch.num_kv_heads
    layer = tokens * ((24 + 2 * s) * arch.d_model + 4 * s * arch.d_ff
                      + (s + 16) * (heads + 2 * kv) * hd + 8 * heads * hd)
    saved = arch.num_layers * tokens * arch.d_model * s
    if not arch.remat:
        saved += arch.num_layers * layer
    logits = tokens * arch.padded_vocab * (2 * s + 10)
    backward = saved + 2 * layer + logits + p * s
    return int(state + grads + engine + backward)


def check_fits(nbytes: int, device) -> None:
    """Raise, naming both byte counts, when ``nbytes`` exceeds the CUDA
    ``device``'s memory; the CPU is not checked."""
    import torch
    if device.type != "cuda":
        return
    total = torch.cuda.mem_get_info(device)[1]
    if nbytes > total:
        raise RuntimeError(
            f"the run needs an estimated {nbytes} bytes of device memory "
            f"({nbytes / 1e9:.1f} GB) and {device} has {total} "
            f"({total / 1e9:.1f} GB): cut --layers or --global-batch")


def run_shape(args: argparse.Namespace):
    """``(arch, seq_len, global_batch)`` of the flags; refuses an
    architecture the trainer does not take, before anything is
    allocated."""
    from repro_torch.models import INPUT_SHAPES, get_config, get_smoke_config
    if get_config(args.arch).arch_type != "dense":
        raise NotImplementedError(
            f"{args.arch}: the trainer takes the dense decoder only; the "
            "MoE and MLA trainer (g_i and h_i for every node at 16 B "
            "parameters) waits for ROADMAP queue 1, item 15")
    if args.smoke:
        arch = get_smoke_config(args.arch).with_overrides(dtype="float32")
        seq, gbatch = 64, 8
    else:
        arch = get_config(args.arch)
        shp = INPUT_SHAPES[args.shape]
        seq, gbatch = shp.seq_len, shp.global_batch
    if args.layers is not None:
        arch = arch.with_overrides(num_layers=args.layers)
    return arch, seq, args.global_batch or gbatch


def estimate_for(args: argparse.Namespace) -> int:
    """:func:`estimate_train_bytes` of the run the flags describe."""
    arch, seq, gbatch = run_shape(args)
    return estimate_train_bytes(
        arch, args.nodes, gbatch, seq, args.variant, args.aggregation,
        compression_ratio=args.ratio, component_batch=args.component_batch,
        server=args.server)


def build_trainer(args: argparse.Namespace):
    """The trainer :func:`main` runs and its first state, on
    ``args.device``, with its data config; refuses, before it allocates,
    a run whose :func:`estimate_train_bytes` exceeds the card.  Returns
    ``(trainer, state, data_config, arch_config)``."""
    import torch

    from repro_torch.core.sharded import ShardedDashaConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.training.optim import adamw_server, paper_server
    from repro_torch.training.trainer import Trainer, TrainerConfig

    arch, seq, gbatch = run_shape(args)
    dev = resolve_device(args.device)
    check_fits(estimate_for(args), dev)
    omega = 1.0 / args.ratio - 1.0
    dcfg = ShardedDashaConfig(
        gamma=args.gamma, a=args.p_a / (2 * omega + 1),
        b=args.p_a / (2 - args.p_a), p_a=args.p_a, sampler="independent",
        compression_ratio=args.ratio, aggregation=args.aggregation,
        variant=args.variant, p_page=args.p_page, fused=not args.unfused)
    server = (paper_server(args.gamma) if args.server == "paper"
              else adamw_server(lr=3e-4))
    tcfg = TrainerConfig(
        dasha=dcfg, server=server, page_mini_batch=args.page_mini_batch,
        num_components=(gbatch // args.nodes
                        if args.variant == "finite_mvr" else None),
        component_batch=args.component_batch)
    model = Model.create(arch, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    trainer = Trainer(model, tcfg, num_nodes=args.nodes)
    data = DataConfig(seq_len=seq, global_batch=gbatch,
                      num_nodes=args.nodes, vocab_size=arch.vocab_size)
    return trainer, trainer.init(), data, arch


def batches(args: argparse.Namespace, arch, data):
    """The gradient and finite-MVR variants (Algs. 2 and 4) are
    finite-sum settings: each node's batch is FIXED across rounds (what
    makes the old-gradient cache exact and gives the ``h_ij`` trackers
    their components); mvr and page stream fresh batches."""
    from repro_torch.data.synthetic import make_batch
    if args.variant in ("gradient", "finite_mvr"):
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
          logger=logger, seed=SEED, device=state.params["embed"].device,
          checkpoint_dir=args.ckpt,
          checkpoint_every=CHECKPOINT_EVERY if args.ckpt else 0)
    logger.close()
    obsrun.finish()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
