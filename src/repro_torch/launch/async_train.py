"""Async federated training entry point of the port:

    python -m repro_torch.launch.async_train \
        --variant mvr --latency lognormal --sigma 0.8 --buffer 5 \
        [--compressor randk|topk|dithering|identity] [--rounds N] \
        [--device cuda|cpu] [--unfused]

The port of ``repro/launch/async_train.py``: runs
:class:`repro_torch.fl.AsyncDashaServer` on the paper's synthetic
federated problem with a heterogeneous virtual-time fleet and logs
per-server-step metrics (virtual wall-clock, loss, ||∇f||², staleness,
bits on the wire) through the metrics logger (JSONL with ``--log``).
``--buffer 0`` means the full barrier, the sync-equivalent baseline.
Same flags and defaults as the reference, except ``--device`` (the card
unless ``cpu`` is asked for), ``--unfused`` in place of ``--use-pallas``
(the fused dispatch and the buffered-commit kernel are the default
here), and a cohort that defaults to ``min(10, n)`` where the reference
refuses ``n < 10``.  The problem, the draws and the server live on
``--device``; data and draws come from ``torch.Generator``s seeded with
``--seed`` and ``--seed + 1``.
"""
import argparse
import math
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.obs import add_cli_flags
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.async_train")
    ap.add_argument("--variant", default="mvr",
                    choices=["mvr", "gradient", "page", "finite_mvr"])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--n", type=int, default=50, help="clients")
    ap.add_argument("--m", type=int, default=24, help="examples/client")
    ap.add_argument("--d", type=int, default=120)
    ap.add_argument("--cohort", type=int, default=None,
                    help="s-nice cohort size per round (default: 10, or "
                         "n when n < 10)")
    ap.add_argument("--buffer", type=int, default=5,
                    help="first-K arrivals per server step; 0 = barrier")
    ap.add_argument("--staleness-exponent", type=float, default=0.5)
    ap.add_argument("--max-staleness", type=int, default=None)
    ap.add_argument("--latency", default="lognormal",
                    choices=["constant", "lognormal"])
    ap.add_argument("--sigma", type=float, default=0.8,
                    help="lognormal jitter + fleet spread")
    ap.add_argument("--bandwidth", type=float, default=2e5,
                    help="uplink bits/s (0 = instant network)")
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--compressor", default="randk",
                    choices=["randk", "topk", "dithering", "identity"])
    ap.add_argument("--ratio", type=float, default=0.05,
                    help="K/d of randk/topk")
    ap.add_argument("--gamma", type=float, default=0.05)
    ap.add_argument("--a", type=float, default=0.1)
    ap.add_argument("--b", type=float, default=0.3)
    ap.add_argument("--p-page", type=float, default=0.25)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--unfused", action="store_true",
                    help="unfused dispatch and commit (the plain formulas)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the problem and the server")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default=None,
                    help="directory of the async_train.jsonl log")
    add_cli_flags(ap)
    return ap


def build_server(args: argparse.Namespace, problem=None):
    """The server :func:`main` runs, on ``args.device``; the synthetic
    problem is made from ``--seed`` unless ``problem`` is given."""
    import torch

    from repro_torch.core import (DashaPPConfig, Identity,
                                  LogisticSigmoidProblem, RandK,
                                  RandomDithering, SNice, TopK,
                                  make_synthetic_classification)
    from repro_torch.device import resolve_device
    from repro_torch.fl import AsyncConfig, AsyncDashaServer, make_latency

    dev = resolve_device(args.device)
    if problem is None:
        data_gen = torch.Generator(device=dev).manual_seed(args.seed)
        feats, y = make_synthetic_classification(data_gen, args.n, args.m,
                                                 args.d, device=dev)
        problem = LogisticSigmoidProblem(feats, y)
    k = max(1, math.ceil(args.ratio * args.d))
    comp = {"randk": RandK(k=k), "topk": TopK(k=k),
            "dithering": RandomDithering(s=4),
            "identity": Identity()}[args.compressor]
    samp = SNice(n=args.n, s=args.cohort or min(10, args.n))
    fused = not args.unfused
    cfg = DashaPPConfig(args.variant, gamma=args.gamma, a=args.a,
                        b=args.b, p_page=args.p_page,
                        batch_size=args.batch_size, fused=fused)
    lat_kw = dict(bandwidth_bps=args.bandwidth or None,
                  dropout=args.dropout, seed=args.seed)
    if args.latency == "lognormal":
        lat_kw.update(sigma=args.sigma, client_sigma=args.sigma)
    latency = make_latency(args.latency, **lat_kw)
    return AsyncDashaServer(
        problem, comp, samp, cfg,
        AsyncConfig(buffer_size=args.buffer or None,
                    staleness_exponent=args.staleness_exponent,
                    max_staleness=args.max_staleness, fused=fused),
        latency, device=dev)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.obs import start_run
    from repro_torch.training.metrics import MetricsLogger

    obsrun = start_run(trace_out=args.trace_out,
                       metrics_out=args.metrics_out,
                       meta={"cli": "async_train", "variant": args.variant})
    srv = build_server(args)
    dev = srv.device
    run_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    state, res = srv.run(run_gen, torch.zeros(args.d, device=dev),
                         args.rounds)

    logger = MetricsLogger(args.log, name="async_train",
                           print_every=max(1, len(res.time) // 20))
    for i in range(len(res.time)):
        logger.log(i, t_virtual=res.time[i], loss=res.loss[i],
                   grad_norm_sq=res.grad_norm_sq[i],
                   committed=int(res.committed[i]),
                   staleness_mean=res.staleness_mean[i],
                   mbits=res.bits_cum[i] / 1e6)
    logger.close()
    print(f"\nfinal ||grad f||^2 = {res.grad_norm_sq[-1]:.3e}  "
          f"t_virtual = {res.total_time:.1f}s  "
          f"util = {float(np.mean(res.utilization)):.2f}  "
          f"dropped = {res.dropped}  "
          f"staleness hist = {res.staleness_hist}")
    obsrun.finish()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
