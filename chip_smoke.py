#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          (from the repository root; one card)

The main paths are Algorithm 1 of the paper (DASHA-PP rounds of all
four variants, with lines 9-11 of each round in the port's hand-written
CUDA kernels, ``src/repro_torch/kernels/csrc/dasha_update.cu``), the
asynchronous server of ``python -m repro_torch.launch.async_train``
(whose every commit runs the buffered-commit kernel) and the
hierarchical fleet.  Phases, each printed as one JSON line:

1. device   -- the card, as ``nvidia-smi`` and torch see it;
2. build    -- ``nvcc`` builds the kernels from the checkout (sm_90a);
3. kernel   -- each kernel against its plain PyTorch version at the
               real-sim width (n = 100, d = 20958; the buffered commit at
               K = 10 and K = 100 rows): equal outputs, a launch counted,
               CUDA-event times beside the bound and, for the commit,
               ``torch.addmv``;
4. main     -- each variant's ``run`` at n = 100, m = 723, d = 20958
               with RandK(d/20), SNice(20) and theory hyperparameters:
               one kernel launch per round, finite metrics, ms per round,
               peak memory;
5. trajectory -- 20 rounds of each variant on the card and on the CPU
               from the same data and the same draws, held allclose;
6. async    -- the async_train CLI's server at the same width with a
               10-arrival buffer and lognormal latency, each variant for
               20 rounds and the drain: one dispatch-kernel launch per
               round, one buffered-commit launch per committing server
               step, finite metrics, ms per server step, peak memory,
               host<->device bytes per round;
7. async-trajectory -- that server on the card and on the CPU at
               n = 20, m = 32, d = 2048 from the same data and draws:
               equal event logs, states allclose;
8. fleet    -- a depth-1 edge-aggregator fleet at full width (gradient,
               10 rounds): the wire-bits ledger reconciles, ms per round;
9. the card's ``nvidia-smi`` line, the ``kernels`` line, and the ``ok``
   line, last.

Any failed check raises, so the script exits non-zero and prints no
``ok`` line; it does so at once without a CUDA device.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import numpy as np  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import fl  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import dasha_update as kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import async_train  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import monitors  # noqa: E402

SEED = 0
N, M, D = 100, 723, 20958          # the real-sim split, full width
DENSITY = 0.15                     # benchmarks/common.py:29
ROUNDS = 10
BATCH = 16
GAMMA_SCALE = 64   # theory stepsize, finetuned over {2^i} (paper §A)
SMALL = dict(n=20, m=32, d=2048)   # the card-vs-CPU trajectory phase
TRAJ_ROUNDS = 20
# Card vs CPU: the same float32 operations, but cuBLAS sums the gradient
# products in another order than the CPU; values are O(1e-1), and the
# differences travel through 20 rounds.
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
TIMING_REPS = 30
SLEEP_CYCLES = 2_000_000   # ~1 ms of device spin ahead of each timed launch
SOURCE = "src/repro_torch/kernels/csrc/dasha_update.cu"
ASYNC_ROUNDS = 20
ASYNC_BUFFER = 10                  # arrivals per server step (the main K)
COMMIT_KS = (ASYNC_BUFFER, N)      # the buffer, and the reference's
#                                    capacity-n commit buffer
FLEET_ROUNDS = 10
FLEET_EDGES = 5

# name -> (TPU kernel it replaces, (n, d) transfers, float ops per
# element, device scalars read besides the (n,) mask)
KERNELS = {
    "dasha_update_batched":
        ("src/repro/kernels/dasha_update.py:168", 7, 10, 0),
    "dasha_page_update_batched":
        ("src/repro/kernels/dasha_update.py:220", 9, 15, 1),
    "dasha_tail_batched":
        ("src/repro/kernels/dasha_update.py:267", 5, 6, 0),
}
COMMIT = "buffered_commit"
COMMIT_REPLACES = "src/repro/kernels/dasha_update.py:405"
KERNEL_OF = {"gradient": "dasha_update_batched",
             "mvr": "dasha_update_batched",
             "page": "dasha_page_update_batched",
             "finite_mvr": "dasha_tail_batched"}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def all_finite(t):
    """Whether every element is finite, in 64 MB slices: a whole-tensor
    ``isfinite`` of the 6 GB ``h_ij`` would take 10 GB of temporaries."""
    return all(bool(torch.isfinite(c).all())
               for c in t.reshape(-1).split(1 << 24))


def card_rates(name):
    """(memory bytes/s, float32 FLOP/s outside the tensor cores) of the
    card, from NVIDIA's data sheets (dense rates, full power)."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "H100" in name:
        if "PCIe" in name:
            return 2.0e12, 51e12
        if "NVL" in name:
            return 3.9e12, 60e12
        return 3.35e12, 67e12
    raise RuntimeError(f"no rated bandwidth known for {name!r}")


def time_ms(fn, flush=None):
    """Median CUDA-event time of ``fn`` over TIMING_REPS launches after a
    warm-up.  Before each, the card spins while the host enqueues, so the
    events time the device work and not the host's launch path; with
    ``flush``, a read of a buffer larger than L2 evicts the operands
    first, as the main path finds them cold."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        if flush is not None:
            torch.sum(flush)   # a read: L2 left clean, no write-backs
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    return name, smi


def phase_build():
    built = build.build(kernels.LIBRARY)
    kernels.library()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", source=SOURCE, library=built.path.name,
         seconds=built.seconds, flags=" ".join(build.NVCC_FLAGS),
         ptxas=ptxas)


def phase_kernels(dev, name, flush):
    """Each kernel against its plain version on the same inputs."""
    mem_rate, f32_rate = card_rates(name)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gn, go, bn, bo, h, gi = (torch.randn(N, D, generator=gen, device=dev)
                             for _ in range(6))
    mask = (torch.rand(N, generator=gen, device=dev) < 0.2).float()
    mask[0], mask[1] = 1.0, 0.0                  # both values present
    hp = dict(b=0.0917, a=0.00962, pa=0.2)
    p_page = 0.0216
    coins = [torch.zeros(1, device=dev), torch.ones(1, device=dev)]
    cases = {
        "dasha_update_batched": [(
            lambda: kernels.dasha_update_batched(gn, go, h, gi, mask, **hp),
            lambda: ref.dasha_update_batched_ref(gn, go, h, gi, mask, **hp))],
        "dasha_page_update_batched": [(
            lambda c=c: kernels.dasha_page_update_batched(
                gn, go, bn, bo, h, gi, mask, c, **hp, p_page=p_page),
            lambda c=c: ref.dasha_page_update_batched_ref(
                gn, go, bn, bo, h, gi, mask, c[0], **hp, p_page=p_page))
            for c in coins],
        "dasha_tail_batched": [(
            lambda: kernels.dasha_tail_batched(gn, h, gi, mask, a=hp["a"],
                                               pa=hp["pa"]),
            lambda: ref.dasha_tail_batched_ref(gn, h, gi, mask, a=hp["a"],
                                               pa=hp["pa"]))],
    }
    rows, failures = {}, []
    for kname, pairs in cases.items():
        err = 0.0
        for kernel_fn, plain_fn in pairs:
            before = kernels.launches[kname]
            outs = kernel_fn()
            torch.cuda.synchronize()
            check(kernels.launches[kname] == before + 1,
                  f"{kname} counted its launch")
            for o, r in zip(outs, plain_fn()):
                check(o.shape == r.shape, f"{kname} output shape")
                err = max(err, (o - r).abs().max().item())
        # exact: --fmad=false, each operation rounded alone on both sides
        if err != 0.0:
            failures.append(f"{kname}: max |kernel - plain| = {err}")
        kernel_fn, plain_fn = pairs[-1]
        ms, plain_ms = time_ms(kernel_fn, flush), time_ms(plain_fn, flush)
        replaces, transfers, flops, scalars = KERNELS[kname]
        nbytes = (transfers * N * D + N + scalars) * 4
        bytes_ms = nbytes / mem_rate * 1e3
        ops_ms = flops * N * D / f32_rate * 1e3
        rows[kname] = dict(
            name=kname, route="cuda", source=SOURCE, replaces=replaces,
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None, bytes=nbytes)
        emit("kernel", **rows[kname], shape=[N, D], tolerance="exact")
    check(not failures, "; ".join(failures))
    return rows


def phase_commit_kernel(dev, name, flush):
    """The buffered commit against its plain version at real-sim d, with
    K = 10 (the async phase's buffer) and K = 100 (the reference's
    capacity-n buffer), the last fifth of the rows at weight 0 as the
    reference pads.  Returns the K = 10 row of the kernels line."""
    mem_rate, f32_rate = card_rates(name)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    g = torch.randn(D, generator=gen, device=dev)
    inv_n = 1.0 / N
    row = None
    for kk in COMMIT_KS:
        m_buf = torch.randn(kk, D, generator=gen, device=dev)
        w = torch.rand(kk, generator=gen, device=dev)
        w[kk - kk // 5:] = 0.0
        before = kernels.launches[COMMIT]
        out = kernels.buffered_commit(g, m_buf, w, n_nodes=N)
        torch.cuda.synchronize()
        check(kernels.launches[COMMIT] == before + 1,
              f"{COMMIT} counted its launch")
        plain = ref.buffered_commit_ref(g, m_buf, w, n_nodes=N)
        check(out.shape == plain.shape == (D,), f"{COMMIT} output shape")
        err = (out - plain).abs().max().item()
        # exact: --fmad=false, the K rows summed in the same order
        check(err == 0.0, f"{COMMIT} K={kk}: max |kernel - plain| = {err}")
        library = torch.addmv(g, m_buf.t(), w, alpha=inv_n)
        ms = time_ms(lambda: kernels.buffered_commit(g, m_buf, w,
                                                     n_nodes=N), flush)
        plain_ms = time_ms(
            lambda: ref.buffered_commit_ref(g, m_buf, w, n_nodes=N), flush)
        library_ms = time_ms(
            lambda: torch.addmv(g, m_buf.t(), w, alpha=inv_n), flush)
        nbytes = (kk * D + 2 * D + kk) * 4
        bytes_ms = nbytes / mem_rate * 1e3
        ops_ms = (2 * kk * D + 2 * D) / f32_rate * 1e3
        fields = dict(
            name=COMMIT, route="cuda", source=SOURCE,
            replaces=COMMIT_REPLACES, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms, bytes=nbytes)
        emit("kernel", **fields, shape=[kk, D], tolerance="exact",
             library="torch.addmv",
             library_max_abs_err=(library - plain).abs().max().item())
        if kk == ASYNC_BUFFER:
            row = fields
    return row


def theory_hp(prob, comp, samp, variant):
    L, L_hat, L_max, L_sigma = prob.smoothness()
    c = rt.theory.ProblemConstants(L=L, L_hat=L_hat, L_max=L_max,
                                   L_sigma=L_sigma, n=prob.n, m=prob.m,
                                   d=prob.d)
    args = (c, comp.omega(prob.d), samp.p_a, samp.p_aa)
    if variant == "gradient":
        return rt.theory.dasha_pp_gradient(*args)
    fn = {"page": rt.theory.dasha_pp_page,
          "finite_mvr": rt.theory.dasha_pp_finite_mvr,
          "mvr": rt.theory.dasha_pp_mvr}[variant]
    return fn(*args, BATCH)


def make_alg(prob, comp, samp, variant, hp, dev):
    kw = dict(gamma=hp.gamma * GAMMA_SCALE, a=hp.a, b=hp.b, device=dev)
    if variant == "gradient":
        return rt.dasha_pp(prob, comp, samp, **kw)
    if variant == "page":
        return rt.dasha_pp_page(prob, comp, samp, p_page=hp.p_page,
                                batch_size=BATCH, **kw)
    if variant == "finite_mvr":
        return rt.dasha_pp_finite_mvr(prob, comp, samp, batch_size=BATCH,
                                      **kw)
    return rt.dasha_pp_mvr(prob, comp, samp, batch_size=BATCH, **kw)


def make_problem(dev):
    """The real-sim-width problem the main, async and fleet phases
    share, with the compressor and sampler of the main phase."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    feats, y = rt.make_synthetic_classification(gen, N, M, D,
                                                density=DENSITY, device=dev)
    prob = rt.LogisticSigmoidProblem(feats, y)
    torch.cuda.synchronize()
    x = torch.zeros(D, device=dev)
    emit("problem", n=N, m=M, d=D, density=DENSITY,
         feats_gb=feats.numel() * 4 / 1e9,
         seconds=time.perf_counter() - t0,
         grad_ms=time_ms(lambda: prob.grad(x)),
         loss_ms=time_ms(lambda: prob.loss(x)))
    return prob, rt.RandK(k=D // 20), rt.SNice(n=N, s=20)


def phase_main(dev, prob, comp, samp):
    """The main path at full width; returns launches per kernel."""
    x = torch.zeros(D, device=dev)
    total = {k: 0 for k in KERNELS}
    for variant, kname in KERNEL_OF.items():
        hp = theory_hp(prob, comp, samp, variant)
        alg = make_alg(prob, comp, samp, variant, hp, dev)
        alg.run(torch.Generator(device=dev).manual_seed(1), x, 2)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_gen = torch.Generator(device=dev).manual_seed(2)
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, met = alg.run(run_gen, x, ROUNDS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        counts = dict(kernels.launches)
        check(counts[kname] == ROUNDS and sum(counts.values()) == ROUNDS,
              f"{variant}: one {kname} launch per round, got {counts}")
        check(all(all_finite(v) for v in (*met, *state) if v is not None),
              f"{variant}: finite metrics and state")
        check(met.participants.tolist() == [20] * ROUNDS,
              f"{variant}: 20 participants per round")
        total[kname] += counts[kname]
        g = met.grad_norm_sq
        emit("main", variant=variant, rounds=ROUNDS, launches=counts,
             ms_per_round=seconds / ROUNDS * 1e3,
             peak_gb=peak_gb,
             gamma=hp.gamma * GAMMA_SCALE, a=hp.a, b=hp.b,
             grad_norm_sq_first=g[0].item(), grad_norm_sq_last=g[-1].item(),
             bits_per_round=met.bits_sent[0].item())
        del alg, state, met
    return total


def phase_trajectory(dev):
    """The same rounds on the card and on the CPU, from the same data and
    draws (made on the CPU and copied over)."""
    n, m, d = SMALL["n"], SMALL["m"], SMALL["d"]
    gen = torch.Generator().manual_seed(SEED)
    feats, y = rt.make_synthetic_classification(gen, n, m, d,
                                                density=DENSITY, device="cpu")
    probs = {"cpu": rt.LogisticSigmoidProblem(feats, y),
             "gpu": rt.LogisticSigmoidProblem(feats.to(dev), y.to(dev))}
    comp, samp = rt.RandK(k=d // 20), rt.SNice(n=n, s=5)
    for variant, kname in KERNEL_OF.items():
        hp = theory_hp(probs["cpu"], comp, samp, variant)
        cpu = make_alg(probs["cpu"], comp, samp, variant, hp, "cpu")
        gpu = make_alg(probs["gpu"], comp, samp, variant, hp, dev)
        draw_gen = torch.Generator().manual_seed(3)
        draws = [cpu.draw(draw_gen) for _ in range(TRAJ_ROUNDS)]
        st_c = cpu.init(torch.zeros(d))
        st_g = gpu.init(torch.zeros(d, device=dev))
        kernels.reset_launches()
        for dr in draws:
            st_c, _ = cpu.step(st_c, dr)
            st_g, _ = gpu.step(st_g, dr.to(dev))
        check(kernels.launches[kname] == TRAJ_ROUNDS,
              f"{variant}: the card's rounds went through {kname}")
        errs = {}
        for f in ("x", "g", "h_i", "g_i", "h_ij"):
            a, b = getattr(st_g, f), getattr(st_c, f)
            if b is None:
                continue
            a = a.cpu()
            errs[f] = (a - b).abs().max().item()
            check(torch.allclose(a, b, **TRAJ_TOL),
                  f"{variant}: {f} card vs CPU within {TRAJ_TOL}: "
                  f"max abs err {errs[f]}")
        emit("trajectory", variant=variant, rounds=TRAJ_ROUNDS, **SMALL,
             max_abs_err=errs, tolerance=TRAJ_TOL)


def async_args(variant, hp, device, n, m, d, cohort, buffer, rounds):
    """The async_train command line of one run, parsed by the CLI's own
    parser: lognormal latency (sigma 0.8), RandK(d/20) and the theory
    hyperparameters of the main phase."""
    argv = ["--device", device, "--variant", variant, "--rounds",
            str(rounds), "--n", str(n), "--m", str(m), "--d", str(d),
            "--cohort", str(cohort), "--buffer", str(buffer),
            "--latency", "lognormal", "--sigma", "0.8", "--ratio", "0.05",
            "--gamma", repr(hp.gamma * GAMMA_SCALE), "--a", repr(hp.a),
            "--b", repr(hp.b), "--batch-size", str(BATCH),
            "--seed", str(SEED)]
    if variant == "page":
        argv += ["--p-page", repr(hp.p_page)]
    return async_train.build_parser().parse_args(argv)


def phase_async(dev, prob, comp, samp):
    """The async_train CLI's server at full width, each variant; returns
    the buffered-commit launches of the four runs."""
    x = torch.zeros(D, device=dev)
    reg = obs_metrics.get_registry()
    total = 0
    for variant, kname in KERNEL_OF.items():
        hp = theory_hp(prob, comp, samp, variant)
        srv = async_train.build_server(
            async_args(variant, hp, str(dev), N, M, D, 20, ASYNC_BUFFER,
                       ASYNC_ROUNDS), problem=prob)
        srv.run(torch.Generator(device=dev).manual_seed(1), x, 2)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, res = srv.run(torch.Generator(device=dev).manual_seed(2), x,
                             ASYNC_ROUNDS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(kernels.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = len(res.time)
        commits = int((res.committed > 0).sum())
        check(counts[kname] == ASYNC_ROUNDS,
              f"async {variant}: one {kname} launch per round, got {counts}")
        check(counts[COMMIT] == commits > 0 and
              sum(counts.values()) == ASYNC_ROUNDS + commits,
              f"async {variant}: one {COMMIT} launch per committing server "
              f"step ({commits}), got {counts}")
        check(int(res.committed.sum()) == int(res.participants.sum()),
              f"async {variant}: every dispatched job committed")
        check(bool(np.all(np.isfinite(res.loss)))
              and bool(np.all(np.isfinite(res.grad_norm_sq)))
              and all(all_finite(v) for v in state if v is not None),
              f"async {variant}: finite metrics and state")
        total += counts[COMMIT]
        emit("async", variant=variant, rounds=ASYNC_ROUNDS,
             server_steps=steps, committing_steps=commits,
             buffer=ASYNC_BUFFER, launches=counts,
             ms_per_server_step=seconds / steps * 1e3, seconds=seconds,
             peak_gb=peak_gb, staleness_hist=res.staleness_hist,
             participants=int(res.participants.sum()),
             virtual_seconds=res.total_time,
             grad_norm_sq_first=float(res.grad_norm_sq[0]),
             grad_norm_sq_final=float(res.grad_norm_sq[-1]),
             h2d_bytes_per_round=reg.gauge("fleet.async.h2d_bytes").value
             / ASYNC_ROUNDS,
             d2h_bytes_per_round=reg.gauge("fleet.async.d2h_bytes").value
             / ASYNC_ROUNDS)
        del srv, state, res
    return total


def phase_async_trajectory(dev):
    """The async server on the card and on the CPU from the same data
    and the same draws (made on the CPU; the server copies them)."""
    n, m, d = SMALL["n"], SMALL["m"], SMALL["d"]
    gen = torch.Generator().manual_seed(SEED)
    feats, y = rt.make_synthetic_classification(gen, n, m, d,
                                                density=DENSITY, device="cpu")
    probs = {"cpu": rt.LogisticSigmoidProblem(feats, y),
             "card": rt.LogisticSigmoidProblem(feats.to(dev), y.to(dev))}
    comp, samp = rt.RandK(k=d // 20), rt.SNice(n=n, s=5)
    for variant, kname in KERNEL_OF.items():
        hp = theory_hp(probs["cpu"], comp, samp, variant)
        srv = {where: async_train.build_server(
                   async_args(variant, hp, device, n, m, d, 5, 3,
                              TRAJ_ROUNDS), problem=probs[where])
               for where, device in (("cpu", "cpu"), ("card", str(dev)))}
        draw_gen = torch.Generator().manual_seed(3)
        draws = [srv["cpu"].engine.draw(draw_gen) for _ in range(TRAJ_ROUNDS)]
        st_c, res_c = srv["cpu"].run(None, torch.zeros(d), TRAJ_ROUNDS,
                                     draws=draws)
        kernels.reset_launches()
        st_g, res_g = srv["card"].run(None, torch.zeros(d, device=dev),
                                      TRAJ_ROUNDS, draws=draws)
        torch.cuda.synchronize()
        check(kernels.launches[kname] == TRAJ_ROUNDS
              and kernels.launches[COMMIT] == int((res_g.committed > 0).sum())
              > 0, f"async {variant}: the card's server went through "
                   f"{kname} and {COMMIT}: {kernels.launches}")
        check(res_g.event_log == res_c.event_log,
              f"async {variant}: card and CPU play the same schedule")
        errs = {}
        pairs = [(f, getattr(st_g, f), getattr(st_c, f))
                 for f in ("x", "g", "h_i", "g_i", "h_ij")]
        pairs += [(f, torch.from_numpy(getattr(res_g, f)),
                   torch.from_numpy(getattr(res_c, f)))
                  for f in ("loss", "grad_norm_sq")]
        for f, a, b in pairs:
            if b is None:
                continue
            a = a.cpu()
            errs[f] = (a - b).abs().max().item()
            check(torch.allclose(a, b, **TRAJ_TOL),
                  f"async {variant}: {f} card vs CPU within {TRAJ_TOL}: "
                  f"max abs err {errs[f]}")
        emit("async-trajectory", variant=variant, rounds=TRAJ_ROUNDS,
             **SMALL, server_steps=len(res_g.time),
             staleness_hist=res_g.staleness_hist, max_abs_err=errs,
             tolerance=TRAJ_TOL)


def phase_fleet(dev, prob, comp, samp):
    """A depth-1 fleet at full width (gradient variant): the host-side
    tree and store around the engine's dispatch on the card."""
    hp = theory_hp(prob, comp, samp, "gradient")
    cfg = rt.DashaPPConfig("gradient", gamma=hp.gamma * GAMMA_SCALE,
                           a=hp.a, b=hp.b)
    wl = fl.DenseProblemWorkload(prob, comp, samp, cfg, device=dev)
    fleet = fl.HierarchicalFleet(
        wl, fl.FleetConfig(tiers=(fl.TierConfig(aggregators=FLEET_EDGES),)),
        fl.LognormalLatency(sigma=0.8, client_sigma=0.8, bandwidth_bps=2e5,
                            seed=SEED))
    kernels.reset_launches()
    t0 = time.perf_counter()
    fs, res = fleet.run(torch.Generator(device=dev).manual_seed(2),
                        np.zeros(D, np.float32), FLEET_ROUNDS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.launches)
    check(counts["dasha_update_batched"] == FLEET_ROUNDS
          and sum(counts.values()) == FLEET_ROUNDS,
          f"fleet: one dasha_update_batched launch per round, got {counts}")
    # the ledger: every hop's bits sum to the cumulative wire total
    check(res.bits_cum[-1] == res.tier_bits.sum(),
          f"fleet: bits_cum {res.bits_cum[-1]} != tier_bits "
          f"{res.tier_bits.sum()}")
    ledger = monitors.check_fleet_ledger(res)
    hops = monitors.check_hops_monotone(res.commit_log)
    check(ledger.ok and hops.ok, f"fleet monitors: {ledger} {hops}")
    check(int(res.committed.sum()) == int(res.participants.sum()) > 0,
          "fleet: every dispatched contribution committed")
    check(bool(np.all(np.isfinite(res.loss))) and
          bool(np.all(np.isfinite(fs.x))), "fleet: finite loss and x")
    emit("fleet", variant="gradient", depth=1, edges=FLEET_EDGES,
         rounds=FLEET_ROUNDS, root_steps=len(res.time), launches=counts,
         ms_per_round=seconds / FLEET_ROUNDS * 1e3, seconds=seconds,
         tier_bits=res.tier_bits.tolist(), bits_cum=float(res.bits_cum[-1]),
         messages=len(res.message_log), staleness_hist=res.staleness_hist,
         grad_norm_sq_final=float(res.grad_norm_sq[-1]),
         h2d_bytes_per_round=wl.h2d_bytes / FLEET_ROUNDS,
         d2h_bytes_per_round=wl.d2h_bytes / FLEET_ROUNDS)
    fs.store.close()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one",
              file=sys.stderr)
        return 1
    # full float32 products, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    phase_build()
    flush = torch.zeros(128 << 20 >> 2, device=dev)   # 128 MB > 50 MB L2
    rows = phase_kernels(dev, name, flush)
    rows[COMMIT] = phase_commit_kernel(dev, name, flush)
    del flush
    prob, comp, samp = make_problem(dev)
    launches = phase_main(dev, prob, comp, samp)
    torch.cuda.empty_cache()
    phase_trajectory(dev)
    launches[COMMIT] = phase_async(dev, prob, comp, samp)
    torch.cuda.empty_cache()
    phase_async_trajectory(dev)
    phase_fleet(dev, prob, comp, samp)
    for kname, count in launches.items():
        check(count > 0, f"the main path launched {kname}")
        rows[kname]["launches"] = count
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
