#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          (from the repository root; one card)

The main paths are Algorithm 1 of the paper (DASHA-PP rounds of all
four variants, with lines 9-11 of each round in the port's hand-written
CUDA kernels, ``src/repro_torch/kernels/csrc/dasha_update.cu``), the
asynchronous server of ``python -m repro_torch.launch.async_train``
(whose every commit runs the buffered-commit kernel), the hierarchical
fleet, and the LM trainer of ``python -m repro_torch.launch.train`` on
granite-3-2b at full width (the sharded engine, its sparse wire in the
tracker and payload-blocks kernels), and paged serving through
``PagedEngine`` of granite-3-2b (the GQA paged-attention kernel) and of
deepseek-v2-lite-16b (MLA + MoE; the absorbed-form paged MLA kernel),
each at its full width and depth.  Phases, each printed as one JSON
line:

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
9. kernel   -- the sparse wire's four kernels (and the batched update in
               its per-leaf form) and BlockRandK's block gather and block
               scatter (``csrc/randk.cu``) at granite-3-2b's ``w_gate``
               and ``embed`` leaves, 8 layers, 4 nodes, ratio 1/64,
               blocks of 128: equal to their plain versions, times
               beside bounds (the scatter also beside ``index_add_``);
10. train   -- the train CLI's ``build_trainer`` at full width from its
               flags ``--layers 8 --global-batch 8`` (8 of 40 layers,
               bf16, 4 nodes x 2 sequences of 4,096), p_a 0.5: gradient,
               mvr, page and finite-MVR on the sparse wire and mvr on
               ``dense_psum``, 3 steps each through ``loop.train``: one
               launch per leaf and step of the wire's kernels, ms per
               step, peak memory against the CLI's estimate, loss, grad
               norm, participants, bits;
11. train-breakdown -- ``torch.profiler`` over one node's gradient and
               one engine update: their times, the device's busy share,
               the top kernels;
12. train-trajectory -- the smoke trainer (float32) on the card and on the
               CPU from the same weights, batches and draws, 5 steps per
               variant, held allclose;
13. train-resume -- the smoke trainer on the card, 4 steps straight
               against 2 steps, a checkpoint, a restore and 2 more
               (gradient and finite-MVR), held allclose, the checkpoint
               numbering extended;
14. train-cli -- ``python -m repro_torch.launch.train --smoke`` on the card;
15. paged-kernel -- the paged GQA attention kernel
               (``csrc/paged_attention.cu``) against its plain version at
               granite-3-2b's serving shapes (16 slots, 2,048 tokens of
               context, 32 heads, 8 KV heads, hd 64, bf16 pages): C = 1
               and C = 256, with and without a 1,024 window, and its
               decode view; times beside the bound, the plain version and
               a note of ``paged_gather`` + ``scaled_dot_product_attention``;
               the bound takes the function's operations at the bf16
               tensor-core rate (``f32_ops_ms``: at the float32 rate);
16. serve   -- ``PagedEngine`` on granite-3-2b at all 40 layers, bf16:
               16 slots, 4,096 tokens a sequence, pages of 16, the
               dense-equivalent pool of 4,096 pages, chunked prefill of
               256 tokens a pass, 32 greedy requests of 512-2,048 prompt
               tokens and 64 new ones; every request finishes, logits
               finite, the pool conserved and drained, one kernel launch
               per layer and pass; tokens/s, ms per decode and mixed
               pass, TTFT and latency, peak memory against the serve
               CLI's estimate; then the same run under
               ``for_long_context()`` (window 4,096), whose tokens must
               equal the first run's; the device's busy share in one
               decode pass (``torch.profiler``) and in one mixed pass (16
               slots, each a 256-token chunk after 1,024 tokens of
               context), with the paged kernel's share of the latter
               (serve-mixed-breakdown);
17. serve-trajectory -- ``PagedEngine`` at smoke size (float32) on the
               card and on the CPU from the same weights: equal tokens,
               logits allclose;
18. serve-anchor -- at smoke size on the card, ``PagedEngine`` with one
               page a sequence against ``DecodeServer``, token for token;
19. serve-cli -- ``python -m repro_torch.launch.serve --engine paged
               --no-smoke`` on the card;
20. paged-mla-kernel -- the paged MLA kernel
               (``csrc/paged_mla_attention.cu``) against its plain version
               at deepseek-v2-lite-16b's serving shapes (16 slots, 2,048
               tokens of context in random pages of 16, 16 heads, r 512,
               rope 64, bf16 pages): C = 1 and C = 256, each with and
               without a 1,024 window; times beside the bound, the plain
               version and a note of ``paged_gather`` +
               ``scaled_dot_product_attention`` (one KV head);
21. serve-mla -- ``PagedEngine`` on deepseek-v2-lite-16b at all 27
               layers, bf16, with the serve phase's traffic and checks
               (one MLA kernel launch per layer and pass), and the
               device's busy share in one decode pass
               (serve-mla-breakdown) and one mixed pass
               (serve-mla-mixed-breakdown);
22. serve-mla-trajectory, serve-mla-anchor -- phases 17 and 18 on the
               deepseek smoke config;
23. serve-cli -- the serve CLI again with ``--arch deepseek-v2-lite-16b``;
24. the card's ``nvidia-smi`` line, the ``kernels`` line, and the ``ok``
   line, last.

Any failed check raises, so the script exits non-zero and prints no
``ok`` line; it does so at once without a CUDA device.
"""
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import numpy as np  # noqa: E402

import repro_torch as rt  # noqa: E402
import repro_torch.training.trainer  # noqa: E402,F401
from repro_torch import fl  # noqa: E402
from repro_torch import models as rt_models  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import dasha_update as kernels  # noqa: E402
from repro_torch.kernels import randk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import paged_attention  # noqa: E402
from repro_torch.launch import async_train  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as rt_layers  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.training import checkpoints  # noqa: E402
from repro_torch.training import loop as train_loop  # noqa: E402
from repro_torch.training.metrics import MetricsLogger  # noqa: E402
from repro_torch.training.trainer import per_node_value_and_grads  # noqa: E402,E501
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
RANDK_SOURCE = "src/repro_torch/kernels/csrc/randk.cu"
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
# The LM trainer at full width (granite-3-2b, cut to 8 of 40 layers for
# memory), and the sparse wire's kernels at its leaves.
TRAIN_LAYERS = 8
TRAIN_NODES = 4
TRAIN_SEQ, TRAIN_PER_NODE = 4096, 2
TRAIN_STEPS = 3
TRAIN_RATIO, TRAIN_BLOCK = 1 / 64, 128
TRAIN_PHASES = (("gradient", "sparse_allgather"), ("mvr", "sparse_allgather"),
                ("page", "sparse_allgather"), ("mvr", "dense_psum"),
                ("finite_mvr", "sparse_allgather"))
# the CLI's memory estimate must hold the measured peak, within 1.5x
ESTIMATE_SLACK = 1.5
TRAIN_TRAJ_STEPS = 5
# card vs CPU, float32 smoke trainer: cuBLAS and the CPU sum the model's
# products in other orders, index_add_ adds repeated blocks in another
# order on the card, and the differences travel through 5 steps
TRAIN_TRAJ_TOL = dict(rtol=1e-4, atol_scale=1e-4)
SPARSE_LEAVES = ("layers.mlp.w_gate", "embed")
# name -> (TPU kernel it replaces, (n, D) transfers, float ops per element,
# device scalars read besides the (n,) mask)
SPARSE_KERNELS = {
    "dasha_h_update": ("src/repro/kernels/dasha_update.py:311", 4, 7, 0),
    "dasha_page_h_update": ("src/repro/kernels/dasha_update.py:354", 6, 12,
                            1),
    # per selected element: reads, float ops (the write and the indices
    # counted apart)
    "dasha_payload_blocks": ("src/repro/kernels/dasha_update.py:456", 4, 9,
                             0),
    "dasha_page_payload_blocks": ("src/repro/kernels/dasha_update.py:513",
                                  6, 14, 1),
}
# BlockRandK's kernels: name -> TPU kernel it replaces
RANDK_KERNELS = {"block_gather": "src/repro/kernels/randk.py:39",
                 "block_scatter": "src/repro/kernels/randk.py:66"}
# (variant, sparse wire?) -> the kernels a compressed train step launches
# once per leaf; every compressed wire scatters each node's blocks into
# its row (block_scatter_rows)
WIRE_KERNELS = {("page", True): ("dasha_page_h_update",
                                 "dasha_page_payload_blocks",
                                 "block_scatter"),
                ("page", False): ("dasha_page_update_batched",
                                  "block_scatter"),
                ("gradient", True): ("dasha_h_update",
                                     "dasha_payload_blocks",
                                     "block_scatter"),
                ("gradient", False): ("dasha_update_batched",
                                      "block_scatter"),
                ("mvr", True): ("dasha_h_update", "dasha_payload_blocks",
                                "block_scatter"),
                ("mvr", False): ("dasha_update_batched", "block_scatter"),
                ("finite_mvr", True): ("dasha_tail_batched", "block_gather",
                                       "block_scatter"),
                ("finite_mvr", False): ("dasha_tail_batched",
                                        "block_scatter")}
# the per-leaf form of the batched update: the flat TPU kernel (#1)
FLAT_UPDATE = "dasha_update"
KERNEL_OF = {"gradient": "dasha_update_batched",
             "mvr": "dasha_update_batched",
             "page": "dasha_page_update_batched",
             "finite_mvr": "dasha_tail_batched"}
# Serving granite-3-2b at all 40 layers (bf16) through PagedEngine.  The
# paged kernel's two rows: launches with C > 1 (chunked-prefill passes)
# count as #12, those with C = 1 (pure-decode passes) as its decode view
# #13 (the wrapper's counters).
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
PAGED_KERNELS = {
    "paged_attention_batched": "src/repro/kernels/paged_attention.py:229",
    "paged_attention": "src/repro/kernels/paged_attention.py:284"}
SERVE_ARCH = "granite-3-2b"
# Serving deepseek-v2-lite-16b (MLA + MoE) at all 27 layers (bf16), with
# the serve phase's traffic: every layer of every pass reads its latent
# pages through the MLA kernel (#14).
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_SOURCE = "src/repro_torch/kernels/csrc/paged_mla_attention.cu"
MLA_KERNEL = "paged_mla_attention"
MLA_REPLACES = "src/repro/kernels/paged_attention.py:354"
SERVE = dict(batch=16, max_seq=4096, page_size=16, pages=4096, chunk=256)
SERVE_REQUESTS, SERVE_NEW = 32, 64
SERVE_PROMPT = (512, 2048)           # prompt tokens, drawn from the seed
PAGED_CTX = 2048                     # the kernel phase's context a slot
MIXED_CTX = 1024                     # the mixed-pass profile's, before
#                                      its chunk
PAGED_WINDOW = 1024
# kernel vs plain on the card: the same float32 products, summed in
# another order (the online softmax's tiles against a full softmax) over
# up to 2,048 positions
PAGED_TOL = dict(rtol=1e-4, atol=1e-5)
# card vs CPU at smoke size (float32): cuBLAS and the CPU sum the model's
# products in other orders, and the differences travel through two layers
# and the cache
SERVE_TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


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
    """(memory bytes/s, float32 FLOP/s outside the tensor cores, dense
    bf16 tensor-core FLOP/s) of the card, from NVIDIA's data sheets
    (dense rates, full power)."""
    if "H200" in name:
        return 4.8e12, 67e12, 989e12
    if "H100" in name:
        if "PCIe" in name:
            return 2.0e12, 51e12, 756e12
        if "NVL" in name:
            return 3.9e12, 60e12, 835e12
        return 3.35e12, 67e12, 989e12
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
    """The CUDA sources built at once, one ``nvcc`` each."""
    libs = {SOURCE: kernels.LIBRARY, RANDK_SOURCE: randk.LIBRARY,
            PAGED_SOURCE: paged_attention.LIBRARY,
            MLA_SOURCE: paged_attention.MLA_LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        built = dict(zip(libs, pool.map(build.build, libs.values())))
    seconds = time.perf_counter() - t0
    kernels.library()
    randk.library()
    paged_attention.library()
    paged_attention.mla_library()
    for source, b in built.items():
        # each kernel's (mangled) name, then its registers and spills
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        emit("build", source=source, library=b.path.name,
             seconds=b.seconds, flags=" ".join(build.NVCC_FLAGS),
             ptxas=ptxas, wall_seconds_both=seconds)


def phase_kernels(dev, name, flush):
    """Each kernel against its plain version on the same inputs."""
    mem_rate, f32_rate, _ = card_rates(name)
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
    mem_rate, f32_rate, _ = card_rates(name)
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


def train_args(variant, aggregation, *extra):
    """The train CLI's flags of one phase: full width, cut to
    TRAIN_LAYERS layers and TRAIN_PER_NODE sequences a node, unless
    ``extra`` says ``--smoke``."""
    cut = [] if "--smoke" in extra else [
        "--layers", str(TRAIN_LAYERS),
        "--global-batch", str(TRAIN_NODES * TRAIN_PER_NODE)]
    return train_cli.build_parser().parse_args(
        ["--variant", variant, "--aggregation", aggregation, "--ratio",
         repr(TRAIN_RATIO), "--nodes", str(TRAIN_NODES), "--p-page", "0.5",
         *cut, *extra])


def full_width_arch():
    return train_cli.run_shape(train_args("mvr", "sparse_allgather"))[0]


def phase_sparse_kernels(dev, name, flush):
    """The sparse wire's kernels at granite's largest leaf (``w_gate``)
    and at ``embed``, 4 nodes, against their plain versions; and the
    batched update in the per-leaf form the dense wires give it.
    Returns the ``w_gate`` rows of the kernels line."""
    mem_rate, f32_rate, _ = card_rates(name)
    shapes = rt_models.param_shapes(full_width_arch())
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    hp = dict(b=0.5 / 1.5, a=0.5 / (2 * (1 / TRAIN_RATIO - 1) + 1), pa=0.5)
    p_page = 0.125
    coins = [torch.zeros(1, device=dev), torch.ones(1, device=dev)]
    rows = {}
    for leaf in SPARSE_LEAVES:
        n, d = TRAIN_NODES, int(np.prod(shapes[leaf]))
        bs, nb, kb = rt.core.variants.block_plan(d, TRAIN_BLOCK, TRAIN_RATIO)
        scale = nb / kb
        gn, go, bn, bo, h, gi = (torch.randn(n, d, generator=gen, device=dev)
                                 for _ in range(6))
        mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
        idx = torch.stack([torch.randperm(nb, generator=gen, device=dev)[:kb]
                           for _ in range(n)]).to(torch.int32)
        blk = dict(hp, scale=scale, block_size=bs)
        cases = {
            "dasha_h_update": [(
                lambda: kernels.dasha_h_update(gn, go, h, mask, b=hp["b"],
                                               pa=hp["pa"]),
                lambda: ref.dasha_h_update_ref(gn, go, h, mask, b=hp["b"],
                                               pa=hp["pa"]))],
            "dasha_page_h_update": [(
                lambda c=c: kernels.dasha_page_h_update(
                    gn, go, bn, bo, h, mask, c, b=hp["b"], pa=hp["pa"],
                    p_page=p_page),
                lambda c=c: ref.dasha_page_h_update_ref(
                    gn, go, bn, bo, h, mask, c[0], b=hp["b"], pa=hp["pa"],
                    p_page=p_page)) for c in coins],
            "dasha_payload_blocks": [(
                lambda: kernels.dasha_payload_blocks(gn, go, h, gi, idx,
                                                     **blk),
                lambda: ref.dasha_payload_blocks_ref(gn, go, h, gi, idx,
                                                     **blk))],
            "dasha_page_payload_blocks": [(
                lambda c=c: kernels.dasha_page_payload_blocks(
                    gn, go, bn, bo, h, gi, idx, c, **blk, p_page=p_page),
                lambda c=c: ref.dasha_page_payload_blocks_ref(
                    gn, go, bn, bo, h, gi, idx, c[0], **blk,
                    p_page=p_page)) for c in coins],
        }
        for kname, pairs in cases.items():
            err = 0.0
            for kernel_fn, plain_fn in pairs:
                before = kernels.launches[kname]
                out = kernel_fn()
                torch.cuda.synchronize()
                check(kernels.launches[kname] == before + 1,
                      f"{kname} counted its launch")
                plain = plain_fn()
                check(out.shape == plain.shape, f"{kname} output shape")
                err = max(err, (out - plain).abs().max().item())
                del out, plain
            # exact: --fmad=false, each operation rounded alone on both
            check(err == 0.0, f"{kname} at {leaf}: max |kernel - plain| = "
                              f"{err}")
            kernel_fn, plain_fn = pairs[-1]
            ms, plain_ms = time_ms(kernel_fn, flush), time_ms(plain_fn,
                                                              flush)
            replaces, transfers, flops, scalars = SPARSE_KERNELS[kname]
            if "payload" in kname:
                # the selected elements inside the row (this run's
                # indices), each input read once; the (n, kb, bs) output
                # and the indices
                inside = int(((idx.long()[..., None] * bs
                               + torch.arange(bs, device=dev)) < d).sum())
                nbytes = (transfers * inside + n * kb * bs + n * kb
                          + scalars) * 4
                work = flops * inside
            else:
                nbytes = (transfers * n * d + n + scalars) * 4
                work = flops * n * d
            bytes_ms = nbytes / mem_rate * 1e3
            ops_ms = work / f32_rate * 1e3
            fields = dict(
                name=kname, route="cuda", source=SOURCE, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None, bytes=nbytes)
            emit("kernel", **fields, leaf=leaf, shape=[n, d],
                 blocks=[nb, bs], kb=kb, tolerance="exact")
            if leaf == SPARSE_LEAVES[0]:
                rows[kname] = fields
        if leaf == SPARSE_LEAVES[0]:
            # the dense wires' per-leaf form of the batched update
            fn = lambda: kernels.dasha_update_batched(gn, go, h, gi, mask,
                                                      **hp)
            before = kernels.launches["dasha_update_batched"]
            outs = fn()
            torch.cuda.synchronize()
            check(kernels.launches["dasha_update_batched"] == before + 1,
                  "dasha_update_batched counted its launch")
            err = max((o - r).abs().max().item() for o, r in zip(
                outs, ref.dasha_update_batched_ref(gn, go, h, gi, mask,
                                                   **hp)))
            check(err == 0.0, f"dasha_update_batched per leaf: {err}")
            del outs
            nbytes = (7 * n * d + n) * 4
            rows[FLAT_UPDATE] = dict(
                name=FLAT_UPDATE, route="cuda", source=SOURCE,
                replaces="src/repro/kernels/dasha_update.py:101",
                max_abs_err=err, ms=time_ms(fn, flush),
                plain_ms=time_ms(lambda: ref.dasha_update_batched_ref(
                    gn, go, h, gi, mask, **hp), flush),
                bound_ms=nbytes / mem_rate * 1e3, bound_by="bytes",
                library_ms=None, bytes=nbytes)
            emit("kernel", **rows[FLAT_UPDATE], leaf=leaf, shape=[n, d],
                 form="dasha_update_batched per leaf, one row per node "
                      "(the flat kernel)", tolerance="exact")
        del gn, go, bn, bo, h, gi, idx
        torch.cuda.empty_cache()
    return rows


def phase_randk_kernels(dev, name, flush):
    """BlockRandK's block gather and block scatter at the ``w_gate`` and
    ``embed`` leaves, 4 nodes, ratio 1/64, blocks of 128, on one
    round's draws, against their plain versions: the gather of a
    payload's selected blocks (finite-MVR's sparse wire), and the
    scatter of those blocks into each node's zero row at ``block_idx +
    nb * node`` (every compressed wire), whose rows this checks are
    distinct.  The scatter is timed beside ``index_add_``, the one
    PyTorch call that computes it; the gather has none (the gather and
    the scale are two calls).  Returns the ``w_gate`` rows."""
    mem_rate, f32_rate, _ = card_rates(name)
    shapes = rt_models.param_shapes(full_width_arch())
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    out_rows = {}
    for leaf in SPARSE_LEAVES:
        n, d = TRAIN_NODES, int(np.prod(shapes[leaf]))
        bs, nb, kb = rt.core.variants.block_plan(d, TRAIN_BLOCK, TRAIN_RATIO)
        scale, sel = nb / kb, n * kb * bs
        payload = torch.randn(n, d, generator=gen, device=dev)
        idx = torch.stack([torch.randperm(nb, generator=gen, device=dev)[:kb]
                           for _ in range(n)])
        rows = (idx + nb * torch.arange(n, device=dev)[:, None]).reshape(-1)
        check(rows.unique().numel() == rows.numel(),
              f"block_scatter at {leaf}: the rows of the draw are distinct")
        # the selected elements inside the row (this run's indices)
        inside = int(((idx[..., None] * bs
                       + torch.arange(bs, device=dev)) < d).sum())
        base = torch.zeros(n * nb, bs, device=dev)

        def gather():
            return randk.block_gather(payload, idx, scale=scale,
                                      block_size=bs)

        def plain_gather():
            return ref.block_gather_ref(payload, idx, scale=scale,
                                        block_size=bs)

        before = dict(kernels.launches)
        vals = gather().reshape(-1, bs)
        # in place: onto zero rows, each side its own
        scattered = randk.block_scatter(torch.zeros_like(base), vals, rows)
        torch.cuda.synchronize()
        errs = {"block_gather": (vals.view(n, kb, bs)
                                 - plain_gather()).abs().max().item(),
                "block_scatter": (scattered - ref.block_scatter_ref(
                    torch.zeros_like(base), vals, rows)).abs().max().item()}
        del scattered
        cases = {
            # kernel, plain version, library call, bytes, float ops
            "block_gather": (gather, plain_gather, None,
                             inside * 4 + sel * 4 + n * kb * 8, inside),
            # base rows read and written, the values read, the rows
            "block_scatter": (
                lambda: randk.block_scatter(base, vals, rows),
                lambda: ref.block_scatter_ref(base, vals, rows),
                lambda: base.index_add_(0, rows, vals),
                3 * sel * 4 + n * kb * 8, sel),
        }
        for kname, (kernel_fn, plain_fn, library_fn, nbytes,
                    flops) in cases.items():
            check(kernels.launches[kname] == before[kname] + 1,
                  f"{kname} counted its launch")
            # exact: one multiply (gather) or one add (scatter) a side
            check(errs[kname] == 0.0, f"{kname} at {leaf}: max |kernel - "
                                      f"plain| = {errs[kname]}")
            bytes_ms = nbytes / mem_rate * 1e3
            ops_ms = flops / f32_rate * 1e3
            fields = dict(
                name=kname, route="cuda", source=RANDK_SOURCE,
                replaces=RANDK_KERNELS[kname], max_abs_err=errs[kname],
                ms=time_ms(kernel_fn, flush),
                plain_ms=time_ms(plain_fn, flush),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=(None if library_fn is None
                            else time_ms(library_fn, flush)),
                bytes=nbytes)
            emit("kernel", **fields, leaf=leaf, shape=[n, d],
                 blocks=[nb, bs], kb=kb, tolerance="exact",
                 library=("torch.Tensor.index_add_" if library_fn
                          else "none: the gather and the scale are two "
                               "PyTorch calls"))
            if leaf == SPARSE_LEAVES[0]:
                out_rows[kname] = fields
        del payload, base, vals, idx, rows
        torch.cuda.empty_cache()
    return out_rows


class Recorder(MetricsLogger):
    """The loop's logger, keeping every row (printing none)."""

    def __init__(self):
        super().__init__(print_every=1 << 30)
        self.rows = []

    def log(self, step, **metrics):
        super().log(step, **metrics)
        self.rows.append(dict(step=step, wall_s=time.time() - self._t0,
                              **{k: float(v) for k, v in metrics.items()}))


def phase_train(dev, variant, aggregation):
    """One full-width phase through the CLI's ``build_trainer`` and the
    loop's ``train``; returns (launches, trainer, state, batch)."""
    args = train_args(variant, aggregation, "--device", str(dev))
    estimate = train_cli.estimate_for(args)
    # earlier phases' cyclic garbage (the real-sim problem's features
    # among it) is freed now, not inside this phase's peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer, state, data, arch = train_cli.build_trainer(args)
    check(arch.num_layers == TRAIN_LAYERS and data.seq_len == TRAIN_SEQ
          and data.global_batch == TRAIN_NODES * TRAIN_PER_NODE,
          f"train {variant}: the flags give the cut")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stream = train_cli.batches(args, arch, data)
    rec = Recorder()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = train_loop.train(trainer, state, stream, TRAIN_STEPS,
                             logger=rec, log_every=1, seed=SEED, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.launches)
    leaves = len(trainer.engine.shapes)
    sparse = aggregation == "sparse_allgather"
    expect = {k: leaves * TRAIN_STEPS for k in WIRE_KERNELS[variant, sparse]}
    check({k: v for k, v in counts.items() if v} == expect,
          f"train {variant} {aggregation}: one launch per leaf and step of "
          f"{sorted(expect)}, got {counts}")
    rows = rec.rows
    check(len(rows) == TRAIN_STEPS and all(
        np.isfinite([r["loss"], r["grad_norm"], r["bits_sent"]]).all()
        for r in rows), f"train {variant}: finite metrics")
    check(all(all_finite(v) for v in state.params.values()),
          f"train {variant}: finite params")
    walls = [r["wall_s"] for r in rows]
    peak = torch.cuda.max_memory_allocated() - resident
    check(peak <= estimate <= ESTIMATE_SLACK * peak,
          f"train {variant} {aggregation}: the CLI's estimate "
          f"{estimate / 1e9:.2f} GB holds the peak {peak / 1e9:.2f} GB "
          f"within {ESTIMATE_SLACK}x")
    bits_node = trainer.engine.message_bits_per_node()
    check(all(r["bits_sent"] == r["participants"] * bits_node for r in rows),
          f"train {variant}: bits = participants x bits per node")
    emit("train", variant=variant, wire=aggregation, steps=TRAIN_STEPS,
         layers=arch.num_layers, d_model=arch.d_model,
         heads=arch.num_heads, kv_heads=arch.num_kv_heads, d_ff=arch.d_ff,
         vocab=arch.vocab_size, dtype=arch.dtype,
         params=rt_models.count_params(state.params), nodes=TRAIN_NODES,
         global_batch=data.global_batch, seq_len=data.seq_len,
         launches=counts, setup_s=setup_s, seconds=seconds,
         ms_first_step=walls[0] * 1e3,
         ms_per_step=(walls[-1] - walls[0]) / (len(walls) - 1) * 1e3,
         peak_gb=peak / 1e9, resident_gb=resident / 1e9,
         estimate_gb=estimate / 1e9,
         estimate_over_peak=estimate / peak,
         component_batch=args.component_batch if variant == "finite_mvr"
         else None,
         loss=[r["loss"] for r in rows],
         grad_norm=[r["grad_norm"] for r in rows],
         participants=[r["participants"] for r in rows],
         bits_sent=[r["bits_sent"] for r in rows], bits_per_node=bits_node)
    return counts, trainer, state, train_loop.to_device(next(stream), dev)


def is_annotation(evt):
    """Whether a profiler event is a ``record_function`` range
    (``trace.kernel_scope``'s ``repro.kernel.<name>``), which the
    profiler also puts on the card's timeline, and not a kernel."""
    return (bool(getattr(evt, "is_user_annotation", False))
            or evt.key.startswith("repro."))


def device_kernels(prof):
    """The card's kernels in a profile, the ranges left out."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not is_annotation(e)]


def busy_share(prof):
    """(device-busy ms, kernels): the union of the kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_kernels(prof))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(spans)


def phase_train_breakdown(dev, trainer, state, batch):
    """Where a step goes: the node gradients against the engine, and the
    device's busy share inside one node's gradient."""
    from torch.profiler import ProfilerActivity, profile
    params = state.params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_node_value_and_grads(trainer.model.loss, params, batch)
    torch.cuda.synchronize()
    grads_ms = (time.perf_counter() - t0) * 1e3
    _, _, g_new, g_old = trainer.full_pass(params, params, batch)
    draws = trainer.engine.draw(train_loop.round_generator(SEED, 99, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.engine.node_update(g_new, g_old, state.dasha, draws)
    torch.cuda.synchronize()
    engine_ms = (time.perf_counter() - t0) * 1e3
    del g_new, g_old
    node = {k: v[:1] for k, v in batch.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        per_node_value_and_grads(trainer.model.loss, params, node)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, launches = busy_share(prof)
    check(launches > 0, "the profiler saw the card's kernels")
    top = []
    for avg in prof.key_averages():
        t = getattr(avg, "self_device_time_total",
                    getattr(avg, "self_cuda_time_total", 0.0))
        if (t > 0 and avg.device_type == torch.autograd.DeviceType.CUDA
                and not is_annotation(avg)):
            top.append([avg.key[:60], t / 1e3, avg.count])
    top.sort(key=lambda r: -r[1])
    emit("train-breakdown", variant=trainer.cfg.dasha.variant,
         wire=trainer.cfg.dasha.aggregation, grads_ms=grads_ms,
         gradients=TRAIN_NODES, engine_ms=engine_ms,
         node_gradient_wall_ms=wall_ms, node_gradient_device_ms=device_ms,
         device_busy_share=device_ms / wall_ms, kernel_launches=launches,
         top_kernels=top[:8])


def phase_train_trajectory(dev):
    """The smoke trainer (float32) on the card and on the CPU from the
    same weights, batches and draws (drawn on the CPU)."""
    for variant, aggregation in TRAIN_PHASES:
        args = train_args(variant, aggregation, "--smoke", "--device", "cpu")
        cpu, st_c, data, arch = train_cli.build_trainer(args)
        params = {k: v.to(dev) for k, v in st_c.params.items()}
        card = rt.training.trainer.Trainer(
            rt_models.Model(arch, params), cpu.cfg, num_nodes=TRAIN_NODES)
        st_g = card.init()
        stream = train_cli.batches(args, arch, data)
        kernels.reset_launches()
        mets = []
        for t in range(TRAIN_TRAJ_STEPS):
            batch = train_loop.to_device(next(stream), "cpu")
            draws = cpu.engine.draw(
                train_loop.round_generator(SEED, t, "cpu"))
            st_c, m_c = cpu.train_step(st_c, batch, draws)
            st_g, m_g = card.train_step(
                st_g, {k: v.to(dev) for k, v in batch.items()},
                draws.to(dev))
            mets.append((m_c, m_g))
        torch.cuda.synchronize()
        sparse = aggregation == "sparse_allgather"
        want = {k: len(card.engine.shapes) * TRAIN_TRAJ_STEPS
                for k in WIRE_KERNELS[variant, sparse]}
        check({k: v for k, v in kernels.launches.items() if v} == want,
              f"train-trajectory {variant}: the card's steps went through "
              f"{sorted(want)}: {kernels.launches}")
        for m_c, m_g in mets:
            check(float(m_c.bits_sent) == float(m_g.bits_sent)
                  and float(m_c.participants) == float(m_g.participants),
                  f"train-trajectory {variant}: equal bits and participants")
        errs, worst = state_errors(st_g, st_c,
                                   f"train-trajectory {variant}")
        emit("train-trajectory", variant=variant, wire=aggregation,
             steps=TRAIN_TRAJ_STEPS, layers=arch.num_layers,
             d_model=arch.d_model, nodes=TRAIN_NODES,
             coins=[bool(cpu.engine.draw(train_loop.round_generator(
                 SEED, t, "cpu")).coin) for t in range(TRAIN_TRAJ_STEPS)]
             if variant == "page" else None,
             max_abs_err_by_part=errs, worst_leaf=worst,
             tolerance=TRAIN_TRAJ_TOL)


def state_errors(st_a, st_b, what):
    """Per state part, the largest |a - b| over its leaves and the leaf
    that has it; checks every leaf within TRAIN_TRAJ_TOL (atol scaled by
    the leaf's largest magnitude), on the CPU."""
    errs, worst = {}, {}
    for part in ("params", "g", "g_i", "h_i", "h_ij"):
        a_tree = st_a.params if part == "params" else getattr(st_a.dasha,
                                                              part)
        b_tree = st_b.params if part == "params" else getattr(st_b.dasha,
                                                              part)
        if b_tree is None:
            continue
        for k, b in b_tree.items():
            a, b = a_tree[k].cpu(), b.cpu()
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            ok = torch.allclose(a, b, rtol=TRAIN_TRAJ_TOL["rtol"],
                                atol=TRAIN_TRAJ_TOL["atol_scale"] * scale)
            check(ok, f"{what}: {part}/{k}: max abs err {err} (leaf max "
                      f"{scale})")
            if err >= errs.get(part, -1.0):
                errs[part], worst[part] = err, f"{part}/{k}"
    return errs, worst


def phase_train_resume(dev):
    """A run resumed from a checkpoint continues the straight run: the
    smoke trainer on the card, 4 steps in one go against 2 steps saved
    every 2, a restore onto a fresh state and 2 more, through
    ``loop.train`` (gradient: its cache restored; finite-MVR: its
    ``h_ij``).  Not bitwise on the card: the server's ``index_add_``
    sums blocks that several nodes chose in an order that varies."""
    for variant in ("gradient", "finite_mvr"):
        args = train_args(variant, "sparse_allgather", "--smoke",
                          "--device", str(dev))

        def run(state, trainer, stream, steps, where=None):
            return train_loop.train(trainer, state, stream, steps,
                                    seed=SEED, device=dev, log_every=100,
                                    checkpoint_dir=where,
                                    checkpoint_every=2 if where else 0)

        with tempfile.TemporaryDirectory() as where:
            trainer, state, data, arch = train_cli.build_trainer(args)
            straight = run(state, trainer,
                           train_cli.batches(args, arch, data), 4)
            trainer, state, _, _ = train_cli.build_trainer(args)
            run(state, trainer, train_cli.batches(args, arch, data), 2,
                where)
            trainer, like, _, _ = train_cli.build_trainer(args)
            kernels.reset_launches()
            restored = checkpoints.restore_checkpoint(where, like)
            check(restored.step == 2 and restored.dasha.step == 2,
                  f"train-resume {variant}: restored at step 2")
            resumed = run(restored, trainer,
                          train_cli.batches(args, arch, data), 2, where)
            torch.cuda.synchronize()
            files = sorted(f for f in os.listdir(where)
                           if f.endswith(".npz"))
        check(files == ["ckpt_00000002.npz", "ckpt_00000004.npz"],
              f"train-resume {variant}: the numbering extends: {files}")
        check(kernels.launches["block_scatter"] > 0,
              f"train-resume {variant}: the resumed steps ran on the card")
        errs, worst = state_errors(resumed, straight,
                                   f"train-resume {variant}")
        emit("train-resume", variant=variant, steps=[2, 2],
             checkpoints=files, max_abs_err_by_part=errs, worst_leaf=worst,
             tolerance=TRAIN_TRAJ_TOL)


def phase_train_cli():
    """The train CLI's smoke run on the card, as a user starts it."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "2"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("[step")]
    check(proc.returncode == 0 and len(rows) == 1,
          f"train CLI: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    emit("train-cli", returncode=proc.returncode, rows=rows,
         seconds=time.perf_counter() - t0)


def paged_inputs(dev, gen, C, lo, hi):
    """Serving-shape inputs of the paged kernel: 16 slots of PAGED_CTX
    tokens each in distinct random pages of a bf16 pool, q (16, C, 32,
    64) bf16, ``start`` in ``[lo, hi]`` and ``q_lens`` in ``[1, C]``
    from the seed (``start + q_lens <= PAGED_CTX``)."""
    arch = serve_arch()
    B, P = SERVE["batch"], SERVE["page_size"]
    H, kvh, hd = arch.num_heads, arch.num_kv_heads, arch.hd
    M = PAGED_CTX // P
    k = torch.randn(B * M, P, kvh, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn(B * M, P, kvh, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn(B, C, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    table = torch.randperm(B * M, generator=gen, device=dev).reshape(
        B, M).to(torch.int32)
    start = torch.randint(lo, hi + 1, (B,), generator=gen,
                          device=dev).to(torch.int32)
    q_lens = (torch.ones(B, dtype=torch.int32, device=dev) if C == 1 else
              torch.minimum(torch.randint(1, C + 1, (B,), generator=gen,
                                          device=dev),
                            PAGED_CTX - start).to(torch.int32))
    return q, k, v, table, start, q_lens


def paged_work(start, q_lens, window, H, kvh, hd):
    """(K/V bytes, float ops) this run's rows need: each slot's live
    positions read once per kv head (bf16 K and V), and 4 H hd flops for
    every (valid query, position it attends) pair."""
    kv_bytes, flops = 0, 0
    for s0, n in zip(start.tolist(), q_lens.tolist()):
        lo = max(0, s0 - window + 1) if window else 0
        kv_bytes += (s0 + n - lo) * kvh * hd * 2 * 2
        for c in range(n):
            pos = s0 + c
            flops += 4 * H * hd * (min(pos + 1, window) if window
                                   else pos + 1)
    return kv_bytes, flops


def phase_paged_kernels(dev, name, flush):
    """The paged attention kernel against its plain version at serving
    shapes: #12 at C = 256 and C = 1, with and without a window, and
    #13 (the decode view) at C = 1.  Rows ``c >= q_lens`` are garbage by
    contract: the kernel writes 0 there, which is checked, and the
    comparison covers the valid rows.  The bound is the larger of the
    bytes over the memory rate and the function's operations over the
    bf16 tensor-core rate (``f32_ops_ms``: those operations at the
    float32 rate).  Returns the rows of the kernels line (the unwindowed
    cases)."""
    import torch.nn.functional as F
    mem_rate, f32_rate, tc_rate = card_rates(name)
    arch = serve_arch()
    H, kvh, hd = arch.num_heads, arch.num_kv_heads, arch.hd
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    rows = {}
    for C, window in ((256, None), (256, PAGED_WINDOW), (1, None),
                      (1, PAGED_WINDOW)):
        lo = PAGED_CTX // 2 if C == 1 else 0
        q, k, v, table, start, q_lens = paged_inputs(
            dev, gen, C, lo, PAGED_CTX - (1 if C == 1 else C))
        cases = {"paged_attention_batched": (
            lambda: paged_attention.paged_attention_batched(
                q, k, v, table, start, q_lens, window=window),
            lambda: ref.paged_attention_batched_ref(
                q, k, v, table, start, q_lens, window=window))}
        if C == 1:
            lens = start + 1
            cases["paged_attention"] = (
                lambda: paged_attention.paged_attention(
                    q[:, 0], k, v, table, lens, window=window)[:, None],
                lambda: ref.paged_attention_ref(
                    q[:, 0], k, v, table, lens, window=window)[:, None])
        valid = (torch.arange(C, device=dev)[None, :]
                 < q_lens[:, None].long())                    # (B, C)
        kv_bytes, flops = paged_work(start, q_lens, window, H, kvh, hd)
        nbytes = (kv_bytes + q.numel() * 2 + q.numel() * 4
                  + table.numel() * 4 + 2 * start.numel() * 4)
        bytes_ms = nbytes / mem_rate * 1e3
        # the function's operations at the bf16 tensor-core rate (the
        # split terms' extra MMAs not counted), and at the float32 rate
        # of PRs 17-18's bounds
        ops_ms = flops / tc_rate * 1e3
        f32_ops_ms = flops / f32_rate * 1e3

        def sdpa():
            kg = rt_layers.paged_gather(k, table).transpose(1, 2)
            vg = rt_layers.paged_gather(v, table).transpose(1, 2)
            q_pos = start[:, None].long() + torch.arange(C, device=dev)
            idx = torch.arange(kg.shape[2], device=dev)
            mask = idx[None, None] <= q_pos[..., None]
            if window:
                mask &= idx[None, None] > q_pos[..., None] - window
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kg, vg, attn_mask=mask[:, None],
                enable_gqa=True)

        sdpa_ms = time_ms(sdpa, flush)
        for kname, (kernel_fn, plain_fn) in cases.items():
            key = "paged_attention" if C == 1 else kname
            before = kernels.launches[key]
            out = kernel_fn()
            torch.cuda.synchronize()
            check(kernels.launches[key] == before + 1,
                  f"{kname} C={C} counted its launch under {key}")
            plain = plain_fn()
            check(out.shape == plain.shape == q.shape,
                  f"{kname} output shape")
            check(bool((out[~valid] == 0).all()),
                  f"{kname} C={C}: rows c >= q_lens written 0")
            err = (out[valid] - plain[valid]).abs().max().item()
            check(torch.allclose(out[valid], plain[valid], **PAGED_TOL),
                  f"{kname} C={C} window={window}: max |kernel - plain| = "
                  f"{err} beyond {PAGED_TOL}")
            fields = dict(
                name=kname, route="cuda", source=PAGED_SOURCE,
                replaces=PAGED_KERNELS[kname], max_abs_err=err,
                ms=time_ms(kernel_fn, flush),
                plain_ms=time_ms(plain_fn, flush),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None, bytes=nbytes, flops=flops,
                f32_ops_ms=f32_ops_ms)
            emit("paged-kernel", **fields, C=C, window=window,
                 shape=[SERVE["batch"], C, H, hd], kv_heads=kvh,
                 context=PAGED_CTX, page_size=SERVE["page_size"],
                 valid_rows=int(valid.sum()), tolerance=PAGED_TOL,
                 library="none: the page gather and the attention are two "
                         "PyTorch calls",
                 sdpa_note_ms=sdpa_ms,
                 sdpa_note="paged_gather + scaled_dot_product_attention "
                           "(bf16, enable_gqa), timed beside it")
            if window is None and (kname != "paged_attention_batched"
                                   or C > 1):
                rows[kname] = fields
        del q, k, v, table
    torch.cuda.empty_cache()
    return rows


def mla_work(start, q_lens, window, H, r, rr):
    """(latent bytes, float ops) this run's rows need: each slot's live
    positions read once (bf16 c_kv and k_rope), and 2 H (r + rope + r)
    operations for every (valid query, position it attends) pair."""
    kv_bytes, flops = 0, 0
    for s0, n in zip(start.tolist(), q_lens.tolist()):
        lo = max(0, s0 - window + 1) if window else 0
        kv_bytes += (s0 + n - lo) * (r + rr) * 2
        for c in range(n):
            pos = s0 + c
            flops += 2 * H * (2 * r + rr) * (min(pos + 1, window) if window
                                             else pos + 1)
    return kv_bytes, flops


def phase_paged_mla_kernels(dev, name, flush):
    """The MLA kernel against its plain version at deepseek-v2-lite-16b's
    serving shapes, as the model calls it (q_abs float32, q_rope and the
    pages bf16): C = 256 (``q_lens`` in [1, 256] from the seed) and
    C = 1, with and without a window.  Rows ``c >= q_lens`` must be 0;
    the comparison covers the valid rows.  Bounds as in
    :func:`phase_paged_kernels`.  Returns the kernels line's row
    (C = 256, no window, the chunked-prefill passes' launch)."""
    import torch.nn.functional as F
    mem_rate, f32_rate, tc_rate = card_rates(name)
    arch = serve_arch(arch_id=MLA_ARCH)
    a, H = arch.mla, arch.num_heads
    r, rr = a.kv_lora_rank, a.qk_rope_head_dim
    scale = 1.0 / (a.qk_nope_head_dim + rr) ** 0.5
    B, P = SERVE["batch"], SERVE["page_size"]
    M = PAGED_CTX // P
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    ckv = torch.randn(B * M, P, r, generator=gen, device=dev).to(
        torch.bfloat16)
    kr = torch.randn(B * M, P, rr, generator=gen, device=dev).to(
        torch.bfloat16)
    table = torch.randperm(B * M, generator=gen, device=dev).reshape(
        B, M).to(torch.int32)
    rows = {}
    for C, window in ((256, None), (256, PAGED_WINDOW), (1, None),
                      (1, PAGED_WINDOW)):
        # q_abs at the scale of q_nope W_uk (unit-variance rows times
        # weights of variance 1/r over 128 dims)
        q_abs = torch.randn(B, C, H, r, generator=gen, device=dev) * 0.5
        q_rope = torch.randn(B, C, H, rr, generator=gen, device=dev).to(
            torch.bfloat16)
        lo, hi = (PAGED_CTX // 2, PAGED_CTX - 1) if C == 1 else (
            0, PAGED_CTX - C)
        start = torch.randint(lo, hi + 1, (B,), generator=gen,
                              device=dev).to(torch.int32)
        q_lens = (torch.ones(B, dtype=torch.int32, device=dev) if C == 1
                  else torch.minimum(torch.randint(1, C + 1, (B,),
                                                   generator=gen, device=dev),
                                     PAGED_CTX - start).to(torch.int32))
        args = (q_abs, q_rope, ckv, kr, table, start, q_lens)

        def kernel_fn():
            return paged_attention.paged_mla_attention(
                *args, scale=scale, window=window)

        def plain_fn():
            return ref.paged_mla_attention_ref(*args, scale=scale,
                                               window=window)

        def sdpa():
            # one KV head of width r + rope against H query heads, values
            # the latent rows: the absorbed read as MQA
            kv = torch.cat([ckv, kr], dim=-1)
            kg = rt_layers.paged_gather(kv, table)[:, None]   # (B,1,S,576)
            vg = rt_layers.paged_gather(ckv, table)[:, None]
            q = torch.cat([q_abs.to(torch.bfloat16), q_rope],
                          dim=-1).transpose(1, 2)          # (B,H,C,576)
            q_pos = start[:, None].long() + torch.arange(C, device=dev)
            idx = torch.arange(kg.shape[2], device=dev)
            mask = idx[None, None] <= q_pos[..., None]
            if window:
                mask &= idx[None, None] > q_pos[..., None] - window
            return F.scaled_dot_product_attention(
                q, kg, vg, attn_mask=mask[:, None], scale=scale,
                enable_gqa=True)

        try:
            sdpa_ms, sdpa_note = time_ms(sdpa, flush), (
                "paged_gather + scaled_dot_product_attention (bf16, one KV "
                "head, enable_gqa, q/k 576 wide, v 512), timed beside it")
        except RuntimeError as exc:
            sdpa_ms, sdpa_note = None, f"SDPA refused the shapes: {exc}"
        valid = (torch.arange(C, device=dev)[None, :]
                 < q_lens[:, None].long())                    # (B, C)
        kv_bytes, flops = mla_work(start, q_lens, window, H, r, rr)
        nbytes = (kv_bytes + q_abs.numel() * 4 + q_rope.numel() * 2
                  + q_abs.numel() * 4 + table.numel() * 4
                  + 2 * start.numel() * 4)
        bytes_ms = nbytes / mem_rate * 1e3
        # the function's operations at the bf16 tensor-core rate (the
        # split terms' extra MMAs not counted), and at the float32 rate
        # of PRs 17-18's bounds
        ops_ms = flops / tc_rate * 1e3
        f32_ops_ms = flops / f32_rate * 1e3
        before = kernels.launches[MLA_KERNEL]
        out = kernel_fn()
        torch.cuda.synchronize()
        check(kernels.launches[MLA_KERNEL] == before + 1,
              f"{MLA_KERNEL} C={C} counted its launch")
        plain = plain_fn()
        check(out.shape == plain.shape == q_abs.shape,
              f"{MLA_KERNEL} output shape")
        check(bool((out[~valid] == 0).all()),
              f"{MLA_KERNEL} C={C}: rows c >= q_lens written 0")
        err = (out[valid] - plain[valid]).abs().max().item()
        check(torch.allclose(out[valid], plain[valid], **PAGED_TOL),
              f"{MLA_KERNEL} C={C} window={window}: max |kernel - plain| = "
              f"{err} beyond {PAGED_TOL}")
        del out, plain
        fields = dict(
            name=MLA_KERNEL, route="cuda", source=MLA_SOURCE,
            replaces=MLA_REPLACES, max_abs_err=err,
            ms=time_ms(kernel_fn, flush), plain_ms=time_ms(plain_fn, flush),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None, bytes=nbytes, flops=flops,
                f32_ops_ms=f32_ops_ms)
        emit("paged-mla-kernel", **fields, C=C, window=window,
             shape=[B, C, H, r], rope=rr, context=PAGED_CTX, page_size=P,
             valid_rows=int(valid.sum()), tolerance=PAGED_TOL,
             splits=paged_attention.mla_library().paged_mla_attention_splits(
                 B, C, H, P, M),
             library="none: the page gather and the attention are two "
                     "PyTorch calls",
             sdpa_note_ms=sdpa_ms, sdpa_note=sdpa_note)
        if C == 256 and window is None:
            rows[MLA_KERNEL] = fields
        del args, q_abs, q_rope
    del ckv, kr, table
    torch.cuda.empty_cache()
    return rows


def serve_arch(long_context=False, arch_id=SERVE_ARCH):
    """The served config as the reference gives it: granite-3-2b at 40
    layers, deepseek-v2-lite-16b at 27, bf16."""
    arch = rt_models.get_config(arch_id)
    return arch.for_long_context() if long_context else arch


def serve_requests(vocab):
    rng = np.random.default_rng(SEED)
    return [serving.Request(
        uid=i, prompt=rng.integers(1, vocab, int(rng.integers(
            SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))).tolist(),
        max_new_tokens=SERVE_NEW) for i in range(SERVE_REQUESTS)]


def serve_launches(arch, m):
    """The kernel launches a serve run must count: one per layer and
    pass, the GQA kernel's C = 1 (decode) passes as #13, or one MLA
    launch per layer and pass."""
    L = arch.num_layers
    if arch.mla is not None:
        return {MLA_KERNEL: L * (m["decode_steps"] + m["mixed_passes"])}
    return {"paged_attention": L * m["decode_steps"],
            "paged_attention_batched": L * m["mixed_passes"]}


def phase_serve(dev, long_context=False, arch_id=SERVE_ARCH):
    """PagedEngine at full width; returns (launches by kernel, the
    generated tokens, the engine)."""
    arch = serve_arch(long_context, arch_id)
    estimate = serve_cli.estimate_serve_bytes(
        arch, engine="paged", batch=SERVE["batch"], max_seq=SERVE["max_seq"],
        page_size=SERVE["page_size"], pages=SERVE["pages"],
        chunk=SERVE["chunk"])
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = rt_models.Model.create(
        arch, torch.Generator(device=dev).manual_seed(SEED), dev)
    engine = serving.PagedEngine(
        model, None, batch_size=SERVE["batch"], max_seq_len=SERVE["max_seq"],
        page_size=SERVE["page_size"], num_pages=SERVE["pages"],
        use_kernel=True, prefill_chunk_tokens=SERVE["chunk"], device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up: cuBLAS's and the allocator's first calls, on a small pool
    serving.PagedEngine(
        model, None, batch_size=2, max_seq_len=SERVE["max_seq"],
        page_size=SERVE["page_size"], num_pages=64,
        prefill_chunk_tokens=SERVE["chunk"], device=dev).run(
        [serving.Request(uid=i, prompt=[5 + i] * (SERVE["chunk"] + 44),
                         max_new_tokens=3)
         for i in range(2)])
    torch.cuda.synchronize()
    nonfinite = torch.zeros((), dtype=torch.long, device=dev)
    fused = model.paged_fused_step

    def finite_spy(*args, **kwargs):
        logits, state = fused(*args, **kwargs)
        nonfinite.add_((~torch.isfinite(logits)).sum())
        return logits, state

    model.paged_fused_step = finite_spy
    reqs = serve_requests(arch.vocab_size)
    kernels.reset_launches()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.launches.items() if v}
    del model.paged_fused_step
    peak = torch.cuda.max_memory_allocated() - resident
    m = engine.metrics()
    passes = m["decode_steps"] + m["mixed_passes"]
    tag = ("serve-long-context" if long_context else
           "serve-mla" if arch.mla is not None else "serve")
    check(all(len(r.generated) == SERVE_NEW for r in done),
          f"{tag}: every request finished with {SERVE_NEW} tokens")
    check(int(nonfinite) == 0, f"{tag}: finite logits")
    check(monitors.check_pool_conservation(engine.pool).ok,
          f"{tag}: pool conservation")
    engine.prefix.drop_all()
    check(engine.pool.in_use == 0,
          f"{tag}: the pages in use were those the prefix cache retained")
    L = arch.num_layers
    check(counts == serve_launches(arch, m),
          f"{tag}: one kernel launch per layer and pass ({L} x "
          f"{m['decode_steps']} decode, {L} x {m['mixed_passes']} mixed): "
          f"{counts}")
    check(peak <= estimate, f"{tag}: the serve CLI's estimate "
                            f"{estimate / 1e9:.2f} GB holds the peak "
                            f"{peak / 1e9:.2f} GB")
    tokens = sum(len(r.generated) for r in done)
    wall = engine.wall_seconds
    emit(tag, arch=arch.name, layers=L, d_model=arch.d_model,
         heads=arch.num_heads, kv_heads=arch.num_kv_heads, d_ff=arch.d_ff,
         vocab=arch.vocab_size, dtype=arch.dtype,
         window=arch.attention_window,
         mla=None if arch.mla is None else vars(arch.mla),
         moe=None if arch.moe is None else vars(arch.moe),
         params=rt_models.count_params(engine.params), **SERVE,
         requests=SERVE_REQUESTS, new_tokens=SERVE_NEW,
         prompt_tokens=sum(len(r.prompt) for r in done),
         setup_s=setup_s, seconds=seconds, wall_seconds=wall,
         tokens_per_s=tokens / wall,
         decode_steps=m["decode_steps"], mixed_passes=m["mixed_passes"],
         ms_per_decode_pass=m["decode_seconds"] / max(m["decode_steps"], 1)
         * 1e3,
         # the run's other wall time (mixed passes, admission, scheduling)
         # over its mixed passes
         ms_per_mixed_pass=(wall - m["decode_seconds"])
         / max(m["mixed_passes"], 1) * 1e3,
         decode_tokens_per_s=m["decode_tokens"] / max(m["decode_seconds"],
                                                      1e-9),
         ttft_p50=m["ttft_p50"], ttft_p95=m["ttft_p95"],
         latency_p50=m["latency_p50"], latency_p95=m["latency_p95"],
         peak_gb=peak / 1e9, estimate_gb=estimate / 1e9,
         estimate_over_peak=estimate / peak,
         cache_hbm_bytes=m["cache_hbm_bytes"],
         pool_peak_in_use=m["pool"]["peak_in_use"],
         prefix_hits=m["pool"]["prefix_hits"],
         preemptions=m["pool"]["preemptions"], launches=counts)
    return counts, [list(r.generated) for r in done], engine


def profile_pass(one_pass):
    """One call of ``one_pass`` under torch.profiler after three
    warm-ups: (wall ms, device-busy ms, kernel launches, the top kernels
    [name, device ms, count], the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        one_pass()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, launches = busy_share(prof)
    check(launches > 0, "the profiler saw the card's kernels")
    top = []
    for avg in prof.key_averages():
        t = getattr(avg, "self_device_time_total",
                    getattr(avg, "self_cuda_time_total", 0.0))
        if (t > 0 and avg.device_type == torch.autograd.DeviceType.CUDA
                and not is_annotation(avg)):
            top.append([avg.key[:60], t / 1e3, avg.count])
    top.sort(key=lambda r: -r[1])
    return wall_ms, device_ms, launches, top, prof


def phase_serve_breakdown(dev, engine, tag="serve-breakdown"):
    """One pure-decode pass of the full-width model under torch.profiler:
    16 slots at 2,047 tokens of context in the engine's pool, C = 1,
    with the greedy read-back; wall time, the device's busy share and
    the top kernels."""
    model, B, P = engine.model, SERVE["batch"], SERVE["page_size"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    M = PAGED_CTX // P
    table = torch.randperm(SERVE["pages"], generator=gen, device=dev)[
        :B * M].reshape(B, M).to(torch.int32)
    state = rt_models.model.PagedDecodeState(
        caches=engine._caches, page_table=table,
        seq_lens=torch.full((B,), PAGED_CTX - 1, dtype=torch.int32,
                            device=dev))
    tokens = torch.randint(1, model.cfg.vocab_size, (B, 1), generator=gen,
                           device=dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)

    def one_pass():
        with torch.no_grad():
            logits, _ = model.paged_fused_step(engine.params, tokens, state,
                                               ones)
            return torch.argmax(logits, dim=-1).cpu()

    wall_ms, device_ms, launches, top, _ = profile_pass(one_pass)
    emit(tag, arch=model.cfg.name, slots=B, context=PAGED_CTX,
         layers=model.cfg.num_layers, pass_wall_ms=wall_ms,
         pass_device_ms=device_ms, device_busy_share=device_ms / wall_ms,
         kernel_launches=launches, top_kernels=top[:8])


def phase_serve_mixed_breakdown(dev, engine, tag="serve-mixed-breakdown"):
    """One chunked-prefill (mixed) pass of the full-width model under
    torch.profiler: 16 slots, each a chunk of 256 prompt tokens
    (``q_lens`` 256) after MIXED_CTX tokens of context in the engine's
    pool, with the greedy read-back; wall time, the device's busy share,
    launches, the top kernels, and the paged kernel's device time and
    share of the pass's device time."""
    model, B, P = engine.model, SERVE["batch"], SERVE["page_size"]
    chunk = SERVE["chunk"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    M = (MIXED_CTX + chunk) // P
    table = torch.randperm(SERVE["pages"], generator=gen, device=dev)[
        :B * M].reshape(B, M).to(torch.int32)
    state = rt_models.model.PagedDecodeState(
        caches=engine._caches, page_table=table,
        seq_lens=torch.full((B,), MIXED_CTX, dtype=torch.int32, device=dev))
    tokens = torch.randint(1, model.cfg.vocab_size, (B, chunk),
                           generator=gen, device=dev)
    q_lens = torch.full((B,), chunk, dtype=torch.int32, device=dev)

    def one_pass():
        with torch.no_grad():
            logits, _ = model.paged_fused_step(engine.params, tokens, state,
                                               q_lens)
            return torch.argmax(logits, dim=-1).cpu()

    wall_ms, device_ms, launches, top, prof = profile_pass(one_pass)
    paged_ms, paged_launches = 0.0, 0
    for evt in device_kernels(prof):
        if "paged_" in evt.name:
            paged_ms += (evt.time_range.end - evt.time_range.start) / 1e3
            paged_launches += 1
    check(paged_launches > 0, f"{tag}: the pass went through the paged "
                              f"kernel")
    emit(tag, arch=model.cfg.name, slots=B, context=MIXED_CTX, chunk=chunk,
         layers=model.cfg.num_layers, pass_wall_ms=wall_ms,
         pass_device_ms=device_ms, device_busy_share=device_ms / wall_ms,
         kernel_launches=launches, paged_kernel_ms=paged_ms,
         paged_kernel_launches=paged_launches,
         paged_share_of_device=paged_ms / device_ms, top_kernels=top[:8])


def _smoke_serve_model(device, arch_id=SERVE_ARCH):
    arch = rt_models.get_smoke_config(arch_id)
    return rt_models.Model.create(
        arch, torch.Generator(device=device).manual_seed(SEED), device)


def _smoke_requests(vocab, n, seed, lo, hi, new):
    rng = np.random.default_rng(seed)
    return [serving.Request(uid=i, prompt=rng.integers(
        1, vocab, int(rng.integers(lo, hi + 1))).tolist(), max_new_tokens=new)
        for i in range(n)]


def smoke_launches_seen(arch_id):
    """Whether the card's smoke-size passes went through the arch's
    paged kernel(s)."""
    if rt_models.get_config(arch_id).mla is not None:
        return kernels.launches[MLA_KERNEL] > 0
    return (kernels.launches["paged_attention"] > 0
            and kernels.launches["paged_attention_batched"] > 0)


def phase_serve_trajectory(dev, arch_id=SERVE_ARCH):
    """PagedEngine at smoke size (float32) on the card and on the CPU,
    from the same weights and requests, every logit traced: equal tokens
    and logits allclose.  Pages of 8, chunks of 16, a pool small enough
    to preempt (also mid-prefill)."""
    tag = ("serve-mla-trajectory" if arch_id == MLA_ARCH
           else "serve-trajectory")
    cpu_model = _smoke_serve_model("cpu", arch_id)
    card_model = rt_models.Model(
        cpu_model.cfg, {k: v.to(dev) for k, v in cpu_model.params().items()})
    vocab = cpu_model.cfg.vocab_size
    kw = dict(batch_size=3, max_seq_len=64, page_size=8, num_pages=10,
              prefill_chunk_tokens=16, trace_logits=True)
    runs = {}
    kernels.reset_launches()
    for where, model, device in (("cpu", cpu_model, "cpu"),
                                 ("card", card_model, dev)):
        eng = serving.PagedEngine(model, None, device=device, **kw)
        runs[where] = (eng, eng.run(_smoke_requests(vocab, 7, SEED, 5, 40,
                                                    12)))
    torch.cuda.synchronize()
    check(smoke_launches_seen(arch_id),
          f"{tag}: the card's passes went through the kernel: "
          f"{kernels.launches}")
    (e_c, out_c), (e_g, out_g) = runs["cpu"], runs["card"]
    err = 0.0
    for rc, rg in zip(out_c, out_g):
        if rc.generated != rg.generated:
            i = next(j for j, (a, b) in enumerate(zip(rc.generated,
                                                      rg.generated))
                     if a != b)
            top2 = torch.topk(torch.from_numpy(
                e_c.logit_trace[rc.uid][i]), 2).values
            raise RuntimeError(
                f"chip_smoke: {tag}: request {rc.uid} token {i} "
                f"differs (CPU {rc.generated[i]}, card {rg.generated[i]}); "
                f"the CPU's top-2 margin {float(top2[0] - top2[1])}")
        for a, b in zip(e_g.logit_trace[rg.uid], e_c.logit_trace[rc.uid]):
            a, b = torch.from_numpy(a), torch.from_numpy(b)
            err = max(err, (a - b).abs().max().item())
            check(torch.allclose(a, b, **SERVE_TRAJ_TOL),
                  f"{tag}: request {rc.uid} logits within "
                  f"{SERVE_TRAJ_TOL}: max abs err {(a - b).abs().max()}")
    check(e_c.metrics()["pool"] == e_g.metrics()["pool"]
          and e_g.pool.metrics.preemptions > 0,
          f"{tag}: equal pool accounting, with preemptions")
    emit(tag, arch=arch_id, requests=len(out_c), **kw,
         preemptions=e_g.pool.metrics.preemptions,
         max_abs_logit_err=err, tolerance=SERVE_TRAJ_TOL,
         launches={k: v for k, v in kernels.launches.items() if v})


def phase_serve_anchor(dev, arch_id=SERVE_ARCH):
    """The reference's parity anchor on the card at smoke size:
    PagedEngine with one page a sequence (page size = max_seq, pages =
    slots) against DecodeServer, token for token, more requests than
    slots."""
    tag = "serve-mla-anchor" if arch_id == MLA_ARCH else "serve-anchor"
    model = _smoke_serve_model(dev, arch_id)
    vocab = model.cfg.vocab_size
    reqs = lambda: _smoke_requests(vocab, 5, SEED + 1, 2, 8, 6)  # noqa: E731
    dense = serving.DecodeServer(model, None, batch_size=2, max_seq_len=32,
                                 device=dev).run(reqs())
    kernels.reset_launches()
    paged = serving.PagedEngine(model, None, batch_size=2, max_seq_len=32,
                                page_size=32, num_pages=2, device=dev)
    out = paged.run(reqs())
    torch.cuda.synchronize()
    seen = (kernels.launches[MLA_KERNEL] if arch_id == MLA_ARCH
            else kernels.launches["paged_attention"])
    check(seen > 0, f"{tag}: the paged engine went through the kernel: "
                    f"{kernels.launches}")
    same = [a.generated == b.generated for a, b in zip(dense, out)]
    check(all(same), f"{tag}: PagedEngine equals DecodeServer token "
                     f"for token: {same}")
    emit(tag, arch=arch_id, requests=len(out), slots=2, max_seq=32,
         page_size=32, num_pages=2, equal=same,
         prefill_forwards=paged.prefill_forwards)


def phase_serve_cli(arch_id=SERVE_ARCH):
    """The serve CLI at full width on the card, at its default sizes."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch_id, "--engine", "paged", "--no-smoke"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    rows = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    check(proc.returncode == 0 and rows and rows[0].startswith("served 8 "),
          f"serve CLI: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    emit("serve-cli", arch=arch_id, returncode=proc.returncode, rows=rows,
         seconds=time.perf_counter() - t0)


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
    del prob
    torch.cuda.empty_cache()
    flush = torch.zeros(128 << 20 >> 2, device=dev)
    rows.update(phase_sparse_kernels(dev, name, flush))
    rows.update(phase_randk_kernels(dev, name, flush))
    del flush
    for kname in (*SPARSE_KERNELS, *RANDK_KERNELS, FLAT_UPDATE):
        launches[kname] = 0
    for variant, aggregation in TRAIN_PHASES:
        counts, trainer, state, batch = phase_train(dev, variant,
                                                    aggregation)
        for kname, count in counts.items():
            # the batched update launched per leaf is the flat kernel's
            # port; the trainer's finite-MVR tail counts with its own row
            key = FLAT_UPDATE if kname == "dasha_update_batched" else kname
            launches[key] = launches.get(key, 0) + count
        if (variant, aggregation) == ("mvr", "sparse_allgather"):
            phase_train_breakdown(dev, trainer, state, batch)
        del trainer, state, batch
        torch.cuda.empty_cache()
    phase_train_trajectory(dev)
    phase_train_resume(dev)
    phase_train_cli()
    flush = torch.zeros(128 << 20 >> 2, device=dev)
    rows.update(phase_paged_kernels(dev, name, flush))
    del flush
    counts, tokens, engine = phase_serve(dev)
    phase_serve_breakdown(dev, engine)
    phase_serve_mixed_breakdown(dev, engine)
    del engine
    counts_lc, tokens_lc, engine = phase_serve(dev, long_context=True)
    # window 4,096 covers every context of the run
    check(tokens_lc == tokens, "serve-long-context: the tokens equal the "
                               "first run's")
    del engine
    for kname in PAGED_KERNELS:
        launches[kname] = counts.get(kname, 0) + counts_lc.get(kname, 0)
    torch.cuda.empty_cache()
    phase_serve_trajectory(dev)
    phase_serve_anchor(dev)
    phase_serve_cli()
    flush = torch.zeros(128 << 20 >> 2, device=dev)
    rows.update(phase_paged_mla_kernels(dev, name, flush))
    del flush
    counts, _, engine = phase_serve(dev, arch_id=MLA_ARCH)
    phase_serve_breakdown(dev, engine, tag="serve-mla-breakdown")
    phase_serve_mixed_breakdown(dev, engine,
                                tag="serve-mla-mixed-breakdown")
    del engine
    launches[MLA_KERNEL] = counts.get(MLA_KERNEL, 0)
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_trajectory(dev, MLA_ARCH)
    phase_serve_anchor(dev, MLA_ARCH)
    phase_serve_cli(MLA_ARCH)
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
