"""Serving entry point of the port:

    python -m repro_torch.launch.serve \\
        --arch {granite-3-2b,deepseek-v2-lite-16b} \\
        [--engine {dense,paged}] [--smoke/--no-smoke] [--batch 4] \\
        [--max-seq 128] [--requests 8] [--new-tokens 16] \\
        [--page-size 16] [--pages N] [--no-kernel] \\
        [--prefill-chunk-tokens N] [--bucket-sizes 8,16,32] \\
        [--device cuda|cpu]

The port of ``repro/launch/serve.py``, with its flags, defaults and
output lines, except:

* ``--device`` (the card unless ``cpu`` is asked for);
* ``--no-smoke`` runs the full config on one card, in place of the
  reference's v5e mesh (whose mesh shardings are not ported);
* the paged engine reads its attention through the paged-attention
  kernel wherever the tensors lie on the card (its plain version on the
  CPU); ``--no-kernel`` asks for the reference's gather read instead, by
  choice, never as a fallback;
* the weights come from ``torch.Generator`` seed 0 (the reference's key
  0), the prompts from numpy seed 0 as in the reference;
* ``--profile-dir`` is not offered yet (ROADMAP).

``--smoke`` (the default) serves the reduced config in float32.  Before
it allocates anything on a card, :func:`build_server` estimates the
run's device memory (:func:`estimate_serve_bytes`) and refuses a run
that would not fit.
"""
import argparse
import math
import time
from typing import Optional, Sequence

SEED = 0


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.obs import add_cli_flags
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config in float32 (default); --no-smoke "
                         "serves the full config on one card")
    ap.add_argument("--engine", choices=("dense", "paged"), default="dense")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged engine: tokens per page")
    ap.add_argument("--pages", type=int, default=0,
                    help="paged engine: pool pages (0 = dense-equivalent)")
    ap.add_argument("--no-kernel", action="store_true",
                    help="paged engine: read attention by gathering the "
                         "pages (the reference's jnp read), not through "
                         "the paged-attention kernel")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    help="paged engine: fold prompt prefill into the fused "
                         "decode pass, this many prompt tokens per pass "
                         "(0 = bulk prefill; default: 16)")
    ap.add_argument("--bucket-sizes", type=str, default=None,
                    help="paged engine: comma-separated prompt-length "
                         "buckets for bulk prefill, e.g. 8,16,32 "
                         "('' = exact length; default: powers of two)")
    ap.add_argument("--device", default="cuda")
    add_cli_flags(ap)
    return ap


def _dtype_bytes(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]


def estimate_serve_bytes(arch, *, engine: str, batch: int, max_seq: int,
                         page_size: int = 16, pages: int = 0,
                         chunk: Optional[int] = None,
                         use_kernel: bool = True) -> int:
    """Device bytes a serving run of ``arch`` needs at most, counted from
    the shapes:

    * the weights (an MoE router in float32);
    * the caches: the dense server's ``(B, S)`` ring rows, or the paged
      engine's pool (``pages`` pages, the dense-equivalent number when 0,
      plus the scratch page), K and V in every layer, or MLA's latent
      and rope key (``L (r + rope)`` values a token);
    * one pass: its ``B x C`` token rows (``C`` the prefill chunk, 16 by
      default; a bulk prefill runs one prompt of up to ``max_seq``)
      through one layer's activations (norms, q/k/v and their float32
      RoPE, the attention output in float32, the MLP's three ``d_ff``
      wide tensors), the attention's scores and probabilities where no
      kernel reads the pages (with the gathered K and V of the paged
      read), and the head's logits of the slots' last tokens;
    * with MLA and MoE (:func:`_mla_moe_pass_bytes`): MLA's float32
      ``q_abs`` and latent output, and the MoE dispatch's buffers.
    """
    from repro_torch.models import param_shapes

    s = _dtype_bytes(arch.dtype)
    L, D, F = arch.num_layers, arch.d_model, arch.d_ff
    H, kv, hd = arch.num_heads, arch.num_kv_heads, arch.hd
    weights = sum(math.prod(v) for v in param_shapes(arch).values()) * s
    if arch.moe is not None:
        weights += L * D * arch.moe.num_experts * (4 - s)   # the router
    if arch.mla is not None:
        per_token_kv = L * (arch.mla.kv_lora_rank
                            + arch.mla.qk_rope_head_dim) * s
    else:
        per_token_kv = L * 2 * kv * hd * s
    if engine == "dense":
        ctx = min(max_seq, arch.attention_window or max_seq)
        caches = batch * ctx * per_token_kv
        C, prompt = 1, 1
    else:
        n_pages = pages or batch * -(-max_seq // page_size)
        caches = (n_pages + 1) * page_size * per_token_kv
        C = 16 if chunk is None else max(chunk, 1)
        prompt = max_seq if chunk == 0 else 1
        ctx = -(-max_seq // page_size) * page_size
    rows = max(batch * C, prompt)
    if arch.mla is not None:
        layer = _mla_moe_pass_bytes(arch, rows, batch, C, prompt, ctx,
                                    gather=engine == "dense"
                                    or not use_kernel)
    else:
        layer = rows * ((6 * D + 3 * F) * s + (H + 2 * kv) * hd * (s + 12)
                        + H * hd * 4)
        if engine == "dense" or not use_kernel:
            # scores and probabilities in float32; the gathered pages
            layer += (2 * batch * H * C * ctx * 4
                      + 2 * batch * ctx * kv * hd * s)
    logits = batch * arch.padded_vocab * (s + 4)
    return int(weights + caches + layer + logits)


def _mla_moe_pass_bytes(arch, rows: int, batch: int, C: int, prompt: int,
                        ctx: int, gather: bool) -> int:
    """One MLA + MoE layer's activations for ``rows`` token rows: the
    norms and residuals; q, its rope part in float32, the latent and the
    rope key; the float32 ``q_abs`` and latent output of the absorbed
    read (``rows H r 4`` bytes each), the float32 nope query and value
    products and the output projection; where the pages are gathered
    (``gather``), the float32 scores and probabilities and the gathered
    latents with their K and V up-projections; a bulk prefill's score
    blocks; and the MoE dispatch: the float32 router logits and
    probabilities, the sort's index arrays, the ``(E C_cap, D)`` buffer
    and expert output (with its zero row), the experts' ``(E, C_cap, F)``
    activations, the gathered and unsorted ``(N K, D)`` outputs and the
    shared experts' activations."""
    from repro_torch.models.moe import _capacity

    s = _dtype_bytes(arch.dtype)
    D, H, a, m = arch.d_model, arch.num_heads, arch.mla, arch.moe
    r, nope, rope, vd = (a.kv_lora_rank, a.qk_nope_head_dim,
                         a.qk_rope_head_dim, a.v_head_dim)
    attn = rows * (6 * D * s + H * (nope + rope) * s + H * rope * (s + 12)
                   + (r + rope) * (s + 12) + 2 * H * r * 4 + H * nope * 4
                   + 2 * H * vd * 4 + H * vd * s)
    if gather:
        attn += (2 * batch * H * C * ctx * 4
                 + batch * ctx * ((r + rope) * s + H * (nope + vd) * s))
    if prompt > 1:
        blk = min(prompt, 1024)
        attn += 2 * H * blk * blk * 4
    E, K = m.num_experts, m.experts_per_token
    ec = E * _capacity(rows, arch)
    Fs = m.d_expert * m.num_shared_experts
    moe = (rows * E * 4 * 2 + rows * K * 8 * 8 + 3 * ec * D * s
           + 3 * ec * m.d_expert * s + 3 * rows * K * D * s
           + 3 * rows * Fs * s)
    return attn + moe


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
            f"({total / 1e9:.1f} GB): cut --batch, --max-seq or --pages")


def run_arch(args: argparse.Namespace):
    from repro_torch.models import get_config, get_smoke_config
    return (get_smoke_config(args.arch) if args.smoke
            else get_config(args.arch))


def estimate_for(args: argparse.Namespace) -> int:
    """:func:`estimate_serve_bytes` of the run the flags describe."""
    return estimate_serve_bytes(
        run_arch(args), engine=args.engine, batch=args.batch,
        max_seq=args.max_seq, page_size=args.page_size, pages=args.pages,
        chunk=args.prefill_chunk_tokens, use_kernel=not args.no_kernel)


def build_server(args: argparse.Namespace):
    """The server :func:`main` runs, on ``args.device``; refuses, before
    it allocates, a run whose :func:`estimate_serve_bytes` exceeds the
    card.  Returns ``(server, arch_config)``."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.serving import DecodeServer, PagedEngine

    dev = resolve_device(args.device)
    arch = run_arch(args)
    if not arch.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    check_fits(estimate_for(args), dev)
    model = Model.create(arch, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    if args.engine == "dense":
        return DecodeServer(model, None, batch_size=args.batch,
                            max_seq_len=args.max_seq, device=dev), arch
    buckets = None
    if args.bucket_sizes is not None:
        buckets = [int(b) for b in args.bucket_sizes.split(",") if b]
    return PagedEngine(model, None, batch_size=args.batch,
                       max_seq_len=args.max_seq, page_size=args.page_size,
                       num_pages=args.pages or None,
                       use_kernel=not args.no_kernel,
                       prefill_chunk_tokens=args.prefill_chunk_tokens,
                       bucket_sizes=buckets, device=dev), arch


def make_requests(args: argparse.Namespace, arch):
    """The reference's requests: 4-token prompts from numpy seed 0."""
    import numpy as np

    from repro_torch.serving import Request
    rng = np.random.default_rng(SEED)
    return [Request(uid=i, prompt=rng.integers(1, arch.vocab_size,
                                               4).tolist(),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch.obs import start_run

    server, arch = build_server(args)
    obsrun = start_run(trace_out=args.trace_out,
                       metrics_out=args.metrics_out,
                       meta={"cli": "serve", "engine": args.engine,
                             "arch": args.arch})
    reqs = make_requests(args, arch)
    t0 = time.time()
    done = server.run(reqs)
    dt = time.time() - t0
    tot = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {tot} tokens, "
          f"{tot/dt:.1f} tok/s (engine={args.engine}, batch={args.batch})")
    if args.engine == "paged":
        m = server.metrics()
        print(f"  prefill_forwards={m['prefill_forwards']} "
              f"decode_steps={m['decode_steps']} "
              f"pool_util={m['pool_utilization']:.2f} "
              f"cache_hbm_bytes={m['cache_hbm_bytes']}")
        if m["latency_p50"] is not None:
            print(f"  latency p50={m['latency_p50']:.0f} "
                  f"p95={m['latency_p95']:.0f} serve-passes; "
                  f"ttft p50={m['ttft_p50']:.0f} p95={m['ttft_p95']:.0f}")
    obsrun.finish()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
