"""repro_torch — the PyTorch/CUDA port of the DASHA-PP reproduction.

It runs Algorithm 1 of the paper (all four variants) on an NVIDIA GPU,
with lines 9-11 of every round in hand-written CUDA kernels
(:mod:`repro_torch.kernels`), and on the CPU through those kernels'
plain PyTorch versions; the asynchronous server and the hierarchical
fleet of :mod:`repro_torch.fl` run on top of it.  The JAX package ``repro`` beside it is the
reference; this package imports nothing of it, nor of JAX.

Entry points that create tensors take ``device=`` and default to
``"cuda"``; without a card they raise unless asked for ``"cpu"``.
"""
from repro_torch.core import (BlockRandK, DashaPP, DashaPPConfig,
                              DashaPPState, EdgeSNice, FullParticipation,
                              Identity, Independent, LogisticSigmoidProblem,
                              NonconvexSoftmaxProblem, QuadraticProblem,
                              RandK, RandomDithering, RoundDraws, SNice,
                              StepMetrics, TopK, dasha_pp,
                              dasha_pp_finite_mvr, dasha_pp_mvr,
                              dasha_pp_page, make_compressor, make_sampler,
                              make_synthetic_classification,
                              sample_batch_indices, theory)
from repro_torch.device import resolve_device

__all__ = [
    "DashaPP", "DashaPPConfig", "DashaPPState", "StepMetrics", "RoundDraws",
    "dasha_pp", "dasha_pp_page", "dasha_pp_finite_mvr", "dasha_pp_mvr",
    "LogisticSigmoidProblem", "NonconvexSoftmaxProblem", "QuadraticProblem",
    "make_synthetic_classification", "sample_batch_indices",
    "Identity", "RandK", "BlockRandK", "TopK", "RandomDithering",
    "make_compressor",
    "SNice", "Independent", "FullParticipation", "EdgeSNice", "make_sampler",
    "theory", "resolve_device",
]
