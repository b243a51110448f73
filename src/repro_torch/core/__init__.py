"""repro_torch.core — the DASHA-PP method family in PyTorch.

Layout (each module ports its namesake in ``repro/core``):
    compressors.py    Identity, RandK, BlockRandK, TopK, RandomDithering
    participation.py  Assumption-8 participation samplers
    variants.py       the k_i rules (Algs. 2-5) and the round's draws
    problems.py       distributed problems (paper §A experiments)
    theory.py         theorem-exact hyperparameters (a copy)
    wire.py           the wire-format bit model (a copy)
    dasha_pp.py       Algorithm 1 (+ Algs. 2-5)
"""
from repro_torch.core import theory, variants, wire
from repro_torch.core.compressors import (BlockRandK, Compressor, Identity,
                                          RandK, RandomDithering, TopK,
                                          make_compressor)
from repro_torch.core.dasha_pp import (DashaPP, DashaPPConfig, DashaPPState,
                                       DispatchOutputs, StepMetrics,
                                       dasha_pp, dasha_pp_finite_mvr,
                                       dasha_pp_mvr, dasha_pp_page)
from repro_torch.core.participation import (EdgeSNice, FullParticipation,
                                            Independent, ParticipationSampler,
                                            SNice, make_sampler)
from repro_torch.core.problems import (DistributedProblem,
                                       LogisticSigmoidProblem,
                                       NonconvexSoftmaxProblem,
                                       QuadraticProblem,
                                       make_synthetic_classification,
                                       sample_batch_indices)
from repro_torch.core.variants import RoundDraws, VariantRule, get_rule

__all__ = [
    "Compressor", "Identity", "RandK", "BlockRandK", "TopK",
    "RandomDithering", "make_compressor",
    "ParticipationSampler", "SNice", "Independent", "FullParticipation",
    "EdgeSNice",
    "make_sampler",
    "DistributedProblem", "LogisticSigmoidProblem", "NonconvexSoftmaxProblem",
    "QuadraticProblem", "make_synthetic_classification",
    "sample_batch_indices",
    "DashaPP", "DashaPPConfig", "DashaPPState", "DispatchOutputs",
    "StepMetrics", "RoundDraws",
    "dasha_pp", "dasha_pp_page", "dasha_pp_finite_mvr", "dasha_pp_mvr",
    "theory", "variants", "wire", "VariantRule", "get_rule",
]
