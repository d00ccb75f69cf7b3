"""Core co-design engine: the paper's contribution as a composable library
(the JAX package's `core`, ported; the same names).

  hardware          — accelerator descriptions (the H100 is the default)
  quantization      — tile/wave/shard quantization math (paper §III-B, §VI-B)
  gemm_model        — analytic GEMM/BMM cost model (paper §V figures)
  transformer_gemms — Table II mapping, generalized to all assigned families
  advisor           — shape rule checks + nearby-shape search (paper §VI-B, §VII)
  roofline          — three-term roofline report
"""
from .hardware import Hardware, TPU_V5E, A100_40GB, V100_16GB, H100_SXM, get_hardware
from .gemm_model import GEMM, GEMMEstimate, MeasuredProfile, estimate, estimate_many, throughput_tflops, total_time
from .transformer_gemms import layer_gemms, model_gemms, training_flops, vanilla_forward_flops
from .advisor import advise, best_combined, check_alignment, propose, score, step_time, Finding, Proposal
from .roofline import RooflineReport, build_report, collective_bytes, to_row
from . import quantization

__all__ = [
    "Hardware", "TPU_V5E", "A100_40GB", "V100_16GB", "H100_SXM", "get_hardware",
    "GEMM", "GEMMEstimate", "MeasuredProfile", "estimate", "estimate_many", "throughput_tflops", "total_time",
    "layer_gemms", "model_gemms", "training_flops", "vanilla_forward_flops",
    "advise", "best_combined", "check_alignment", "propose", "score", "step_time", "Finding", "Proposal",
    "RooflineReport", "build_report", "collective_bytes", "to_row",
    "quantization",
]
