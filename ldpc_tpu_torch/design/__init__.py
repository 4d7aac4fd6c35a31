"""Quantizer/ladder design tools (counterpart of ``ldpc_tpu/design/``).

Discretized density evolution for the quantized min-sum family, the
per-phase (C, gamma) ladder designer built on it, protograph DE of a
built decoder, iterated refinement and the trapping-set enumerator. Pure
numpy, design-time tools run on the host: copies of the JAX package's
modules that import the port's own ``quantizer``.
"""

from ldpc_tpu_torch.design.dde import (
    DegreeProfile,
    DEResult,
    degree_profile_from_H,
    degree_profile_from_base,
    density_evolution,
    design_rcq_ladders,
)
from ldpc_tpu_torch.design.iterate import (RefineHistory, RefinePass,
                                           estimate_threshold, iterate_refine)
from ldpc_tpu_torch.design.proto_dde import (analyze_decoder,
                                             design_dynamic_quantizers,
                                             protograph_density_evolution,
                                             refine_ladders_protograph)
from ldpc_tpu_torch.design.trapping_sets import (TrappingSet,
                                                 TrappingSetReport,
                                                 find_trapping_sets,
                                                 trapping_set_profile)

__all__ = [
    "DegreeProfile",
    "DEResult",
    "degree_profile_from_H",
    "degree_profile_from_base",
    "density_evolution",
    "design_rcq_ladders",
    "protograph_density_evolution",
    "analyze_decoder",
    "refine_ladders_protograph",
    "design_dynamic_quantizers",
    "iterate_refine",
    "estimate_threshold",
    "RefineHistory",
    "RefinePass",
    "TrappingSet",
    "TrappingSetReport",
    "find_trapping_sets",
    "trapping_set_profile",
]
