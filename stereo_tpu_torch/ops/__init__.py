"""Stereo ops: plain torch versions (any device) and, under ``ops.cuda``,
the hand-written Hopper kernels with the same semantics."""

from .census import census_transform, hamming_distance, rank_transform
from .cost import (
    box_sum,
    census_cost_volume,
    cost_volume,
    rank_cost_volume,
    sad_cost_volume,
)
from .postprocess import (
    apply_postprocess,
    lr_consistency,
    lr_gate_from_right_map,
    median_3x3,
    right_disparity_from_volume,
    right_view_partial_min,
    right_view_spill,
    select_disparity,
    spill_width,
    unpack_partial_min,
)
from .sgm import adaptive_p2_map, sgm_aggregate
from .wta import wta_with_aux

__all__ = [
    "census_transform",
    "hamming_distance",
    "rank_transform",
    "rank_cost_volume",
    "census_cost_volume",
    "box_sum",
    "sad_cost_volume",
    "cost_volume",
    "adaptive_p2_map",
    "sgm_aggregate",
    "wta_with_aux",
    "apply_postprocess",
    "lr_consistency",
    "median_3x3",
    "right_disparity_from_volume",
    "select_disparity",
    "spill_width",
    "right_view_partial_min",
    "right_view_spill",
    "unpack_partial_min",
    "lr_gate_from_right_map",
]
