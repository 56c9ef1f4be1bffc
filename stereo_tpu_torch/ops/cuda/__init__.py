"""Hand-written Hopper (sm_90a) CUDA kernels of the main paths and the ALU
peak anchor, one wrapper each. Every wrapper counts its launches in
``<wrapper>.forms``, a Counter keyed by the launched form: the tensors' shape and whatever else picks the
kernel's instantiation (``launch.count_launch``)."""

from typing import Dict, Tuple

from .cost_kernel import census_cost, rank_cost, sad_cost, transform_words
from .filter_kernel import median3x3
from .peak_kernel import alu_peak
from .sgm_kernel import sgm_paths, sgm_select

#: The kernel wrappers in main-path order, then the anchor.
KERNELS = (transform_words, census_cost, rank_cost, sad_cost, sgm_paths,
           sgm_select, median3x3, alu_peak)


def launch_counts() -> Dict[str, int]:
    """Launches per wrapper since the last reset."""
    return {k.__name__: sum(k.forms.values()) for k in KERNELS}


def launch_forms() -> Dict[Tuple, int]:
    """Launches per (wrapper, *form) since the last reset."""
    return {(k.__name__, *form): n for k in KERNELS
            for form, n in k.forms.items()}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.forms.clear()


__all__ = [
    "transform_words",
    "census_cost",
    "rank_cost",
    "sad_cost",
    "sgm_paths",
    "sgm_select",
    "median3x3",
    "alu_peak",
    "KERNELS",
    "launch_counts",
    "launch_forms",
    "reset_launch_counts",
]
