"""Hand-written Hopper (sm_90a) CUDA kernels of the main path, one wrapper
each. Every wrapper counts its launches in ``<wrapper>.launches``."""

from typing import Dict

from .cost_kernel import census_cost, sad_cost
from .filter_kernel import median3x3
from .sgm_kernel import sgm_paths, sgm_select

#: The kernel wrappers in main-path order.
KERNELS = (census_cost, sad_cost, sgm_paths, sgm_select, median3x3)


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "census_cost",
    "sad_cost",
    "sgm_paths",
    "sgm_select",
    "median3x3",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]
