"""Disparity quality metrics, the hard evaluation suite, the sweep harness
and the tuning sweeps."""

from .hard_suite import SCENARIOS, census_vs_sad_robustness, run_hard_suite
from .metrics import evaluate_disparity

__all__ = [
    "evaluate_disparity",
    "run_hard_suite",
    "census_vs_sad_robustness",
    "SCENARIOS",
]
