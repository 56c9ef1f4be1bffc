"""Disparity quality metrics, the hard evaluation suite and the sweep
harness."""

from .metrics import evaluate_disparity

__all__ = ["evaluate_disparity"]
