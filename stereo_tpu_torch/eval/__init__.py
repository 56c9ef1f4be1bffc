"""Disparity quality metrics (numpy only)."""

from .metrics import evaluate_disparity

__all__ = ["evaluate_disparity"]
