"""Synthetic stereo pairs with exact ground truth (numpy only)."""

from .synthetic import StereoPair, kitti_like_pair, make_pair

__all__ = ["StereoPair", "kitti_like_pair", "make_pair"]
