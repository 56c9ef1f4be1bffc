"""Helpers around the pipeline: depth and point clouds from a disparity
map, logging, timing and visualisation."""

from .depth import CameraRig, disparity_to_depth, reproject

__all__ = ["CameraRig", "disparity_to_depth", "reproject"]
