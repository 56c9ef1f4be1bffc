"""Synthetic stereo pairs with exact ground truth (numpy only), and the
KITTI and Middlebury loaders (numpy, PIL and the native PNM/PFM readers)."""

from .kitti import (
    frame_pairs,
    list_frame_ids,
    load_kitti_pair,
    read_kitti_disparity,
    write_kitti_disparity,
)
from .middlebury import (
    discover_scenes,
    load_image_gray,
    load_scene,
    read_pfm,
    write_pfm,
)
from .synthetic import StereoPair, kitti_like_pair, make_pair

__all__ = ["StereoPair", "kitti_like_pair", "make_pair", "frame_pairs",
           "list_frame_ids", "load_kitti_pair", "read_kitti_disparity",
           "write_kitti_disparity", "discover_scenes", "load_image_gray",
           "load_scene", "read_pfm", "write_pfm"]
