"""End-to-end stereo pipeline on whole frames.

On CUDA tensors ``compute_disparity`` runs the hand-written kernels in
order: the cost volume (K1 after the census or rank transform, which stays
plain torch as it stays in XLA on the TPU, or K5 for SAD), K2 once per path
direction (skipped for ``num_paths=0``), K3 selection, K4 median. With
``lr_exact`` the flipped pair runs the same chain a second time for the
right view's integer winners, and the consistency compare runs in plain
torch on [H, W] maps, as it runs in XLA on the TPU. On CPU tensors it runs
the plain staged path (cost volume, SGM, WTA, post-processing), the same
composition as the reference's ``compute_disparity`` with
``backend="jnp"``; both give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import StereoConfig
from .ops import census_transform, rank_transform, wta_with_aux
from .ops.cost import cost_volume
from .ops.cuda import (
    census_cost,
    median3x3,
    rank_cost,
    sad_cost,
    sgm_paths,
    sgm_select,
)
from .ops.postprocess import apply_postprocess, lr_consistency
from .ops.sgm import sgm_aggregate


class StereoResult(NamedTuple):
    """disp: [H, W] float32 left-view disparity; valid: [H, W] bool, False
    where the uniqueness or LR test rejected the match."""

    disp: torch.Tensor
    valid: torch.Tensor


def use_kernels(cfg: StereoConfig, device: torch.device) -> bool:
    """Whether ``cfg.backend`` sends tensors on ``device`` to the kernels."""
    if cfg.backend == "torch":
        return False
    if cfg.backend == "cuda":
        if device.type != "cuda":
            raise ValueError("backend='cuda' needs CUDA tensors")
        return True
    return device.type == "cuda"


def _kernel_view(ref: torch.Tensor, tgt: torch.Tensor, cfg: StereoConfig,
                 emit_d0: bool = False):
    """One reference view through the kernels: cost volume (K1 or K5),
    then ``kernel_select``."""
    if cfg.cost_fn == "sad":
        cost = sad_cost(ref, tgt, cfg)
    elif cfg.cost_fn == "rank":
        cost = rank_cost(rank_transform(ref, cfg.census_window),
                         rank_transform(tgt, cfg.census_window), cfg)
    else:
        cost = census_cost(census_transform(ref, cfg.census_window),
                           census_transform(tgt, cfg.census_window), cfg)
    return kernel_select(cost, cfg, ref, emit_d0=emit_d0)


def kernel_select(cost: torch.Tensor, cfg: StereoConfig, image: torch.Tensor,
                  emit_d0: bool = False):
    """K2 per direction on a cost volume (S is the cost itself for
    num_paths=0), then K3. Returns ``sgm_select``'s outputs."""
    if cfg.num_paths == 0:
        s = cost.to(torch.int16)
    else:
        s = sgm_paths(cost, cfg, image=image)
    return sgm_select(s, cfg, emit_d0=emit_d0)


def _kernel_path(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
                 ) -> StereoResult:
    if cfg.lr_check and cfg.lr_exact:
        # As the reference's fused lr_exact: the left view keeps its
        # uniqueness gate and integer winners; the flipped pair gives the
        # right view's integer winners (subpixel and uniqueness affect
        # nothing the compare reads).
        disp, ok, d0 = _kernel_view(
            left, right, cfg.replace(lr_check=False), emit_d0=True)
        cfg_r = cfg.replace(lr_check=False, subpixel=False,
                            uniqueness_ratio=0.0)
        disp_rf, _ = _kernel_view(right.flip(1), left.flip(1), cfg_r)
        d_int_l = d0.to(torch.float32) + cfg.min_disparity
        ok = ok & lr_consistency(d_int_l, disp_rf.flip(1), cfg)
    else:
        disp, ok = _kernel_view(left, right, cfg)
    if cfg.median_filter:
        disp = median3x3(disp)
    return StereoResult(disp=disp, valid=ok)


def _aggregate(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
               ) -> torch.Tensor:
    """Plain cost volume + SGM for one reference view."""
    return sgm_aggregate(cost_volume(left, right, cfg), cfg, image=left)


def compute_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    valid: Optional[torch.Tensor] = None,
    constrain=None,
    x_offset: int = 0,
    image_width: Optional[int] = None,
    y_offset: int = 0,
    image_height: Optional[int] = None,
    right_context: int = 0,
) -> StereoResult:
    """Full pipeline on one rectified pair of whole frames.

    Args:
      left, right: [H, W] uint8 (or float) grayscale images on one device.
      cfg: static StereoConfig; ``cfg.backend`` picks kernels or plain ops.
      valid, constrain, x_offset, image_width, y_offset, image_height,
        right_context: the reference's tile and patch framing; only the
        whole-frame defaults are ported, anything else raises.

    Returns: StereoResult(disp [H, W] float32, valid [H, W] bool).
    """
    if left.ndim != 2 or left.shape != right.shape:
        raise ValueError(
            f"expected two [H, W] images, got {tuple(left.shape)} and "
            f"{tuple(right.shape)}"
        )
    if left.device != right.device:
        raise ValueError(f"images on {left.device} and {right.device}")
    framed = (
        valid is not None or constrain is not None or x_offset != 0
        or image_width not in (None, left.shape[1]) or y_offset != 0
        or image_height is not None or right_context != 0
    )
    if framed:
        raise NotImplementedError(
            "tiles, patches and masked frames (valid, constrain, x_offset, "
            "image_width, y_offset, image_height, right_context) are not "
            "ported yet (ROADMAP Queue 1: multi-GPU, tiles, patches and "
            "framing)"
        )
    if use_kernels(cfg, left.device):
        return _kernel_path(left, right, cfg)

    s = _aggregate(left, right, cfg)
    disp, ok, d_int = wta_with_aux(s, cfg)
    if cfg.lr_check and cfg.lr_exact:
        # The reference's staged exact check: the right view matched as
        # the flipped pair, integer winners compared on both sides.
        s_r = _aggregate(right.flip(1), left.flip(1), cfg)
        _, _, d_int_r = wta_with_aux(s_r, cfg)
        ok = ok & lr_consistency(d_int, d_int_r.flip(1), cfg)
    disp, ok = apply_postprocess(disp, ok, s, cfg, disp_int=d_int)
    return StereoResult(disp=disp, valid=ok)


def build_pipeline(cfg: StereoConfig, device="cuda"):
    """Return ``(left, right) -> StereoResult`` for a fixed config.

    Images may be numpy arrays or tensors; they are moved to ``device``
    and the result stays there.
    """
    device = torch.device(device)

    def run(left, right) -> StereoResult:
        return compute_disparity(
            torch.as_tensor(left).to(device), torch.as_tensor(right).to(device),
            cfg,
        )

    return run


def host_postprocess(disp, valid, cfg: StereoConfig):
    """Host-side (numpy) post-filters after device compute.

    Speckle removal with size ``max(speckle_max_size, round(speckle_rel *
    H*W))``, then, with ``cfg.fill_occlusions``, each invalid pixel takes
    the smaller of its nearest valid row neighbours and counts as an
    estimate; both are the reference's C++ (``native``). Returns numpy
    (disp, valid).
    """
    if isinstance(disp, torch.Tensor):
        disp = disp.cpu().numpy()
    if isinstance(valid, torch.Tensor):
        valid = valid.cpu().numpy()
    disp = np.asarray(disp)
    valid = np.asarray(valid)
    speckle = max(
        cfg.speckle_max_size,
        int(round(cfg.speckle_rel * disp.shape[0] * disp.shape[1])),
    )
    if speckle > 0:
        from .native import filter_speckles

        disp, valid, _ = filter_speckles(disp, valid, cfg.speckle_tau, speckle)
    if cfg.fill_occlusions:
        from .native import fill_invalid_lr

        disp, filled = fill_invalid_lr(disp, valid)
        valid = valid | filled
    return disp, valid
