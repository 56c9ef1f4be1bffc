"""End-to-end stereo pipeline on whole frames.

On CUDA tensors ``compute_disparity`` runs the census transform (plain
torch, as it runs in XLA on the TPU) and then the hand-written kernels in
order: K1 cost volume, K2 once per path direction, K3 selection, K4
median. On CPU tensors it runs the plain staged path (cost volume, SGM,
WTA, post-processing), the same composition as the reference's
``compute_disparity`` with ``backend="jnp"``; both give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import StereoConfig
from .ops import census_cost_volume, census_transform, wta_with_aux
from .ops.cuda import census_cost, median3x3, sgm_paths, sgm_select
from .ops.postprocess import apply_postprocess
from .ops.sgm import sgm_aggregate


class StereoResult(NamedTuple):
    """disp: [H, W] float32 left-view disparity; valid: [H, W] bool, False
    where the uniqueness or LR test rejected the match."""

    disp: torch.Tensor
    valid: torch.Tensor


def _use_kernels(cfg: StereoConfig, device: torch.device) -> bool:
    if cfg.backend == "torch":
        return False
    if cfg.backend == "cuda":
        if device.type != "cuda":
            raise ValueError("backend='cuda' needs CUDA tensors")
        return True
    return device.type == "cuda"


def _check_supported(cfg: StereoConfig, framed: bool) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for modes the
    port does not have yet."""
    if framed:
        raise NotImplementedError(
            "tiles, patches and masked frames (valid, constrain, x_offset, "
            "image_width, y_offset, image_height, right_context) are not "
            "ported yet (ROADMAP Queue 1: multi-GPU, tiles, patches and "
            "framing)"
        )
    if cfg.lr_check and cfg.lr_exact:
        raise NotImplementedError(
            "lr_exact is not ported yet (ROADMAP Queue 1: lr_exact)"
        )
    if cfg.adaptive_p2:
        raise NotImplementedError(
            "adaptive_p2 is not ported yet (ROADMAP Queue 1: adaptive P2)"
        )
    if cfg.cost_fn != "census":
        raise NotImplementedError(
            f"cost_fn={cfg.cost_fn!r} is not ported yet (ROADMAP Queue 1: "
            "rank/SAD ops)"
        )


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
    _check_supported(cfg, framed)
    if _use_kernels(cfg, left.device):
        cl = census_transform(left, cfg.census_window)
        cr = census_transform(right, cfg.census_window)
        s = sgm_paths(census_cost(cl, cr, cfg), cfg)
        disp, ok = sgm_select(s, cfg)
        if cfg.median_filter:
            disp = median3x3(disp)
        return StereoResult(disp=disp, valid=ok)

    s = sgm_aggregate(census_cost_volume(left, right, cfg), cfg)
    disp, ok, d_int = wta_with_aux(s, cfg)
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
    """Host-side (numpy) speckle removal after device compute.

    The speckle size is ``max(speckle_max_size, round(speckle_rel * H*W))``
    as in the reference; the filter is the reference's C++ (``native``).
    Returns numpy (disp, valid).
    """
    if cfg.fill_occlusions:
        raise NotImplementedError(
            "fill_occlusions is not ported yet (ROADMAP Queue 1: eval/hard "
            "suite, rest of host_postprocess)"
        )
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
    return disp, valid
