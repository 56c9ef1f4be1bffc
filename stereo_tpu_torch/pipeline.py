"""End-to-end stereo pipeline on whole frames and on column patches of a
larger frame.

On CUDA tensors ``compute_disparity`` runs the hand-written kernels in
order: the cost volume (K1's transform stage on each image, then its cost
stage, or K5 for SAD), K2 once per path
direction (skipped for ``num_paths=0``), K3 selection, K4 median. With
``lr_exact`` the flipped pair runs the same chain a second time for the
right view's integer winners, and the consistency compare runs in plain
torch on [H, W] maps, as it runs in XLA on the TPU. On CPU tensors it runs
the plain staged path (cost volume, SGM, WTA, post-processing), the same
composition as the reference's ``compute_disparity`` with
``backend="jnp"``; both give the same bits. A masked call (a ``valid``
mask) runs K2's mask form; a constrained one (the ``constrain`` hooks) runs
the reference's composition of the hooks and the path families with each
family in K2's mask form (``kernel_sum``); the rest of the chain is the
same.

A static column patch (``parallel/bands.py``) passes its global column
origin ``x_offset``, the frame's ``image_width`` and ``right_context``
frame-true columns in front of the right image (census, rank or SAD), so
that disparity-range masking and LR framing are the whole frame's;
``compute_patch_parts`` is the patch whose LR check the stitched runner
reassembles across patches.

A rectangular tile of a larger frame (``parallel/tiling.py``) passes
``image_height`` too, with its origin (``x_offset``, ``y_offset``, either
negative at the frame's top and left edges): every SGM path then starts
fresh at the edges of the tile's in-frame rectangle. The plain path
materialises the rectangle as a ``valid`` mask, as the reference's golden
path does (``stereo_tpu/pipeline/pipeline.py:658-664``); the kernel path
hands K2 the rectangle and K1, K3 and K5 the (possibly negative) origin.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import StereoConfig
from .ops import wta_with_aux
from .ops.cost import cost_volume
from .ops.cuda import (
    census_cost,
    median3x3,
    rank_cost,
    sad_cost,
    sgm_paths,
    sgm_select,
    transform_words,
)
from .ops.postprocess import (
    apply_postprocess,
    lr_consistency,
    median_3x3,
    select_disparity,
)
from .ops.sgm import sgm_aggregate


#: A block's in-frame rectangle (y_lo, y_hi, x_lo, x_hi), block coordinates.
Rect = Tuple[int, int, int, int]


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


def _kernel_cost(ref: torch.Tensor, tgt: torch.Tensor, cfg: StereoConfig,
                 x_offset: int = 0, right_context: int = 0,
                 constrain=None) -> torch.Tensor:
    """The cost volume of one reference view through K1 (its transform
    stage on each image, ``tgt`` with its context columns, into 32-bit
    words, then its cost stage) or K5; the disparity-plane hook
    ``constrain[2]``, where given, takes it first, as in ``_aggregate``."""
    if cfg.cost_fn == "sad":
        cost = sad_cost(ref, tgt, cfg, x_offset, right_context)
    else:
        rank = cfg.cost_fn == "rank"
        words = [transform_words(img, cfg.census_window, rank=rank)
                 for img in (ref, tgt)]
        cost = (rank_cost if rank else census_cost)(
            *words, cfg, x_offset, right_context)
    if _dplanes(constrain) is not None:
        cost = constrain[2](cost)
    return cost


def _dplanes(constrain):
    """The disparity-plane hook of ``constrain``, or None."""
    if constrain is None or len(constrain) < 3:
        return None
    return constrain[2]


def _kernel_view(ref: torch.Tensor, tgt: torch.Tensor, cfg: StereoConfig,
                 emit_d0: bool = False, x_offset: int = 0,
                 image_width: Optional[int] = None, right_context: int = 0,
                 rect: Optional[Rect] = None,
                 valid: Optional[torch.Tensor] = None, constrain=None):
    """One reference view through the kernels: cost volume (K1 or K5),
    then ``kernel_select``."""
    cost = _kernel_cost(ref, tgt, cfg, x_offset, right_context, constrain)
    return kernel_select(cost, cfg, ref, emit_d0=emit_d0, x_offset=x_offset,
                         image_width=image_width, rect=rect, valid=valid,
                         constrain=constrain)


def _k2_family(cost, cfg, steps, image, valid):
    """One family of path directions in K2 (``sgm_aggregate``'s scan), in
    its mask form where ``valid`` is given. A hook may hand back a strided
    view; K2 reads a contiguous volume."""
    return sgm_paths(cost.contiguous(), cfg, image=image, steps=steps,
                     mask=valid)


def kernel_sum(cost: torch.Tensor, cfg: StereoConfig, image: torch.Tensor,
               rect: Optional[Rect] = None,
               valid: Optional[torch.Tensor] = None,
               constrain=None) -> torch.Tensor:
    """S in int16: K2 per direction on a cost volume, or the cost itself
    for num_paths=0. Paths start fresh at the edges of ``rect`` where one
    is given, or after every invalid pixel of a ``valid`` mask (K2's mask
    form; the mask wins over ``rect``). With the ``constrain`` hooks
    (rows_local, cols_local[, dplanes]; the cost volume has taken the
    third) S is the reference's composition (``ops.sgm.sgm_aggregate``):
    each family of directions one K2 call in its mask form on the hooked
    tuple, the diagonals on the sheared volume, the int16 sums added (the
    bound K2's wrapper checks covers their total)."""
    if cfg.num_paths == 0:
        return cost.to(torch.int16)
    if constrain is None and valid is None:
        return sgm_paths(cost, cfg, image=image, rect=rect)
    return sgm_aggregate(cost, cfg, image=image, valid=valid,
                         constrain=None if constrain is None
                         else constrain[:2], scan=_k2_family)


def kernel_select(cost: torch.Tensor, cfg: StereoConfig, image: torch.Tensor,
                  emit_d0: bool = False, x_offset: int = 0,
                  image_width: Optional[int] = None,
                  rect: Optional[Rect] = None,
                  valid: Optional[torch.Tensor] = None, constrain=None):
    """``kernel_sum``, then K3. Returns ``sgm_select``'s outputs."""
    return sgm_select(kernel_sum(cost, cfg, image, rect, valid, constrain),
                      cfg, emit_d0=emit_d0, x_offset=x_offset,
                      image_width=image_width)


def _kernel_path(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
                 x_offset: int, image_width: int, right_context: int,
                 rect: Optional[Rect] = None,
                 valid: Optional[torch.Tensor] = None,
                 constrain=None) -> StereoResult:
    if cfg.lr_check and cfg.lr_exact:
        # As the reference's fused lr_exact: the left view keeps its
        # uniqueness gate and integer winners; the flipped pair gives the
        # right view's integer winners (subpixel and uniqueness affect
        # nothing the compare reads). On a patch or a tile the flipped pair
        # sits at the flipped global origin, with no rectangle and no mask
        # but with the hooks, as the reference's golden path runs it.
        disp, ok, d0 = _kernel_view(
            left, right, cfg.replace(lr_check=False), emit_d0=True,
            x_offset=x_offset, rect=rect, valid=valid, constrain=constrain)
        cfg_r = cfg.replace(lr_check=False, subpixel=False,
                            uniqueness_ratio=0.0)
        disp_rf, _ = _kernel_view(
            right.flip(1), left.flip(1), cfg_r,
            x_offset=image_width - x_offset - left.shape[1],
            constrain=constrain)
        d_int_l = d0.to(torch.float32) + cfg.min_disparity
        ok = ok & lr_consistency(d_int_l, disp_rf.flip(1), cfg, x_offset,
                                 image_width)
    else:
        disp, ok = _kernel_view(left, right, cfg, x_offset=x_offset,
                                image_width=image_width,
                                right_context=right_context, rect=rect,
                                valid=valid, constrain=constrain)
    if cfg.median_filter:
        disp = median3x3(disp)
    return StereoResult(disp=disp, valid=ok)


def _aggregate(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
               x_offset: int = 0, right_context: int = 0,
               valid: Optional[torch.Tensor] = None,
               constrain=None) -> torch.Tensor:
    """Plain cost volume + SGM for one reference view. ``constrain[2]``,
    where given, is the disparity-plane hook: it takes the cost volume
    first, and ``constrain[:2]`` go to ``sgm_aggregate``, as the
    reference's ``_aggregate`` (``stereo_tpu/pipeline/pipeline.py:186``)."""
    cost = cost_volume(left, right, cfg, x_offset, right_context)
    if _dplanes(constrain) is not None:
        cost = constrain[2](cost)
    if constrain is not None:
        constrain = constrain[:2]
    return sgm_aggregate(cost, cfg, image=left, valid=valid,
                         constrain=constrain)


def frame_rect(shape: Tuple[int, int], x_offset: int, y_offset: int,
               image_width: int, image_height: int) -> Rect:
    """The in-frame rectangle (y_lo, y_hi, x_lo, x_hi) of a block of
    ``shape`` at global origin (``y_offset``, ``x_offset``) in an
    ``image_height`` x ``image_width`` frame, in block coordinates (empty
    when the block misses the frame)."""
    h, w = shape
    y_lo, x_lo = min(h, max(0, -y_offset)), min(w, max(0, -x_offset))
    return (y_lo, max(y_lo, min(h, image_height - y_offset)),
            x_lo, max(x_lo, min(w, image_width - x_offset)))


def rect_mask(rect: Rect, shape: Tuple[int, int], device) -> torch.Tensor:
    """[H, W] bool, True inside ``rect``."""
    y_lo, y_hi, x_lo, x_hi = rect
    mask = torch.zeros(shape, dtype=torch.bool, device=device)
    mask[y_lo:y_hi, x_lo:x_hi] = True
    return mask


def _check_block(left: torch.Tensor, right: torch.Tensor, x_offset: int,
                 image_width: Optional[int], right_context: int,
                 y_offset: int, image_height: Optional[int]) -> int:
    """Validate one block of a frame and its framing; returns the frame's
    width. A column patch (no ``image_height``) lies inside its frame; a
    rectangular tile may reach past any edge of it."""
    if left.ndim != 2 or right.ndim != 2 or (
        left.shape[0] != right.shape[0]
        or left.shape[1] + right_context != right.shape[1]
    ):
        raise ValueError(
            f"expected [H, W] left and [H, W + right_context] right, got "
            f"left {tuple(left.shape)} vs right {tuple(right.shape)} "
            f"(right_context={right_context})"
        )
    if left.device != right.device:
        raise ValueError(f"images on {left.device} and {right.device}")
    if right_context < 0:
        raise ValueError("right_context must be >= 0")
    if image_height is not None:
        if not all(isinstance(v, int) for v in (x_offset, y_offset,
                                                image_height)):
            raise ValueError("a tile's origin and frame height are ints")
        if image_width is None:
            image_width = x_offset + left.shape[1]
        if image_height < 1 or image_width < 1:
            raise ValueError(f"empty frame {image_height}x{image_width}")
        return image_width
    if not isinstance(x_offset, int) or x_offset < 0:
        raise ValueError("a column patch's x_offset is an int >= 0 (a "
                         "negative origin needs image_height: a tile)")
    if image_width is None:
        image_width = x_offset + left.shape[1]
    if image_width < x_offset + left.shape[1]:
        raise ValueError(
            f"block [{x_offset}, {x_offset + left.shape[1]}) leaves the "
            f"frame [0, {image_width})")
    return image_width


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
    """Full pipeline on one rectified pair: a whole frame, or a static
    column patch of a larger frame.

    Args:
      left: [H, W] uint8 (or float) grayscale image.
      right: [H, W + right_context], on the same device: ``right_context``
        frame-true columns preceding the block are prepended, so the
        disparity search reads real neighbours without extending the SGM
        domain (census, rank and SAD costs).
      cfg: static StereoConfig; ``cfg.backend`` picks kernels or plain ops.
      x_offset, image_width: the block's global column origin and the
        frame's width (default: the block ends the frame), so that
        disparity-range masking and LR framing match the whole frame's.
      y_offset, image_height: passing ``image_height`` makes the block a
        rectangular tile of the frame at (``y_offset``, ``x_offset``), both
        possibly negative: SGM paths start fresh at the edges of its
        in-frame rectangle (``frame_rect``).
      valid: [H, W] bool mask of real pixels: SGM paths start fresh after
        every invalid pixel (K2's mask form on the kernels); it wins over
        the rectangle of ``image_height``, as in the reference.
      constrain: the reference's exact-mode hooks (rows_local, cols_local[,
        dplanes]): ``dplanes`` takes the cost volume, the other two go to
        the path families (``kernel_sum``, ``sgm_aggregate``; both views
        under ``lr_exact``, the flipped one without the mask).
        ``parallel/exact.py`` is the exact mode itself.

    Returns: StereoResult(disp [H, W] float32, valid [H, W] bool).
    """
    iw = _check_block(left, right, x_offset, image_width, right_context,
                      y_offset, image_height)
    rect = image_height is not None
    if right_context and (cfg.lr_exact or rect):
        raise NotImplementedError(
            "right_context supports static column patches only (no lr_exact "
            "flipped pass, no rectangular-tile mode)")
    if use_kernels(cfg, left.device):
        box = (frame_rect(left.shape, x_offset, y_offset, iw, image_height)
               if rect else None)
        return _kernel_path(left, right, cfg, x_offset, iw, right_context,
                            box, valid, constrain)
    if rect and valid is None:
        valid = rect_mask(frame_rect(left.shape, x_offset, y_offset, iw,
                                     image_height), left.shape, left.device)

    s = _aggregate(left, right, cfg, x_offset, right_context, valid,
                   constrain)
    disp, ok, d_int = wta_with_aux(s, cfg)
    if cfg.lr_check and cfg.lr_exact:
        # The reference's staged exact check: the right view matched as
        # the flipped pair (at the flipped global origin, with no mask),
        # integer winners compared on both sides.
        s_r = _aggregate(right.flip(1), left.flip(1), cfg,
                         x_offset=iw - x_offset - left.shape[1],
                         constrain=constrain)
        _, _, d_int_r = wta_with_aux(s_r, cfg)
        ok = ok & lr_consistency(d_int, d_int_r.flip(1), cfg, x_offset, iw)
    disp, ok = apply_postprocess(disp, ok, s, cfg, x_offset, iw,
                                 disp_int=d_int)
    return StereoResult(disp=disp, valid=ok)


class PatchParts(NamedTuple):
    """One column patch with its LR check left open for stitching
    (``parallel/bands.py``).

    disp: [H, W] float32 final disparity (subpixel + median applied).
    ok_nolr: [H, W] bool uniqueness gate (LR excluded).
    lr_bit: [H, W] bool LR verdict against the patch's own partial map
      (the stitcher replaces it near interior patch edges).
    d0: [H, W] int32 integer winner LANE (min_disparity excluded).
    qr: [H, W] float32 packed right-view partial min, min-combinable
      across patches (``ops.postprocess.right_view_partial_min``).
    spill: [H, SP] float32 the same at block-local positions [-SP, 0): this
      patch's contribution to the PREVIOUS patch's map.
    """

    disp: torch.Tensor
    ok_nolr: torch.Tensor
    lr_bit: torch.Tensor
    d0: torch.Tensor
    qr: torch.Tensor
    spill: torch.Tensor


def compute_patch_parts(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    x_offset: int = 0,
    image_width: Optional[int] = None,
    right_context: int = 0,
    own: Optional[Tuple[int, int]] = None,
    valid: Optional[torch.Tensor] = None,
    y_offset: int = 0,
    image_height: Optional[int] = None,
) -> PatchParts:
    """One column patch of a larger frame, gates left open for stitching.

    Arguments as ``compute_disparity``; ``own`` is the block-local column
    range (lo, hi) the patch OWNS (default the whole patch): its packed
    partial mins draw sources only from it, so the stitcher's min over
    patches counts every frame column exactly once. With ``image_height``
    the patch is a rectangular tile (the stitched tiles of
    ``parallel/tiling.py``), and ``right_context`` is allowed there. On
    CUDA tensors this is K1, K2, K3 in its ``emit_qr`` form and K4; on CPU
    tensors the plain composition; bit-identical either way.
    """
    if not (cfg.lr_check and not cfg.lr_exact and cfg.num_paths > 0):
        raise ValueError(
            "compute_patch_parts requires lr_check (re-index mode) + SGM"
        )
    iw = _check_block(left, right, x_offset, image_width, right_context,
                      y_offset, image_height)
    rect = (frame_rect(left.shape, x_offset, y_offset, iw, image_height)
            if image_height is not None else None)
    if use_kernels(cfg, left.device):
        cost = _kernel_cost(left, right, cfg, x_offset, right_context)
        parts = sgm_select(kernel_sum(cost, cfg, left, rect, valid), cfg,
                           x_offset=x_offset, image_width=iw, emit_qr=True,
                           own=own)
        median = median3x3
    else:
        if rect is not None and valid is None:
            valid = rect_mask(rect, left.shape, left.device)
        s = _aggregate(left, right, cfg, x_offset, right_context, valid)
        parts = select_disparity(s, cfg, x_offset=x_offset, image_width=iw,
                                 emit_qr=True, own=own)
        median = median_3x3
    disp = median(parts[0]) if cfg.median_filter else parts[0]
    return PatchParts(disp, *parts[1:])


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
