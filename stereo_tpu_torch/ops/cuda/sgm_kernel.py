"""K2 and K3 wrappers: SGM path aggregation (csrc/sgm_paths.cu) and
disparity selection (csrc/sgm_select.cu).

K2 replaces ``stereo_tpu/ops/pallas/sgm_kernel.py:_h_kernel``,
``_v_kernel`` and the path half of ``_v_fused_kernel``, fixed and adaptive
P2; K3 replaces the selection epilogue of ``_v_fused_kernel`` (its base,
``emit_d0`` and ``emit_qr`` forms, whole frames and column patches of a
larger frame). Together they compute what ``sgm_wta_fused_pallas`` does,
with S materialized once in int16 between them; ``sgm_paths`` alone is the
staged S of ``sgm_aggregate_pallas`` (the pyramid model's residual volume
at D=16). K2's rectangle form replaces the Pallas kernels' ``bounds`` form
(``frame_bounds``, ``stereo_tpu/ops/pallas/sgm_kernel.py:66-81``): a tile
of a larger frame, whose paths start fresh at the edges of its in-frame
rectangle; K3 takes a tile's origin, negative on the frame's left edge.
The exact reshard mode (``parallel/exact.py``) runs K2 on a subset of the
directions (``steps``: the horizontals of a row band, the verticals of a
column band) and in its sheared form (``shear``): the verticals of a band
of the sheared volume, in which the reference scans its diagonals
(``stereo_tpu/ops/sgm.py:127-157``). K2's mask form (``mask``) runs the
reference's golden path under an arbitrary ``valid`` mask
(``stereo_tpu/ops/sgm.py:83``): a path restarts after every pixel whose
mask is False; ``pipeline.kernel_sum`` runs each family of the constrained
composition in it. The whole form's two horizontals run as one launch,
the horizontal pair, and on large frames its three down directions and its
three up ones run as one launch each, the sweep groups (``launch_plan``).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ...config import StereoConfig
from ..postprocess import select_disparity, spill_width
from ..sgm import H_STEPS, PATH_STEPS, V_STEPS, shear_valid, sum_paths
from .build import load_kernels
from .launch import count_launch, on_cpu, require, require_disparities, run


def _check_int16_bound(cfg: StereoConfig) -> None:
    """Each path cost is at most max_unary_cost + the largest P2 (with
    adaptive P2, max(P2, p2_min)), so S fits int16 iff num_paths times that
    is below 2^15."""
    p2 = max(cfg.p2, cfg.p2_min) if cfg.adaptive_p2 else cfg.p2
    bound = cfg.num_paths * (cfg.max_unary_cost + p2)
    if bound >= 1 << 15:
        raise ValueError(f"int16 SGM sum may overflow: bound {bound}")


def _clip_rect(rect, h: int, w: int):
    """``rect`` clipped to the [0, h) x [0, w) block, or None where it is
    the whole block (which is the whole-frame form)."""
    if rect is None:
        return None
    y_lo, y_hi, x_lo, x_hi = (int(v) for v in rect)
    y_lo, x_lo = min(max(y_lo, 0), h), min(max(x_lo, 0), w)
    box = (y_lo, max(y_lo, min(y_hi, h)), x_lo, max(x_lo, min(x_hi, w)))
    return None if box == (0, h, 0, w) else box


def _form_args(cost: torch.Tensor, cfg: StereoConfig, image, rect, steps,
               shear, mask):
    """Check a K2 call; returns (image or None, the clipped rectangle or
    None, the steps)."""
    if cfg.num_paths not in (4, 8):
        raise ValueError(f"sgm_paths needs 4 or 8 paths, got {cfg.num_paths}")
    if cfg.adaptive_p2 and image is None:
        raise ValueError("adaptive_p2 needs the reference image")
    _check_int16_bound(cfg)
    img = image if cfg.adaptive_p2 else None
    if img is not None and img.shape != cost.shape[:2]:
        raise ValueError(f"image {tuple(img.shape)} != cost "
                         f"{tuple(cost.shape[:2])}")
    steps = PATH_STEPS[: cfg.num_paths] if steps is None else tuple(
        tuple(st) for st in steps)
    if not steps or len(set(steps)) != len(steps) or not set(steps) <= set(
            PATH_STEPS):
        raise ValueError(f"steps {steps}: distinct travel steps of "
                         f"{PATH_STEPS}")
    box = _clip_rect(rect, *cost.shape[:2])
    if mask is not None:
        if rect is not None or shear is not None:
            raise ValueError("a mask takes neither a rectangle nor a shear")
        if tuple(mask.shape) != tuple(cost.shape[:2]):
            raise ValueError(f"mask {tuple(mask.shape)} != cost "
                             f"{tuple(cost.shape[:2])}")
    if shear is not None:
        sign, x0, frame_w = (int(v) for v in shear)
        h, w = cost.shape[:2]
        if sign not in (1, -1) or rect is not None:
            raise ValueError(f"shear {shear}: sign +1 or -1, no rectangle")
        if not set(steps) <= set(V_STEPS):
            raise ValueError(f"the sheared form scans the verticals "
                             f"{V_STEPS}, got {steps}")
        if frame_w < 1 or x0 < 0 or x0 + w > frame_w + h - 1:
            raise ValueError(f"sheared columns [{x0}, {x0 + w}) leave the "
                             f"sheared frame [0, {frame_w + h - 1})")
    return img, box, steps


class Launch(NamedTuple):
    """One K2 launch of a call: its form (``"whole"``, ``"rect"``,
    ``"shear+1"``, ``"shear-1"``, ``"mask"``, ``"hpair"``, the two
    horizontals at once, or ``"vdown"`` and ``"vup"``, the sweep groups),
    the directions it runs, and whether it adds into the S of the launches
    before it."""
    form: str
    steps: Tuple[Tuple[int, int], ...]
    accumulate: bool


#: The whole form's sweep groups: its three down directions and its three
#: up ones, each run as one launch where ``groups_pay``.
SWEEP_GROUPS = (("vdown", tuple(st for st in PATH_STEPS if st[0] == 1)),
                ("vup", tuple(st for st in PATH_STEPS if st[0] == -1)))


def groups_pay(h: int, w: int, d: int, cost_bytes: int = 1) -> bool:
    """Whether the sweep groups beat the six single directions on an
    h x w x d block of ``cost_bytes``-byte costs: int8 costs at D = 128
    or 256 (the instances built) on a frame of 2^22 pixels or more. A
    group's strips hand their edges on one after another across the frame,
    a chain that only a large frame's rows pay back: on the H100 the two
    groups take about half the six singles' time at 1988 x 2880 (D = 256
    and 128), and as long or longer at 375 x 1242 x 128 (``PERF.md``
    records the timings)."""
    return cost_bytes == 1 and d in (128, 256) and h * w >= 1 << 22


def launch_plan(steps: Sequence[Tuple[int, int]], form: str,
                shape: Tuple[int, int, int], cost_bytes: int = 1
                ) -> Tuple[Launch, ...]:
    """K2's launches for a call of ``steps`` in ``form`` on an h x w x d
    block (``shape``) of ``cost_bytes``-byte costs, in order: one per
    direction, except in the whole form. There both horizontals, where
    ``steps`` holds them, run as one paired launch (``"hpair"``), and where
    ``groups_pay`` for the shape, the three down directions and the three
    up ones, where ``steps`` holds all three, as one launch each (``"vdown"``,
    ``"vup"``); each such launch stands where the first of its directions
    does. Every launch but the first accumulates."""
    units = []
    if form == "whole":
        units.append(("hpair", H_STEPS))
        if groups_pay(*shape, cost_bytes):
            units.extend(SWEEP_GROUPS)
    units = [(name, group) for name, group in units
             if set(group) <= set(steps)]
    plan = []
    for step in steps:
        name, group = next(((n, g) for n, g in units if step in g),
                           (form, (step,)))
        if name == form or not any(p.form == name for p in plan):
            plan.append(Launch(name, group, bool(plan)))
    return tuple(plan)


#: Each (device index, stream)'s sweep-group work: its counters (zero
#: between launches) and the tag of its last launch, and its edge buffer of
#: tagged words, zero when made: the two are made and kept together.
_GROUP_WORK = {}


def _group_work(device: torch.device, h: int, w: int, d: int):
    """(counters, edge buffer) for a sweep group on ``device``'s current
    stream over an h x w x d block (``stpu_sgm_path``)."""
    words = (load_kernels().stpu_sgm_group_blocks(h, w, d) * h * 3 * 16
             * -(-d // 32))
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    work = _GROUP_WORK.get(key)
    if work is None or work[1].numel() < words:
        work = (torch.zeros(3, dtype=torch.int32, device=device),
                torch.zeros(words, dtype=torch.int64, device=device))
        _GROUP_WORK[key] = work
    return work


def sgm_paths_plain(cost: torch.Tensor, cfg: StereoConfig,
                    image: Optional[torch.Tensor] = None,
                    rect: Optional[Tuple[int, int, int, int]] = None,
                    steps: Optional[Sequence] = None,
                    shear: Optional[Tuple[int, int, int]] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sgm_paths``' plain version on any device: ``ops.sgm.sum_paths``
    over the steps, under the mask, the rectangle or the sheared validity
    as its ``valid`` mask."""
    img, box, steps = _form_args(cost, cfg, image, rect, steps, shear, mask)
    h, w = cost.shape[:2]
    if mask is not None:
        mask = mask.to(torch.bool)
    elif box is not None:
        mask = torch.zeros((h, w), dtype=torch.bool, device=cost.device)
        mask[box[0]:box[1], box[2]:box[3]] = True
    elif shear is not None:
        sign, x0, frame_w = (int(v) for v in shear)
        mask = shear_valid(h, frame_w, sign, x0, w, cost.device)
    return sum_paths(cost, cfg, steps, img, mask).to(torch.int16)


def sgm_paths(cost: torch.Tensor, cfg: StereoConfig,
              image: Optional[torch.Tensor] = None,
              rect: Optional[Tuple[int, int, int, int]] = None,
              steps: Optional[Sequence] = None,
              shear: Optional[Tuple[int, int, int]] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[H, W, D] int16 S = sum of the cfg.num_paths (4 or 8) path costs of
    an int8 (census, rank) or int16 (SAD) cost volume, any D in [1, 256]:
    one kernel launch per direction (fewer in the whole form, below). With
    ``cfg.adaptive_p2``, ``image``
    ([H, W], the reference view) is required and each step's P2 comes from
    it. ``rect`` = (y_lo, y_hi, x_lo, x_hi), a tile's in-frame rectangle:
    L = C wherever a pixel's predecessor lies outside it (the rectangle
    form; a rectangle that is the whole block is the whole-frame form).

    ``steps`` (a sub-tuple of ``ops.sgm.PATH_STEPS``; default the
    cfg.num_paths first) launches only those directions, summed. ``shear``
    = (sign, x0, W) makes the block the sheared columns [x0, x0 + w) of an
    H x W frame (sign +1: column x' holds frame column x' + y - (H-1),
    sign -1: x' - y; ``ops.sgm._shear``), scanned along the verticals only:
    L = C wherever the predecessor's source column lies outside the frame
    (the sheared form). ``mask`` ([H, W] bool, no rectangle, no shear):
    L = C wherever a pixel's predecessor is False, whatever the pixel's own
    value (the mask form). CPU tensors take the plain version
    (``sgm_paths_plain``).

    A call whose ``steps`` hold both horizontals, (0, 1) and (0, -1), and
    that takes no rectangle, shear or mask (every whole frame and patch, a
    row band's ``steps=H_STEPS``) runs them as one launch, the horizontal
    pair: two warps per row walk toward each other and meet mid-row, so the
    row's two chains of dependent steps run at once. Its result is bit for
    bit the two launches'. ``sgm_paths.forms`` counts it once under the
    form ``"hpair"``: an 8-path whole frame is 1 ``"hpair"`` and 6
    ``"whole"`` launches, a 4-path one 1 and 2. Where ``groups_pay`` for
    the block's shape, the whole form's three down directions and its three
    up ones run as one launch each, the sweep groups (``"vdown"``,
    ``"vup"``): a warp carries the three paths of a pixel, so C is read and
    S read and written once for the three, and an 8-path whole frame is 1
    ``"hpair"``, 1 ``"vdown"`` and 1 ``"vup"``; bit for bit the six
    launches' sum. The rectangle, mask and sheared forms launch once per
    direction."""
    if on_cpu(*(t for t in (cost, image, mask) if t is not None)):
        return sgm_paths_plain(cost, cfg, image, rect, steps, shear, mask)
    img, box, steps = _form_args(cost, cfg, image, rect, steps, shear, mask)
    if cost.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"cost: expected int8 or int16, got {cost.dtype}")
    require(cost, "cost", cost.dtype, 3)
    h, w, d = cost.shape
    require_disparities(d)
    img_ptr = None
    if img is not None:
        # int32, as the reference's astype(int32), for any image dtype.
        img = img.to(torch.int32).contiguous()
        img_ptr = img.data_ptr()
    mask_ptr = None
    if mask is not None:
        # Bytes of 0 or 1, contiguous and word-aligned, for any mask dtype.
        mask = mask.to(torch.bool).contiguous()
        if mask.data_ptr() % 4:
            mask = mask.clone()
        mask_ptr = mask.data_ptr()
    s = torch.empty((h, w, d), dtype=torch.int16, device=cost.device)
    y_lo, y_hi, x_lo, x_hi = box if box is not None else (0, h, 0, w)
    sign, x0, frame_w = (int(v) for v in shear) if shear else (0, 0, 0)
    # The form: the steps launched and the run, as csrc's enum Run: the
    # whole block, the rectangle, the sheared form with its sign, or the
    # mask.
    form = ("mask" if mask is not None else f"shear{sign:+d}" if sign
            else "rect" if box is not None else "whole")
    plan = launch_plan(steps, form, (h, w, d), cost.element_size())
    sync = edge = None
    if any(launch.form in ("vdown", "vup") for launch in plan):
        sync, edge = _group_work(cost.device, h, w, d)
    for launch in plan:
        # the C entry's step (0, 0) is the horizontal pair, (+-2, 0) a
        # sweep group
        step_y, step_x = {"hpair": (0, 0), "vdown": (2, 0),
                          "vup": (-2, 0)}.get(launch.form, launch.steps[0])
        group = launch.form in ("vdown", "vup")
        run("stpu_sgm_path", cost.device, cost.data_ptr(),
            cost.element_size(), img_ptr, s.data_ptr(), h, w, d, step_y,
            step_x, cfg.p1, cfg.p2, cfg.p2_min, cfg.adaptive_grad_floor,
            int(launch.accumulate), int(box is not None), y_lo, y_hi, x_lo,
            x_hi, sign, x0, frame_w, mask_ptr,
            sync.data_ptr() if group else None,
            edge.data_ptr() if group else None)
        count_launch(sgm_paths, h, w, d, str(cost.dtype), steps,
                     cfg.adaptive_p2, launch.form)
    return s


sgm_paths.forms = Counter()


def sgm_select(s: torch.Tensor, cfg: StereoConfig, emit_d0: bool = False,
               x_offset: int = 0, image_width: Optional[int] = None,
               emit_qr: bool = False,
               own: Optional[Tuple[int, int]] = None,
               ) -> Tuple[torch.Tensor, ...]:
    """(disp [H, W] float32, valid [H, W] bool) from S: first-min WTA,
    uniqueness, subpixel and the cheap LR check (off with ``lr_exact``),
    median excluded. ``emit_d0`` adds the integer winner lane d0 ([H, W]
    int32, md excluded), the form the exact LR check compares.
    ``x_offset`` / ``image_width`` place the block in a larger frame: a
    column patch inside it, or a tile that reaches past its left edge
    (``x_offset < 0``) or its right edge, but not one that misses it.

    ``emit_qr`` (a column patch whose LR check is stitched across patches;
    needs the cheap LR check and a block at least D + md wide) returns
    (disp, ok_nolr, lr_bit, d0, qr, spill) as
    ``ops.postprocess.select_disparity`` does, the right view fed by the
    source columns in ``own`` only.

    Any D in [1, 256]; a negative ``min_disparity`` only with the cheap LR
    check off. CPU tensors take the plain version (``select_disparity``).
    """
    h, w, d = s.shape
    md = int(cfg.min_disparity)
    if image_width is None:
        image_width = x_offset + w
    if x_offset >= image_width or x_offset + w <= 0:
        raise ValueError(f"block [{x_offset}, {x_offset + w}) leaves the "
                         f"frame [0, {image_width})")
    cheap_lr = cfg.lr_check and not cfg.lr_exact
    own_lo, own_hi = own if own is not None else (0, w)
    if emit_qr:
        if not cheap_lr:
            raise ValueError("emit_qr needs the cheap LR check (lr_check "
                             "without lr_exact)")
        if w < d + md:
            raise ValueError(f"emit_qr requires block width >= D + "
                             f"min_disparity ({d + md}), got {w}")
        if not 0 <= own_lo <= own_hi <= w:
            raise ValueError(f"own {own} is not a range of [0, {w}]")
    if on_cpu(s):
        return select_disparity(s, cfg, emit_d0=emit_d0, x_offset=x_offset,
                                image_width=image_width, emit_qr=emit_qr,
                                own=own)
    require(s, "s", torch.int16, 3)
    require_disparities(d)
    if md < 0 and cheap_lr:
        raise ValueError("the CUDA select kernel takes min_disparity < 0 "
                         "only with the cheap LR check off")
    sp = spill_width(d, md) if emit_qr else 0
    if not load_kernels().stpu_sgm_select_fits(w, sp):
        raise ValueError(f"the CUDA select kernel keeps a row in shared "
                         f"memory: width {w} is too large")

    def out(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=s.device)

    disp = out((h, w), torch.float32)
    valid = out((h, w), torch.bool)
    d0 = out((h, w), torch.int32) if emit_d0 or emit_qr else None
    lr_bit = out((h, w), torch.bool) if emit_qr else None
    qr = out((h, w), torch.float32) if emit_qr else None
    spill = out((h, sp), torch.float32) if emit_qr else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    run("stpu_sgm_select", s.device, s.data_ptr(), disp.data_ptr(),
        valid.data_ptr(), ptr(d0), h, w, d, md, int(cfg.subpixel),
        int(cfg.uniqueness_ratio > 0), 1.0 + cfg.uniqueness_ratio,
        int(cheap_lr), cfg.lr_tau, x_offset, image_width, ptr(lr_bit),
        ptr(qr), ptr(spill), own_lo, own_hi, sp)
    # framed: the block's origin and frame matter (cheap LR only); -1 for
    # a tile at a negative origin, a form of its own.
    framed = cheap_lr and (x_offset != 0 or image_width != w)
    if framed and x_offset < 0:
        framed = -1
    count_launch(sgm_select, h, w, d, md, cfg.subpixel,
                 cfg.uniqueness_ratio > 0, cheap_lr, emit_d0, framed, emit_qr)
    if emit_qr:
        return disp, valid, lr_bit, d0, qr, spill
    return (disp, valid) if d0 is None else (disp, valid, d0)


sgm_select.forms = Counter()
