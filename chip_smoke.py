"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each failure raises, and the script exits nonzero without a
result line):

  1. device: a CUDA card is required (there is no CPU path); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the six CUDA kernels (nvcc, sm_90a, one compiler per
     source, all at once) and the host speckle and fill library (g++) from
     the sources in this checkout; prints ptxas's registers and spills of
     every K2 instance with its ring (pixels staged per warp, shared memory
     per block), of every K1 (transform and cost stage) and K3 instance,
     and of every K5 (by sum type, window half-width and disparity chunk)
     and K4 instance with its shared memory per block (K5's at the paths'
     windows and D);
  3. kernels: runs each kernel form and its plain torch version on the card
     at every shape a path below gives it, requires bit-equal results,
     times both with CUDA events (medians) and computes the form's bound on
     this card from the same shapes; K5's and K4's rows also carry the
     kernel's device time per call (device_ms, torch.profiler over a train
     of calls). A form is what the wrappers count their launches by: the
     shape and what picks the instantiation.
       - K1's transform stage (transform_words, each image of the pair)
         and its cost stage census_cost, K2 sgm_paths (fixed and adaptive
         P2), K3 sgm_select (base and the exact LR check's two forms:
         emit_d0, and integer winners without uniqueness) and K4 median3x3
         on kitti_like_pair(seed=0) at 375x1242, D=128;
       - K1's rank form (transform and cost stage) at 375x1242x128;
       - the pyramid model's coarse pass on the 2x2-pooled pair (188x621,
         D=64): K1 on a 1-word 5x5 census, K2 (fixed and adaptive P2), K3
         without subpixel and LR, K4;
       - K1's transform stage on a 5x5 window at 375x1242 (the residual
         pass's descriptors), K2 at D=16 (fixed and adaptive P2) and K3
         with min_disparity=-8 on the pyramid model's residual volume
         (375x1242x16), and the plain-torch gather that builds that
         volume;
       - K1 at D=64, K2 with 4 paths, K3 and K4 on the Middlebury pair
         (555x900);
       - K1, K2 (fixed and adaptive P2), K3, K4, K5 sad_cost at D=128 and
         K2 on its int16 costs on the hard suite's radiometric pair
         (160x288, D=128);
       - K5, K3 at D=16 and K4 on the tsukuba_sad16 pair (288x384), and
         K5 with a right context on its right half (sad_cost/ctx, a form
         that no path below launches yet: 0 launches per frame);
       - K5 at 375x1242x128 on kitti_like_pair(seed=0) (sad_cost/kitti,
         kitti_sgm8_128 with cost_fn="sad"; timed, no path launches it);
       - config 4 (middlebury_full_256_tiled, D=256) through the banded
         runner: every patch of the three splits below, at 497x720 and at
         1988x2880, through K1 (with x_offset and right_context where the
         patch has them), K2, K3 (base, framed, or the emit_qr form with
         the patch's own range) and K4, each patch at its whole shape
         against the plain version on the same patch (at 1988x2880 the
         plain K2 takes seconds, and is timed once);
       - tsukuba_sad16 in two column patches (288x228 each, the legacy
         overlap): K5 without and with a column origin, K3 framed, K4;
       - the halo-tiled pipeline (build_halo_pipeline on the local grid,
         every tile of each grid of phase 4's tiled paths, at the tile's
         whole shape): K1's transform stage on each tile image, its cost
         stage or K5 at the tile's origin (negative on the frame's left
         edge: rows ".../neg"), K2 in its rectangle form (paths start
         fresh at the tile's in-frame rectangle: ".../rect"; the exact LR
         check's flipped pass runs the whole form), K3 at the tile's
         origin (framed, emit_qr, or the exact LR check's forms) and K4 on
         the cropped tile with its 1-px halo, each against the plain
         version on the same tile (the plain K2 takes the rectangle as its
         valid mask); the launches of one frame are tallied by row as the
         tiles are held;
       - K6 alu_peak in float32 and int32 at the anchor's two programs;
  4. slices: each path serves a few requests through get_model(...).build,
     host_postprocess and evaluate_disparity, with the launch counters set
     to 0 just before and read just after, by form; a launch of a form
     that phase 3 did not hold against its plain version fails (per frame,
     K1/K5 K2 K3 K4; K1 stands for its cost stage, and its transform stage
     adds one launch per image, two per K1):
     kitti_sgm8_128 (1 8 1 1), kitti_sgm8_128_quality (1 8 1 1),
     kitti_sgm8_128 with lr_exact (2 16 2 1), tsukuba_sad16 through the
     block_matching model (1 0 1 1) and through build_banded_pipeline in two
     column patches (2 0 2 2, K5 with x_offset != 0),
     middlebury_census_sgm4_64 (1 4 1 1),
     kitti_sgm8_128 and kitti_sgm8_128_quality through the pyramid model
     with a 5x5 census (1 16 2 2 each; the quality preset gives the
     residual pass its adaptive P2) and kitti_sgm8_128 with cost_fn="rank"
     (1 8 1 1); then config 4 through build_banded_pipeline at 497x720
     and at 1988x2880 (make_pair(shape, max_disp=200, kind="shapes",
     texture="cloud")): the whole frame (n_bands=1, n_cols=1; 1 8 1 1),
     two column patches stitched (2 16 2 2, K3 in its emit_qr form) and
     2x2 patches in the legacy overlap (4 32 4 4, x_offset != 0); the
     splits are not expected to equal the whole frame (SGM warm-up at
     patch edges), and the share of pixels that differ is printed; then
     the halo-tiled pipeline on the local grid (build_halo_pipeline over
     make_tile_mesh(["cuda"] * n, grid)): kitti_sgm8_128 on 2x2 tiles
     (stitched), kitti_sgm8_128_quality on 2x2 (legacy), kitti_sgm8_128
     with lr_exact on 1x2 (legacy), tsukuba_sad16 on 1x2 (K5 at a negative
     origin) and config 4 on 2x2 (legacy) and 1x2 (stitched) at 497x720
     and at 1988x2880, each with the launches that the kernels phase
     tallied for its tiles, and its median device ms beside the whole
     frame's (a JSON line "tiled vs whole"). Frame 0 of each must
     reproduce the reference package's hashes
     (stereo_tpu_torch/testdata/*_seed0.json) and the repeated seeds their
     first answers;
  5. hard suite: run_hard_suite(kitti_sgm8_128_quality, (160, 288), seeds
     0-2) and census_vs_sad_robustness(kitti_sgm8_128, (160, 288), seed 0)
     on the card, rows equal to the reference's
     (testdata/hard_suite_*.json, census_vs_sad_*.json), launch counters
     checked; prints the rows and the sweep's wall time;
  6. stream: config 5, the batched video stream, through its entry points
     (each run with the launch counters set to 0 just before and read
     just after, by form): kitti_sgm8_128 at 375x1242 through
     StreamRunner.run_batches at batch 48, 96 frames of make_pair(shape,
     max_disp=96, kind="shapes", texture="cloud", seed=i) staged on the
     card, after one warm-up batch (bench.py:296-325); prints the record
     {"metric": "kitti_stream_batch48_fps_per_chip", ...} with the card's
     name and power limit, holds every frame (disp and valid) equal to
     build_pipeline on that frame and frame 0 also to the plain torch
     path; then StreamRunner.run on 10 of those frames as numpy arrays at
     batch 4 (the last batch partial) with a manifest, a fault injected
     after 4 frames and a restart from the manifest, every frame delivered
     once and equal to the per-frame path; a tiled stream, 4 frames on a
     local 2x2 grid (stitched), each equal to build_halo_pipeline; and
     scaling_report's row for the one card. Launches: 13 a frame (the
     kitti_sgm8_128 forms) for the 96 + 12 + 31 frames of the whole-frame
     runs, the 2x2 tiles' forms for the tiled one;
  7. anchor: measure_alu_peak times K6 over the reference's two programs
     in float32 and int32 (one JSON line per program, then the best rate
     per type), with the launch counters set to 0 before and read after;
     every kernel row gains sol_fraction and sol_fraction_anchor.

    python3 chip_smoke.py --write-fixtures DIR

instead makes the full-size (1988x2880) config-4 fixtures: each split
(banded runner) and each tile grid (halo-tiled pipeline) runs on the card
through the plain torch path (backend="torch") and through the kernels,
the two must agree bit for bit, and DIR/<fixture>_seed0.json gets the
hashes (to be copied into stereo_tpu_torch/testdata). The quarter-size
fixtures, which the reference package makes on the CPU, tie that plain
path to the reference.

K1's two stages are separate rows: ``census_transform*`` rows time the
transform stage on one image (each image of a pair is one launch), and
``census_cost*`` rows time the cost stage from the words the transform
stage wrote; the plain versions are the plain torch transforms and the
plain cost volume from the images.

Prints, on the lines before the last, the card's name and power limit
and one JSON object with each kernel form's launches on the main paths
(as the wrappers counted them), error, times and bound; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Tuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stereo_tpu_torch import (  # noqa: E402
    KITTI_SGM8_128,
    KITTI_SGM8_128_QUALITY,
    MIDDLEBURY_CENSUS_SGM4_64,
    PRESETS,
    TSUKUBA_SAD16,
    build_pipeline,
    host_postprocess,
    native,
)
from stereo_tpu_torch.config import MIDDLEBURY_FULL_256_TILED  # noqa: E402
from stereo_tpu_torch.data import kitti_like_pair, make_pair  # noqa: E402
from stereo_tpu_torch.eval import evaluate_disparity  # noqa: E402
from stereo_tpu_torch.eval.hard_suite import (  # noqa: E402
    SCENARIOS,
    census_vs_sad_robustness,
    run_hard_suite,
)
from stereo_tpu_torch.eval.roofline import (  # noqa: E402
    ANCHOR_PROGRAMS,
    cost_bound,
    cuda_ms,
    measure_alu_peak,
    median_bound,
    paths_bound,
    peak_bound,
    profiled_ms,
    sad_bound,
    select_bound,
    sol_fractions,
    transform_bound,
)
from stereo_tpu_torch.models import get_model  # noqa: E402
from stereo_tpu_torch.models.pyramid import (  # noqa: E402
    _pool2,
    _residual_cost_volume,
)
from stereo_tpu_torch.ops import (  # noqa: E402
    adaptive_p2_map,
    census_cost_volume,
    median_3x3,
    rank_cost_volume,
    sad_cost_volume,
    select_disparity,
    sgm_aggregate,
)
from stereo_tpu_torch.ops.census import (  # noqa: E402
    census_transform_plain,
    rank_transform_plain,
)
from stereo_tpu_torch.ops.cuda import (  # noqa: E402
    alu_peak,
    census_cost,
    launch_forms,
    median3x3,
    rank_cost,
    reset_launch_counts,
    sad_cost,
    sgm_paths,
    sgm_select,
    transform_words,
)
from stereo_tpu_torch.ops.cuda.build import load_kernels  # noqa: E402
from stereo_tpu_torch.ops.cuda.launch import run  # noqa: E402
from stereo_tpu_torch.ops.cuda.peak_kernel import alu_peak_plain  # noqa: E402
from stereo_tpu_torch.ops.postprocess import spill_width  # noqa: E402
from stereo_tpu_torch.ops.sgm import PATH_STEPS  # noqa: E402
from stereo_tpu_torch.eval.scaling import scaling_report  # noqa: E402
from stereo_tpu_torch.parallel import (  # noqa: E402
    StreamRunner,
    build_banded_pipeline,
    build_halo_pipeline,
    make_tile_mesh,
    plan_bands,
)
from stereo_tpu_torch.parallel.bands import right_context_of  # noqa: E402
from stereo_tpu_torch.parallel.tiling import (  # noqa: E402
    _halo_widths,
    padded_extent,
    stitch_supported,
)
from stereo_tpu_torch.config import TileConfig  # noqa: E402
from stereo_tpu_torch.pipeline import frame_rect, rect_mask  # noqa: E402

TESTDATA = ROOT / "stereo_tpu_torch" / "testdata"
CFG = KITTI_SGM8_128
PLAIN = CFG.replace(backend="torch")
QCFG = KITTI_SGM8_128_QUALITY
LRCFG = CFG.replace(lr_exact=True)
SAD = TSUKUBA_SAD16
RANK = CFG.replace(cost_fn="rank")
MID = MIDDLEBURY_CENSUS_SGM4_64
SADSGM = CFG.replace(cost_fn="sad")
QUALITY_P2 = dict(adaptive_p2=True, adaptive_grad_floor=12, p2_min=30)

CFG4 = MIDDLEBURY_FULL_256_TILED
_COST_CU = "stereo_tpu_torch/csrc/census_cost.cu"
_SAD_CU = "stereo_tpu_torch/csrc/sad_cost.cu"
_PATHS_CU = "stereo_tpu_torch/csrc/sgm_paths.cu"
_SELECT_CU = "stereo_tpu_torch/csrc/sgm_select.cu"
_MEDIAN_CU = "stereo_tpu_torch/csrc/median3x3.cu"
_PEAK_CU = "stereo_tpu_torch/csrc/alu_peak.cu"
_COST_X = "stereo_tpu/ops/pallas/cost_kernel.py:206"
_COST_D = "stereo_tpu/ops/pallas/cost_kernel.py:119"
_H_PATHS = "stereo_tpu/ops/pallas/sgm_kernel.py:399"
_V_FUSED = "stereo_tpu/ops/pallas/sgm_kernel.py:992"
_MEDIAN = "stereo_tpu/ops/pallas/filter_kernel.py:33"
_EMIT_QR = "stereo_tpu/ops/pallas/sgm_kernel.py:1082"
#: K1's transform stage replaces the transforms inside the reference's K1
#: entry points (XLA there): census_cost_volume_pallas, rank_cost_volume_pallas.
_CENSUS_T = "stereo_tpu/ops/pallas/cost_kernel.py:504"
_RANK_T = "stereo_tpu/ops/pallas/cost_kernel.py:533"
_PEAK = "stereo_tpu/eval/roofline.py:141"
#: kernel form -> (wrapper, source, the TPU kernel it replaces). A row with
#: a size in its name is a form of an earlier row at another path's shape.
KERNEL_INFO = {
    # K1's transform stage, one image at a time: kitti (9x7), rank, the
    # pyramid's coarse pass (5x5 on the pooled pair) and residual pass
    # (5x5), middlebury, the hard suite
    "census_transform": ("transform_words", _COST_CU, _CENSUS_T),
    "census_transform/rank": ("transform_words", _COST_CU, _RANK_T),
    "census_transform/w1_d64": ("transform_words", _COST_CU, _CENSUS_T),
    "census_transform/5x5": ("transform_words", _COST_CU, _CENSUS_T),
    "census_transform/555x900": ("transform_words", _COST_CU, _CENSUS_T),
    "census_transform/160x288": ("transform_words", _COST_CU, _CENSUS_T),
    "census_cost": ("census_cost", _COST_CU,
                    "stereo_tpu/ops/pallas/cost_kernel.py:206"),
    "census_cost/rank": ("rank_cost", _COST_CU,
                         "stereo_tpu/ops/pallas/cost_kernel.py:513"),
    "census_cost/d64": ("census_cost", _COST_CU,
                        "stereo_tpu/ops/pallas/cost_kernel.py:119"),
    "sad_cost": ("sad_cost", _SAD_CU,
                 "stereo_tpu/ops/pallas/cost_kernel.py:584"),
    "sad_cost/d128": ("sad_cost", _SAD_CU,
                      "stereo_tpu/ops/pallas/cost_kernel.py:584"),
    "sgm_paths": ("sgm_paths", _PATHS_CU,
                  "stereo_tpu/ops/pallas/sgm_kernel.py:399"),
    "sgm_paths/adaptive": ("sgm_paths", _PATHS_CU,
                           "stereo_tpu/ops/pallas/sgm_kernel.py:399"),
    "sgm_paths/4": ("sgm_paths", _PATHS_CU,
                    "stereo_tpu/ops/pallas/sgm_kernel.py:586"),
    "sgm_paths/d16": ("sgm_paths", _PATHS_CU,
                      "stereo_tpu/ops/pallas/sgm_kernel.py:871"),
    "sgm_paths/d16/adaptive": ("sgm_paths", _PATHS_CU,
                               "stereo_tpu/ops/pallas/sgm_kernel.py:905"),
    "sgm_paths/int16": ("sgm_paths", _PATHS_CU,
                        "stereo_tpu/ops/pallas/sgm_kernel.py:399"),
    "sad_cost/ctx": ("sad_cost", _SAD_CU,
                     "stereo_tpu/ops/pallas/cost_kernel.py:584"),
    # kitti_sgm8_128 with cost_fn="sad": 375x1242x128 (timed only)
    "sad_cost/kitti": ("sad_cost", _SAD_CU,
                       "stereo_tpu/ops/pallas/cost_kernel.py:584"),
    "sgm_select": ("sgm_select", _SELECT_CU,
                   "stereo_tpu/ops/pallas/sgm_kernel.py:992"),
    "sgm_select/d0": ("sgm_select", _SELECT_CU,
                      "stereo_tpu/ops/pallas/sgm_kernel.py:1224"),
    "sgm_select/int": ("sgm_select", _SELECT_CU, _V_FUSED),
    "sgm_select/d16": ("sgm_select", _SELECT_CU,
                       "stereo_tpu/ops/pallas/sgm_kernel.py:992"),
    "sgm_select/md-8": ("sgm_select", _SELECT_CU,
                        "stereo_tpu/ops/pallas/sgm_kernel.py:992"),
    "median3x3": ("median3x3", _MEDIAN_CU, _MEDIAN),
    # the pyramid model's coarse pass: 188x621, D=64, 5x5 census
    "census_cost/w1_d64": ("census_cost", _COST_CU, _COST_D),
    "sgm_paths/d64": ("sgm_paths", _PATHS_CU, _H_PATHS),
    "sgm_paths/d64/adaptive": ("sgm_paths", _PATHS_CU, _H_PATHS),
    "sgm_select/coarse": ("sgm_select", _SELECT_CU, _V_FUSED),
    "median3x3/coarse": ("median3x3", _MEDIAN_CU, _MEDIAN),
    # middlebury_census_sgm4_64: 555x900, D=64
    "sgm_select/d64": ("sgm_select", _SELECT_CU, _V_FUSED),
    "median3x3/555x900": ("median3x3", _MEDIAN_CU, _MEDIAN),
    # the hard suite: 160x288, D=128
    "census_cost/160x288": ("census_cost", _COST_CU, _COST_X),
    "sgm_paths/160x288": ("sgm_paths", _PATHS_CU, _H_PATHS),
    "sgm_paths/adaptive/160x288": ("sgm_paths", _PATHS_CU, _H_PATHS),
    "sgm_select/160x288": ("sgm_select", _SELECT_CU, _V_FUSED),
    "median3x3/160x288": ("median3x3", _MEDIAN_CU, _MEDIAN),
    # tsukuba_sad16: 288x384
    "median3x3/288x384": ("median3x3", _MEDIAN_CU, _MEDIAN),
}



def _cfg4_forms(images: Dict[str, int], k1: Dict[str, int],
                shapes: Dict[str, int], k3: str) -> Dict[str, int]:
    """Launches per frame of one config-4 split, by KERNEL_INFO row:
    ``images`` maps an image shape "HxW" (a right image with its context
    columns included) to K1 transform launches, ``k1`` a K1 row's suffix
    ("HxW" or "HxW/framed") to its launches, ``shapes`` a patch shape "HxW"
    to the patches of that shape, ``k3`` is the suffix of the split's K3
    form ("", "/framed" or "/qr")."""
    forms = {f"census_transform/cfg4/{shape}": n
             for shape, n in images.items()}
    forms.update({f"census_cost/cfg4/{suffix}": n
                  for suffix, n in k1.items()})
    for shape, n in shapes.items():
        forms[f"sgm_paths/cfg4/{shape}"] = 8 * n
        forms[f"sgm_select/cfg4/{shape}{k3}"] = n
        forms[f"median3x3/cfg4/{shape}"] = n
    return forms


#: Config 4 through the banded runner, halo 20: the split, then the
#: launches per frame at 497x720 and at 1988x2880. Stitched patches are
#: 380 and 1460 columns wide (half the frame + the halo; the second reads
#: 255 context columns); the legacy ones 636 and 1716 (+ halo + D on the
#: inner side), in bands of 269 and 268, or 1014, rows. K1's transform
#: stage runs on both images of each patch: the stitched second patch's
#: right image carries its 255 context columns (380 + 255, 1460 + 255).
CFG4_SPLITS = {
    "": (dict(n_bands=1, n_cols=1),
         _cfg4_forms({"497x720": 2}, {"497x720": 1}, {"497x720": 1}, ""),
         _cfg4_forms({"1988x2880": 2}, {"1988x2880": 1}, {"1988x2880": 1},
                     "")),
    "_1x2": (dict(n_bands=1, n_cols=2),
             _cfg4_forms({"497x380": 3, "497x635": 1},
                         {"497x380": 1, "497x380/framed": 1}, {"497x380": 2},
                         "/qr"),
             _cfg4_forms({"1988x1460": 3, "1988x1715": 1},
                         {"1988x1460": 1, "1988x1460/framed": 1},
                         {"1988x1460": 2}, "/qr")),
    "_2x2_legacy": (dict(n_bands=2, n_cols=2, lr_stitch=False),
                    _cfg4_forms({"269x636": 4, "268x636": 4},
                                {"269x636": 1, "269x636/framed": 1,
                                 "268x636": 1, "268x636/framed": 1},
                                {"269x636": 2, "268x636": 2}, "/framed"),
                    _cfg4_forms({"1014x1716": 8},
                                {"1014x1716": 2, "1014x1716/framed": 2},
                                {"1014x1716": 4}, "/framed")),
}
for _, _quarter, _full in CFG4_SPLITS.values():
    for _name in (*_quarter, *_full):
        _kernel = _name.split("/")[0]
        KERNEL_INFO[_name] = {
            "census_transform": ("transform_words", _COST_CU, _CENSUS_T),
            "census_cost": ("census_cost", _COST_CU, _COST_X),
            "sgm_paths": ("sgm_paths", _PATHS_CU, _H_PATHS),
            "sgm_select": ("sgm_select", _SELECT_CU,
                           _EMIT_QR if _name.endswith("/qr") else _V_FUSED),
            "median3x3": ("median3x3", _MEDIAN_CU, _MEDIAN),
        }[_kernel]
#: tsukuba_sad16 (288x384, D=16, no SGM paths) in two column patches: a SAD
#: cost takes the legacy overlap, so both patches are 228 columns wide (half
#: the frame + halo 20 + D) and the second has a column origin in K5 and K3.
SAD_SPLIT = dict(n_bands=1, n_cols=2)
SAD_SPLIT_FORMS = {"sad_cost/bands/288x228": 1,
                   "sad_cost/bands/288x228/framed": 1,
                   "sgm_select/bands/288x228/framed": 2,
                   "median3x3/bands/288x228": 2}
for _name in SAD_SPLIT_FORMS:
    KERNEL_INFO[_name] = {
        "sad_cost": ("sad_cost", _SAD_CU,
                     "stereo_tpu/ops/pallas/cost_kernel.py:584"),
        "sgm_select": ("sgm_select", _SELECT_CU, _V_FUSED),
        "median3x3": ("median3x3", _MEDIAN_CU, _MEDIAN),
    }[_name.split("/")[0]]
#: K6 at the anchor's programs: alu_peak/<type>/k<k>.
for _rows, _k, _chains in ANCHOR_PROGRAMS:
    for _type in ("float32", "int32"):
        KERNEL_INFO[f"alu_peak/{_type}/k{_k}"] = ("alu_peak", _PEAK_CU, _PEAK)

#: Rows held against their plain version that no path launches yet.
OFF_PATH = {"sad_cost/ctx", "sad_cost/kitti"}

#: (wrapper, *form) as the wrappers count their launches -> the KERNEL_INFO
#: row whose comparison in the kernels phase launched that form.
HELD: Dict[tuple, str] = {}


def tsukuba_pair(seed: int):
    """The tsukuba_sad16 fixture's pair family (the reference's bench)."""
    return make_pair((288, 384), max_disp=14, kind="shapes", texture="cloud",
                     seed=seed)


def middlebury_pair(seed: int):
    """The middlebury_census_sgm4_64 pair family (the reference's bench)."""
    return make_pair((555, 900), max_disp=48, kind="shapes", texture="cloud",
                     seed=seed)


def cfg4_pair(shape):
    """seed -> the config-4 pair family at ``shape`` (the reference's
    bench, at 1988x2880)."""
    return lambda seed: make_pair(shape, max_disp=200, kind="shapes",
                                  texture="cloud", seed=seed)


class Slice(NamedTuple):
    fixture: str                      # testdata/<fixture>_seed0.json
    pair: Callable[[int], object]     # seed -> StereoPair
    seeds: Tuple[int, ...]
    forms: Dict[str, int]             # KERNEL_INFO row -> launches per frame
    model: str = ""                   # "": the fixture's model
    differs_from: str = ""            # print the share of pixels that differ


class BandedRunner(NamedTuple):
    """A fixture's ``bands`` split as a model: ``build(device)`` is
    ``build_banded_pipeline`` for the fixture's frame."""

    cfg: object
    shape: Tuple[int, int]
    split: Dict[str, object]

    @property
    def name(self) -> str:
        return "banded " + " ".join(f"{k}={v}" for k, v in self.split.items())

    def build(self, device):
        return build_banded_pipeline(self.cfg, self.shape, device=device,
                                     **self.split)


class TiledRunner(NamedTuple):
    """A fixture's ``tiles`` grid as a model: ``build(device)`` is
    ``build_halo_pipeline`` on the local grid, every tile on ``device``."""

    cfg: object
    grid: Tuple[int, int]
    lr_stitch: object

    @property
    def name(self) -> str:
        return (f"halo tiles {self.grid[0]}x{self.grid[1]} "
                f"lr_stitch={self.lr_stitch}")

    def build(self, device):
        mesh = make_tile_mesh([device] * (self.grid[0] * self.grid[1]),
                              self.grid)
        return build_halo_pipeline(self.cfg, mesh, lr_stitch=self.lr_stitch,
                                   device=device)


#: A pyramid frame: the coarse pass at half size and D/2 (K1, K2 x 8, K3
#: without LR, K4), then K2 x 8 and K3 on the residual volume, and K4.
_PYRAMID_FORMS = {
    "census_transform/w1_d64": 2, "census_transform/5x5": 2,
    "census_cost/w1_d64": 1, "sgm_paths/d64": 8, "sgm_select/coarse": 1,
    "median3x3/coarse": 1, "sgm_paths/d16": 8, "sgm_select/md-8": 1,
    "median3x3": 1,
}

SLICES = (
    Slice("kitti_sgm8_128", kitti_like_pair, (0, 1, 0, 1),
          {"census_transform": 2, "census_cost": 1, "sgm_paths": 8,
           "sgm_select": 1, "median3x3": 1}),
    Slice("kitti_sgm8_128_quality", kitti_like_pair, (0, 1, 0),
          {"census_transform": 2, "census_cost": 1, "sgm_paths/adaptive": 8,
           "sgm_select": 1, "median3x3": 1}),
    Slice("kitti_sgm8_128_lr_exact", kitti_like_pair, (0, 1, 0),
          {"census_transform": 4, "census_cost": 2, "sgm_paths": 16,
           "sgm_select/d0": 1,
           "sgm_select/int": 1, "median3x3": 1}),
    Slice("tsukuba_sad16", tsukuba_pair, (0, 1, 2, 3, 0, 1, 2, 3),
          {"sad_cost": 1, "sgm_select/d16": 1, "median3x3/288x384": 1},
          model="block_matching"),
    Slice("tsukuba_sad16_1x2", tsukuba_pair, (0, 1, 0), SAD_SPLIT_FORMS,
          differs_from="tsukuba_sad16"),
    Slice("middlebury_census_sgm4_64", middlebury_pair, (0, 1, 0, 1),
          {"census_transform/555x900": 2, "census_cost/d64": 1,
           "sgm_paths/4": 4, "sgm_select/d64": 1, "median3x3/555x900": 1}),
    Slice("kitti_sgm8_128_pyramid55", kitti_like_pair, (0, 1, 0, 1),
          _PYRAMID_FORMS),
    Slice("kitti_sgm8_128_quality_pyramid55", kitti_like_pair, (0, 1, 0),
          {"census_transform/w1_d64": 2, "census_transform/5x5": 2,
           "census_cost/w1_d64": 1, "sgm_paths/d64/adaptive": 8,
           "sgm_select/coarse": 1, "median3x3/coarse": 1,
           "sgm_paths/d16/adaptive": 8, "sgm_select/md-8": 1,
           "median3x3": 1}),
    Slice("kitti_sgm8_128_rank", kitti_like_pair, (0, 1, 0),
          {"census_transform/rank": 2, "census_cost/rank": 1, "sgm_paths": 8,
           "sgm_select": 1, "median3x3": 1}),
    # config 4 through the banded runner, at a quarter of the resolution
    # (fixtures from the reference package) and at the bench's size
    *(Slice(f"middlebury_full_256_tiled_q{tag}", cfg4_pair((497, 720)),
            (0, 1, 0), quarter,
            differs_from="middlebury_full_256_tiled_q" if tag else "")
      for tag, (_, quarter, _) in CFG4_SPLITS.items()),
    *(Slice(f"middlebury_full_256_tiled{tag}", cfg4_pair((1988, 2880)),
            (0, 0), full,
            differs_from="middlebury_full_256_tiled" if tag else "")
      for tag, (_, _, full) in CFG4_SPLITS.items()),
)


#: The halo-tiled pipeline's paths; their launches per frame are tallied by
#: ``tiled_rows`` in the kernels phase (each ``forms`` starts empty).
TILED_SLICES = (
    Slice("kitti_sgm8_128_tiles_2x2", kitti_like_pair, (0, 1, 0), {},
          differs_from="kitti_sgm8_128"),
    Slice("kitti_sgm8_128_quality_tiles_2x2_legacy", kitti_like_pair,
          (0, 1, 0), {}, differs_from="kitti_sgm8_128_quality"),
    Slice("kitti_sgm8_128_lr_exact_tiles_1x2", kitti_like_pair, (0, 1, 0),
          {}, differs_from="kitti_sgm8_128_lr_exact"),
    Slice("tsukuba_sad16_tiles_1x2", tsukuba_pair, (0, 1, 0), {},
          differs_from="tsukuba_sad16"),
    *(Slice(f"middlebury_full_256_tiled{q}_tiles_{grid}", cfg4_pair(shape),
            seeds, {}, differs_from=f"middlebury_full_256_tiled{q}")
      for q, shape, seeds in (("_q", (497, 720), (0, 1, 0)),
                              ("", (1988, 2880), (0, 0)))
      for grid in ("2x2_legacy", "1x2")),
)
SLICES = SLICES + TILED_SLICES

#: While not None, ``held`` adds each call's launches here by row: one
#: frame's launches of a tiled path, as ``tiled_rows`` holds its tiles.
_TALLY = None


def held(name: str, fn):
    """``fn()`` must launch row ``name``'s kernel form and nothing else (K2
    once per direction): notes the counted form under the row, waits for
    the card so a fault shows where it ran, and returns what ``fn`` did,
    which the caller compares with the plain version."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    forms = list(launch_forms())
    if len(forms) != 1 or forms[0][0] != KERNEL_INFO[name][0]:
        raise AssertionError(f"{name}: launched {forms}")
    form = forms[0]
    if HELD.setdefault(form, name) != name:
        raise AssertionError(f"{name} and {HELD[form]} are one form: {form}")
    if _TALLY is not None:
        _TALLY[name] = _TALLY.get(name, 0) + launch_forms()[form]
    return out


def counted_launches(what: str) -> Dict[str, int]:
    """The wrappers' launches since the last reset, by KERNEL_INFO row;
    fails for a form that the kernels phase held against no plain version."""
    by_row: Dict[str, int] = {}
    for form, n in launch_forms().items():
        if form not in HELD:
            raise AssertionError(f"{what}: launched {form}, a form that no "
                                 f"row holds against its plain version")
        by_row[HELD[form]] = by_row.get(HELD[form], 0) + n
    return by_row


def expected_launches(forms: Dict[str, int], times: int) -> Dict[str, int]:
    return {form: n * times for form, n in forms.items()}


def load_slice(sl: Slice):
    """(fixture, config, model) of a slice, from its fixture file."""
    fx = json.loads((TESTDATA / f"{sl.fixture}_seed0.json").read_text())
    cfg = PRESETS[fx["preset"]].replace(**fx.get("overrides", {}))
    if "bands" in fx:
        return fx, cfg, BandedRunner(cfg, tuple(fx["shape"]), fx["bands"])
    if "tiles" in fx:
        return fx, cfg, TiledRunner(cfg, tuple(fx["tiles"]["mesh_shape"]),
                                    fx["tiles"]["lr_stitch"])
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in fx.get("model_kwargs", {}).items()}
    model = get_model(sl.model or fx.get("model", "classic"), cfg=cfg,
                      **kwargs)
    return fx, cfg, model


def sha16(a) -> str:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference (nan if any is), taken in bands of rows: a
    full-size config-4 volume as one float64 tensor is 11.7 GB."""
    return float(torch.stack([
        (g.double() - w.double()).abs().max()
        for g, w in zip(got.split(64), want.split(64))]).max())


def require_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """``got`` must hold ``want``'s values (the kernels' int8 and int16
    volumes against the plain versions' int32); returns the max abs err."""
    err = max_abs_err(got, want) if got.shape == want.shape else float("nan")
    if err != 0:
        raise AssertionError(
            f"{name}: kernel differs from its plain version (shape "
            f"{tuple(got.shape)} vs {tuple(want.shape)}, max abs err {err})")
    return err


def synced(fn):
    """``fn()``, then wait for the card, so a fault shows where it ran."""
    out = fn()
    torch.cuda.synchronize()
    return out


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's main path runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    load_kernels()
    native.load()
    print(f"build: kernels + speckle library in "
          f"{time.perf_counter() - t0:.2f} s")
    print("K2 instances (ptxas registers and spill bytes; ring: pixels "
          "staged per warp, shared bytes per block): "
          + json.dumps(k2_instances()))
    print("K1 and K3 instances (ptxas registers and spill bytes, by "
          "template arguments): " + json.dumps({
              kernel: kernel_instances(kernel) for kernel in (
                  "census_transform_kernel", "census_cost_kernel",
                  "sgm_select_kernel")}))
    lib = load_kernels()
    print("K5 and K4 instances (ptxas registers, spill bytes and static "
          "shared bytes per block, by template arguments; K5: sum type, "
          "window half-width, disparity chunk): " + json.dumps({
              kernel: kernel_instances(kernel) for kernel in (
                  "sad_cost_kernel", "median3x3_kernel")}))
    print("K5 shared bytes per block (dynamic, 16-row tile): " + json.dumps({
        f"D={d} {wy}x{wx}": lib.stpu_sad_cost_smem(d, wy, wx)
        for d, (wy, wx) in ((SAD.num_disparities, SAD.sad_window),
                            (SADSGM.num_disparities, SADSGM.sad_window))}))



def kernel_instances(kernel: str, log: str = "") -> Dict[str, dict]:
    """Registers and spill bytes of every instance of ``kernel``, keyed by
    its template arguments joined by "/" (numbers, or a mangled type: h
    uint8, f float, i int, a int8, s int16), from the ptxas report the build
    keeps beside the library (or ``log``)."""
    if not log:
        log = Path(load_kernels()._name + ".log").read_text()
    found: Dict[str, dict] = {}
    row = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function "
                      r"properties for (\S+)", line)
        if m:
            k = re.search(kernel + r"I(.+?)Ev", m.group(1) or m.group(2))
            args = re.sub(r"L[a-z](\d+)E", r"/\1/", k.group(1)) if k else ""
            row = None if k is None else found.setdefault(
                re.sub("/+", "/", args).rstrip("E").strip("/"), {})
            continue
        if row is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_stores"], row["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                row["smem"] = int(m.group(1))
    if not found or not all("registers" in r for r in found.values()):
        raise AssertionError(f"ptxas report: {kernel} instances {found}")
    return dict(sorted(found.items()))


def k2_instances() -> Dict[str, dict]:
    """Each K2 instance's registers and spills (``kernel_instances``; its
    template arguments are DPL, PARTIAL, ADAPTIVE, RECT and the cost
    type) and its ring from the C queries."""
    lib = load_kernels()
    found: Dict[str, dict] = {}
    for args, row in kernel_instances("sgm_path_kernel").items():
        dpl, partial, adaptive, rect, t = args.split("/")
        cost_bytes = 1 if t == "a" else 2
        name = (f"dpl{dpl}{'/partial' * (partial == '1')}"
                f"{'/adaptive' * (adaptive == '1')}{'/rect' * (rect == '1')}"
                f"/int{8 * cost_bytes}")
        d = 32 * int(dpl)
        found[name] = dict(stages=lib.stpu_sgm_path_stages(d),
                           smem=lib.stpu_sgm_path_smem(d, cost_bytes), **row)
    if len(found) != 128:
        raise AssertionError(f"ptxas report: {len(found)} K2 instances")
    return dict(sorted(found.items()))


def per_direction_ms(dev, cost, scratch, image_ptr, cfg, rect=None
                     ) -> Dict[str, float]:
    """One K2 direction at a time, straight through the C entry point
    (these launches bypass the wrapper's counter), into a scratch sum; in
    the rectangle form where ``rect`` is given."""
    h, w, d = cost.shape
    box = (0, h, 0, w) if rect is None else rect
    return {
        f"{dy:+d},{dx:+d}": cuda_ms(
            lambda: run("stpu_sgm_path", dev, cost.data_ptr(),
                        cost.element_size(), image_ptr, scratch.data_ptr(), h,
                        w, d, dy, dx, cfg.p1, cfg.p2, cfg.p2_min,
                        cfg.adaptive_grad_floor, 1, int(rect is not None),
                        *box), reps=10)
        for dy, dx in PATH_STEPS[: cfg.num_paths]
    }


def to_dev(pair, dev):
    return (torch.from_numpy(pair.left).to(dev),
            torch.from_numpy(pair.right).to(dev))


def transform_row(rows, name, img, window, rank=False, reps=20):
    """K1's transform stage on one image against the plain transform
    (census words compared as int64 in [0, 2^32)); the first image of a
    row is timed into ``rows[name]``. Returns the kernel's int32 words."""
    plain_fn = rank_transform_plain if rank else census_transform_plain
    got = held(name, lambda: transform_words(img, window, rank=rank))
    want = synced(lambda: plain_fn(img, window))
    err = require_equal(name, got if rank else got.to(torch.int64)
                        & 0xFFFFFFFF, want)
    _first_row(rows, name, lambda: dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: transform_words(img, window, rank=rank),
                   reps=reps),
        plain_ms=cuda_ms(lambda: plain_fn(img, window), reps=3),
        **transform_bound(*img.shape, window, rank, img.element_size())))
    return got


def census_row(name, tname, rows, left, right, cfg, reps=20):
    """One K1 census form: its transform stage on each image (row
    ``tname``, ``transform_row``), then its cost stage from those words
    against the plain volume from the images; returns (cost row, volume,
    plain volume)."""
    plain = cfg.replace(backend="torch")
    cl = transform_row(rows, tname, left, cfg.census_window)
    cr = transform_row(rows, tname, right, cfg.census_window)
    cost = held(name, lambda: census_cost(cl, cr, cfg))
    cost_plain = synced(lambda: census_cost_volume(left, right, plain))
    row = dict(
        max_abs_err=require_equal(name, cost.to(torch.int32), cost_plain),
        ms=cuda_ms(lambda: census_cost(cl, cr, cfg), reps=reps),
        plain_ms=cuda_ms(lambda: census_cost_volume(left, right, plain),
                         reps=3),
        **cost_bound(*left.shape, cfg.num_disparities, cfg.census_words, 5),
    )
    return row, cost, cost_plain


def kernel_device_ms(fn, kernel: str):
    """``kernel``'s device ms per call of ``fn`` (``profiled_ms``), or None
    where the profiler recorded none of its launches."""
    got = profiled_ms(fn, kernel)
    if got is None:
        print(f"profiler: no launch of {kernel} recorded; device_ms null")
        return None
    return got[0]


def sad_row(name, left, right, cfg, reps=20):
    """One K5 form against the plain volume; returns (row, volume, plain
    volume)."""
    plain = cfg.replace(backend="torch")
    cost = held(name, lambda: sad_cost(left, right, cfg))
    cost_plain = synced(lambda: sad_cost_volume(left, right, plain))
    row = dict(
        max_abs_err=require_equal(name, cost.to(torch.int32), cost_plain),
        ms=cuda_ms(lambda: sad_cost(left, right, cfg), reps=reps),
        device_ms=kernel_device_ms(lambda: sad_cost(left, right, cfg),
                                   "sad_cost_kernel"),
        plain_ms=cuda_ms(lambda: sad_cost_volume(left, right, plain), reps=5),
        **sad_bound(*left.shape, cfg.num_disparities, cfg.sad_window),
    )
    return row, cost, cost_plain


def paths_row(name, dev, cost, cost_plain, cfg, image=None, reps=10):
    """One K2 form against plain SGM on the same costs; returns (row, S,
    plain S)."""
    plain = cfg.replace(backend="torch")
    s = held(name, lambda: sgm_paths(cost, cfg, image=image))
    s_plain = synced(lambda: sgm_aggregate(cost_plain, plain, image=image))
    row = dict(
        max_abs_err=require_equal(name, s.to(torch.int32), s_plain),
        ms=cuda_ms(lambda: sgm_paths(cost, cfg, image=image), reps=reps),
        plain_ms=cuda_ms(lambda: sgm_aggregate(cost_plain, plain, image=image),
                         reps=2),
        **paths_bound(cost, cfg),
    )
    ptr = None if image is None else image.to(torch.int32)
    scratch = torch.empty_like(s)
    print(f"{name} per direction (dy,dx) ms: " + json.dumps(per_direction_ms(
        dev, cost, scratch, None if ptr is None else ptr.data_ptr(), cfg)))
    return row, s, s_plain


def select_row(name, s, s_plain, cfg, emit_d0=False, reps=20):
    """One K3 form against the plain selection; returns (row, outputs,
    plain outputs)."""
    plain = cfg.replace(backend="torch")
    got = held(name, lambda: sgm_select(s, cfg, emit_d0=emit_d0))
    want = synced(lambda: select_disparity(s_plain, plain, emit_d0=emit_d0))
    errs = [require_equal(f"{name} output {i}", g, w)
            for i, (g, w) in enumerate(zip(got, want))]
    row = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: sgm_select(s, cfg, emit_d0=emit_d0), reps=reps),
        plain_ms=cuda_ms(lambda: select_disparity(s_plain, plain,
                                                  emit_d0=emit_d0), reps=3),
        **select_bound(*s.shape, emit_d0=emit_d0),
    )
    return row, got, want


def median_row(name, disp, disp_plain):
    """One K4 shape against the plain median; returns (row, plain map)."""
    med = held(name, lambda: median3x3(disp))
    med_plain = synced(lambda: median_3x3(disp_plain))
    row = dict(
        max_abs_err=require_equal(name, med, med_plain),
        ms=cuda_ms(lambda: median3x3(disp), reps=50),
        device_ms=kernel_device_ms(lambda: median3x3(disp),
                                   "median3x3_kernel"),
        plain_ms=cuda_ms(lambda: median_3x3(disp_plain), reps=20),
        **median_bound(*disp.shape),
    )
    return row, med_plain


def _first_row(rows: dict, name: str, make) -> None:
    """``rows[name] = make()`` unless the row was already measured (a
    second patch of the same form is compared, not timed again)."""
    if name not in rows:
        rows[name] = make()


def banded_rows(dev, left, right, cfg, split, tag: str = "cfg4") -> dict:
    """Every kernel form ``build_banded_pipeline(cfg, left.shape, **split)``
    launches, on each of its patches at the patch's whole shape, against
    the plain version on the same patch: K1 (census) or K5 (SAD), K2 unless
    the config has no paths, K3 and K4. Returns the rows by KERNEL_INFO
    name, ``<kernel>/<tag>/<H>x<W>[/framed|/qr]``."""
    h, w = left.shape
    d, md = cfg.num_disparities, int(cfg.min_disparity)
    plan = plan_bands(cfg, (h, w), **split)
    plain = cfg.replace(backend="torch")
    rows: dict = {}
    for _, _, e0, e1 in plan.rows:
        for x0, x1, f0, f1 in plan.cols:
            ctx = right_context_of(cfg, f0) if plan.stitched else 0
            own = (x0 - f0, x1 - f0) if plan.stitched else None
            pl_, pr_ = left[e0:e1, f0:f1], right[e0:e1, f0 - ctx:f1]
            ph, pw = pl_.shape
            shape = f"{ph}x{pw}"
            frame = dict(x_offset=f0, image_width=w)

            if cfg.cost_fn == "sad":
                cost, cost_plain = _banded_sad(
                    rows, f"sad_cost/{tag}/{shape}", pl_, pr_, cfg, f0)
            else:
                cost, cost_plain = _banded_census(
                    rows, tag, shape, pl_, pr_, cfg, f0, ctx)

            if cfg.num_paths == 0:
                # no SGM: S is the cost itself
                s, s_plain = cost, cost_plain
            else:
                s, s_plain = _banded_paths(
                    dev, rows, f"sgm_paths/{tag}/{shape}", cost, cost_plain,
                    cfg)
            del cost, cost_plain

            # K3: base on the whole frame, framed on a legacy patch, the
            # emit_qr form with the patch's own range on a stitched one
            kw = dict(frame, emit_qr=plan.stitched, own=own)
            suffix = ("/qr" if plan.stitched
                      else "/framed" if (f0, f1) != (0, w) else "")
            name = f"sgm_select/{tag}/{shape}{suffix}"
            got = held(name, lambda: sgm_select(s, cfg, **kw))
            want = synced(lambda: select_disparity(s_plain, plain, **kw))
            err = max(require_equal(f"{name} output {i}", g, w_)
                      for i, (g, w_) in enumerate(zip(got, want)))
            _first_row(rows, name, lambda: dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: sgm_select(s, cfg, **kw), reps=5),
                plain_ms=cuda_ms(lambda: select_disparity(s_plain, plain,
                                                          **kw), reps=2),
                **select_bound(ph, pw, d, spill=spill_width(d, md)
                               if plan.stitched else 0)))
            del s, s_plain

            # K4 on the patch's disparity
            name = f"median3x3/{tag}/{shape}"
            med = held(name, lambda: median3x3(got[0]))
            err = require_equal(name, med, median_3x3(want[0]))
            _first_row(rows, name, lambda: dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: median3x3(got[0]), reps=10),
                device_ms=kernel_device_ms(lambda: median3x3(got[0]),
                                           "median3x3_kernel"),
                plain_ms=cuda_ms(lambda: median_3x3(want[0]), reps=3),
                **median_bound(ph, pw)))
    return rows


def _banded_census(rows, tag, shape, pl_, pr_, cfg, f0, ctx):
    """K1 on one patch, with its origin and right context: the transform
    stage on each image (rows ``census_transform/<tag>/<H>x<W>``, the right
    image with its context columns), then the cost stage (row
    ``census_cost/<tag>/<shape>[/framed]``); returns (the patch's volume,
    its plain volume)."""
    plain = cfg.replace(backend="torch")
    ph, pw = pl_.shape
    name = f"census_cost/{tag}/{shape}" + _origin_suffix(f0, ctx)
    cl, cr = (transform_row(rows, f"census_transform/{tag}/{ph}x{iw}", img,
                            cfg.census_window, reps=5)
              for img, iw in ((pl_, pw), (pr_, pw + ctx)))
    cost = held(name, lambda: census_cost(cl, cr, cfg, f0, ctx))
    cost_plain = synced(lambda: census_cost_volume(pl_, pr_, plain, f0, ctx))
    err = require_equal(name, cost, cost_plain)
    _first_row(rows, name, lambda: dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: census_cost(cl, cr, cfg, f0, ctx), reps=5),
        plain_ms=cuda_ms(lambda: census_cost_volume(pl_, pr_, plain, f0, ctx),
                         reps=2),
        **cost_bound(ph, pw, cfg.num_disparities, cfg.census_words, 5, ctx)))
    return cost, cost_plain


def _banded_sad(rows, name, pl_, pr_, cfg, f0):
    """K5 on one patch, with its origin; returns as ``_banded_census``."""
    plain = cfg.replace(backend="torch")
    ph, pw = pl_.shape
    name += _origin_suffix(f0, 0)
    cost = held(name, lambda: sad_cost(pl_, pr_, cfg, f0))
    cost_plain = synced(lambda: sad_cost_volume(pl_, pr_, plain, f0))
    err = require_equal(name, cost, cost_plain)
    _first_row(rows, name, lambda: dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: sad_cost(pl_, pr_, cfg, f0), reps=10),
        device_ms=kernel_device_ms(lambda: sad_cost(pl_, pr_, cfg, f0),
                                   "sad_cost_kernel"),
        plain_ms=cuda_ms(lambda: sad_cost_volume(pl_, pr_, plain, f0),
                         reps=3),
        **sad_bound(ph, pw, cfg.num_disparities, cfg.sad_window)))
    return cost, cost_plain


def _origin_suffix(x_offset: int, ctx: int) -> str:
    """A cost row's framing, as the wrappers count it: "/neg" at a negative
    origin, "/framed" at a positive one or with context columns."""
    if x_offset < 0:
        return "/neg"
    return "/framed" if x_offset or ctx else ""


def _banded_paths(dev, rows, name, cost, cost_plain, cfg, image=None,
                  rect=None):
    """K2 on a patch's costs against plain SGM on the same (``rect``: a
    tile's in-frame rectangle, the plain version's valid mask); returns
    (the patch's S, its plain S). The plain version is timed once, after
    the run that was compared (it takes seconds on a full-size patch)."""
    plain = cfg.replace(backend="torch")
    img = image if cfg.adaptive_p2 else None
    mask = None if rect is None else rect_mask(rect, cost.shape[:2],
                                               cost.device)

    def plain_fn():
        return sgm_aggregate(cost_plain, plain, image=img, valid=mask)

    s = held(name, lambda: sgm_paths(cost, cfg, image=img, rect=rect))
    s_plain = synced(plain_fn)
    err = require_equal(name, s, s_plain)
    if name not in rows:
        scratch = torch.empty_like(s)
        img32 = None if img is None else img.to(torch.int32)
        print(f"{name} per direction (dy,dx) ms: " + json.dumps(
            per_direction_ms(dev, cost, scratch, None if img32 is None else
                             img32.data_ptr(), cfg, rect)))
        del scratch, img32
        rows[name] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: sgm_paths(cost, cfg, image=img, rect=rect),
                       reps=3),
            plain_ms=cuda_ms(plain_fn, reps=1, warmup=0),
            **paths_bound(cost, cfg))
    return s, s_plain


def _tile_info(name: str) -> None:
    """Register a tiled row in KERNEL_INFO by its kernel."""
    k3 = _EMIT_QR if name.endswith("/qr") else _V_FUSED
    KERNEL_INFO.setdefault(name, {
        "census_transform": ("transform_words", _COST_CU, _CENSUS_T),
        "census_cost": ("census_cost", _COST_CU, _COST_X),
        "sad_cost": ("sad_cost", _SAD_CU,
                     "stereo_tpu/ops/pallas/cost_kernel.py:584"),
        "sgm_paths": ("sgm_paths", _PATHS_CU, _H_PATHS),
        "sgm_select": ("sgm_select", _SELECT_CU, k3),
        "median3x3": ("median3x3", _MEDIAN_CU, _MEDIAN),
    }[name.split("/")[0]])


def tiled_rows(dev, left, right, cfg, grid, lr_stitch, forms) -> dict:
    """Every kernel form ``build_halo_pipeline`` launches on the local
    ``grid`` for this frame, held on each tile at the tile's whole shape
    against the plain version on the same tile (the tile's images are the
    frame at its extended positions, clamped into the frame, as the tile
    body gathers them). ``forms`` gets one frame's launches by row. Rows
    are named ``<kernel>/tiles/<H>x<W>`` plus the form's framing: "/neg" or
    "/framed" (origin), "/rect" (K2's rectangle form), "/qr", "/d0",
    "/int" (K3's forms)."""
    h, w = left.shape
    ty, tx = grid
    bh, bw = padded_extent(h, ty) // ty, padded_extent(w, tx) // tx
    halo_y, x_lo, x_hi = _halo_widths(cfg, TileConfig(mesh_shape=grid))
    d, md = cfg.num_disparities, int(cfg.min_disparity)
    stitch = (tx > 1 and stitch_supported(cfg, bw, halo_y)
              if lr_stitch is None else lr_stitch)
    ctx = d - 1 + md if stitch else 0
    if stitch:
        x_lo = x_hi = halo_y
    eh, ew = bh + 2 * halo_y, bw + x_lo + x_hi
    plain = cfg.replace(backend="torch")
    rows: dict = {}
    global _TALLY
    forms.clear()
    _TALLY = forms
    try:
        for iy in range(ty):
            for ix in range(tx):
                y0, x0 = iy * bh - halo_y, ix * bw - x_lo
                ys = (y0 + torch.arange(eh, device=dev)).clamp(0, h - 1)
                xs = (x0 - ctx + torch.arange(ew + ctx, device=dev)
                      ).clamp(0, w - 1)
                tl, tr = left[ys][:, xs[ctx:]], right[ys][:, xs]
                box = frame_rect((eh, ew), x0, y0, w, h)
                if cfg.lr_check and cfg.lr_exact:
                    disp = _tile_exact(dev, rows, tl, tr, cfg, x0, w, box)
                else:
                    disp = _tile_view(dev, rows, tl, tr, cfg, x0, w, ctx,
                                      box, own=(halo_y, halo_y + bw)
                                      if stitch else None)
                if cfg.median_filter:
                    # K4 on the crop with its 1-px halo: (bh + 2) x (bw + 2)
                    crop = disp[halo_y - 1:halo_y + bh + 1,
                                x_lo - 1:x_lo + bw + 1].contiguous()
                    name = f"median3x3/tiles/{bh + 2}x{bw + 2}"
                    _tile_info(name)
                    med = held(name, lambda: median3x3(crop))
                    err = require_equal(name, med, median_3x3(crop))
                    _first_row(rows, name, lambda: dict(
                        max_abs_err=err,
                        ms=cuda_ms(lambda: median3x3(crop), reps=10),
                        device_ms=kernel_device_ms(lambda: median3x3(crop),
                                                   "median3x3_kernel"),
                        plain_ms=cuda_ms(lambda: median_3x3(crop), reps=3),
                        **median_bound(*crop.shape)))
                torch.cuda.empty_cache()
    finally:
        _TALLY = None
    return rows


def _tile_cost(dev, rows, ref, tgt, cfg, x0, ctx):
    """K1 (both stages) or K5 on one tile's view at origin ``x0``; returns
    (volume, plain volume)."""
    shape = f"{ref.shape[0]}x{ref.shape[1]}"
    if cfg.cost_fn == "sad":
        name = f"sad_cost/tiles/{shape}" + _origin_suffix(x0, ctx)
        _tile_info(name)
        return _banded_sad(rows, f"sad_cost/tiles/{shape}", ref, tgt, cfg,
                           x0)
    for img in (ref, tgt):
        _tile_info(f"census_transform/tiles/{ref.shape[0]}x{img.shape[1]}")
    _tile_info(f"census_cost/tiles/{shape}" + _origin_suffix(x0, ctx))
    return _banded_census(rows, "tiles", shape, ref, tgt, cfg, x0, ctx)


def _tile_sum(dev, rows, cost, cost_plain, cfg, image, box):
    """K2 on a tile's costs, in the rectangle form unless ``box`` is the
    whole tile (or None: the exact LR check's flipped pass)."""
    h, w = cost.shape[:2]
    if box == (0, h, 0, w):
        box = None
    name = f"sgm_paths/tiles/{h}x{w}" + ("/rect" if box else "") + (
        "/adaptive" if cfg.adaptive_p2 else "")
    _tile_info(name)
    return _banded_paths(dev, rows, name, cost, cost_plain, cfg, image, box)


def _tile_select(rows, name, s, s_plain, cfg, **kw):
    """K3 on a tile's S against the plain selection; returns (outputs,
    plain outputs)."""
    _tile_info(name)
    plain = cfg.replace(backend="torch")
    got = held(name, lambda: sgm_select(s, cfg, **kw))
    want = synced(lambda: select_disparity(s_plain, plain, **kw))
    err = max(require_equal(f"{name} output {i}", g, w_)
              for i, (g, w_) in enumerate(zip(got, want)))
    h, w, d = s.shape
    spill = spill_width(d, int(cfg.min_disparity)) if kw.get("emit_qr") else 0
    _first_row(rows, name, lambda: dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: sgm_select(s, cfg, **kw), reps=5),
        plain_ms=cuda_ms(lambda: select_disparity(s_plain, plain, **kw),
                         reps=2),
        **select_bound(h, w, d, emit_d0=kw.get("emit_d0", False),
                       spill=spill)))
    return got, want


def _tile_view(dev, rows, tl, tr, cfg, x0, iw, ctx, box, own):
    """One tile through K1/K5, K2 and K3 (framed, or emit_qr with ``own``
    on a stitched tile); returns the tile's disparity."""
    cost, cost_plain = _tile_cost(dev, rows, tl, tr, cfg, x0, ctx)
    if cfg.num_paths == 0:
        s, s_plain = cost, cost_plain
    else:
        s, s_plain = _tile_sum(dev, rows, cost, cost_plain, cfg, tl, box)
    del cost, cost_plain
    h, w = tl.shape
    kw = dict(x_offset=x0, image_width=iw)
    if own is not None:
        kw.update(emit_qr=True, own=own)
    name = f"sgm_select/tiles/{h}x{w}" + (
        "/neg" if x0 < 0 else "/framed") + ("/qr" if own else "")
    got, _ = _tile_select(rows, name, s, s_plain, cfg, **kw)
    return got[0]


def _tile_exact(dev, rows, tl, tr, cfg, x0, iw, box):
    """One tile of the exact LR check: the left view (K1 at ``x0``, K2 in
    the rectangle form, K3's emit_d0 form) and the flipped pair (K1 at the
    flipped origin, K2's whole form, K3's integer form); returns the left
    view's disparity."""
    h, w = tl.shape
    cost, cost_plain = _tile_cost(dev, rows, tl, tr, cfg, x0, 0)
    s, s_plain = _tile_sum(dev, rows, cost, cost_plain, cfg, tl, box)
    del cost, cost_plain
    got, _ = _tile_select(rows, f"sgm_select/tiles/{h}x{w}/d0", s, s_plain,
                          cfg.replace(lr_check=False), emit_d0=True,
                          x_offset=x0)
    del s, s_plain
    xf = iw - x0 - w
    fl, fr = tr.flip(1).contiguous(), tl.flip(1).contiguous()
    cost, cost_plain = _tile_cost(dev, rows, fl, fr, cfg, xf, 0)
    s, s_plain = _tile_sum(dev, rows, cost, cost_plain, cfg, fl, None)
    _tile_select(rows, f"sgm_select/tiles/{h}x{w}/int", s, s_plain,
                 cfg.replace(lr_check=False, subpixel=False,
                             uniqueness_ratio=0.0), x_offset=xf)
    return got[0]


def peak_rows(dev) -> dict:
    """K6 in both element types at the anchor's programs, against its plain
    version (the chain's closed form) on quarter steps in [0, 64)."""
    rows = {}
    for dtype in (torch.float32, torch.int32):
        name_t = str(dtype).split(".")[1]
        for n_rows, k, chains in ANCHOR_PROGRAMS:
            name = f"alu_peak/{name_t}/k{k}"
            n = n_rows * 64 * 128
            x = (torch.arange(n, device=dev) % 256).to(dtype)
            if dtype == torch.float32:
                x = x / 4
            got = held(name, lambda: alu_peak(x, k, chains))
            rows[name] = dict(
                max_abs_err=require_equal(name, got,
                                          alu_peak_plain(x, k, chains)),
                ms=cuda_ms(lambda: alu_peak(x, k, chains), reps=20),
                plain_ms=cuda_ms(lambda: alu_peak_plain(x, k, chains), reps=5),
                **peak_bound(n, k))
    return rows


def phase_kernels(dev) -> dict:
    """Each kernel form against its plain version at its paths' shapes."""
    left, right = to_dev(kitti_like_pair(seed=0), dev)
    h, w = left.shape
    one_view = cuda_ms(lambda: census_transform_plain(left,
                                                      CFG.census_window),
                       reps=10)
    print(f"census_transform (plain torch, both views): {2 * one_view:.4f} ms")
    rows = {}

    # kitti_sgm8_128, its quality preset and lr_exact: 375x1242, D=128.
    rows["census_cost"], cost, cost_plain = census_row(
        "census_cost", "census_transform", rows, left, right, CFG)
    rows["sgm_paths"], s, s_plain = paths_row(
        "sgm_paths", dev, cost, cost_plain, CFG)
    # K2 adaptive: the quality preset has the same census and D as CFG, so
    # the cost volume above is its cost volume.
    rows["sgm_paths/adaptive"], _, _ = paths_row(
        "sgm_paths/adaptive", dev, cost, cost_plain, QCFG, image=left)
    # The TPU's alternative: eight [H, W] P2 maps precomputed outside the
    # kernel (plain torch here), which the in-kernel division replaces.
    maps_ms = cuda_ms(lambda: [adaptive_p2_map(left, QCFG, -dy, -dx)
                               for dy, dx in PATH_STEPS], reps=10)
    print(f"adaptive P2 as 8 precomputed maps (plain torch): {maps_ms:.4f} ms")
    rows["sgm_select"], (disp, _), (disp_plain, valid_plain) = select_row(
        "sgm_select", s, s_plain, CFG)
    # lr_exact: the left view's winners with emit_d0, the flipped pair's as
    # integers without uniqueness; the cheap LR check is off in both.
    rows["sgm_select/d0"], _, _ = select_row(
        "sgm_select/d0", s, s_plain, LRCFG, emit_d0=True)
    rows["sgm_select/int"], _, _ = select_row(
        "sgm_select/int", s, s_plain,
        LRCFG.replace(subpixel=False, uniqueness_ratio=0.0))
    rows["median3x3"], med_plain = median_row("median3x3", disp, disp_plain)

    # The plain chain on the card is the reference composition too.
    fx = json.loads((TESTDATA / "kitti_sgm8_128_seed0.json").read_text())
    if (sha16(med_plain), sha16(valid_plain)) != (fx["disp"], fx["valid"]):
        raise AssertionError("plain torch path on the card misses the fixture")
    del cost, cost_plain, s, s_plain

    # K1's rank form: one int32 rank per pixel, |rank_l - rank_r|.
    rl, rr = (transform_row(rows, "census_transform/rank", img,
                            RANK.census_window, rank=True)
              for img in (left, right))
    rank_view = cuda_ms(lambda: rank_transform_plain(left,
                                                     RANK.census_window),
                        reps=10)
    print(f"rank_transform (plain torch, both views): {2 * rank_view:.4f} ms")
    rplain = RANK.replace(backend="torch")
    rcost = held("census_cost/rank", lambda: rank_cost(rl, rr, RANK))
    rcost_plain = synced(lambda: rank_cost_volume(left, right, rplain))
    rows["census_cost/rank"] = dict(
        max_abs_err=require_equal("census_cost/rank", rcost.to(torch.int32),
                                  rcost_plain),
        ms=cuda_ms(lambda: rank_cost(rl, rr, RANK), reps=20),
        plain_ms=cuda_ms(lambda: rank_cost_volume(left, right, rplain),
                         reps=3),
        **cost_bound(h, w, RANK.num_disparities, 1, 2),
    )
    del rcost, rcost_plain

    # The pyramid model's coarse pass, on its own inputs: the pooled pair
    # at 188x621, D=64, a 1-word 5x5 census, integer winners, no LR.
    pyramid = get_model("pyramid", cfg=CFG, census_window=(5, 5))
    ccfg = pyramid.coarse_cfg()
    pleft, pright = _pool2(left), _pool2(right)
    rows["census_cost/w1_d64"], ccost, ccost_plain = census_row(
        "census_cost/w1_d64", "census_transform/w1_d64", rows, pleft, pright,
        ccfg)
    rows["sgm_paths/d64"], cs, cs_plain = paths_row(
        "sgm_paths/d64", dev, ccost, ccost_plain, ccfg)
    rows["sgm_paths/d64/adaptive"], _, _ = paths_row(
        "sgm_paths/d64/adaptive", dev, ccost, ccost_plain,
        ccfg.replace(**QUALITY_P2), image=pleft)
    rows["sgm_select/coarse"], (cdisp, _), (cdisp_plain, _) = select_row(
        "sgm_select/coarse", cs, cs_plain, ccfg)
    rows["median3x3/coarse"], _ = median_row(
        "median3x3/coarse", cdisp, cdisp_plain)
    del ccost, ccost_plain, cs, cs_plain

    # The pyramid model's residual pass: the gather volume (plain torch),
    # then K2 at D=16 (the staged S) and K3 with min_disparity=-8; its
    # K4 is the 375x1242 form above.
    base, vol, res_cfg = synced(lambda: pyramid.residual_volume(left, right))
    pcl, pcr = (transform_row(rows, "census_transform/5x5", img, (5, 5)
                              ).to(torch.int64) & 0xFFFFFFFF
                for img in (left, right))
    base_i = torch.round(base).to(torch.int32)
    gather_ms = cuda_ms(lambda: _residual_cost_volume(pcl, pcr, base_i, 8, 16),
                        reps=10)
    volume_ms = cuda_ms(lambda: pyramid.residual_volume(left, right), reps=5)
    print(f"pyramid residual volume (plain torch): gather + Hamming "
          f"{gather_ms:.4f} ms; coarse pass + transforms + volume "
          f"{volume_ms:.4f} ms")
    vol8 = vol.to(res_cfg.cost_volume_dtype)
    rows["sgm_paths/d16"], s16, s16_plain = paths_row(
        "sgm_paths/d16", dev, vol8, vol, res_cfg)
    rows["sgm_paths/d16/adaptive"], _, _ = paths_row(
        "sgm_paths/d16/adaptive", dev, vol8, vol,
        res_cfg.replace(**QUALITY_P2), image=left)
    rows["sgm_select/md-8"], (dres, _), _ = select_row(
        "sgm_select/md-8", s16, s16_plain, res_cfg)
    if float(dres.min()) >= 0:
        raise AssertionError("no negative residual: md=-8 was not exercised")
    del vol, vol8, s16, s16_plain

    # middlebury_census_sgm4_64: 555x900, D=64, 4 paths.
    ml, mr = to_dev(middlebury_pair(0), dev)
    rows["census_cost/d64"], mcost, mcost_plain = census_row(
        "census_cost/d64", "census_transform/555x900", rows, ml, mr, MID)
    rows["sgm_paths/4"], ms_, ms_plain = paths_row(
        "sgm_paths/4", dev, mcost, mcost_plain, MID)
    rows["sgm_select/d64"], (mdisp, _), (mdisp_plain, _) = select_row(
        "sgm_select/d64", ms_, ms_plain, MID)
    rows["median3x3/555x900"], _ = median_row(
        "median3x3/555x900", mdisp, mdisp_plain)
    del mcost, mcost_plain, ms_, ms_plain

    # The hard suite's classic pass at 160x288, D=128 (adaptive P2 in the
    # sweep, fixed in census_vs_sad_robustness) and the SAD half of the
    # latter: K5 at D=128, K2 on its int16 costs.
    rp = make_pair((160, 288), max_disp=96, seed=0, **SCENARIOS["radiometric"])
    hl, hr = to_dev(rp, dev)
    rows["census_cost/160x288"], hcost, hcost_plain = census_row(
        "census_cost/160x288", "census_transform/160x288", rows, hl, hr, CFG)
    rows["sgm_paths/160x288"], hs, hs_plain = paths_row(
        "sgm_paths/160x288", dev, hcost, hcost_plain, CFG)
    rows["sgm_paths/adaptive/160x288"], _, _ = paths_row(
        "sgm_paths/adaptive/160x288", dev, hcost, hcost_plain, QCFG, image=hl)
    rows["sgm_select/160x288"], (hdisp, _), (hdisp_plain, _) = select_row(
        "sgm_select/160x288", hs, hs_plain, CFG)
    rows["median3x3/160x288"], _ = median_row(
        "median3x3/160x288", hdisp, hdisp_plain)
    rows["sad_cost/d128"], hsad, hsad_plain = sad_row(
        "sad_cost/d128", hl, hr, SADSGM)
    if int(hsad.max()) <= 127:
        raise AssertionError("SAD costs fit int8: int16 was not exercised")
    rows["sgm_paths/int16"], _, _ = paths_row(
        "sgm_paths/int16", dev, hsad, hsad_plain, SADSGM)

    # tsukuba_sad16: K5, K3 at D=16 on the raw SAD cost (num_paths=0), K4.
    tl, tr = to_dev(tsukuba_pair(0), dev)
    rows["sad_cost"], sad, sad_plain = sad_row("sad_cost", tl, tr, SAD)
    rows["sgm_select/d16"], (tdisp, _), (tdisp_plain, _) = select_row(
        "sgm_select/d16", sad, sad_plain, SAD)
    rows["median3x3/288x384"], _ = median_row(
        "median3x3/288x384", tdisp, tdisp_plain)
    # K5 with a right context: the frame's right half with the 20 columns
    # before it in the right view (no path launches this form yet).
    f0, ctx = tl.shape[1] // 2, 20
    cl_, cr_ = tl[:, f0:].contiguous(), tr[:, f0 - ctx:].contiguous()
    plain = SAD.replace(backend="torch")
    cost = held("sad_cost/ctx", lambda: sad_cost(cl_, cr_, SAD, f0, ctx))
    rows["sad_cost/ctx"] = dict(
        max_abs_err=require_equal(
            "sad_cost/ctx", cost.to(torch.int32),
            synced(lambda: sad_cost_volume(cl_, cr_, plain, f0, ctx))),
        ms=cuda_ms(lambda: sad_cost(cl_, cr_, SAD, f0, ctx), reps=20),
        device_ms=kernel_device_ms(
            lambda: sad_cost(cl_, cr_, SAD, f0, ctx), "sad_cost_kernel"),
        plain_ms=cuda_ms(lambda: sad_cost_volume(cl_, cr_, plain, f0, ctx),
                         reps=5),
        **sad_bound(*cl_.shape, SAD.num_disparities, SAD.sad_window, ctx))
    del cost
    # K5 at KITTI size (kitti_sgm8_128 with cost_fn="sad", the SAD half of
    # census_vs_sad at full size): its rate away from launch latency; no
    # path launches this form.
    rows["sad_cost/kitti"], _, _ = sad_row("sad_cost/kitti", left, right,
                                           SADSGM)
    del sad, sad_plain, hsad, hsad_plain, hcost, hcost_plain, hs, hs_plain

    # Config 4 through the banded runner: every patch of the three splits,
    # at 497x720 and at 1988x2880.
    for shape in ((497, 720), (1988, 2880)):
        bl, br = to_dev(cfg4_pair(shape)(0), dev)
        for split, _, _ in CFG4_SPLITS.values():
            rows.update(banded_rows(dev, bl, br, CFG4, split))
            torch.cuda.empty_cache()
        del bl, br
    torch.cuda.empty_cache()
    # tsukuba_sad16 in two column patches: K5 and K3 with a column origin.
    rows.update(banded_rows(dev, tl, tr, SAD, SAD_SPLIT, tag="bands"))
    # The halo-tiled pipeline: every tile of each tiled path's grid, with
    # one frame's launches tallied into the slice's forms.
    for sl in TILED_SLICES:
        _, cfg, runner = load_slice(sl)
        gl, gr = to_dev(sl.pair(0), dev)
        rows.update(tiled_rows(dev, gl, gr, cfg, runner.grid,
                               runner.lr_stitch, sl.forms))
        print(f"{sl.fixture}: launches per frame {sl.forms}")
        del gl, gr
        torch.cuda.empty_cache()
    rows.update(peak_rows(dev))

    for name, r in rows.items():
        device = (f", {r['device_ms']:.4f} ms on the device"
                  if r.get("device_ms") is not None else "")
        print(f"kernel {name}: equal to plain; {r['ms']:.4f} ms{device} "
              f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']})")
    return rows


def run_slice(dev, sl: Slice, frame0: Dict[str, tuple],
              device_ms_of: Dict[str, float]) -> Dict[str, int]:
    """The slice's requests through the entry points a user calls; returns
    the launches of that run alone, by kernel form, as counted, and notes
    the median device ms per frame in ``device_ms_of``. ``frame0`` keeps
    frame 0's (disp, valid) of the slices that a later one names in
    ``differs_from``."""
    fx, cfg, model = load_slice(sl)
    pairs = {seed: sl.pair(seed) for seed in set(sl.seeds)}
    fn = model.build(dev)
    fn(pairs[0].left, pairs[0].right)  # warm-up: caches, allocator
    torch.cuda.synchronize()

    reset_launch_counts()
    answers, device_ms, e2e_ms = {}, [], []
    for i, seed in enumerate(sl.seeds):
        pair = pairs[seed]
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn(pair.left, pair.right)
        end.record()
        disp, valid = host_postprocess(res.disp, res.valid, cfg)
        m = evaluate_disparity(disp, pair.gt_disp, pair.gt_valid, valid)
        e2e_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))

        raw = (sha16(res.disp), sha16(res.valid))
        post = (sha16(disp), sha16(valid))
        if res.disp.shape != pair.left.shape or not bool(
                torch.isfinite(res.disp).all()):
            raise AssertionError(f"{sl.fixture} frame {i}: bad disparity map")
        if seed in answers and answers[seed] != (raw, post):
            raise AssertionError(
                f"{sl.fixture} frame {i}: seed {seed} answered differently")
        answers[seed] = (raw, post)
        print(f"{sl.fixture} frame {i} seed {seed}: device "
              f"{device_ms[-1]:.3f} ms, end to end {e2e_ms[-1]:.3f} ms, bad3 "
              f"{m['bad3']:.6f}, density {m['density']:.6f}")
        if i == 0 and sl.differs_from:
            base_disp, base_valid = frame0[sl.differs_from]
            differ = (res.disp != base_disp) | (res.valid != base_valid)
            print(f"{sl.fixture}: {float(differ.float().mean()):.6f} of the "
                  f"pixels differ from {sl.differs_from} (SGM warm-up at "
                  f"patch edges)")
        elif i == 0 and any(sl.fixture == o.differs_from for o in SLICES):
            frame0[sl.fixture] = (res.disp, res.valid)
        if seed == 0:
            want = ((fx["disp"], fx["valid"]), (fx["post_disp"],
                                                 fx["post_valid"]))
            if (raw, post) != want or int(valid.sum()) != fx["post_n_valid"]:
                raise AssertionError(f"{sl.fixture} frame {i}: hashes {raw} "
                                     f"{post} != fixture {want}")
            if (m["bad3"], m["density"]) != (fx["bad3"], fx["density"]):
                raise AssertionError(
                    f"{sl.fixture} frame {i}: metrics {m} != fixture")
    counts = counted_launches(sl.fixture)
    want_counts = expected_launches(sl.forms, len(sl.seeds))
    if counts != want_counts:
        raise AssertionError(
            f"{sl.fixture}: launch counts {counts} != {want_counts}")
    device_ms_of[sl.fixture] = statistics.median(device_ms)
    print(f"slice {sl.fixture} ({model.name}): {len(sl.seeds)} frames, "
          f"median device {statistics.median(device_ms):.3f} ms, median end "
          f"to end {statistics.median(e2e_ms):.3f} ms; frame 0 matches the "
          f"reference hashes; launches {counts}")
    return counts


#: Kernel forms of one pair of the hard suite's two sweeps (the second
#: runs a census and a SAD pipeline on each pair).
_SUITE_FORMS = {"census_transform/160x288": 2, "census_cost/160x288": 1,
                "sgm_paths/adaptive/160x288": 8, "sgm_select/160x288": 1,
                "median3x3/160x288": 1}
_ROBUST_FORMS = {"census_transform/160x288": 2, "census_cost/160x288": 1,
                 "sad_cost/d128": 1,
                 "sgm_paths/160x288": 8, "sgm_paths/int16": 8,
                 "sgm_select/160x288": 2, "median3x3/160x288": 2}


def phase_hard_suite(dev) -> Dict[str, int]:
    """The reference bench's suite-scale sweep and its census-vs-SAD
    comparison on the card; returns the launches by kernel form, as
    counted."""
    fx = json.loads(
        (TESTDATA / "hard_suite_kitti_sgm8_128_quality.json").read_text())
    rb = json.loads(
        (TESTDATA / "census_vs_sad_kitti_sgm8_128.json").read_text())
    n_pairs = len(SCENARIOS) * len(fx["seeds"])

    reset_launch_counts()
    t0 = time.perf_counter()
    rows = run_hard_suite(PRESETS[fx["preset"]], shape=tuple(fx["shape"]),
                          seeds=tuple(fx["seeds"]), device=dev)
    torch.cuda.synchronize()
    suite_s = time.perf_counter() - t0
    launches = counted_launches("hard suite")
    if launches != expected_launches(_SUITE_FORMS, n_pairs):
        raise AssertionError(f"hard suite: launch counts {launches}")
    for row in rows:
        print("hard suite row: " + json.dumps(row))
    if rows != fx["rows"]:
        raise AssertionError("hard suite rows differ from the reference's")

    reset_launch_counts()
    t0 = time.perf_counter()
    robust = census_vs_sad_robustness(
        PRESETS[rb["preset"]], shape=tuple(rb["shape"]),
        seeds=tuple(rb["seeds"]), device=dev)
    torch.cuda.synchronize()
    robust_s = time.perf_counter() - t0
    counts = counted_launches("census vs SAD")
    if counts != expected_launches(_ROBUST_FORMS, len(rb["seeds"])):
        raise AssertionError(f"census vs SAD: launch counts {counts}")
    print("census vs SAD rows: " + json.dumps(robust))
    if robust != rb["rows"]:
        raise AssertionError("census vs SAD rows differ from the reference's")
    print(f"hard suite: {n_pairs} pairs at {fx['shape']} in {suite_s:.3f} s "
          f"wall ({suite_s / n_pairs * 1e3:.3f} ms per pair, making the pair "
          f"included); census vs SAD: {robust_s:.3f} s; all rows equal the "
          f"reference's; launches {launches} and {counts}")
    for form, n in counts.items():
        launches[form] = launches.get(form, 0) + n
    return launches


#: Config 5, the batched video stream, as the reference's bench runs it
#: (bench.py:296-333): kitti_sgm8_128 at 375x1242, batch 48, 96 frames.
STREAM_SHAPE = (375, 1242)
STREAM_BATCH, STREAM_FRAMES = 48, 96
#: StreamRunner.run on host frames: 10 frames at batch 4 (the last batch
#: partial), a fault injected after the first batch, then a restart.
RUN_FRAMES, RUN_BATCH, RUN_FAIL_AFTER = 10, 4, 4
#: scaling_report's row on the card: one frame a call, its default trains.
SCALE_ITERS, SCALE_REPEATS = 10, 3


def stream_pair(seed: int):
    """The reference bench's stream frames (bench.py:315-317)."""
    return make_pair(STREAM_SHAPE, max_disp=96, kind="shapes",
                     texture="cloud", seed=seed)


def _hold_frames(what: str, got_disp, got_valid, want) -> None:
    """Each frame of a stream result must equal the per-frame path's."""
    for i, res in enumerate(want):
        if not (torch.equal(got_disp[i], res.disp)
                and torch.equal(got_valid[i], res.valid)):
            raise AssertionError(f"{what}: frame {i} differs from the "
                                 f"per-frame path")


def _count(what: str, forms: Dict[str, int], frames: int) -> Dict[str, int]:
    """The launches counted since the last reset, which must be ``forms``
    per frame for ``frames`` frames."""
    counts = counted_launches(what)
    if counts != expected_launches(forms, frames):
        raise AssertionError(f"{what}: launch counts {counts} != "
                             f"{expected_launches(forms, frames)}")
    return counts


def phase_stream(dev, smi: str) -> Dict[str, int]:
    """Config 5 through the stream's entry points on the card; returns the
    launches by kernel form, as counted (the per-frame paths that the
    frames are held against are not counted)."""
    frame_forms = SLICES[0].forms            # kitti_sgm8_128, whole frame
    tile_forms = TILED_SLICES[0].forms       # its 2x2 stitched tiles
    t0 = time.perf_counter()
    pairs = [stream_pair(i) for i in range(STREAM_FRAMES)]
    batches = [tuple(
        torch.from_numpy(np.stack([getattr(p, side)
                                   for p in pairs[i:i + STREAM_BATCH]])
                         ).to(dev) for side in ("left", "right"))
        for i in range(0, STREAM_FRAMES, STREAM_BATCH)]
    print(f"stream: {STREAM_FRAMES} frames made and staged on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    launches: Dict[str, int] = {}

    def add(counts):
        for form, n in counts.items():
            launches[form] = launches.get(form, 0) + n

    # The full-width stream: one warm-up batch, then a reset and the run.
    whole = make_tile_mesh([dev], (1, 1))
    runner = StreamRunner(CFG, whole, STREAM_SHAPE, batch_size=STREAM_BATCH,
                          device=dev)
    runner.run_batches(batches[:1])
    runner.frames_done, runner.elapsed = 0, 0.0
    outs = []
    reset_launch_counts()
    stats = runner.run_batches(batches, on_result=outs.append)
    add(_count("stream", frame_forms, STREAM_FRAMES))
    print(json.dumps({
        "metric": f"kitti_stream_batch{STREAM_BATCH}_fps_per_chip",
        "value": stats["fps"], "unit": "fps", "batch": STREAM_BATCH,
        "frames": stats["frames"], "shape": list(STREAM_SHAPE),
        "elapsed_s": stats["elapsed"], "device": smi}))
    if stats["frames"] != STREAM_FRAMES:
        raise AssertionError(f"stream: {stats['frames']} frames done")
    frame = build_pipeline(CFG, dev)
    for b, res in enumerate(outs):
        if res.frames != range(STREAM_BATCH) or res.disp.shape != (
                STREAM_BATCH, *STREAM_SHAPE):
            raise AssertionError(f"stream batch {b}: {res.frames}, "
                                 f"{tuple(res.disp.shape)}")
        _hold_frames(f"stream batch {b}", res.disp, res.valid,
                     [frame(p.left, p.right) for p in
                      pairs[b * STREAM_BATCH:(b + 1) * STREAM_BATCH]])
    plain = build_pipeline(PLAIN, dev)(pairs[0].left, pairs[0].right)
    if not (torch.equal(outs[0].disp[0], plain.disp)
            and torch.equal(outs[0].valid[0], plain.valid)):
        raise AssertionError("stream frame 0 differs from the plain path")
    if not bool(torch.isfinite(outs[0].disp).all()):
        raise AssertionError("stream: non-finite disparities")
    print(f"stream: all {STREAM_FRAMES} frames equal the per-frame kernel "
          f"path, frame 0 the plain torch path")
    del outs

    # StreamRunner.run on host frames: a fault, a restart, a partial batch.
    host = [(p.left, p.right) for p in pairs[:RUN_FRAMES]]
    delivered: Dict[int, tuple] = {}
    work = ROOT / "build" / "chip_smoke_stream"
    work.mkdir(parents=True, exist_ok=True)
    manifest = work / "manifest.json"
    manifest.unlink(missing_ok=True)

    def make_runner():
        return StreamRunner(CFG, whole, STREAM_SHAPE, batch_size=RUN_BATCH,
                            manifest_path=str(manifest), device=dev)

    def keep(r):
        def on_result(res):
            for j, index in enumerate(res.frames):
                delivered[r.frames_done + index] = (res.disp[j],
                                                    res.valid[j])
        return on_result

    reset_launch_counts()
    first = make_runner()
    try:
        first.run(host, on_result=keep(first), fail_after=RUN_FAIL_AFTER)
    except RuntimeError as e:
        if "fault injection" not in str(e):
            raise
    else:
        raise AssertionError("run: the injected fault did not fire")
    second = make_runner()
    at_restart = second.frames_done
    stats_run = second.run(host, on_result=keep(second))
    add(_count("stream run()", frame_forms,
               RUN_FAIL_AFTER + -(-(RUN_FRAMES - RUN_FAIL_AFTER) // RUN_BATCH)
               * RUN_BATCH))
    if at_restart != RUN_FAIL_AFTER or stats_run["frames"] != RUN_FRAMES or (
            sorted(delivered) != list(range(RUN_FRAMES))):
        raise AssertionError(f"run: restarted at {at_restart}, "
                             f"{stats_run['frames']} frames, delivered "
                             f"{sorted(delivered)}")
    _hold_frames("stream run()", [d for d, _ in delivered.values()],
                 [v for _, v in delivered.values()],
                 [frame(*host[fid]) for fid in delivered])
    manifest.unlink()
    print(f"stream run(): {RUN_FRAMES} host frames at batch {RUN_BATCH}, "
          f"fault after {RUN_FAIL_AFTER}, restarted from the manifest at "
          f"{at_restart}; every frame delivered once, equal to the per-frame "
          f"path")

    # A tiled stream on one card: the local 2x2 grid, stitched.
    grid = make_tile_mesh([dev] * 4, (2, 2))
    tiled = StreamRunner(CFG, grid, STREAM_SHAPE, batch_size=4, device=dev)
    outs = []
    reset_launch_counts()
    tiled.run_batches([(batches[0][0][:4], batches[0][1][:4])],
                      on_result=outs.append)
    add(_count("tiled stream", tile_forms, 4))
    halo = build_halo_pipeline(CFG, grid, device=dev)
    _hold_frames("tiled stream", outs[0].disp, outs[0].valid,
                 [halo(p.left, p.right) for p in pairs[:4]])
    print("tiled stream: 4 frames on a local 2x2 grid (stitched), equal to "
          "build_halo_pipeline")

    # scaling_report's row for the one card.
    reset_launch_counts()
    rows = scaling_report(CFG, STREAM_SHAPE, device_counts=[1],
                          iters=SCALE_ITERS, devices=[dev])
    add(_count("scaling_report", frame_forms,
               1 + SCALE_ITERS * SCALE_REPEATS))
    for row in rows:
        print("scaling row: " + json.dumps({**row, "device": smi}))
    return launches


def phase_anchor(dev):
    """The ALU anchor through its entry point; returns the best rate per
    element type and K6's launches by kernel form, as counted."""
    reset_launch_counts()
    peak = measure_alu_peak(dev, iters=20)
    torch.cuda.synchronize()
    counts = counted_launches("anchor")
    print("alu peak, best per type, Gop/s: " + json.dumps(
        {k: v / 1e9 for k, v in peak.items()}))
    return peak, counts


#: The full-size config-4 tile grids (``--write-fixtures``): fixture
#: suffix -> the grid's ``tiles`` entry.
TILED_FULL = {"_tiles_2x2_legacy": dict(mesh_shape=[2, 2], lr_stitch=False),
              "_tiles_1x2": dict(mesh_shape=[1, 2], lr_stitch=None)}


def write_fixtures(dev, out_dir: Path) -> None:
    """Make the full-size config-4 fixtures on the card: each split of the
    banded runner and each tile grid of the halo-tiled pipeline through the
    plain torch path and through the kernels, which must agree."""
    out_dir.mkdir(parents=True, exist_ok=True)
    shape = (1988, 2880)
    pair = cfg4_pair(shape)(0)
    runs = [(tag, "bands", split,
             lambda cfg, split=split: BandedRunner(cfg, shape, split))
            for tag, (split, _, _) in CFG4_SPLITS.items()]
    runs += [(tag, "tiles", tiles, lambda cfg, tiles=tiles: TiledRunner(
        cfg, tuple(tiles["mesh_shape"]), tiles["lr_stitch"]))
        for tag, tiles in TILED_FULL.items()]
    for tag, key, split, runner in runs:
        results = {}
        for backend in ("torch", "auto"):
            t0 = time.perf_counter()
            fn = runner(CFG4.replace(backend=backend)).build(dev)
            res = fn(pair.left, pair.right)
            torch.cuda.synchronize()
            results[backend] = (res.disp.cpu(), res.valid.cpu())
            del res
            torch.cuda.empty_cache()
            print(f"{tag or 'whole'} backend={backend}: "
                  f"{time.perf_counter() - t0:.1f} s, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        disp, valid = results["torch"]
        if not (torch.equal(disp, results["auto"][0])
                and torch.equal(valid, results["auto"][1])):
            raise AssertionError(f"{tag}: kernels differ from the plain path")
        pdisp, pvalid = host_postprocess(disp, valid, CFG4)
        m = evaluate_disparity(pdisp, pair.gt_disp, pair.gt_valid, pvalid)
        source = ("build_banded_pipeline(cfg(backend='torch'), shape, "
                  "**bands)" if key == "bands" else
                  "build_halo_pipeline(cfg(backend='torch'), "
                  "make_tile_mesh(devices, mesh_shape), lr_stitch)")
        record = dict(
            source=f"stereo_tpu_torch {source} + host_postprocess + "
                   "evaluate_disparity",
            made_by="the port's plain torch path on "
                    f"{torch.cuda.get_device_name(0)} (chip_smoke.py "
                    "--write-fixtures), equal to its kernel path; the "
                    "quarter-size fixtures tie that path to the reference",
            preset="middlebury_full_256_tiled", **{key: split},
            pair="make_pair((1988, 2880), max_disp=200, kind='shapes', "
                 "texture='cloud', seed=0)",
            hash="sha256(array.tobytes()).hexdigest()[:16]",
            shape=list(shape), disp=sha16(disp), valid=sha16(valid),
            n_valid=int(valid.sum()), post_disp=sha16(pdisp),
            post_valid=sha16(pvalid), post_n_valid=int(pvalid.sum()),
            bad3=m["bad3"], density=m["density"])
        path = out_dir / f"middlebury_full_256_tiled{tag}_seed0.json"
        path.write_text(json.dumps(record, indent=2) + "\n")
        print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--write-fixtures", type=Path, metavar="DIR",
                    help="make the full-size config-4 fixtures into DIR "
                         "instead of running the phases")
    args = ap.parse_args(argv)
    smi = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    if args.write_fixtures is not None:
        write_fixtures(dev, args.write_fixtures)
        return 0
    rows = phase_kernels(dev)
    # From here on every launch is one a wrapper counted on a main path.
    launches = dict.fromkeys(KERNEL_INFO, 0)
    frame0: Dict[str, tuple] = {}
    device_ms_of: Dict[str, float] = {}
    for counts in (*(run_slice(dev, sl, frame0, device_ms_of)
                     for sl in SLICES), phase_hard_suite(dev),
                   phase_stream(dev, smi)):
        for form, n in counts.items():
            launches[form] += n
    print("tiled vs whole, median device ms per frame: " + json.dumps({
        sl.fixture: {"tiled": device_ms_of[sl.fixture],
                     "whole": device_ms_of[sl.differs_from],
                     "whole_path": sl.differs_from}
        for sl in TILED_SLICES}))
    peak, anchor_counts = phase_anchor(dev)
    for form, n in anchor_counts.items():
        launches[form] += n
    missing = [form for form, n in launches.items()
               if n == 0 and form not in OFF_PATH]
    if missing:
        raise AssertionError(f"no main path launched {missing}")
    kernels = []
    for form in KERNEL_INFO:
        # The median's exchanges are float32 mins and maxes and K5 sums the
        # paths' uint8 images in float32; every other kernel's operations
        # are integer.
        anchor = "float32" if form.startswith((
            "median3x3", "sad_cost", "alu_peak/float32")) else "int32"
        kernels.append(dict(
            name=form, route="cuda", source=KERNEL_INFO[form][1],
            replaces=KERNEL_INFO[form][2], launches=launches[form],
            **rows[form], **sol_fractions(rows[form], peak[anchor])))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
