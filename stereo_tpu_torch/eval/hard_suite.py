"""Hard synthetic evaluation suite; twin of ``stereo_tpu/eval/hard_suite.py``.

The clean warped pairs of ``data/synthetic.py`` are near-ideal for census
matching, so quality measured on them says little about realistic
conditions. This module curates adversarial scenario families (per-view
radiometric distortion, sensor noise, wide occlusions, textureless
regions, slanted planes, thin structures, rectification jitter,
repetitive texture), sweeps a config over them, and aggregates
bad-delta/EPE/density per scenario. ``census_vs_sad_robustness`` measures
census's invariance to monotone intensity maps against SAD on the same
pairs. Every function takes the ``device`` the matching runs on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import StereoConfig
from ..data.synthetic import make_pair
from ..models import get_model
from ..pipeline import host_postprocess
from .metrics import evaluate_disparity

# Each scenario: generation kwargs for data.synthetic.make_pair. max_disp
# is expressed as a FRACTION of the config's disparity range so the suite
# scales from D=16 CI runs to D=128 bench runs.
SCENARIOS: Dict[str, dict] = {
    # the easy baseline every earlier round measured - kept for contrast
    "clean": dict(kind="shapes", texture="cloud"),
    # exposure/response mismatch between cameras; monotone intensity map
    # on the left view only + mild noise
    "radiometric": dict(
        kind="shapes", texture="cloud",
        gain=1.35, bias=25.0, gamma=0.85, noise_std=2.0,
    ),
    # heavy iid sensor noise, independent per view
    "noise": dict(kind="shapes", texture="cloud", noise_std=10.0),
    # 8 overlapping foreground layers -> wide disocclusion bands
    "occlusion": dict(kind="layers", texture="cloud", noise_std=2.0),
    # ~35% of the scene constant-intensity: locally unmatchable
    "textureless": dict(
        kind="shapes", texture="cloud", flat_frac=0.35, noise_std=2.0
    ),
    # piecewise slanted planes, fractional ground truth everywhere
    "slant": dict(kind="wedges", texture="cloud", noise_std=2.0),
    # 2-4 px thin structures the smoothness prior wants to erase
    "thin": dict(kind="bars", texture="cloud", noise_std=2.0),
    # 0.5 px vertical rectification error
    "jitter": dict(kind="shapes", texture="cloud", y_jitter=0.5, noise_std=2.0),
    # repetitive texture (picket fence): cost minima at every stripe-period
    # alias, the failure mode the uniqueness gate exists for. period 8 <
    # every suite search range, so in-range aliases exist from D=16 up.
    "periodic": dict(
        kind="shapes", texture="picket", period=8, noise_std=6.0
    ),
    # everything at once: layered occlusions + radiometric + noise + flats
    "combo": dict(
        kind="layers", texture="cloud",
        gain=1.25, bias=15.0, noise_std=6.0, flat_frac=0.2,
    ),
}


def suite_pairs(
    cfg: StereoConfig,
    shape: Tuple[int, int] = (160, 288),
    seeds: Sequence[int] = (0, 1, 2),
    scenarios: Optional[Sequence[str]] = None,
):
    """Yield (scenario_name, StereoPair) for the sweep."""
    names = scenarios or list(SCENARIOS)
    max_disp = max(4, cfg.num_disparities * 3 // 4)
    for name in names:
        kw = SCENARIOS[name]
        for seed in seeds:
            yield name, make_pair(shape, max_disp=max_disp, seed=seed, **kw)


def run_hard_suite(
    cfg: StereoConfig,
    shape: Tuple[int, int] = (160, 288),
    seeds: Sequence[int] = (0, 1, 2),
    scenarios: Optional[Sequence[str]] = None,
    model: str = "classic",
    score_occluded: bool = True,
    device="cuda",
) -> List[dict]:
    """Aggregate metrics per scenario; one row per scenario.

    Metrics are computed two ways per pair:
      * ``noc``  - over non-occluded GT pixels (gt_valid), the convention
        every earlier round reported;
      * ``all``  - over ALL in-frame GT pixels including occlusions
        (gt_valid_all; the KITTI disp_occ analog) when the pair carries it
        and ``score_occluded``: this is where occlusion fill
        (cfg.fill_occlusions) earns or loses its keep.
    """
    fn = get_model(model, cfg=cfg).build(device)

    by_scenario: Dict[str, List[dict]] = {}
    for name, pair in suite_pairs(cfg, shape, seeds, scenarios):
        res = fn(pair.left, pair.right)
        disp, valid = host_postprocess(res.disp, res.valid, cfg)
        m = evaluate_disparity(disp, pair.gt_disp, pair.gt_valid, valid)
        row = {f"{k}_noc": v for k, v in m.items()}
        if score_occluded and pair.gt_valid_all is not None:
            m_all = evaluate_disparity(
                disp, pair.gt_disp, pair.gt_valid_all, valid
            )
            row.update({f"{k}_all": v for k, v in m_all.items()})
        by_scenario.setdefault(name, []).append(row)

    rows = []
    for name, recs in by_scenario.items():
        agg = {"scenario": name, "n_pairs": len(recs)}
        for key in recs[0]:
            vals = [r[key] for r in recs if np.isfinite(r[key])]
            agg[key] = round(float(np.mean(vals)), 5) if vals else float("inf")
        rows.append(agg)
    return rows


def census_vs_sad_robustness(
    cfg: StereoConfig,
    shape: Tuple[int, int] = (160, 288),
    seeds: Sequence[int] = (0, 1, 2),
    scenario: str = "radiometric",
    device="cuda",
) -> Dict[str, dict]:
    """bad3 of census vs SAD matching on a radiometrically distorted scene.

    Census descriptors compare pixels against their window center, so any
    monotone per-view intensity map leaves them unchanged (up to
    quantization); SAD compares raw intensities and collapses. This
    measures that gap on the same pairs with the same aggregation
    (on CUDA the SAD half runs K5's int16 costs through K2).
    """
    out = {}
    for cost_fn in ("census", "sad"):
        rows = run_hard_suite(
            cfg.replace(cost_fn=cost_fn),
            shape=shape, seeds=seeds, scenarios=[scenario],
            score_occluded=False, device=device,
        )
        out[cost_fn] = rows[0]
    return out
