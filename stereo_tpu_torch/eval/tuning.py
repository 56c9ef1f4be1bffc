"""Quality-tuning sweep harness, as ``stereo_tpu/eval/tuning.py``.

Sweeps configs over the hard suite (``eval/hard_suite.py``, on ``device``)
and scores them with a density-aware objective, so that a config cannot
"win" by invalidating every ambiguous pixel: the mean over scenarios of
bad3 plus the density shortfall below a floor, optionally weighted per
scenario. ``stage_sweep`` is staged coordinate descent (a p1/p2 grid
first, then the gates and post-filters on the survivors); ``sweep`` one
cartesian grid; ``format_table`` a human-readable summary.
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import StereoConfig
from .hard_suite import SCENARIOS, run_hard_suite

# Scenario weights for the default objective: the north-star bar is ≤4%
# bad-3.0 on realistic content, so the scenarios that model failure modes
# a production rig actually hits carry full weight; "clean" is a sanity
# anchor (regressing it means the tuning broke the easy case).
DEFAULT_WEIGHTS: Dict[str, float] = {name: 1.0 for name in SCENARIOS}


def score_rows(
    rows: Sequence[dict],
    density_floor: float = 0.90,
    density_weight: float = 0.5,
    weights: Optional[Dict[str, float]] = None,
    all_weight: float = 0.0,
) -> float:
    """Scalar objective (lower is better) over per-scenario suite rows.

    score = Σ_s w_s * (blend_s + density_weight * max(0, floor - density_noc_s))
            / Σ_s w_s
    blend = (1 - all_weight) * bad3_noc + all_weight * bad3_all

    ``all_weight`` > 0 requires suite rows carrying *_all metrics
    (score_occluded). Run it with cfg.fill_occlusions=True: gated pixels
    are then filled and SCORED, so a config cannot win by invalidating
    hard content — the uniqueness/speckle gates only pay off where the
    fill recovers better values than the rejected winner. bad3_noc alone
    is gameable in exactly that way (the round-4 sweep-1 lesson:
    textureless density collapsed to 0.59 while its bad3_noc "won").
    """
    weights = weights or DEFAULT_WEIGHTS
    num, den = 0.0, 0.0
    for r in rows:
        w = weights.get(r["scenario"], 1.0)
        if w == 0.0:
            continue
        bad = r["bad3_noc"]
        if all_weight > 0.0 and "bad3_all" in r:
            bad = (1.0 - all_weight) * bad + all_weight * r["bad3_all"]
        shortfall = max(0.0, density_floor - r["density_noc"])
        num += w * (bad + density_weight * shortfall)
        den += w
    return num / max(den, 1e-9)


def sweep(
    base: StereoConfig,
    grid: Dict[str, Sequence],
    shape: Tuple[int, int] = (96, 160),
    seeds: Sequence[int] = (0, 1),
    scenarios: Optional[Sequence[str]] = None,
    density_floor: float = 0.90,
    density_weight: float = 0.5,
    weights: Optional[Dict[str, float]] = None,
    all_weight: float = 0.0,
    log_path: Optional[str] = None,
    verbose: bool = False,
    device="cuda",
) -> List[dict]:
    """Evaluate the cartesian product of ``grid`` overrides on the suite.

    Returns one record per variant, sorted best-first:
      {"overrides": {...}, "score": float, "rows": {scenario: suite_row},
       "elapsed_s": float}.
    Each variant runs the whole suite, so grids should stay staged-small;
    see stage_sweep.
    """
    keys = list(grid)
    out = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        cfg = base.replace(**overrides)
        t0 = time.time()
        rows = run_hard_suite(
            cfg, shape=shape, seeds=seeds, scenarios=scenarios,
            score_occluded=all_weight > 0.0, device=device,
        )
        rec = {
            "overrides": {k: _jsonable(v) for k, v in overrides.items()},
            "score": round(
                score_rows(rows, density_floor, density_weight, weights,
                           all_weight), 6
            ),
            "rows": {r["scenario"]: r for r in rows},
            "elapsed_s": round(time.time() - t0, 1),
        }
        out.append(rec)
        if log_path:
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if verbose:
            worst = max(rows, key=lambda r: r["bad3_noc"])
            print(
                f"{overrides} -> score {rec['score']:.5f} "
                f"(worst {worst['scenario']} {worst['bad3_noc']:.4f})",
                flush=True,
            )
    out.sort(key=lambda r: r["score"])
    return out


def stage_sweep(
    base: StereoConfig,
    stages: Sequence[Dict[str, Sequence]],
    keep: int = 3,
    device="cuda",
    **kw,
) -> List[dict]:
    """Staged coordinate descent: sweep stage 1's grid, keep the ``keep``
    best override sets, extend each with stage 2's grid, and so on.

    Cuts the cartesian blowup (|g1| + keep * |g2| + ... evaluations instead
    of |g1| * |g2| * ...) at the usual risk of missing cross-stage
    interactions — acceptable here because the knobs are near-separable
    (penalties vs gates vs post-filters) and the final candidates get a
    full re-rank at larger scale anyway.
    """
    survivors = [{}]
    results: List[dict] = []
    for stage in stages:
        results = []
        for prev in survivors:
            merged_base = base.replace(**prev) if prev else base
            for rec in sweep(merged_base, stage, device=device, **kw):
                rec["overrides"] = {**prev, **rec["overrides"]}
                results.append(rec)
        results.sort(key=lambda r: r["score"])
        # dedupe identical override sets (stages may reproduce a survivor)
        seen, uniq = set(), []
        for rec in results:
            key = json.dumps(rec["overrides"], sort_keys=True)
            if key not in seen:
                seen.add(key)
                uniq.append(rec)
        results = uniq
        survivors = [r["overrides"] for r in results[:keep]]
    return results


def _jsonable(v):
    if isinstance(v, tuple):
        return list(v)
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    return v


def format_table(results: Sequence[dict], top: int = 10) -> str:
    """Human-readable summary of the best variants."""
    lines = []
    for rec in list(results)[:top]:
        cells = [f"score={rec['score']:.5f}"]
        cells.append(json.dumps(rec["overrides"]))
        worst = max(rec["rows"].values(), key=lambda r: r["bad3_noc"])
        cells.append(
            f"worst={worst['scenario']}:{worst['bad3_noc']:.4f}"
        )
        mean_d = np.mean([r["density_noc"] for r in rec["rows"].values()])
        cells.append(f"mean_density={mean_d:.3f}")
        lines.append("  ".join(cells))
    return "\n".join(lines)
