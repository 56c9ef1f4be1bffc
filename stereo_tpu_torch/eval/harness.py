"""Evaluation sweep harness with resume; twin of
``stereo_tpu/eval/harness.py``.

Runs a config over a dataset of pairs, accumulating bad-delta/EPE/density
per pair and in aggregate; appends structured records to a results JSONL
(config, git sha, device, timing) and keeps a resume manifest of completed
pairs so an interrupted sweep restarts where it stopped.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..config import StereoConfig
from ..data.synthetic import StereoPair
from ..models import get_model
from ..pipeline import host_postprocess
from .metrics import evaluate_disparity


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip()
    except Exception:
        return "unknown"


class EvalHarness:
    def __init__(
        self,
        cfg: StereoConfig,
        results_path: Optional[str] = None,
        manifest_path: Optional[str] = None,
        artifacts_dir: Optional[str] = None,
        model: str = "classic",
        device="cuda",
    ):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.results_path = results_path
        self.manifest_path = manifest_path
        self.artifacts_dir = artifacts_dir
        self._fn = None
        self.done = set()
        if manifest_path and os.path.exists(manifest_path):
            with open(manifest_path) as f:
                self.done = set(json.load(f).get("done", []))

    def _device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def _checkpoint(self):
        if not self.manifest_path:
            return
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"done": sorted(self.done)}, f)
        os.replace(tmp, self.manifest_path)

    def run(self, pairs: Iterable[StereoPair], deltas=(1.0, 2.0, 3.0)) -> dict:
        if self._fn is None:
            self._fn = get_model(self.model, cfg=self.cfg).build(self.device)
        records = []
        for pair in pairs:
            if pair.name in self.done:
                continue
            t0 = time.perf_counter()
            res = self._fn(pair.left, pair.right)
            disp, valid = host_postprocess(res.disp, res.valid, self.cfg)
            dt = time.perf_counter() - t0
            m = evaluate_disparity(
                disp, pair.gt_disp, pair.gt_valid, valid, deltas=deltas
            )
            rec = {
                "pair": pair.name,
                "shape": list(pair.left.shape),
                "sec": round(dt, 5),
                "git_sha": _git_sha(),
                "device": self._device_name(),
                "config": {
                    "model": self.model,
                    "cost_fn": self.cfg.cost_fn,
                    "D": self.cfg.num_disparities,
                    "paths": self.cfg.num_paths,
                },
                **{k: round(v, 6) for k, v in m.items()},
            }
            records.append(rec)
            if self.results_path:
                with open(self.results_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if self.artifacts_dir:
                from ..utils.viz import colorize_disparity, error_map, save_png

                os.makedirs(self.artifacts_dir, exist_ok=True)
                base = os.path.join(self.artifacts_dir, pair.name)
                save_png(base + "_disp.png", colorize_disparity(disp, valid))
                if pair.gt_valid.any():
                    save_png(
                        base + "_err.png",
                        error_map(disp, pair.gt_disp, pair.gt_valid),
                    )
            self.done.add(pair.name)
            self._checkpoint()

        if not records:
            return {"n_pairs": 0}
        summary = {"n_pairs": len(records)}
        for key in records[0]:
            if key in ("pair", "shape", "config", "git_sha", "device"):
                continue
            vals = [r[key] for r in records if isinstance(r[key], (int, float))]
            if vals:
                summary[key] = round(float(np.mean(vals)), 6)
        return summary
