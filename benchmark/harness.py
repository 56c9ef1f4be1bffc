"""One run of one cell: set-up, the measured window, the check, the result.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json``, run by the code of the entry it names,
``traffic/<entry>.py``, each metric's reader in ``metrics/<metric>.py`` and
the configuration's plain reference in ``reference/<reference>.py``. A cell,
a mix or a metric is added by adding files and entries.

The engine (``stereo_tpu_torch``) is imported only inside the entries, so a
directory that holds the benchmark alone fails at the first run.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .frames import make_pool

BENCH = Path(__file__).resolve().parent
SPEC = BENCH.parent / "BENCHMARK.json"
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_tpu")


def load_cell(workload: str, spec_path: Path = SPEC) -> SimpleNamespace:
    """The cell named ``workload`` in ``BENCHMARK.json``."""
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[workload]

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return make_cell(workload, cell["chips"], cell["config"], cell["traffic"],
                     mine(spec["end_to_end"]), mine(spec["per_layer"]))


def make_cell(name: str, chips: int, config: str, traffic: str,
              end_to_end: List[Dict], per_layer: List[Dict]
              ) -> SimpleNamespace:
    """A cell: its configuration and traffic mix read by name, and the
    end-to-end and per-layer metrics it reports."""
    return SimpleNamespace(
        name=name, chips=chips,
        config=json.loads((BENCH / "configs" / f"{config}.json").read_text()),
        traffic=json.loads((BENCH / "traffic" /
                            f"{traffic}.json").read_text()),
        end_to_end=end_to_end, per_layer=per_layer)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Sample:
    """A sample, drawn from the seed, of the frames the timed path delivered
    for a few pool pairs: a reservoir of ``size`` over their deliveries, so
    that late frames count as much as early ones, and one frame for each of
    the ``slots`` slots of a batch, so that a fault in one slot shows."""

    def __init__(self, pool: int, pairs: int, size: int, slots: int, rng):
        self.pairs = set(int(i) for i in rng.choice(pool, size=pairs,
                                                    replace=False))
        self.size = size
        self.slots = slots
        self.rng = rng
        self.seen = 0
        self.kept: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        self.by_slot: Dict[int, Tuple[int, Tuple]] = {}

    def offer(self, frame: int, pair: int, disp, valid, slot: int = 0
              ) -> None:
        """A delivered frame: ``disp``, ``valid`` in host memory, at
        ``slot`` of its batch."""
        if pair not in self.pairs:
            return

        def item():
            return (frame, pair, np.array(disp, copy=True),
                    np.array(valid, copy=True))

        self.seen += 1
        i = (len(self.kept) if len(self.kept) < self.size
             else int(self.rng.integers(self.seen)))
        if i < self.size:
            if i == len(self.kept):
                self.kept.append(item())
            else:
                self.kept[i] = item()
        n, held = self.by_slot.get(slot, (0, None))
        if int(self.rng.integers(n + 1)) == 0:
            held = item()
        self.by_slot[slot] = (n + 1, held)

    def frames(self) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
        """Every frame kept: the reservoir's, then one a slot."""
        return self.kept + [held for _, held in self.by_slot.values()]


def load_file(path: Path, name: str):
    """The module in the file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(traffic: Dict):
    """The code of a traffic mix, ``traffic/<entry>.py``: its ``drive``
    runs the window, and its ``HOST_POST`` says whether the output has been
    through the host filters."""
    name = traffic["entry"]
    return load_file(BENCH / "traffic" / f"{name}.py",
                     f"benchmark_traffic_{name}")


def check(cell, left, right, sample: Sample, host_post: bool, device
          ) -> Dict[str, Dict]:
    """Compare the sampled frames with the plain reference run on the same
    pairs: each number compared, with its limit."""
    ref = importlib.import_module(
        f"benchmark.reference.{cell.config['reference']}")
    stereo = cell.config["stereo"]
    want = {}
    kept = sample.frames()
    for pair in sorted({p for _, p, _, _ in kept}):
        disp, valid = ref.compute_disparity(left[pair], right[pair], stereo,
                                            device)
        if host_post:
            disp, valid = ref.host_postprocess(disp, valid, stereo)
        want[pair] = disp, valid
    disp_px = valid_px = 0
    for _, pair, disp, valid in kept:
        wd, wv = want[pair]
        disp_px = max(disp_px, int((disp.view(np.int32)
                                    != wd.view(np.int32)).sum()))
        valid_px = max(valid_px, int((valid != wv).sum()))
    return {"frames_checked": {"value": len(kept), "min": 1},
            "slots_checked": {"value": len(sample.by_slot),
                              "min": sample.slots},
            "disp_px_differ": {"value": disp_px, "limit": 0},
            "valid_px_differ": {"value": valid_px, "limit": 0}}


def within(compared: Dict[str, Dict]) -> bool:
    """Whether every number compared keeps to its limit."""
    return all(c["value"] >= c["min"] if "min" in c else
               c["value"] <= c["limit"] for c in compared.values())


def read_metrics(names: List[str], run) -> Dict[str, Dict]:
    """Each metric by its reader ``metrics/<name>.py``; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in names:
        mod = load_file(BENCH / "metrics" / f"{m['name']}.py",
                        f"benchmark_metric_{len(out)}")
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict:
    """One run: set-up from process start (``t_start``, host clock) to the
    first frame handed over, the window, the check. Returns the result line's
    object; its last key, ``compared``, holds each number compared beside
    its limit."""
    from stereo_tpu_torch.config import from_reference

    device = torch.device(device)
    cfg = from_reference(cell.config["stereo"])
    t = cell.traffic
    left, right = make_pool(t["pool"], tuple(cell.config["image_shape"]),
                            cell.config["scene"]["max_disp"], seed, device)
    sample = Sample(t["pool"], t["check_pool_pairs"], t["check_frames"],
                    t.get("batch", 1), np.random.default_rng([seed, 1]))
    code = entry(t)
    rec = code.drive(cell, cfg, left, right, seconds, trace, device, sample,
                     np.random.default_rng([seed, 2]))
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        peak, kind, platform = 0, "cpu", "cpu"
    run = SimpleNamespace(
        setup_s=rec.t0 - t_start, seconds=seconds, bench=BENCH,
        shape=tuple(cell.config["image_shape"]), stereo=cell.config["stereo"],
        **vars(rec))
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, run)

    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    compared = check(cell, left, right, sample, code.HOST_POST, device)
    reference_s = time.perf_counter() - t_ref
    compared["frames_lost"] = {"value": run.attempted - run.delivered,
                               "limit": 0}
    device_info = {"platform": platform, "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak),
                   "power_limit": power_limit() if platform == "gpu" else None}
    result = {"correct": within(compared), "attempted": run.attempted,
              "failed": run.attempted - run.delivered, "metrics": metrics,
              "device": device_info}
    if trace:
        if run.trace is None or run.trace.busy_s <= 0:
            raise RuntimeError("the traced window recorded no device time")
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["reference_s"] = reference_s
    loaded = forbidden_modules()
    if loaded:
        raise ForbiddenModules(loaded)
    result["compared"] = compared
    return result


class ForbiddenModules(RuntimeError):
    """The run's process loaded a module it may not load."""

    def __init__(self, names: List[str]):
        super().__init__("loaded modules the benchmark forbids: "
                         + ", ".join(names))
