"""The frozen work model against the bounds that PERF.md records for K2 and
against the engine's own model."""

import pytest

from benchmark import work


@pytest.mark.parametrize("shape,bound", [((375, 1242, 128), 0.0712),
                                         ((1988, 2880, 256), 1.7501)])
def test_k2_bound_matches_perf_md(shape, bound):
    assert round(work.paths_bound_ms(*shape, num_paths=8), 4) == bound


@pytest.mark.parametrize("shape,d", [((375, 1242), 128), ((1988, 2880), 256)])
def test_frozen_model_equals_engines(shape, d):
    from stereo_tpu_torch.config import PRESETS
    from stereo_tpu_torch.eval import roofline

    import dataclasses
    import torch

    cfg = PRESETS["kitti_sgm8_128"].replace(num_disparities=d)
    h, w = shape
    cost = torch.empty((1, 1, 1), dtype=torch.int8).expand(h, w, d)
    assert work.paths_bound_ms(h, w, d, 8) == pytest.approx(
        roofline.paths_bound(cost, cfg)["bound_ms"])
    stages = [roofline.transform_bound(h, w, cfg.census_window),
              roofline.transform_bound(h, w, cfg.census_window),
              roofline.cost_bound(h, w, d, cfg.census_words, 5),
              roofline.paths_bound(cost, cfg),
              roofline.select_bound(h, w, d), roofline.median_bound(h, w)]
    frame = work.frame_work(h, w, dataclasses.asdict(cfg))
    assert frame["ops"] == sum(s["operations"] for s in stages)
    assert frame["bytes"] == h * w * 7
    assert frame["bound_ms"] == pytest.approx(frame["ops"] / 67e9)


def test_kitti_frame_work():
    """About 5.56 G operations a KITTI frame: 0.0830 ms at 67 T/s."""
    cfg = {"num_disparities": 128, "census_window": [9, 7], "num_paths": 8,
           "median_filter": True}
    f = work.frame_work(375, 1242, cfg)
    assert round(f["ops"] / 1e9, 2) == 5.56
    assert round(f["bound_ms"], 4) == 0.0830
