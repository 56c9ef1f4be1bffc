"""The port's banded and column-patched runner against
``stereo_tpu.parallel.bands`` on the CPU.

The same synthetic pairs (made from a seed with numpy) go through both
packages' ``build_banded_pipeline``; every comparison is exact
(``assert_array_equal``, tolerance 0): the patches are the same integer
pipeline and the stitch is elementwise min, unpack and compare on maps
whose values are integers below 2^24.
"""

import numpy as np
import pytest
import torch

from stereo_tpu.config import StereoConfig as JCfg
from stereo_tpu.config import TileConfig as JTile
from stereo_tpu.data import make_pair
from stereo_tpu.parallel.bands import build_banded_pipeline as j_banded
from stereo_tpu_torch.config import StereoConfig as TCfg
from stereo_tpu_torch.config import TileConfig as TTile
from stereo_tpu_torch.config import tile_from_reference
from stereo_tpu_torch.parallel import build_banded_pipeline as t_banded
from stereo_tpu_torch.pipeline import compute_disparity as t_compute

torch.set_num_threads(1)


def _both(kw, shape, pair, **split):
    """(port result, reference result) of one banded configuration, as
    numpy (disp, valid)."""
    got = t_banded(TCfg(**kw), shape, device="cpu", **split)(
        pair.left, pair.right)
    want = j_banded(JCfg(**kw), shape, **split)(pair.left, pair.right)
    return ((got.disp.numpy(), got.valid.numpy()),
            (np.asarray(want.disp), np.asarray(want.valid)))


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("halo", [64, None], ids=["halo64", "default_halo"])
def test_row_bands_match_reference(halo):
    """64x96 in four row bands: with a halo covering the frame the bands
    are the whole frame; with the default halo both packages make the
    same warm-up error."""
    pair = make_pair((64, 96), max_disp=10, kind="shapes", seed=11)
    kw = dict(num_disparities=16, num_paths=8)
    got, want = _both(kw, (64, 96), pair, n_bands=4, halo=halo)
    _assert_equal(got, want)
    if halo == 64:
        whole = t_compute(torch.from_numpy(pair.left),
                          torch.from_numpy(pair.right), TCfg(**kw))
        np.testing.assert_array_equal(got[0], whole.disp.numpy())


@pytest.mark.parametrize("lr_stitch", [None, False],
                         ids=["stitched_default", "legacy"])
@pytest.mark.parametrize("halo", [128, None], ids=["halo128", "default_halo"])
def test_rows_and_cols_match_reference(halo, lr_stitch):
    """64x128 in 2x2 patches with static offsets, in both overlap regimes;
    a halo covering the frame makes either the whole frame."""
    pair = make_pair((64, 128), max_disp=10, kind="shapes", seed=12)
    kw = dict(num_disparities=16, num_paths=8)
    got, want = _both(kw, (64, 128), pair, n_bands=2, n_cols=2, halo=halo,
                      lr_stitch=lr_stitch)
    _assert_equal(got, want)
    if halo == 128:
        whole = t_compute(torch.from_numpy(pair.left),
                          torch.from_numpy(pair.right), TCfg(**kw))
        np.testing.assert_array_equal(got[0], whole.disp.numpy())
        np.testing.assert_array_equal(got[1], whole.valid.numpy())


@pytest.mark.parametrize("lr_stitch", [None, False],
                         ids=["stitched_default", "legacy"])
def test_wide_frame_matches_reference(lr_stitch):
    """64x256 in 2x2: stitched by default for census with the cheap LR
    check, the legacy overlap when switched off; bounded error against the
    whole frame in both."""
    pair = make_pair((64, 256), max_disp=10, kind="shapes", seed=12)
    kw = dict(num_disparities=16, num_paths=8)
    got, want = _both(kw, (64, 256), pair, n_bands=2, n_cols=2,
                      lr_stitch=lr_stitch)
    _assert_equal(got, want)
    whole = t_compute(torch.from_numpy(pair.left),
                      torch.from_numpy(pair.right), TCfg(**kw))
    both = got[1] & whole.valid.numpy()
    mm = (np.abs(got[0] - whole.disp.numpy()) > 1)[both].mean()
    assert mm < 0.02, mm
    assert (got[1] != whole.valid.numpy()).mean() < 0.02


@pytest.mark.parametrize("n_cols", [2, 3])
@pytest.mark.parametrize(
    "kw",
    [dict(num_disparities=16, num_paths=8, p1=0, p2=0),
     dict(num_disparities=32, num_paths=8, p1=0, p2=0, min_disparity=3,
          uniqueness_ratio=0.15)],
    ids=["d16", "d32_md3_uniq"],
)
def test_stitched_zero_penalty_is_the_whole_frame(kw, n_cols):
    """With P1 = P2 = 0 SGM carries no state, the warm-up error vanishes,
    and the stitched runner must equal the whole-frame pipeline and the
    reference's stitched runner bit for bit."""
    pair = make_pair((48, 384), max_disp=12, kind="shapes", seed=3)
    got, want = _both(kw, (48, 384), pair, n_bands=2, n_cols=n_cols,
                      lr_stitch=True)
    _assert_equal(got, want)
    whole = t_compute(torch.from_numpy(pair.left),
                      torch.from_numpy(pair.right), TCfg(**kw))
    np.testing.assert_array_equal(got[0], whole.disp.numpy())
    np.testing.assert_array_equal(got[1], whole.valid.numpy())


@pytest.mark.parametrize(
    "kw, split, match",
    [(dict(num_disparities=16, cost_fn="sad"), dict(n_bands=2, n_cols=2,
                                                     lr_stitch=True),
      "lr_stitch"),
     (dict(num_disparities=16), dict(n_bands=2, n_cols=1, lr_stitch=True),
      "lr_stitch"),
     (dict(num_disparities=16), dict(n_bands=65, n_cols=1), "degenerate")],
    ids=["sad", "one_column", "degenerate_split"],
)
def test_rejected_configurations(kw, split, match):
    """Both packages refuse the same configurations with the same word."""
    with pytest.raises(ValueError, match=match):
        t_banded(TCfg(**kw), (64, 256), device="cpu", **split)
    with pytest.raises(ValueError, match=match):
        j_banded(JCfg(**kw), (64, 256), **split)


@pytest.mark.parametrize("cost_fn, lr_exact", [("sad", False),
                                               ("census", True),
                                               ("rank", False)])
def test_legacy_patches_other_costs(cost_fn, lr_exact):
    """SAD and the exact LR check take the legacy overlap (x_offset on the
    SAD volume; the flipped pass at the flipped origin); rank is stitched
    by default."""
    pair = make_pair((40, 160), max_disp=10, kind="shapes", seed=5)
    kw = dict(num_disparities=16, num_paths=4, cost_fn=cost_fn,
              lr_exact=lr_exact, sad_window=(5, 5))
    got, want = _both(kw, (40, 160), pair, n_bands=1, n_cols=2)
    _assert_equal(got, want)


def test_wrong_frame_shape_raises():
    fn = t_banded(TCfg(num_disparities=16), (64, 96), n_bands=2,
                  device="cpu")
    with pytest.raises(ValueError, match="built for"):
        fn(np.zeros((32, 96), np.uint8), np.zeros((32, 96), np.uint8))


@pytest.mark.parametrize("halo", [None, 7])
def test_tile_config_carries_across(halo):
    """``tile_from_reference`` turns the reference's TileConfig (as a dict
    of plain values) into the port's, with the same resolved halo."""
    import dataclasses

    jt = JTile(mesh_shape=(2, 4), halo=halo, batch_axis=True)
    tt = tile_from_reference(dataclasses.asdict(jt))
    assert tt == TTile(mesh_shape=(2, 4), halo=halo, batch_axis=True)
    for window in [(5, 5), (9, 7)]:
        assert (tt.resolved_halo(TCfg(census_window=window))
                == jt.resolved_halo(JCfg(census_window=window)))
