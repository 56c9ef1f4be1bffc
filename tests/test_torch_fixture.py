"""The full-size fixtures that the port's GPU run must reproduce, tied to
the reference package, and the port's independence from jax.

The fixtures under ``stereo_tpu_torch/testdata`` are made by this file from
the reference's golden path (``backend="jnp"`` on the CPU):

    python tests/test_torch_fixture.py            # every fixture
    python tests/test_torch_fixture.py NAME ...   # the named ones

A slice fixture holds hashes of ``disp``/``valid`` before and after
``host_postprocess``, counts and metrics of one frame; the hard-suite
fixtures hold the aggregated rows.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # run as a script: the CPU backend, as conftest
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
from stereo_tpu import data as jdata  # noqa: E402
from stereo_tpu.config import KITTI_SGM8_128, PRESETS  # noqa: E402
from stereo_tpu.data import kitti_like_pair  # noqa: E402
from stereo_tpu.eval import hard_suite as jsuite  # noqa: E402
from stereo_tpu.eval.metrics import evaluate_disparity  # noqa: E402
from stereo_tpu.models import get_model  # noqa: E402
from stereo_tpu.parallel import build_halo_pipeline  # noqa: E402
from stereo_tpu.parallel import make_tile_mesh  # noqa: E402
from stereo_tpu.parallel.bands import build_banded_pipeline  # noqa: E402
from stereo_tpu.pipeline.pipeline import host_postprocess  # noqa: E402
from stereo_tpu_torch import PRESETS as TPRESETS  # noqa: E402
from stereo_tpu_torch import data as tdata  # noqa: E402
from stereo_tpu_torch.eval import hard_suite as tsuite  # noqa: E402
from stereo_tpu_torch.eval import evaluate_disparity as t_evaluate  # noqa: E402
from stereo_tpu_torch.parallel import (  # noqa: E402
    build_banded_pipeline as t_banded,
)
from stereo_tpu_torch.parallel import (  # noqa: E402
    build_halo_pipeline as t_halo,
)
from stereo_tpu_torch.parallel import make_tile_mesh as t_mesh  # noqa: E402
from stereo_tpu_torch.pipeline import host_postprocess as t_post  # noqa: E402

torch.set_num_threads(1)

TESTDATA = ROOT / "stereo_tpu_torch" / "testdata"
FIXTURE = TESTDATA / "kitti_sgm8_128_seed0.json"


def _kitti(data):
    return data.kitti_like_pair(seed=0)


def _shapes_pair(shape, max_disp):
    return lambda data: data.make_pair(shape, max_disp=max_disp, kind="shapes",
                                       texture="cloud", seed=0)


#: The slice fixtures whose golden run is repeated by the tests: name ->
#: the pair each was made on, from either package's data module
#: (chip_smoke.py builds the same pairs).
SLICE_PAIRS = {
    "kitti_sgm8_128_quality": _kitti,
    "kitti_sgm8_128_lr_exact": _kitti,
    "tsukuba_sad16": _shapes_pair((288, 384), 14),
    "middlebury_census_sgm4_64": _shapes_pair((555, 900), 48),
    "kitti_sgm8_128_pyramid55": _kitti,
    "kitti_sgm8_128_quality_pyramid55": _kitti,
    "kitti_sgm8_128_rank": _kitti,
}

#: Every slice fixture: name -> (preset, config overrides, model, model
#: keyword arguments, pair, the pair's description).
SLICES = {
    "kitti_sgm8_128": ("kitti_sgm8_128", {}, "classic", {}, _kitti,
                       "kitti_like_pair(seed=0)"),
    "kitti_sgm8_128_quality": ("kitti_sgm8_128_quality", {}, "classic", {},
                               _kitti, "kitti_like_pair(seed=0)"),
    "kitti_sgm8_128_lr_exact": ("kitti_sgm8_128", {"lr_exact": True},
                                "classic", {}, _kitti,
                                "kitti_like_pair(seed=0)"),
    "tsukuba_sad16": ("tsukuba_sad16", {}, "classic", {},
                      _shapes_pair((288, 384), 14),
                      "make_pair((288, 384), max_disp=14, kind='shapes', "
                      "texture='cloud', seed=0)"),
    "middlebury_census_sgm4_64": (
        "middlebury_census_sgm4_64", {}, "classic", {},
        _shapes_pair((555, 900), 48),
        "make_pair((555, 900), max_disp=48, kind='shapes', texture='cloud', "
        "seed=0)"),
    "kitti_sgm8_128_pyramid55": ("kitti_sgm8_128", {}, "pyramid",
                                 {"census_window": [5, 5]}, _kitti,
                                 "kitti_like_pair(seed=0)"),
    "kitti_sgm8_128_quality_pyramid55": (
        "kitti_sgm8_128_quality", {}, "pyramid", {"census_window": [5, 5]},
        _kitti, "kitti_like_pair(seed=0)"),
    "kitti_sgm8_128_rank": ("kitti_sgm8_128", {"cost_fn": "rank"}, "classic",
                            {}, _kitti, "kitti_like_pair(seed=0)"),
}

#: The banded runner's fixtures: name -> (preset, pair, the pair's
#: description, the runner's split). Config 4 (middlebury_full_256_tiled)
#: at a quarter of the resolution and the full D: the whole frame (the
#: reference bench's form), two column patches (stitched by default) and
#: 2x2 patches in the legacy overlap. tsukuba_sad16 in two column patches:
#: a SAD cost always takes the legacy overlap, with a column origin.
_CFG4_Q = ("middlebury_full_256_tiled", _shapes_pair((497, 720), 200),
           "make_pair((497, 720), max_disp=200, kind='shapes', "
           "texture='cloud', seed=0)")
_TSUKUBA = ("tsukuba_sad16", _shapes_pair((288, 384), 14),
            "make_pair((288, 384), max_disp=14, kind='shapes', "
            "texture='cloud', seed=0)")
BANDED = {
    "middlebury_full_256_tiled_q": (*_CFG4_Q, dict(n_bands=1, n_cols=1)),
    "middlebury_full_256_tiled_q_1x2": (*_CFG4_Q, dict(n_bands=1, n_cols=2)),
    "middlebury_full_256_tiled_q_2x2_legacy": (
        *_CFG4_Q, dict(n_bands=2, n_cols=2, lr_stitch=False)),
    "tsukuba_sad16_1x2": (*_TSUKUBA, dict(n_bands=1, n_cols=2)),
}
#: The same three splits at 1988x2880, the bench's size. Their int32
#: volumes are 5.9 GB each, too much for a CPU test run, so they are
#: made on the card by the port's plain path (``chip_smoke.py
#: --write-fixtures``), which the quarter-size fixtures tie to the
#: reference; each says so in ``made_by``.
FULL_SIZE = {name.replace("_q", ""): split
             for name, (preset, *_, split) in BANDED.items()
             if preset == _CFG4_Q[0]}

#: The halo-tiled pipeline's fixtures: name -> (preset, config overrides,
#: pair, the pair's description, the grid: ``mesh_shape`` and ``lr_stitch``
#: (None: stitched where supported)). KITTI on a 2x2 grid (the frame pads
#: to 376 rows: the crop is exercised) stitched, its quality preset legacy,
#: the exact LR check on 1x2 (legacy: exact LR is not stitchable);
#: tsukuba_sad16 on 1x2 (SAD: legacy, K5 at a negative origin); config 4
#: at a quarter of the resolution, full D, on 2x2 legacy and 1x2 stitched.
_KITTI_TEXT = "kitti_like_pair(seed=0)"
TILED = {
    "kitti_sgm8_128_tiles_2x2": ("kitti_sgm8_128", {}, _kitti, _KITTI_TEXT,
                                 dict(mesh_shape=[2, 2], lr_stitch=None)),
    "kitti_sgm8_128_quality_tiles_2x2_legacy": (
        "kitti_sgm8_128_quality", {}, _kitti, _KITTI_TEXT,
        dict(mesh_shape=[2, 2], lr_stitch=False)),
    "kitti_sgm8_128_lr_exact_tiles_1x2": (
        "kitti_sgm8_128", {"lr_exact": True}, _kitti, _KITTI_TEXT,
        dict(mesh_shape=[1, 2], lr_stitch=None)),
    "tsukuba_sad16_tiles_1x2": (_TSUKUBA[0], {}, *_TSUKUBA[1:],
                                dict(mesh_shape=[1, 2], lr_stitch=None)),
    "middlebury_full_256_tiled_q_tiles_2x2_legacy": (
        _CFG4_Q[0], {}, *_CFG4_Q[1:],
        dict(mesh_shape=[2, 2], lr_stitch=False)),
    "middlebury_full_256_tiled_q_tiles_1x2": (
        _CFG4_Q[0], {}, *_CFG4_Q[1:], dict(mesh_shape=[1, 2],
                                           lr_stitch=None)),
}
#: The config-4 tile grids at 1988x2880, made on the card by the port's
#: plain path (``chip_smoke.py --write-fixtures``), as ``FULL_SIZE``.
TILED_FULL_SIZE = {name.replace("_q_", "_"): grid
                   for name, (preset, *_, grid) in TILED.items()
                   if preset == _CFG4_Q[0]}

#: The hard-suite fixtures: the reference bench's suite-scale sweep.
SUITE_FIXTURE = TESTDATA / "hard_suite_kitti_sgm8_128_quality.json"
SUITE = dict(preset="kitti_sgm8_128_quality", shape=[160, 288],
             seeds=[0, 1, 2])
ROBUSTNESS_FIXTURE = TESTDATA / "census_vs_sad_kitti_sgm8_128.json"
ROBUSTNESS = dict(preset="kitti_sgm8_128", shape=[160, 288], seeds=[0])

SLICE_KEYS = {"source", "preset", "overrides", "model", "model_kwargs", "pair",
              "shape", "hash", "disp", "valid", "n_valid", "post_disp",
              "post_valid", "post_n_valid", "bad3", "density"}
#: A banded fixture names its split instead of a model; a full-size one
#: says who made it.
BANDED_KEYS = (SLICE_KEYS - {"overrides", "model", "model_kwargs"}) | {"bands"}
#: A tiled fixture names its grid instead.
TILED_KEYS = (SLICE_KEYS - {"model", "model_kwargs"}) | {"tiles"}


def _hash(a) -> str:
    return hashlib.sha256(np.asarray(a).tobytes()).hexdigest()[:16]


def _model_kwargs(fx: dict) -> dict:
    """JSON lists back to the tuples the models take."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in fx.get("model_kwargs", {}).items()}


def _golden_record(cfg, pair, model="classic", model_kwargs=None) -> dict:
    """Hashes, counts and metrics of the JAX golden path on ``pair``,
    before and after host_postprocess."""
    fn = get_model(model, cfg=cfg.replace(backend="jnp"),
                   **(model_kwargs or {})).build()
    return _record(cfg, pair, fn(pair.left, pair.right), host_postprocess,
                   evaluate_disparity)


def _record(cfg, pair, res, post, evaluate) -> dict:
    """Hashes, counts and metrics of one result, before and after the
    host post-filters."""
    disp, valid = np.asarray(res.disp), np.asarray(res.valid)
    pdisp, pvalid = post(disp, valid, cfg)
    m = evaluate(pdisp, pair.gt_disp, pair.gt_valid, pvalid)
    return dict(
        shape=list(pair.left.shape), disp=_hash(disp), valid=_hash(valid),
        n_valid=int(valid.sum()), post_disp=_hash(pdisp),
        post_valid=_hash(pvalid), post_n_valid=int(pvalid.sum()),
        bad3=m["bad3"], density=m["density"],
    )


def _banded_golden_record(name: str) -> dict:
    """The JAX golden banded runner on the fixture's pair."""
    preset, make, _, split = BANDED[name]
    cfg = PRESETS[preset].replace(backend="jnp")
    pair = make(jdata)
    fn = build_banded_pipeline(cfg, pair.left.shape, **split)
    return _record(cfg, pair, fn(pair.left, pair.right), host_postprocess,
                   evaluate_disparity)


def _tiled_golden_record(name: str) -> dict:
    """The JAX golden halo-tiled pipeline on the fixture's pair, over the
    first ty * tx of the fake CPU devices."""
    preset, overrides, make, _, tiles = TILED[name]
    cfg = PRESETS[preset].replace(backend="jnp", **overrides)
    pair = make(jdata)
    ty, tx = tiles["mesh_shape"]
    mesh = make_tile_mesh(jax.devices()[:ty * tx], mesh_shape=(ty, tx))
    fn = build_halo_pipeline(cfg, mesh, lr_stitch=tiles["lr_stitch"])
    return _record(cfg, pair, fn(pair.left, pair.right), host_postprocess,
                   evaluate_disparity)


def _check_golden(fx: dict, cfg, pair) -> None:
    """The JAX golden path on ``pair`` gives the hashes, counts and
    metrics stored in ``fx``, before and after host_postprocess."""
    got = _golden_record(cfg, pair, fx.get("model", "classic"),
                         _model_kwargs(fx))
    assert got == {k: fx[k] for k in got}


def test_reference_reproduces_fixture():
    """The JAX golden path at 375x1242, D=128 gives the stored hashes."""
    _check_golden(json.loads(FIXTURE.read_text()), KITTI_SGM8_128,
                  kitti_like_pair(seed=0))


@pytest.mark.parametrize("name", sorted(SLICE_PAIRS))
def test_reference_reproduces_slice_fixture(name):
    """The quality preset, the exact LR check, the rank cost and the
    pyramid model at 375x1242, D=128, the Middlebury preset at 555x900,
    D=64, and tsukuba_sad16 at 288x384, D=16, give the stored hashes."""
    fx = json.loads((TESTDATA / f"{name}_seed0.json").read_text())
    cfg = PRESETS[fx["preset"]].replace(**fx.get("overrides", {}))
    _check_golden(fx, cfg, SLICE_PAIRS[name](jdata))


@pytest.mark.parametrize("name", sorted(SLICE_PAIRS))
def test_port_data_matches_reference(name):
    """The port's synthetic pairs are the reference's, bit for bit."""
    want, got = SLICE_PAIRS[name](jdata), SLICE_PAIRS[name](tdata)
    for field in ("left", "right", "gt_disp", "gt_valid"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_fixture_is_well_formed(name):
    """Every slice fixture names a preset and a model of both packages,
    the pair's shape and all the hashes the GPU run compares."""
    fx = json.loads((TESTDATA / f"{name}_seed0.json").read_text())
    preset, overrides, model, mkw, pair, _ = SLICES[name]
    assert set(fx) <= SLICE_KEYS and SLICE_KEYS - set(fx) <= {
        "overrides", "model", "model_kwargs"}
    assert fx["preset"] == preset and fx["preset"] in TPRESETS
    assert fx.get("overrides", {}) == overrides
    assert fx.get("model", "classic") == model
    assert fx.get("model_kwargs", {}) == mkw
    assert fx["shape"] == list(pair(tdata).left.shape)
    for key in ("disp", "valid", "post_disp", "post_valid"):
        assert re.fullmatch(r"[0-9a-f]{16}", fx[key])
    h, w = fx["shape"]
    assert 0 < fx["post_n_valid"] <= fx["n_valid"] <= h * w
    assert 0.0 <= fx["bad3"] < 0.1 and 0.5 < fx["density"] <= 1.0


@pytest.mark.parametrize("name", sorted(BANDED))
def test_reference_reproduces_banded_fixture(name):
    """The JAX golden banded runner on config 4 at 497x720, D=256, and on
    tsukuba_sad16 at 288x384, gives the stored hashes."""
    fx = json.loads((TESTDATA / f"{name}_seed0.json").read_text())
    preset, *_, split = BANDED[name]
    assert fx["bands"] == split and fx["preset"] == preset
    got = _banded_golden_record(name)
    assert got == {k: fx[k] for k in got}


@pytest.mark.parametrize("name", ["middlebury_full_256_tiled_q_1x2",
                                  "tsukuba_sad16_1x2"])
def test_port_cpu_path_reproduces_banded_fixture(name):
    """The port's banded runner on the CPU (plain ops) reproduces the
    stitched quarter-size config-4 fixture and the SAD one: the same
    hashes, counts and metrics as the JAX golden path, host post-filters
    included."""
    fx = json.loads((TESTDATA / f"{name}_seed0.json").read_text())
    cfg = TPRESETS[fx["preset"]]
    pair = BANDED[name][1](tdata)
    fn = t_banded(cfg, pair.left.shape, device="cpu", **fx["bands"])
    got = _record(cfg, pair, fn(pair.left, pair.right), t_post, t_evaluate)
    assert got == {k: fx[k] for k in got}


@pytest.mark.parametrize("name", sorted({**BANDED, **FULL_SIZE}))
def test_banded_fixture_is_well_formed(name):
    """Every banded fixture names the preset, the pair, the split and all
    the hashes the GPU run compares; a full-size one says who made it."""
    fx = json.loads((TESTDATA / f"{name}_seed0.json").read_text())
    full = name in FULL_SIZE
    assert set(fx) == BANDED_KEYS | ({"made_by"} if full else set())
    if full:
        preset, split, shape = _CFG4_Q[0], FULL_SIZE[name], [1988, 2880]
    else:
        preset, make, _, split = BANDED[name]
        shape = list(make(tdata).left.shape)
    assert fx["preset"] == preset and fx["preset"] in TPRESETS
    assert fx["bands"] == split
    assert fx["shape"] == shape
    for key in ("disp", "valid", "post_disp", "post_valid"):
        assert re.fullmatch(r"[0-9a-f]{16}", fx[key])
    h, w = fx["shape"]
    assert 0 < fx["post_n_valid"] <= fx["n_valid"] <= h * w
    assert 0.0 <= fx["bad3"] < 0.1 and 0.5 < fx["density"] <= 1.0


@pytest.mark.parametrize("name", sorted({**TILED, **TILED_FULL_SIZE}))
def test_tiled_fixture_is_well_formed(name):
    """Every tiled fixture names the preset, its overrides, the pair, the
    grid and all the hashes the GPU run compares; a full-size one says who
    made it."""
    fx = json.loads((TESTDATA / f"{name}_seed0.json").read_text())
    full = name in TILED_FULL_SIZE
    assert set(fx) | {"overrides"} == TILED_KEYS | (
        {"made_by"} if full else set())
    if full:
        preset, overrides, tiles = _CFG4_Q[0], {}, TILED_FULL_SIZE[name]
        shape = [1988, 2880]
    else:
        preset, overrides, make, _, tiles = TILED[name]
        shape = list(make(tdata).left.shape)
    assert fx["preset"] == preset and fx["preset"] in TPRESETS
    assert fx.get("overrides", {}) == overrides
    assert fx["tiles"] == tiles
    assert fx["shape"] == shape
    for key in ("disp", "valid", "post_disp", "post_valid"):
        assert re.fullmatch(r"[0-9a-f]{16}", fx[key])
    h, w = fx["shape"]
    assert 0 < fx["post_n_valid"] <= fx["n_valid"] <= h * w
    assert 0.0 <= fx["bad3"] < 0.1 and 0.5 < fx["density"] <= 1.0


def test_tiled_sad_fixture_both_packages():
    """The smallest tiled fixture (tsukuba_sad16 on a 1x2 grid) from the
    JAX golden tile grid and from the port's local grid on the CPU: the
    stored hashes, counts and metrics, host post-filters included."""
    name = "tsukuba_sad16_tiles_1x2"
    fx = json.loads((TESTDATA / f"{name}_seed0.json").read_text())
    want = {k: fx[k] for k in _tiled_golden_record(name)}
    assert _tiled_golden_record(name) == want
    cfg = TPRESETS[fx["preset"]]
    pair = TILED[name][2](tdata)
    fn = t_halo(cfg, t_mesh(["cpu"] * 2, (1, 2)), device="cpu")
    assert _record(cfg, pair, fn(pair.left, pair.right), t_post,
                   t_evaluate) == want


def test_hard_suite_fixture_is_well_formed():
    """Ten scenario rows of three pairs each, with both score sets."""
    fx = json.loads(SUITE_FIXTURE.read_text())
    assert {k: fx[k] for k in SUITE} == SUITE
    assert [r["scenario"] for r in fx["rows"]] == list(tsuite.SCENARIOS)
    for row in fx["rows"]:
        assert row["n_pairs"] == 3
        assert {"bad3_noc", "density_noc", "bad3_all", "density_all"} <= set(row)
    rb = json.loads(ROBUSTNESS_FIXTURE.read_text())
    assert {k: rb[k] for k in ROBUSTNESS} == ROBUSTNESS
    assert set(rb["rows"]) == {"census", "sad"}
    assert rb["rows"]["census"]["bad3_noc"] < rb["rows"]["sad"]["bad3_noc"]


def test_reference_reproduces_suite_fixtures():
    """The JAX golden path gives the stored hard-suite and robustness rows."""
    fx = json.loads(SUITE_FIXTURE.read_text())
    assert fx["rows"] == jsuite.run_hard_suite(
        PRESETS[fx["preset"]].replace(backend="jnp"),
        shape=tuple(fx["shape"]), seeds=tuple(fx["seeds"]))
    rb = json.loads(ROBUSTNESS_FIXTURE.read_text())
    assert rb["rows"] == jsuite.census_vs_sad_robustness(
        PRESETS[rb["preset"]].replace(backend="jnp"),
        shape=tuple(rb["shape"]), seeds=tuple(rb["seeds"]))


def test_port_cpu_path_reproduces_robustness_fixture():
    """The smallest fixture (two 160x288 pairs at D=128, census and SAD
    through 8-path SGM) on the port's CPU path, row for row."""
    rb = json.loads(ROBUSTNESS_FIXTURE.read_text())
    got = tsuite.census_vs_sad_robustness(
        TPRESETS[rb["preset"]], shape=tuple(rb["shape"]),
        seeds=tuple(rb["seeds"]), device="cpu")
    assert got == rb["rows"]


def test_port_imports_no_jax():
    code = (
        "import sys, stereo_tpu_torch\n"
        "stereo_tpu_torch.build_pipeline\n"
        "import stereo_tpu_torch.cli, stereo_tpu_torch.native\n"
        "import stereo_tpu_torch.models, stereo_tpu_torch.eval.hard_suite\n"
        "import stereo_tpu_torch.eval.harness, stereo_tpu_torch.utils.viz\n"
        "import stereo_tpu_torch.eval.roofline, stereo_tpu_torch.parallel\n"
        "import stereo_tpu_torch.ops.cuda.peak_kernel\n"
        "import stereo_tpu_torch.parallel.stream, stereo_tpu_torch.data\n"
        "import stereo_tpu_torch.eval.scaling, stereo_tpu_torch.utils.timing\n"
        "import stereo_tpu_torch.data.kitti, stereo_tpu_torch.data.middlebury\n"
        "import chip_smoke, profile_paths\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'stereo_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _port_sources():
    return [ROOT / "chip_smoke.py", ROOT / "profile_paths.py",
            *sorted((ROOT / "stereo_tpu_torch").rglob("*.py")),
            *sorted((ROOT / "stereo_tpu_torch" / "csrc").iterdir())]


def _code_lines(path: Path):
    """Lines of ``path`` outside comments and docstrings (which may cite
    the reference's counterpart by file and line)."""
    text = path.read_text()
    if path.suffix == ".py":
        text = re.sub(r'("""|\'\'\')[\s\S]*?\1', "", text)
        return [ln.split("#", 1)[0] for ln in text.splitlines()]
    text = re.sub(r"/\*[\s\S]*?\*/", "", text)
    return [ln.split("//", 1)[0] for ln in text.splitlines()]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_names_no_reference_path(path):
    """No port file imports jax or the reference package, or builds a path
    into ``stereo_tpu/``: the port keeps its own copy of what it needs. A
    ``file.py:line`` citation of the kernel a port kernel replaces names no
    file that could be opened, and is allowed."""
    bad = [
        ln for ln in _code_lines(path)
        if re.search(r"^\s*(import|from)\s+(jax|jaxlib|stereo_tpu)\b", ln)
        or re.search(r"stereo_tpu(?!_torch)\b",
                     re.sub(r"stereo_tpu/[\w/]+\.py:\d+", "", ln))
    ]
    assert not bad, bad


def _write(path: Path, record: dict) -> None:
    path.write_text(json.dumps(record, indent=2) + "\n")
    print(f"wrote {path.relative_to(ROOT)}")


def write_fixtures(names) -> None:
    """Make the named fixtures (all when none is named) from the JAX
    golden path and store them under ``stereo_tpu_torch/testdata``."""
    names = list(names) or [*SLICES, *BANDED, *TILED, "hard_suite",
                            "census_vs_sad"]
    for name in names:
        if name in TILED:
            preset, overrides, _, pair_text, tiles = TILED[name]
            fx = dict(
                source="stereo_tpu build_halo_pipeline(cfg(backend='jnp'), "
                       "make_tile_mesh(devices, mesh_shape), lr_stitch) + "
                       "host_postprocess + evaluate_disparity",
                preset=preset, tiles=tiles, pair=pair_text,
                hash="sha256(array.tobytes()).hexdigest()[:16]",
                **_tiled_golden_record(name))
            if overrides:
                fx["overrides"] = overrides
            _write(TESTDATA / f"{name}_seed0.json", fx)
        elif name in BANDED:
            _write(TESTDATA / f"{name}_seed0.json", dict(
                source="stereo_tpu build_banded_pipeline(cfg(backend='jnp'), "
                       "shape, **bands) + host_postprocess + "
                       "evaluate_disparity",
                preset=BANDED[name][0], bands=BANDED[name][3],
                pair=BANDED[name][2],
                hash="sha256(array.tobytes()).hexdigest()[:16]",
                **_banded_golden_record(name)))
        elif name == "hard_suite":
            rows = jsuite.run_hard_suite(
                PRESETS[SUITE["preset"]].replace(backend="jnp"),
                shape=tuple(SUITE["shape"]), seeds=tuple(SUITE["seeds"]))
            _write(SUITE_FIXTURE, dict(
                source="stereo_tpu run_hard_suite(backend='jnp')", **SUITE,
                rows=rows))
        elif name == "census_vs_sad":
            rows = jsuite.census_vs_sad_robustness(
                PRESETS[ROBUSTNESS["preset"]].replace(backend="jnp"),
                shape=tuple(ROBUSTNESS["shape"]),
                seeds=tuple(ROBUSTNESS["seeds"]))
            _write(ROBUSTNESS_FIXTURE, dict(
                source="stereo_tpu census_vs_sad_robustness(backend='jnp')",
                **ROBUSTNESS, rows=rows))
        else:
            preset, overrides, model, mkw, pair, pair_text = SLICES[name]
            cfg = PRESETS[preset].replace(**overrides)
            fx = dict(
                source="stereo_tpu get_model(model, cfg(backend='jnp')) + "
                       "host_postprocess + evaluate_disparity",
                preset=preset, pair=pair_text,
                hash="sha256(array.tobytes()).hexdigest()[:16]",
                **_golden_record(cfg, pair(jdata), model,
                                 _model_kwargs({"model_kwargs": mkw})))
            if overrides:
                fx["overrides"] = overrides
            if model != "classic":
                fx["model"] = model
            if mkw:
                fx["model_kwargs"] = mkw
            _write(TESTDATA / f"{name}_seed0.json", fx)


def golden_peak_memory(shape) -> dict:
    """The JAX golden (jnp) whole-frame config-4 path on its pair at
    ``shape``, seed 0: its hashes of disp and valid, the wall seconds and
    this process's peak resident memory. Run once per process (the peak is
    the process's own) to size the full-size run against a machine's
    memory: ``python tests/test_torch_fixture.py --golden-peak 497 720``."""
    import resource
    import time

    shape = tuple(shape)
    cfg = PRESETS["middlebury_full_256_tiled"].replace(backend="jnp")
    pair = jdata.make_pair(shape, max_disp=200, kind="shapes",
                           texture="cloud", seed=0)
    t0 = time.perf_counter()
    res = build_banded_pipeline(cfg, pair.left.shape, n_bands=1, n_cols=1)(
        pair.left, pair.right)
    disp, valid = np.asarray(res.disp), np.asarray(res.valid)
    return dict(shape=list(shape), seconds=time.perf_counter() - t0,
                disp=_hash(disp), valid=_hash(valid),
                peak_rss_gib=resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 2**20)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--golden-peak"]:
        print(json.dumps(golden_peak_memory(map(int, sys.argv[2:4]))))
    else:
        write_fixtures(sys.argv[1:])
