"""The port's CLI against the reference's on the same files, on the CPU.

Each case writes its inputs itself (a 48x80 pair as PNGs, KITTI and
Middlebury trees, a calib.txt), runs ``stereo_tpu.cli.main`` (on the fake
CPU devices of tests/conftest.py) and ``stereo_tpu_torch.cli.main`` with
``--device cpu`` on them, and requires the same stdout records (timings
aside) and byte-equal written files: disparity as PFM, KITTI PNG or colour
PNG, depth as .npy, points as PLY, the aggregated volume, eval results
and artifacts.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_tpu.cli import main as j_main
from stereo_tpu_torch.cli import main as t_main
from stereo_tpu_torch.data import make_pair
from stereo_tpu_torch.data.kitti import write_kitti_disparity
from stereo_tpu_torch.data.middlebury import write_pfm

torch.set_num_threads(1)

#: Seconds a test here may take.
TIME_LIMIT = 150

SMALL = ["--set", "num_disparities=16"]


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"over this file's {TIME_LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _png(path, img):
    Image.fromarray(img, mode="L").save(path)


CALIB = ("cam0=[612.5 0 30.25; 0 612.5 20.5; 0 0 1]\n"
         "cam1=[612.5 0 41.75; 0 612.5 20.5; 0 0 1]\n"
         "doffs=11.5\nbaseline=193.001\nwidth=80\nheight=48\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A pair with KITTI GT, a calib.txt, a Middlebury scene (with its
    calib.txt) and a KITTI tree of two frames."""
    root = tmp_path_factory.mktemp("inputs")
    pair = make_pair((48, 80), max_disp=10, kind="shapes", texture="cloud",
                     seed=2)
    _png(root / "l.png", pair.left)
    _png(root / "r.png", pair.right)
    write_kitti_disparity(str(root / "gt.png"), pair.gt_disp, pair.gt_valid)
    (root / "calib.txt").write_text(CALIB)
    scene = root / "mb" / "sceneA"
    scene.mkdir(parents=True)
    _png(scene / "im0.png", pair.left)
    _png(scene / "im1.png", pair.right)
    write_pfm(str(scene / "disp0.pfm"),
              np.where(pair.gt_valid, pair.gt_disp, np.inf).astype(
                  np.float32))
    (scene / "calib.txt").write_text(CALIB)
    kitti = root / "kitti"
    for sub in ("image_2", "image_3", "disp_noc_0"):
        (kitti / sub).mkdir(parents=True)
    for i in range(2):
        p = make_pair((48, 80), max_disp=10, kind="shapes", texture="cloud",
                      seed=10 + i)
        fid = f"{i:06d}_10"
        _png(kitti / "image_2" / f"{fid}.png", p.left)
        _png(kitti / "image_3" / f"{fid}.png", p.right)
        write_kitti_disparity(str(kitti / "disp_noc_0" / f"{fid}.png"),
                              p.gt_disp, p.gt_valid)
    return root


def _both(args, outs, tmp_path, capsys):
    """Run both CLIs with ``args``, where ``{out}`` stands for each one's
    own output directory; returns (reference stdout, port stdout, the two
    directories)."""
    dirs = []
    lines = []
    for name, main, extra in (("ref", j_main, []),
                              ("port", t_main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        dirs.append(d)
        assert main([a.format(out=d) for a in args] + extra) == 0
        lines.append(capsys.readouterr().out.strip().splitlines())
    for f in outs:
        assert (dirs[0] / f).read_bytes() == (dirs[1] / f).read_bytes(), f
    return lines[0], lines[1], dirs


RUN_CASES = {
    "pfm_rig_depth_ply_volume": (
        ["--gt", "{inp}/gt.png", "--out", "{out}/d.pfm", "--rig",
         "721.5,0.54", "--depth-out", "{out}/z.npy", "--ply", "{out}/c.ply",
         "--dump-volume", "{out}/s.npy"],
        ["d.pfm", "z.npy", "c.ply", "s.npy"]),
    "kitti_png_calib": (
        ["--out", "{out}/d.png", "--kitti-format", "--calib",
         "{inp}/calib.txt", "--depth-out", "{out}/z.npy", "--ply",
         "{out}/c.ply"],
        ["d.png", "z.npy", "c.ply"]),
    "colour_png_quality_doffs": (
        ["--preset", "kitti_sgm8_128_quality", "--out", "{out}/d.png",
         "--rig", "500,0.2,3.5", "--ply", "{out}/c.ply"],
        ["d.png", "c.ply"]),
    "tiles": (["--tiles", "1,2", "--out", "{out}/d.pfm"], ["d.pfm"]),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_on_files_matches_reference(inputs, tmp_path, capsys, case):
    args, outs = RUN_CASES[case]
    args = [a.replace("{inp}", str(inputs)) for a in args]
    ref, port, _ = _both(["run", "--left", f"{inputs}/l.png", "--right",
                          f"{inputs}/r.png", *SMALL, *args], outs, tmp_path,
                         capsys)
    assert ref == port


def test_run_scene_finds_its_calib(inputs, tmp_path, capsys):
    """--scene with --depth-out/--ply takes the calib.txt beside it; the
    metrics line is the PFM ground truth's."""
    ref, port, _ = _both(
        ["run", "--scene", f"{inputs}/mb/sceneA", *SMALL, "--out",
         "{out}/d.pfm", "--depth-out", "{out}/z.npy", "--ply",
         "{out}/c.ply"], ["d.pfm", "z.npy", "c.ply"], tmp_path, capsys)
    assert ref == port and json.loads(port[-1])["pair"] == "sceneA"


def test_run_exact_mesh_equals_the_whole_frame(inputs, tmp_path, capsys):
    """--exact-mesh 2,2 (a local grid of CPU tiles) writes the whole
    frame's PFM, which the reference's run writes."""
    ref, port, dirs = _both(
        ["run", "--left", f"{inputs}/l.png", "--right", f"{inputs}/r.png",
         *SMALL, "--out", "{out}/d.pfm"], ["d.pfm"], tmp_path, capsys)
    exact = tmp_path / "exact.pfm"
    assert t_main(["run", "--left", f"{inputs}/l.png", "--right",
                   f"{inputs}/r.png", *SMALL, "--exact-mesh", "2,2",
                   "--dplane-cost", "--out", str(exact), "--device",
                   "cpu"]) == 0
    assert exact.read_bytes() == (dirs[0] / "d.pfm").read_bytes()


def _records(path):
    drop = ("sec", "device", "git_sha")
    return [{k: v for k, v in json.loads(line).items() if k not in drop}
            for line in path.read_text().splitlines()]


@pytest.mark.parametrize("source", ["kitti", "middlebury", "synthetic"])
def test_eval_matches_reference(inputs, tmp_path, capsys, source):
    """eval over a KITTI tree, a Middlebury root or one synthetic pair:
    the same records and summary (timings aside) and byte-equal
    artifacts."""
    where = {"kitti": ["--kitti", f"{inputs}/kitti"],
             "middlebury": ["--middlebury", f"{inputs}/mb", "--artifacts",
                            "{out}/art"],
             "synthetic": ["--limit", "1"]}[source]
    outs = ["art/sceneA_disp.png", "art/sceneA_err.png"] if (
        source == "middlebury") else []
    ref, port, dirs = _both(
        ["eval", *SMALL, *where, "--results", "{out}/res.jsonl",
         "--manifest", "{out}/m.json"], outs, tmp_path, capsys)
    assert _records(dirs[0] / "res.jsonl") == _records(dirs[1] / "res.jsonl")
    summary = [json.loads(line[-1]) for line in (ref, port)]
    for s in summary:
        s.pop("sec")
    assert summary[0] == summary[1]
    assert json.loads((dirs[1] / "m.json").read_text())["done"]


def test_eval_hard_suite_matches_reference(tmp_path, capsys):
    ref, port, _ = _both(
        ["eval", "--hard-suite", "--demo-shape", "48", "80", "--limit", "1",
         *SMALL, "--results", "{out}/res.jsonl"], ["res.jsonl"], tmp_path,
        capsys)
    assert ref == port and len(port) == 10


def test_bench_and_info(capsys):
    """bench prints the reference's keys plus the device; info the
    reference's preset table."""
    bench = ["bench", "--preset", "middlebury_census_sgm4_64", *SMALL,
             "--demo-shape", "48", "80", "--demo-max-disp", "8", "--iters",
             "2"]
    assert j_main(bench) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t_main(bench + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert got["shape"] == want["shape"] == [48, 80] and got["fps"] > 0
    assert j_main(["info"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert t_main(["--log", "WARNING", "info", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    table = want.index("presets:")
    assert got[got.index("presets:"):] == want[table:]
    assert got[1] == "devices: ['cpu']"


@pytest.mark.parametrize("command", ["stream", "scale"])
def test_stream_and_scale_take_a_model(command, capsys):
    """--model, as the reference's add_common gives every command."""
    extra = (["--limit", "2", "--batch", "2"] if command == "stream"
             else ["--iters", "1"])
    assert t_main([command, "--model", "classic", *SMALL, "--demo-shape",
                   "32", "48", *extra, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])
