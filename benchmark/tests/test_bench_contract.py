"""BENCHMARK.json keeps to the contract the harness is written for, and
every name in it has the file the harness finds it by."""

import dataclasses
import json
import re

import pytest

from benchmark.harness import BENCH, SPEC, entry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
#: Keys of a configuration that are its widths and shapes: never reduced.
WIDTHS = ("image_shape", "num_disparities", "census_window", "sad_window",
          "num_paths")


@pytest.fixture(scope="module")
def spec():
    return json.loads(SPEC.read_text())


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in \
        text and "\t" not in text


def test_top_level(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    n = 24  # the most cells later PRs may bring
    check = (2 + 14 * n) * (spec["run_seconds"] + 60) + n * 180 + 1200
    assert check <= 43200
    assert len(SPEC.read_bytes()) <= 64 * 1024


def test_configs(spec):
    from stereo_tpu_torch.config import PRESETS, from_reference

    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["why"]) and line(c["source"])
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = json.loads((BENCH.parent / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k not in WIDTHS for k in c["reduced"])
        mine = dataclasses.asdict(from_reference(data["stereo"]))
        preset = dataclasses.asdict(PRESETS[data["preset"]])
        changed = {k for k in mine if mine[k] != preset[k]}
        assert changed <= set(c["reduced"]), changed
        assert (BENCH / "reference" / f"{data['reference']}.py").exists()


def test_workloads(spec):
    configs = {c["name"] for c in spec["configs"]}
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        traffic = json.loads((BENCH / "traffic" /
                              f"{w['traffic']}.json").read_text())
        code = entry(traffic)
        assert callable(code.drive) and isinstance(code.HOST_POST, bool)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(spec["workloads"])
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(pairs) // 4)
    assert len({w["name"] for w in spec["workloads"]}) == len(pairs)


def test_metrics(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in e2e
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reporting
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for cell in cells:
        mine = [m["name"] for m in spec["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m["workloads"] for m in spec["per_layer"])


def test_files_under_paths_are_named_by_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(BENCH.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
