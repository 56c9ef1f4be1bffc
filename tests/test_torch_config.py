"""The port's config equals the reference's, preset by preset."""

import dataclasses

import numpy as np
import pytest
import torch

from stereo_tpu import config as ref
from stereo_tpu_torch import config as port

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(ref.PRESETS))
def test_preset_matches_reference(name):
    a, b = ref.PRESETS[name], port.PRESETS[name]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.census_words, a.max_unary_cost, a.window_radius) == (
        b.census_words, b.max_unary_cost, b.window_radius
    )
    assert np.dtype(a.cost_volume_dtype).name == str(
        b.cost_volume_dtype
    ).removeprefix("torch.")


@pytest.mark.parametrize("name", sorted(ref.PRESETS))
def test_from_reference_round_trip(name):
    got = port.from_reference(dataclasses.asdict(ref.PRESETS[name]))
    assert got == port.PRESETS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref.PRESETS[name])


def test_from_reference_takes_json_lists_and_drops_jax_backend():
    d = dataclasses.asdict(ref.KITTI_SGM8_128.replace(backend="pallas"))
    d["census_window"] = list(d["census_window"])
    got = port.from_reference(d)
    assert got.census_window == (9, 7)
    assert got.backend == "auto"


def test_from_reference_rejects_unknown_field():
    d = dataclasses.asdict(ref.KITTI_SGM8_128)
    d["no_such_field"] = 1
    with pytest.raises(ValueError, match="no_such_field"):
        port.from_reference(d)


@pytest.mark.parametrize(
    "kw",
    [
        dict(backend="jnp"),
        dict(num_paths=2),
        dict(census_window=(4, 5)),
        dict(cost_fn="ncc"),
    ],
)
def test_invalid_config_raises(kw):
    with pytest.raises(ValueError):
        port.StereoConfig(**kw)


def test_cost_volume_dtype():
    assert port.KITTI_SGM8_128.cost_volume_dtype == torch.int8
    assert port.TSUKUBA_SAD16.cost_volume_dtype == torch.int16
