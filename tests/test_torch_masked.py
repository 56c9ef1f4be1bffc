"""Masked and constrained calls on the port's kernel route against the
reference on the CPU.

The reference sends a call with a ``valid`` mask (no tile rectangle) or
with the ``constrain`` hooks of its exact mode to its golden path. The
port runs such a call through the kernels: K2's mask form, one call per
family of directions between the hooks (``pipeline.kernel_sum``). On CPU
tensors the wrappers run their plain twins, so here the route's
composition is held against ``stereo_tpu`` on the same numpy inputs, with
``assert_array_equal`` (tolerance 0: every value is an integer below 2^24
or one fixed IEEE operation). The route is forced with ``use_kernels``
(the CPU otherwise takes the plain path), and K2's calls are recorded, so
each case also shows which forms the card would launch.
"""

import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.config import StereoConfig as JCfg
from stereo_tpu.data import make_pair
from stereo_tpu.ops.sgm import sgm_aggregate as j_sgm
from stereo_tpu.pipeline.pipeline import compute_disparity as j_compute
from stereo_tpu.pipeline.pipeline import compute_patch_parts as j_parts
from stereo_tpu_torch import pipeline as tpipe
from stereo_tpu_torch.config import StereoConfig as TCfg
from stereo_tpu_torch.ops.sgm import PATH_STEPS

torch.set_num_threads(1)

#: Seconds a test here may take.
TIME_LIMIT = 120

SHAPE, D = (40, 96), 16


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"over this file's {TIME_LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def k2_calls(monkeypatch):
    """Forces the kernel route on CPU tensors and records each K2 call as
    (steps, has a mask)."""
    calls = []
    real = tpipe.sgm_paths

    def spy(cost, cfg, image=None, rect=None, steps=None, shear=None,
            mask=None):
        calls.append((None if steps is None else tuple(steps),
                      mask is not None))
        return real(cost, cfg, image=image, rect=rect, steps=steps,
                    shear=shear, mask=mask)

    monkeypatch.setattr(tpipe, "use_kernels", lambda cfg, device: True)
    monkeypatch.setattr(tpipe, "sgm_paths", spy)
    return calls


def _mask(seed, shape=SHAPE):
    """About 20% of the pixels off at random, and a disk-shaped hole."""
    rng = np.random.default_rng(seed)
    h, w = shape
    ys, xs = np.mgrid[:h, :w]
    hole = (ys - h / 2) ** 2 + (xs - w / 3) ** 2 < (h / 5) ** 2
    return (rng.random(shape) >= 0.2) & ~hole


def _t_moves(tree):
    """A hook that moves every tensor: a copy of each, transposed there
    and back (a strided view)."""
    return tuple(None if x is None else x.transpose(0, 1).clone()
                 .transpose(0, 1) for x in tree)


def _j_moves(tree):
    return tuple(None if x is None else jnp.swapaxes(
        jnp.swapaxes(x, 0, 1) + 0, 0, 1) for x in tree)


def _t_planes(vol):
    return vol.flip(2).clone().flip(2)


def _j_planes(vol):
    return vol[:, :, ::-1][:, :, ::-1]


def _cfgs(kw):
    return TCfg(num_disparities=D, **kw), JCfg(backend="jnp",
                                              num_disparities=D, **kw)


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


ADAPTIVE = dict(adaptive_p2=True, p2_min=20, adaptive_grad_floor=3)


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("hooks", [False, True])
def test_kernel_sum_masked_and_constrained(k2_calls, paths, adaptive, hooks):
    """``kernel_sum`` with a random mask, with and without hooks that move
    the tuple, equals the reference's ``sgm_aggregate``: one K2 mask-form
    call over every direction, or one per family of the composition."""
    kw = dict(num_paths=paths, **(ADAPTIVE if adaptive else {}))
    tcfg, jcfg = _cfgs(kw)
    rng = np.random.default_rng(paths + 2 * adaptive)
    cost = rng.integers(0, tcfg.max_unary_cost + 1,
                        size=(*SHAPE, D)).astype(np.int8)
    image = rng.integers(0, 256, size=SHAPE).astype(np.uint8)
    valid = _mask(paths)
    got = tpipe.kernel_sum(
        torch.from_numpy(cost), tcfg, torch.from_numpy(image),
        valid=torch.from_numpy(valid),
        constrain=(_t_moves, _t_moves) if hooks else None)
    want = j_sgm(jnp.asarray(cost, jnp.int32), jcfg, image=image,
                 valid=valid,
                 constrain=(_j_moves, _j_moves) if hooks else None)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.to(torch.int32).numpy(),
                                  np.asarray(want))
    families = 2 + (paths == 8) * 2 if hooks else 1
    assert len(k2_calls) == families and all(m for _, m in k2_calls)


@pytest.mark.parametrize("kw", [dict(), ADAPTIVE, dict(num_paths=4)],
                         ids=["fixed", "adaptive", "4paths"])
def test_compute_disparity_masked(k2_calls, kw):
    pair = make_pair(SHAPE, max_disp=12, kind="shapes", seed=5)
    tcfg, jcfg = _cfgs(kw)
    valid = _mask(5)
    got = tpipe.compute_disparity(torch.from_numpy(pair.left),
                                  torch.from_numpy(pair.right), tcfg,
                                  valid=torch.from_numpy(valid))
    _assert_same(got, j_compute(pair.left, pair.right, jcfg, valid=valid))
    assert k2_calls == [(tuple(PATH_STEPS[:tcfg.num_paths]), True)]


@pytest.mark.parametrize("call", ["hooks", "dplane", "lr_exact",
                                  "lr_exact_masked"])
def test_compute_disparity_constrained(k2_calls, call):
    """Hooks that move the tuple, the disparity-plane hook too, and
    ``lr_exact`` with hooks (the flipped pass takes the hooks and no
    mask)."""
    pair = make_pair(SHAPE, max_disp=12, kind="shapes", seed=6)
    kw = dict(lr_exact=True) if call.startswith("lr_exact") else {}
    tcfg, jcfg = _cfgs(kw)
    t_hooks, j_hooks = (_t_moves, _t_moves), (_j_moves, _j_moves)
    if call == "dplane":
        t_hooks, j_hooks = t_hooks + (_t_planes,), j_hooks + (_j_planes,)
    valid = _mask(6) if call == "lr_exact_masked" else None
    got = tpipe.compute_disparity(
        torch.from_numpy(pair.left), torch.from_numpy(pair.right), tcfg,
        valid=None if valid is None else torch.from_numpy(valid),
        constrain=t_hooks)
    _assert_same(got, j_compute(pair.left, pair.right, jcfg, valid=valid,
                                constrain=j_hooks))
    views = 2 if tcfg.lr_exact else 1
    assert len(k2_calls) == 4 * views and all(m for _, m in k2_calls)


def test_compute_disparity_mask_wins_over_rectangle(k2_calls):
    """A tile (``image_height``) with a mask: the mask is the paths'
    validity, as the reference builds the rectangle only without one."""
    pair = make_pair(SHAPE, max_disp=12, kind="shapes", seed=7)
    tcfg, jcfg = _cfgs({})
    valid = _mask(7)
    frame = dict(x_offset=-8, y_offset=4, image_width=80, image_height=30)
    got = tpipe.compute_disparity(torch.from_numpy(pair.left),
                                  torch.from_numpy(pair.right), tcfg,
                                  valid=torch.from_numpy(valid), **frame)
    _assert_same(got, j_compute(pair.left, pair.right, jcfg, valid=valid,
                                **frame))
    assert k2_calls == [(tuple(PATH_STEPS[:8]), True)]


def test_compute_patch_parts_masked(k2_calls):
    pair = make_pair(SHAPE, max_disp=12, kind="shapes", seed=8)
    tcfg, jcfg = _cfgs({})
    valid = _mask(8)
    f0, ctx = 40, 16
    left, right = pair.left[:, f0:], pair.right[:, f0 - ctx:]
    got = tpipe.compute_patch_parts(
        torch.from_numpy(np.ascontiguousarray(left)),
        torch.from_numpy(np.ascontiguousarray(right)), tcfg, x_offset=f0,
        image_width=SHAPE[1], right_context=ctx,
        valid=torch.from_numpy(np.ascontiguousarray(valid[:, f0:])))
    want = j_parts(left, right, jcfg, x_offset=f0, image_width=SHAPE[1],
                   right_context=ctx, valid=valid[:, f0:])
    _assert_same(got, want)
    assert k2_calls == [(tuple(PATH_STEPS[:8]), True)]
