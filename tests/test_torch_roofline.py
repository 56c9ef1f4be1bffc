"""The H100 roofline module on the CPU: K6's plain version against the
chain run step by step, the byte and operation models against the bounds
the GPU smoke script printed before they moved here, and the rule for the
measured anchor. Times, rates and fractions of the card come only from a
run on it; here the measuring entry points must refuse the CPU.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stereo_tpu_torch.config import KITTI_SGM8_128, KITTI_SGM8_128_QUALITY
from stereo_tpu_torch.eval import roofline
from stereo_tpu_torch.ops.cuda import alu_peak, launch_counts
from stereo_tpu_torch.ops.cuda.peak_kernel import PROGRAMS, alu_peak_plain

torch.set_num_threads(1)


def _chain(x: np.ndarray, k: int, chains: int) -> np.ndarray:
    """The anchor's chain step by step in the element type, as the kernel
    and the reference's Pallas body run it."""
    big = np.float32(3e38) if x.dtype == np.float32 else np.int32(1 << 30)
    seed = np.float32(0.25) if x.dtype == np.float32 else np.int32(1)
    one = x.dtype.type(1)
    accs = [x + x.dtype.type(c) * seed for c in range(chains)]
    for _ in range(k // chains):
        accs = [np.minimum(a + one, big) for a in accs]
    total = accs[0]
    for a in accs[1:]:
        total = total + a
    return total


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("k, chains", PROGRAMS)
def test_alu_peak_plain_is_the_chain(dtype, k, chains):
    """The closed form equals the step-by-step chain on inputs where each
    step is exact (quarter steps below 64), through the wrapper, which
    counts no launch on the CPU."""
    rng = np.random.default_rng(k + chains)
    x = rng.integers(0, 256, size=(7, 33)).astype(dtype)
    if dtype == np.float32:
        x = x / np.float32(4)
    before = launch_counts()
    got = alu_peak(torch.from_numpy(x), k, chains)
    assert launch_counts() == before
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), _chain(x, k, chains))


@pytest.mark.parametrize("dtype, top", [(np.float32, 3e38),
                                        (np.int32, (1 << 30) - 5)])
def test_alu_peak_plain_saturates(dtype, top):
    x = np.full((5,), top, dtype=dtype)
    got = alu_peak_plain(torch.from_numpy(x), 256, 4)
    np.testing.assert_array_equal(got.numpy(), _chain(x, 256, 4))


def test_alu_peak_matches_reference_body_in_interpret_mode():
    """The reference's anchor kernel (Pallas, interpret mode) computes the
    same float32 chain. The reference builds it inside its timing function
    and drops the output, so the body is repeated here from
    stereo_tpu/eval/roofline.py:141-151 and run on ones, its input."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    k, chains, rows = 256, 4, 8

    def kernel(x_ref, o_ref):
        x = x_ref[:]
        accs = [x + jnp.float32(i) * 0.25 for i in range(chains)]
        for _ in range(k // chains):
            accs = [jnp.minimum(a + 1.0, jnp.float32(3e38)) for a in accs]
        tot = accs[0]
        for a in accs[1:]:
            tot = tot + a
        o_ref[:] = tot

    x = np.ones((rows, 128), np.float32)
    want = pl.pallas_call(
        kernel, out_shape=jnp.zeros((rows, 128), jnp.float32),
        interpret=True)(x)
    got = alu_peak(torch.from_numpy(x), k, chains)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_alu_peak_rejects():
    with pytest.raises(ValueError, match="one of"):
        alu_peak(torch.ones(4), 100, 4)
    with pytest.raises(TypeError, match="float32 or int32"):
        alu_peak(torch.ones(4, dtype=torch.float64), 256, 4)


#: The bounds the GPU smoke script printed, to four decimals, when the
#: models still lived in it (one H100 at 700 W; PERF.md's kernel table);
#: K5's rows count its uint8 images and 8 operations per voxel.
@pytest.mark.parametrize(
    "model, want_ms, want_by",
    [
        (lambda: roofline.cost_bound(375, 1242, 128, 2, 5), 0.0200, "bytes"),
        (lambda: roofline.cost_bound(375, 1242, 128, 1, 2), 0.0189, "bytes"),
        (lambda: roofline.cost_bound(555, 900, 64, 2, 5), 0.0119, "bytes"),
        (lambda: roofline.sad_bound(288, 384, 16, (9, 9)), 0.0011,
         "bytes"),
        (lambda: roofline.sad_bound(160, 288, 128, (9, 9)), 0.0035,
         "bytes"),
        (lambda: roofline.paths_bound(
            SimpleNamespace(shape=(375, 1242, 128), element_size=lambda: 1),
            KITTI_SGM8_128), 0.0712, "operations"),
        (lambda: roofline.paths_bound(
            SimpleNamespace(shape=(375, 1242, 128), element_size=lambda: 1),
            KITTI_SGM8_128_QUALITY), 0.0712, "operations"),
        (lambda: roofline.paths_bound(
            SimpleNamespace(shape=(555, 900, 64), element_size=lambda: 1),
            KITTI_SGM8_128.replace(num_paths=4)), 0.0286, "bytes"),
        (lambda: roofline.paths_bound(
            SimpleNamespace(shape=(160, 288, 128), element_size=lambda: 2),
            KITTI_SGM8_128), 0.0070, "bytes"),
        (lambda: roofline.select_bound(375, 1242, 128), 0.0363, "bytes"),
        (lambda: roofline.select_bound(375, 1242, 128, emit_d0=True), 0.0368,
         "bytes"),
        (lambda: roofline.select_bound(375, 1242, 16), 0.0051, "bytes"),
        (lambda: roofline.median_bound(375, 1242), 0.0011, "bytes"),
        (lambda: roofline.median_bound(555, 900), 0.0012, "bytes"),
    ],
)
def test_models_give_the_bounds_printed_before_the_move(model, want_ms,
                                                        want_by):
    got = model()
    assert round(got["bound_ms"], 4) == want_ms
    assert got["bound_by"] == want_by
    assert got["library_ms"] is None


def test_bound_is_the_larger_of_bytes_and_operations():
    b = roofline.bound(3.35e9, 67e9)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = roofline.bound(3.35e9, 2 * 67e9)
    assert b["bound_ms"] == pytest.approx(2.0)
    assert b["bound_by"] == "operations"
    assert (b["nbytes"], b["operations"]) == (3.35e9, 2 * 67e9)


def test_context_and_spill_enter_the_byte_models():
    base = roofline.cost_bound(100, 200, 256, 2, 5)
    ctx = roofline.cost_bound(100, 200, 256, 2, 5, ctx=255)
    assert ctx["nbytes"] - base["nbytes"] == 100 * 255 * 2 * 4
    qr = roofline.select_bound(100, 200, 256, spill=256)
    assert qr["nbytes"] - roofline.select_bound(100, 200, 256)["nbytes"] == (
        100 * 200 * 9 + 100 * 256 * 4)
    assert roofline.peak_bound(1000, 256)["operations"] == 2 * 256 * 1000


@pytest.mark.parametrize(
    "window, rank, image_bytes, words",
    [((9, 7), False, 1, 2), ((5, 5), False, 1, 1), ((9, 7), True, 1, 1),
     ((7, 9), False, 4, 2), ((3, 3), True, 4, 1)])
def test_transform_bound_counts_image_in_and_words_out(window, rank,
                                                       image_bytes, words):
    """K1's transform stage: one image in, int32 words (or rank) out, a
    compare and a combine per off-centre neighbour."""
    b = roofline.transform_bound(375, 1242, window, rank, image_bytes)
    pixels = 375 * 1242
    assert b["nbytes"] == pixels * (image_bytes + 4 * words)
    assert b["operations"] == pixels * (window[0] * window[1] - 1) * 2
    assert b["library_ms"] is None
    assert b["bound_ms"] == pytest.approx(max(
        b["nbytes"] / 3.35e12, b["operations"] / 67e12) * 1e3)


def test_anchor_fraction_holds_operations_against_the_anchor():
    """The fraction of record uses the fixed rates; ``sol_fraction_anchor``
    holds the operations against the measured anchor instead, and equals
    the fraction of record where the bytes bind either way."""
    row = dict(roofline.bound(1e6, 67e9), ms=2.0)       # 1.0 ms of operations
    low = roofline.sol_fractions(row, 67e12 / 2)        # 2.0 ms at the anchor
    assert low["sol_fraction"] == 0.5
    assert low["sol_fraction_anchor"] == pytest.approx(1.0)
    by_bytes = dict(roofline.bound(3.35e9, 1e6), ms=4.0)
    assert roofline.sol_fractions(by_bytes, 30e12) == dict(
        sol_fraction=0.25, sol_fraction_anchor=0.25)
    # bytes bind at the fixed rate (1.0 ms), operations at the anchor (2.0 ms)
    flips = dict(roofline.bound(3.35e9, 60e9), ms=4.0)
    assert flips["bound_by"] == "bytes"
    assert roofline.sol_fractions(flips, 30e12) == dict(
        sol_fraction=0.25, sol_fraction_anchor=pytest.approx(0.5))


def test_anchor_programs_are_the_reference_set():
    """(rows, k, chains) as the reference's variants, and every (k, chains)
    has a kernel instantiation."""
    assert list(roofline.ANCHOR_PROGRAMS) == [(512, 256, 4), (256, 512, 4)]
    assert list(roofline.ANCHOR_SWEEP) == [(512, 256, 8), (512, 512, 8),
                                           (256, 256, 16), (512, 256, 2)]
    for _, k, chains in roofline.ANCHOR_PROGRAMS + roofline.ANCHOR_SWEEP:
        assert (k, chains) in PROGRAMS


@pytest.mark.parametrize("call", [
    lambda: roofline.measure_alu_peak("cpu"),
    lambda: roofline.per_kernel_report(KITTI_SGM8_128, (16, 64), "cpu"),
    lambda: roofline.main(["--device", "cpu"]),
], ids=["anchor", "report", "main"])
def test_measuring_refuses_the_cpu(call, capsys):
    """No device metric is taken on a CPU: the entry points raise."""
    with pytest.raises(RuntimeError, match="CUDA card"):
        call()
    assert "gops" not in capsys.readouterr().out


def test_report_covers_the_census_sgm_path_only():
    with pytest.raises(NotImplementedError, match="census"):
        roofline.per_kernel_report(KITTI_SGM8_128.replace(cost_fn="sad"),
                                   (16, 64), "cpu")
    assert json.dumps(roofline.bound(1, 1))  # rows are JSON-serialisable
