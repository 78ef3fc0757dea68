"""The 144p rung of a 4K ladder (Lanczos3 3840x2160 -> 256x144 YUV420, the
benchmark's ``lanczos3_4k_to_256x144``) on the CPU.

At small sizes of the same 15:1 ratio on both axes (one of them odd), on
seeded frames with flat fields and hard edges among them: the benchmark's
plain NumPy reference equals the port's dense oracle ``numpy_ref`` byte for
byte; the port's ``YUV420Resizer`` equals the benchmark's reference, and so
do the NumPy models of the two kernels the rung takes (the wide-window kernel's luma,
the tiled kernel's px_scale 2 chroma); a byte changed in the port's output
fails the benchmark's comparison.  At the published size, without
resizing: luma takes ``wrap16_wide_s8`` (the wide-window kernel's s8 Y
form at TW 32), chroma ``wrap16_tiled`` at TW 32.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize as cr
from libiqo_tpu_torch.yuv import YUV420Resizer
from portbench import check
from portbench.reference import yuv420

from test_torch_tiled import _model as tiled_model
from test_torch_wide_kernel import wide_model, wide_s8_model

GEOMETRIES = [(960, 540, 64, 36), (480, 270, 32, 18), (495, 285, 33, 19)]


def _even(v: int) -> int:
    return (v + 1) & ~1


def frames(sw: int, sh: int, seed: int):
    """Seeded YUV420 frames of (sw, sh), chroma at half the evened size:
    random bytes, flat fields at 0, 255 and 128, a hard vertical and a
    hard horizontal edge between 0 and 255, a checkerboard of 3-pixel
    squares."""
    rng = np.random.default_rng(seed)
    shapes = ((sh, sw), (_even(sh) // 2, _even(sw) // 2), (_even(sh) // 2, _even(sw) // 2))

    def planes(make):
        return tuple(make(*s).astype(np.uint8) for s in shapes)
    yield planes(lambda h, w: rng.integers(0, 256, (h, w)))
    for level in (0, 255, 128):
        yield planes(lambda h, w: np.full((h, w), level))
    yield planes(lambda h, w: np.where(np.arange(w)[None, :] >= w // 3, 255, 0).repeat(h, 0))
    yield planes(lambda h, w: np.where(np.arange(h)[:, None] >= h // 2, 255, 0).repeat(w, 1))
    yield planes(lambda h, w: 255 * ((np.arange(h)[:, None] // 3 + np.arange(w)[None, :] // 3)
                                     % 2))


def ids(g):
    return "{}x{}-{}x{}".format(*g)


def test_the_sizes_keep_the_ratio():
    assert all(sw == 15 * dw and sh == 15 * dh for sw, sh, dw, dh in GEOMETRIES)
    assert any(v % 2 for g in GEOMETRIES for v in g)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=ids)
def test_reference_equals_the_dense_oracle(geometry):
    ref = yuv420.Frame("lanczos3", *geometry)
    r = YUV420Resizer("lanczos3", *geometry, device="cpu")
    plans = (r._luma.plan, r._chroma.plan, r._chroma.plan)
    assert ref.luma.y.taps == 90 and r._luma.plan.y.num_coefs == 90
    for planes in frames(*geometry[:2], seed=sum(geometry)):
        for got, plan, src in zip(ref(*planes), plans, planes):
            want = numpy_ref.resize_u8(plan, np.ascontiguousarray(src[:plan.y.n_src,
                                                                        :plan.x.n_src]))
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got[:want.shape[0], :want.shape[1]], want)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=ids)
def test_port_equals_the_reference(geometry):
    r = YUV420Resizer("lanczos3", *geometry, device="cpu")
    ref = yuv420.Frame("lanczos3", *geometry)
    batch = list(frames(*geometry[:2], seed=7 * sum(geometry)))
    outs = r.resize_batch(*(torch.from_numpy(np.stack(p)) for p in zip(*batch)))
    for k, planes in enumerate(batch):
        for got, want in zip(outs, ref(*planes)):
            np.testing.assert_array_equal(got[k].numpy(), want)


def test_the_kernels_models_equal_the_reference():
    """960x540 -> 64x36: luma on the wide-window kernel's s8 Y form at the
    published size's width and ring (at this size its 6 blocks a frame keep
    the route on the scalar form, WIDE_S8_MIN_BLOCKS) and on its scalar form
    with one Y slice, its px_scale 2 chroma on the tiled kernel, as at the
    published size."""
    luma = build_plan("lanczos", 960, 540, 64, 36, degree=3)
    chroma = build_plan("lanczos", 480, 270, 32, 18, degree=3, px_scale=2)
    lay, s8 = cr.wide_layout(luma), cr.wide_s8_form(luma, 32)
    assert not cr.tiled_ok(luma) and lay.ks == 1 and cr.tiled_ok(chroma)
    assert s8.stages == cr.wide_s8(build_plan("lanczos", 3840, 2160, 256, 144,
                                              degree=3)).stages
    ref = yuv420.Frame("lanczos3", 960, 540, 64, 36)
    for k, (y, u, v) in enumerate(frames(960, 540, seed=11)):
        want_y, want_u, _ = ref(y, u, v)
        np.testing.assert_array_equal(wide_s8_model(luma, s8, y, offset=5 * k, seed=k),
                                      want_y)
        np.testing.assert_array_equal(wide_model(luma, lay, y, align=16 if k % 2 else 1, seed=k),
                                      want_y)
        np.testing.assert_array_equal(tiled_model(chroma, u, seed=k), want_u)


def test_published_size_routes():
    r = YUV420Resizer("lanczos3", 3840, 2160, 256, 144, device="cpu")
    luma, chroma = r._luma.plan, r._chroma.plan
    assert (luma.y.num_coefs, luma.x.num_coefs, chroma.y.num_coefs) == (90, 90, 30)
    assert (chroma.x.n_src, chroma.y.n_src, chroma.x.n_dst, chroma.y.n_dst) == (1920, 1080,
                                                                                128, 72)
    lk, ck = cr.kernel_tables(luma), cr.kernel_tables(chroma)
    assert (cr.variant(lk), cr.variant(ck)) == ("wrap16_wide_s8", "wrap16_tiled")
    s8, lay = lk.layout, cr.wide_layout(luma)
    assert (s8.tw, s8.stages, s8.blocks) == (32, 5, 72)
    assert (lay.tc, lay.tr, lay.ks, lay.group, lay.blocks) == (32, 4, 1, 2, 288)  # scalar form
    assert ck.layout.tw == 32 == cr.tiled_layout(chroma).tw
    assert (cr.launch_form(lk), cr.launch_form(ck)) == ("wide.y_s8", "tiled.x_taps")


def test_a_changed_byte_fails_the_comparison():
    geometry = GEOMETRIES[0]
    ref = yuv420.Frame("lanczos3", *geometry)
    planes = next(frames(*geometry[:2], seed=3))
    out = YUV420Resizer("lanczos3", *geometry, device="cpu")._planes(*planes)
    jobs = [(planes, tuple(np.array(p) for p in out))]
    assert check.compare(ref, jobs) == {"max_lsb": 0, "frames": 1}
    jobs[0][1][1][5, 7] ^= 1
    numbers = check.compare(ref, jobs)
    assert numbers["max_lsb"] == 1 and not check.verdict(numbers)
