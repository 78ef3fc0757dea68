"""The benchmark's frozen reference equals the port's ``golden/numpy_ref``
byte for byte: planes of small Lanczos and Area geometries (down, up,
borders, px_scale 2 and 4, identity axes) on random, flat and hard-edged
sources, and whole YUV420 frames with the sample's rules (odd sizes evened,
Lanczos chroma at px_scale 2) against ``YUV420Resizer(backend="numpy")``.
The test imports the port; the reference does not."""

from __future__ import annotations

import numpy as np
import pytest

from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.yuv import YUV420Resizer
from portbench.reference import coeffs
from portbench.reference.yuv420 import Frame, plane, resize_plane

PLANES = [
    ("lanczos3", 97, 61, 31, 23, 1), ("lanczos3", 64, 48, 32, 24, 2),
    ("lanczos3", 40, 30, 97, 61, 1), ("lanczos3", 64, 64, 64, 64, 1),
    ("lanczos3", 120, 8, 60, 3, 1), ("lanczos2", 300, 7, 17, 5, 2),
    ("lanczos3", 96, 54, 24, 13, 4), ("lanczos4", 33, 47, 20, 47, 1),
    ("area", 90, 60, 30, 20, 1), ("area", 77, 50, 64, 50, 1),
    ("area", 100, 37, 7, 36, 1), ("area", 64, 36, 64, 12, 1),
]


def sources(h, w, rng):
    cols = np.arange(w)[None, :].repeat(h, 0)
    yield rng.integers(0, 256, (h, w), np.uint8)
    yield np.full((h, w), 255, np.uint8)
    yield np.where(cols >= w // 2, 255, 0).astype(np.uint8)
    yield np.where((np.arange(h)[:, None] + cols) % 2, 255, 0).astype(np.uint8)


@pytest.mark.parametrize("case", PLANES, ids=lambda c: "-".join(map(str, c)))
def test_plane_equals_numpy_ref(case):
    method, sw, sh, dw, dh, px = case
    algo = "area" if method == "area" else "lanczos"
    kw = {} if algo == "area" else {"degree": int(method[7:]), "px_scale": px}
    port = build_plan(algo, sw, sh, dw, dh, **kw)
    mine = plane(method, sw, sh, dw, dh, px)
    for axis, theirs in ((mine.y, port.y), (mine.x, port.x)):
        np.testing.assert_array_equal(axis.coef, theirs.coef)
        np.testing.assert_array_equal(axis.start, theirs.start)
        np.testing.assert_array_equal(axis.deno, theirs.deno)
        np.testing.assert_array_equal(axis.is_border, theirs.is_border)
    rng = np.random.default_rng(sw * 1000 + sh)
    for src in sources(sh, sw, rng):
        np.testing.assert_array_equal(resize_plane(mine, src), numpy_ref.resize_u8(port, src))


@pytest.mark.parametrize("geometry", [
    ("lanczos3", 96, 54, 48, 28), ("lanczos3", 97, 61, 31, 23),
    ("area", 90, 60, 30, 20), ("area", 61, 45, 20, 15), ("lanczos3", 40, 30, 80, 60),
], ids=lambda g: "-".join(map(str, g)))
def test_frame_equals_the_ports_yuv420_oracle(geometry):
    method, sw, sh, dw, dh = geometry
    rng = np.random.default_rng(7)
    ew, eh = (sw + 1) & ~1, (sh + 1) & ~1
    y = rng.integers(0, 256, (sh, sw), np.uint8)
    u, v = (rng.integers(0, 256, (eh // 2, ew // 2), np.uint8) for _ in range(2))
    want = YUV420Resizer(method, sw, sh, dw, dh, backend="numpy", device="cpu")._planes(y, u, v)
    got = Frame(method, sw, sh, dw, dh)(y, u, v)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_the_main_geometries_tables():
    f = Frame("lanczos3", 3840, 2160, 1920, 1080)
    assert (f.luma.y.taps, f.luma.x.taps, f.chroma.y.taps) == (12, 12, 4)
    assert f.luma.wrap16 and f.chroma.y.n_src == 1080
    a = Frame("area", 1920, 1080, 640, 360)
    assert (a.luma.y.taps, a.chroma.x.n_dst) == (3, 320) and not a.luma.wrap16


def test_trunc_div_is_cs():
    a = np.array([7, -7, 7, -7, 0])
    b = np.array([2, 2, -2, -2, 3])
    np.testing.assert_array_equal(coeffs.trunc_div(a, b), [3, -3, -3, 3, 0])


def test_unknown_method_refused():
    with pytest.raises(ValueError):
        plane("linear", 10, 10, 5, 5)
