"""The JAX package's contract tests on the port: ``test_edge_cases.py``,
``test_properties.py`` and ``test_api_xla.py``'s grid, with the port's
facades on ``device="cpu"`` and every case held to the JAX package's result
(its ``numpy_ref`` or its XLA path) on inputs from a seeded NumPy
generator.
"""

import numpy as np
import pytest
import torch

from libiqo_tpu import AreaResizer as JaxAreaResizer
from libiqo_tpu import LanczosResizer as JaxLanczosResizer
from libiqo_tpu import LinearResizer as JaxLinearResizer
from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.golden import numpy_ref as jax_numpy_ref
from libiqo_tpu.yuv import YUV420Resizer as JaxYUV420Resizer
from libiqo_tpu_torch import AreaResizer, LanczosResizer, LinearResizer
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.utils.device import caps, describe
from libiqo_tpu_torch.yuv import YUV420Frame, YUV420Resizer, read_yuv420, write_yuv420

RNG = np.random.default_rng(55)
CPU = dict(device="cpu")


def _img(w, h):
    return RNG.integers(0, 256, (h, w), np.uint8)


def _jax_ref(algo, sw, sh, dw, dh, src, **kw):
    return jax_numpy_ref.resize_u8(jax_build_plan(algo, sw, sh, dw, dh, **kw), src)


# -- test_edge_cases.py -------------------------------------------------------

def test_multi_batch_dims():
    src = RNG.integers(0, 256, (2, 3, 48, 64), np.uint8)
    out = AreaResizer(64, 48, 32, 24, **CPU).resize(src)
    assert out.shape == (2, 3, 24, 32)
    np.testing.assert_array_equal(
        out, JaxAreaResizer(64, 48, 32, 24, backend="xla").resize(src))


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_one_pixel_dst(backend):
    src = np.full((64, 64), 200, np.uint8)
    out = AreaResizer(64, 64, 1, 1, backend=backend, **CPU).resize(src)
    assert out.shape == (1, 1) and out[0, 0] == 200
    np.testing.assert_array_equal(out, _jax_ref("area", 64, 64, 1, 1, src))


@pytest.mark.parametrize("algo", ["area", "linear"])
def test_one_pixel_src(algo):
    src = np.full((1, 1), 77, np.uint8)
    cls = AreaResizer if algo == "area" else LinearResizer
    out = cls(1, 1, 4, 4, **CPU).resize(src)
    assert (out == 77).all()
    np.testing.assert_array_equal(out, _jax_ref(algo, 1, 1, 4, 4, src))


@pytest.mark.parametrize("degree", [1, 9])
def test_degree_extremes(degree):
    src = _img(96, 64)
    out = LanczosResizer(degree, 96, 64, 48, 32, **CPU).resize(src)
    np.testing.assert_array_equal(
        out, JaxLanczosResizer(degree, 96, 64, 48, 32, backend="xla").resize(src))


def test_truncated_yuv_file(tmp_path):
    f = YUV420Frame(y=_img(16, 16), u=_img(8, 8), v=_img(8, 8))
    p = tmp_path / "t.yuv"
    write_yuv420(p, [f])
    data = p.read_bytes()
    p.write_bytes(data + data[: len(data) // 2])     # half a second frame
    frames = read_yuv420(str(p), 16, 16)
    assert len(frames) == 1
    np.testing.assert_array_equal(frames[0].u, f.u)


@pytest.mark.parametrize("args,kw", [
    (("lanczos", 64, 64, 32, 32), dict(degree=0)),
    (("lanczos", 64, 64, 32, 32), dict(degree=3, px_scale=0)),
    (("area", 64, -1, 32, 32), {}),
    (("area", 0, 4, 2, 2), {}),
    (("nearest", 4, 4, 2, 2), {}),
])
def test_bad_plan_params(args, kw):
    for build in (build_plan, jax_build_plan):
        with pytest.raises(ValueError):
            build(*args, **kw)


def test_plan_cache_key_distinct():
    plans = [build_plan("lanczos", 64, 64, 32, 32, degree=2),
             build_plan("lanczos", 64, 64, 32, 32, degree=3),
             build_plan("lanczos", 64, 64, 32, 32, degree=3, px_scale=2)]
    assert len({p.cache_key() for p in plans}) == 3


LINEAR_DST1 = [(8, 8, 1, 1), (8, 8, 2, 1), (8, 8, 1, 2), (16, 12, 1, 1), (7, 9, 1, 3),
               (640, 480, 1, 1), (2, 2, 1, 1), (1, 1, 1, 1), (3, 1, 1, 1), (9, 7, 2, 2)]


@pytest.mark.parametrize("sw,sh,dw,dh", LINEAR_DST1)
def test_linear_to_a_destination_of_one(sw, sh, dw, dh):
    """Linear to one output: the reference's second border loop wins and
    replicates the last source pixel (``test_linear_dst1_matches_reference``,
    which needs the reference build); the port == the JAX package."""
    src = _img(sw, sh)
    want = _jax_ref("linear", sw, sh, dw, dh, src)
    for backend in ("torch", "numpy"):
        np.testing.assert_array_equal(
            LinearResizer(sw, sh, dw, dh, backend=backend, **CPU).resize(src), want)


def test_yuv_odd_dimensions():
    """Odd YUV sizes: luma at its true size inside evened strides, the
    padding zero; chroma at the strides' halves, at px_scale 2."""
    iw, ih, ow, oh = 99, 77, 51, 41
    f = YUV420Frame(y=_img(iw + 1, ih + 1), u=_img((iw + 1) // 2, (ih + 1) // 2),
                    v=_img((iw + 1) // 2, (ih + 1) // 2))
    got = YUV420Resizer("lanczos3", iw, ih, ow, oh, **CPU).resize(f)
    want = JaxYUV420Resizer("lanczos3", iw, ih, ow, oh, backend="numpy").resize(f)
    assert got.y.shape == (oh + 1, ow + 1)
    assert (got.y[oh:, :] == 0).all() and (got.y[:, ow:] == 0).all()
    for p in "yuv":
        np.testing.assert_array_equal(getattr(got, p), np.asarray(getattr(want, p)))
    np.testing.assert_array_equal(got.y[:oh, :ow], numpy_ref.resize_u8(
        build_plan("lanczos", iw, ih, ow, oh, degree=3),
        np.ascontiguousarray(f.y[:ih, :iw])))


# -- test_properties.py ---------------------------------------------------------

def _resizers(backend):
    return [LanczosResizer(3, 160, 120, 67, 53, backend=backend, **CPU),
            AreaResizer(160, 120, 67, 53, backend=backend, **CPU),
            LinearResizer(160, 120, 67, 53, backend=backend, **CPU)]


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_flat_invariance(backend):
    for r in _resizers(backend):
        for val in (0, 128, 255):
            out = r.resize(np.full((120, 160), val, np.uint8))
            assert (out == val).all(), (type(r).__name__, backend, val)


@pytest.mark.parametrize("algo,kw", [("lanczos", dict(degree=3)), ("area", {}),
                                     ("linear", {})])
def test_identity_resize_is_identity(algo, kw):
    src = _img(64, 64)
    plan = build_plan(algo, 64, 64, 64, 64, **kw)
    np.testing.assert_array_equal(numpy_ref.resize_u8(plan, src), src)
    r = {"lanczos": lambda: LanczosResizer(3, 64, 64, 64, 64, **CPU),
         "area": lambda: AreaResizer(64, 64, 64, 64, **CPU),
         "linear": lambda: LinearResizer(64, 64, 64, 64, **CPU)}[algo]()
    np.testing.assert_array_equal(r.resize(src), src)


def test_area_energy_conservation_integer_ratio():
    src = _img(128, 128)
    out = AreaResizer(128, 128, 32, 32, **CPU).resize(src)
    assert abs(float(out.mean()) - float(src.mean())) < 1.0
    np.testing.assert_array_equal(out, _jax_ref("area", 128, 128, 32, 32, src))


def test_monotone_gradient_stays_monotone_linear():
    src = np.tile(np.arange(0, 200, dtype=np.uint8), (16, 1))
    out = LinearResizer(200, 16, 100, 8, **CPU).resize(src)
    assert (np.diff(out[4].astype(int)) >= 0).all()
    np.testing.assert_array_equal(out, _jax_ref("linear", 200, 16, 100, 8, src))


def test_device_caps():
    c = caps("cpu")
    assert c.num_devices >= 1 and c.platform == "cpu" and not c.is_gpu
    assert describe("cpu") == "cpu (no CUDA kernels)"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            caps("cuda")


def test_resolved_backend_consistency():
    """The JAX package names its routes "pallas"/"xla"; the port's CPU
    route is the plain path, its kernel routes need a card."""
    assert AreaResizer(64, 48, 32, 24, **CPU).resolved_backend() == "torch"
    assert AreaResizer(64, 48, 32, 24, backend="numpy", **CPU).resolved_backend() == "numpy"
    assert AreaResizer(64, 48, 32, 24, **CPU)._backend_for(torch.device("cuda")) == "cuda"


# -- test_api_xla.py's grid ----------------------------------------------------

# test_api_xla.GEOMETRIES without its two full-HD frames (the XLA path on the
# CPU is slow there; tests/test_api_xla.py runs them)
GEOMETRIES = [
    (640, 480, 320, 240),
    (100, 80, 99, 79),
    (97, 61, 31, 23),
    (64, 64, 64, 64),
    (64, 48, 64, 24),
    (64, 48, 32, 48),
    (321, 241, 123, 97),
    (16, 16, 3, 3),
]


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("degree,px_scale", [(2, 1), (3, 1), (3, 2)])
def test_lanczos_torch_equals_xla(geom, degree, px_scale):
    sw, sh, dw, dh = geom
    src = _img(sw, sh)
    got = LanczosResizer(degree, sw, sh, dw, dh, px_scale, **CPU).resize(src)
    xla = JaxLanczosResizer(degree, sw, sh, dw, dh, px_scale, backend="xla").resize(src)
    np.testing.assert_array_equal(got, np.asarray(xla))
    np.testing.assert_array_equal(got, numpy_ref.resize_u8(
        build_plan("lanczos", sw, sh, dw, dh, degree=degree, px_scale=px_scale), src))


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("algo", ["area", "linear"])
def test_area_linear_torch_equals_xla(geom, algo):
    sw, sh, dw, dh = geom
    src = _img(sw, sh)
    ours, theirs = {"area": (AreaResizer, JaxAreaResizer),
                    "linear": (LinearResizer, JaxLinearResizer)}[algo]
    got = ours(sw, sh, dw, dh, **CPU).resize(src)
    np.testing.assert_array_equal(got, np.asarray(theirs(sw, sh, dw, dh,
                                                         backend="xla").resize(src)))
    np.testing.assert_array_equal(got, numpy_ref.resize_u8(
        build_plan(algo, sw, sh, dw, dh), src))


def test_batched_matches_loop():
    batch = RNG.integers(0, 256, (5, 120, 160), np.uint8)
    r = LanczosResizer(3, 160, 120, 80, 60, **CPU)
    out = r.resize(batch)
    assert out.shape == (5, 60, 80)
    for i in range(5):
        np.testing.assert_array_equal(out[i], r.resize(batch[i]))
    np.testing.assert_array_equal(out, np.asarray(
        JaxLanczosResizer(3, 160, 120, 80, 60, backend="xla").resize(batch)))
    t = torch.from_numpy(batch)
    np.testing.assert_array_equal(r.resize(t).numpy(), out)


def test_input_validation():
    r = LinearResizer(64, 48, 32, 24, **CPU)
    with pytest.raises(ValueError):
        r.resize(np.zeros((47, 64), np.uint8))
    with pytest.raises(TypeError):
        r.resize(np.zeros((48, 64), np.float32))
    with pytest.raises(TypeError):
        r.resize(torch.zeros((48, 64), dtype=torch.int16))
    with pytest.raises(ValueError):
        LinearResizer(64, 48, 32, 24, backend="xla", **CPU)
    with pytest.raises(ValueError):
        LinearResizer(64, 48, 32, 24, precision="fast", **CPU)
