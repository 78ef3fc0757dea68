"""The port's main path as a whole, on the CPU, against the JAX package.

``libiqo_tpu_torch.yuv.YUV420Resizer`` must give the bytes of
``libiqo_tpu.yuv.YUV420Resizer`` with ``backend="pallas"`` (interpret mode
on the CPU) and ``backend="xla"``, through ``resize`` and ``resize_batch``
(tolerance 0 LSB: the contract is byte-exact), for Lanczos, Area and
Linear.  Also: array types in and out, leading batch dimensions, backend
resolution, the device rules (the card by default), the resize CLI against
the JAX package's CLI, and the benchmark CLI's modes.
"""

import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import libiqo_tpu.yuv as jax_yuv
import libiqo_tpu_torch
from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import numpy_ref
from libiqo_tpu_torch import api, yuv
from libiqo_tpu_torch.cli import benchmark, resize_yuv420p
from libiqo_tpu_torch.ops import cuda_resize
from libiqo_tpu_torch.tools import profile_yuv

ROOT = Path(__file__).resolve().parents[1]
GEOMETRIES = [(256, 144, 128, 72), (255, 143, 127, 71)]   # even, odd


def _frames(seed, w, h, n):
    rng = np.random.default_rng(seed)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return [yuv.YUV420Frame(rng.integers(0, 256, (h + h % 2, w + w % 2), np.uint8),
                            rng.integers(0, 256, (ch, cw), np.uint8),
                            rng.integers(0, 256, (ch, cw), np.uint8))
            for _ in range(n)]


def _assert_planes(got, want, msg):
    for name, g, w in zip("yuv", got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{msg} plane {name}")


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_yuv_matches_jax(backend, geometry):
    sw, sh, dw, dh = geometry
    port = yuv.YUV420Resizer("lanczos3", sw, sh, dw, dh, device="cpu")
    ref = jax_yuv.YUV420Resizer("lanczos3", sw, sh, dw, dh, backend=backend)
    frames = _frames(sw + sh, sw, sh, 2)
    for i, f in enumerate(frames):
        o = port.resize(f)
        assert isinstance(o.y, np.ndarray)
        r = ref.resize(jax_yuv.YUV420Frame(f.y, f.u, f.v))
        _assert_planes((o.y, o.u, o.v), (r.y, r.u, r.v), f"resize frame {i}")
    batch = [np.stack([getattr(f, p) for f in frames]) for p in "yuv"]
    _assert_planes(port.resize_batch(*batch), ref.resize_batch(*batch),
                   "resize_batch")


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("method,geometry", [
    ("area", (97, 61, 40, 30)),           # odd, non-integer ratio
    ("area", (255, 143, 85, 47)),         # 3:1 with odd sizes
    ("linear", (65, 49, 130, 90)),        # upscale, odd source
    ("linear", (33, 25, 70, 41)),         # odd, up on both axes
], ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_area_linear_yuv_matches_jax(backend, method, geometry):
    sw, sh, dw, dh = geometry
    port = yuv.YUV420Resizer(method, sw, sh, dw, dh, device="cpu")
    assert port.resolved_backend() == "torch"
    ref = jax_yuv.YUV420Resizer(method, sw, sh, dw, dh, backend=backend)
    frames = _frames(sw * dh, sw, sh, 2)
    for i, f in enumerate(frames):
        o = port.resize(f)
        r = ref.resize(jax_yuv.YUV420Frame(f.y, f.u, f.v))
        _assert_planes((o.y, o.u, o.v), (r.y, r.u, r.v), f"{method} frame {i}")
    batch = [np.stack([getattr(f, p) for f in frames]) for p in "yuv"]
    _assert_planes(port.resize_batch(*batch), ref.resize_batch(*batch),
                   f"{method} resize_batch")


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_tensor_in_tensor_out(geometry):
    sw, sh, dw, dh = geometry
    r = yuv.YUV420Resizer("lanczos3", sw, sh, dw, dh, device="cpu")
    f = _frames(7, sw, sh, 1)[0]
    want = r.resize(f)
    got = r.resize(yuv.YUV420Frame(*(torch.from_numpy(p) for p in (f.y, f.u, f.v))))
    for g in (got.y, got.u, got.v):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
    _assert_planes((got.y, got.u, got.v), (want.y, want.u, want.v), "tensor")
    by, bu, bv = r.resize_batch(*(torch.from_numpy(p[None]) for p in (f.y, f.u, f.v)))
    assert isinstance(by, torch.Tensor)
    _assert_planes((by[0], bu[0], bv[0]), (want.y, want.u, want.v), "batch")


def test_leading_batch_dims():
    plan = build_plan("lanczos", 64, 48, 40, 30, degree=3)
    src = np.random.default_rng(9).integers(0, 256, (2, 3, 48, 64), np.uint8)
    r = api.Resizer.from_plan(plan, device="cpu")
    out = r.resize(src)
    assert out.shape == (2, 3, 30, 40)
    for idx in np.ndindex(2, 3):
        np.testing.assert_array_equal(out[idx], numpy_ref.resize_u8(plan, src[idx]))
    t = r.resize(torch.from_numpy(src))
    assert t.shape == (2, 3, 30, 40)
    np.testing.assert_array_equal(t.numpy(), out)


@pytest.mark.parametrize("factory", [
    lambda b, **kw: api.LanczosResizer(3, 70, 50, 35, 25, backend=b,
                                       device="cpu", **kw),
    lambda b, **kw: api.AreaResizer(70, 50, 35, 25, backend=b, device="cpu", **kw),
    lambda b, **kw: api.LinearResizer(70, 50, 35, 25, backend=b, device="cpu", **kw),
], ids=["lanczos", "area", "linear"])
def test_facades_all_backends(factory):
    """Exact, and relaxed through "torch" and "numpy" (and "auto", which on
    the CPU takes "torch"), give the oracle's bytes.  Relaxed through
    "cuda" runs the kernel's relaxed plain version: within 2 LSB of the
    oracle and equal to that version."""
    src = np.random.default_rng(4).integers(0, 256, (50, 70), np.uint8)
    want = numpy_ref.resize_u8(factory("numpy").plan, src)
    for backend in ("auto", "cuda", "torch", "numpy"):
        for precision in ("exact", "relaxed"):
            r = factory(backend, precision=precision)
            got = r.resize(src)
            msg = f"{backend} {precision}"
            if precision == "relaxed" and backend == "cuda":
                assert r.resolved_backend() == "cuda-relaxed", msg
                assert np.abs(got.astype(int) - want).max() <= 2, msg
                ops = cuda_resize.pack_operands(r.plan, "cpu", relaxed=True)
                plain = cuda_resize.resize_plain(ops, torch.from_numpy(src))
                np.testing.assert_array_equal(got, plain.numpy(), err_msg=msg)
            else:
                assert r.resolved_backend() != "cuda-relaxed", msg
                np.testing.assert_array_equal(got, want, err_msg=msg)


def test_resolved_backend():
    cpu = dict(device="cpu")
    assert api.LanczosResizer(3, 64, 48, 32, 24, **cpu).resolved_backend() == "torch"
    assert api.LanczosResizer(3, 64, 48, 32, 24, backend="cuda",
                              **cpu).resolved_backend() == "cuda"
    assert api.AreaResizer(64, 48, 32, 24, backend="cuda", **cpu).resolved_backend() == "cuda"
    assert api.LinearResizer(64, 48, 32, 24, backend="cuda",
                             **cpu).resolved_backend() == "cuda"
    # outside the kernel's shared-memory budget: the plain path
    assert api.AreaResizer(65536, 16, 16, 16, backend="cuda",
                           **cpu).resolved_backend() == "torch"
    assert api.LinearResizer(64, 48, 32, 24, backend="numpy",
                             **cpu).resolved_backend() == "numpy"
    assert yuv.YUV420Resizer("lanczos3", 64, 48, 32, 24, **cpu).resolved_backend() == "torch"
    assert yuv.YUV420Resizer("area", 64, 48, 32, 24, backend="cuda",
                             **cpu).resolved_backend() == "cuda"


def test_auto_on_cuda_takes_the_kernel_by_plan_alone(monkeypatch):
    """On a CUDA device ``auto`` picks by ``supports_plan`` only: with no
    nvcc the kernel path is still chosen (and raises when it cannot build)
    instead of running the plain path on the card."""
    monkeypatch.setattr("libiqo_tpu_torch.ops._build.find_nvcc", lambda: None)
    card = torch.device("cuda", 0)
    cpu = dict(device="cpu")
    assert api.LanczosResizer(3, 64, 48, 32, 24, **cpu)._backend_for(card) == "cuda"
    assert api.AreaResizer(64, 48, 32, 24, **cpu)._backend_for(card) == "cuda"
    assert api.LinearResizer(64, 48, 32, 24, **cpu)._backend_for(card) == "cuda"
    assert api.LanczosResizer(3, 64, 48, 32, 24, px_scale=3,
                              **cpu)._backend_for(card) == "cuda"
    assert api.AreaResizer(65536, 16, 16, 16, **cpu)._backend_for(card) == "torch"
    assert api.LanczosResizer(3, 64, 48, 32, 24, backend="torch",
                              **cpu)._backend_for(card) == "torch"


def test_profile_busy_union_counts_overlap_once():
    assert profile_yuv.union_length([]) == 0
    assert profile_yuv.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert profile_yuv.union_length([(4, 9), (0, 1), (2, 5)]) == 8


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.LanczosResizer(3, 64, 48, 32, 24, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yuv.YUV420Resizer("lanczos3", 64, 48, 32, 24, device="cuda")
    assert resize_yuv420p.main(["-m", "lanczos3", "-i", "in.yuv", "-iw", "64",
                                "-ih", "48", "-o", "out.yuv", "-ow", "32",
                                "-oh", "24"]) == 2


@pytest.mark.parametrize("factory", [
    lambda: api.LanczosResizer(3, 64, 48, 32, 24),
    lambda: api.AreaResizer(64, 48, 32, 24),
    lambda: api.LinearResizer(64, 48, 32, 24),
    lambda: api.Resizer(libiqo_tpu_torch.build_plan("area", 64, 48, 32, 24)),
    lambda: api.Resizer.from_plan(build_plan("linear", 64, 48, 32, 24)),
    lambda: yuv.YUV420Resizer("area", 64, 48, 32, 24),
], ids=["lanczos", "area", "linear", "resizer", "from_plan", "yuv420"])
def test_default_device_is_the_card(factory):
    """Without ``device=`` a resizer runs on the card; with no card,
    constructing one raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert factory().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory()


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        api.LanczosResizer(3, 64, 48, 32, 24, backend="xla", device="cpu")
    with pytest.raises(ValueError):
        api.LanczosResizer(3, 64, 48, 32, 24, precision="fast", device="cpu")
    r = api.LanczosResizer(3, 64, 48, 32, 24, device="cpu")
    with pytest.raises(ValueError):
        r.resize(np.zeros((48, 63), np.uint8))
    with pytest.raises(TypeError):
        r.resize(np.zeros((48, 64), np.int16))
    with pytest.raises(ValueError):
        yuv.YUV420Resizer("cubic", 64, 48, 32, 24, device="cpu")


def test_warmup_and_operand_cache():
    r = api.LanczosResizer(3, 96, 64, 48, 32, device="cpu")
    assert r.warmup() is r
    assert r.warmup_async(batch=2).result(timeout=60) is r
    ops = r._operands(r.device)
    again = api.LanczosResizer(3, 96, 64, 48, 32, device="cpu")
    assert again._operands(again.device) is ops      # shared, read-only
    api.clear_operand_cache()
    assert again._operands(again.device) is not ops


def test_version_matches_pyproject():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert libiqo_tpu_torch.__version__ == meta["project"]["version"]


def test_cli_matches_jax_cli(tmp_path):
    sw, sh, dw, dh = 65, 49, 33, 25
    frames = _frames(11, sw, sh, 2)
    src = tmp_path / "in.yuv"
    yuv.write_yuv420(src, frames)
    outs = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for pkg, extra in (("libiqo_tpu_torch", ["--device", "cpu"]),
                       ("libiqo_tpu", ["--backend", "xla"])):
        dst = tmp_path / f"{pkg}.yuv"
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli.resize_yuv420p", "-m", "lanczos3",
             "-i", str(src), "-iw", str(sw), "-ih", str(sh), "-o", str(dst),
             "-ow", str(dw), "-oh", str(dh), *extra],
            capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs[pkg] = dst.read_bytes()
    assert len(outs["libiqo_tpu_torch"]) == 2 * (34 * 26 + 2 * 17 * 13)
    assert outs["libiqo_tpu_torch"] == outs["libiqo_tpu"]
    got = yuv.read_yuv420(tmp_path / "libiqo_tpu_torch.yuv", dw, dh)
    want = yuv.YUV420Resizer("lanczos3", sw, sh, dw, dh, device="cpu").resize(frames[0])
    _assert_planes((got[0].y, got[0].u, got[0].v), (want.y, want.u, want.v), "cli")


BENCH_ARGS = ["-iw", "64", "-ih", "48", "-ow", "32", "-oh", "24",
              "--device", "cpu", "--cycles", "2"]


@pytest.mark.parametrize("mode,header", [
    ([], "benchmark (per-cycle construction)"),
    (["--amortized"], "benchmark (amortized)"),
    (["--batch", "2"], "benchmark (batched x2, 1 calls in flight)"),
    (["--oracle", "pil"], "benchmark (per-cycle construction)"),
    (["-m", "linear", "--amortized"], "benchmark (amortized)"),
    (["-m", "lanczos3", "--batch", "2"], "benchmark (batched x2, 1 calls in flight)"),
], ids=["default", "amortized", "batch", "oracle_pil", "linear", "lanczos3_batch"])
def test_benchmark_cli_modes(mode, header, capsys):
    assert benchmark.main(BENCH_ARGS + mode) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == ["    size: 32x24",
                         f"  method: {mode[1] if mode[:1] == ['-m'] else 'area'}"
                         "  backend: auto",
                         "  device: cpu (no CUDA kernels)"]
    assert header in lines
    assert "  backend: torch" in lines
    elapsed = [ln for ln in lines if ln.startswith("  elapsed time: ")]
    assert len(elapsed) == 1 and float(elapsed[0].split()[2]) > 0
    if "--batch" in mode:
        assert any(ln.startswith("  luma input: ") for ln in lines)
    else:
        assert "  cycles: 2" in lines
    if "--oracle" in mode:
        assert any(ln.startswith("  oracle PIL: ") for ln in lines)


def test_benchmark_cli_device_rules(capsys):
    """--stream measures host<->device copies and needs a card; the default
    --device cuda with no card is an error, never a CPU run."""
    assert benchmark.main(BENCH_ARGS + ["--stream", "4", "--batch", "2"]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert benchmark.main(["--cycles", "1"]) == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_benchmark_cli_profile(tmp_path, capsys):
    out = tmp_path / "prof"
    assert benchmark.main(BENCH_ARGS + ["--batch", "2", "--profile", str(out)]) == 0
    assert f"  profile: {out}" in capsys.readouterr().out.splitlines()
    assert (out / "trace.json").stat().st_size > 0


def test_benchmark_entry_point_in_pyproject():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert (meta["project"]["scripts"]["iqo-tpu-torch-benchmark"]
            == "libiqo_tpu_torch.cli.benchmark:main")
    data = meta["tool"]["setuptools"]["package-data"]
    assert "*.cpp" in data["libiqo_tpu_torch.native"]
