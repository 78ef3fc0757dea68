"""The host side of the port's measurement and packaging modules
(``libiqo_tpu_torch/tools/bench*.py``, ``tile_sweep.py``,
``check_wheel.py``, and their protocol ``tools/_bench.py``).

Their constants equal the JAX scripts' (read with ``ast``, so no JAX script
runs); the guards and the byte counts are pure functions, tested at their
edges; without a card every module exits non-zero and prints no result;
the wheel gate's list of sources is the package's and the wheel's package
data covers it.  Whether there is a card is decided in a fixture.
"""

import ast
import json
import math
import tomllib
from pathlib import Path, PurePosixPath

import numpy as np
import pytest
import torch

from libiqo_tpu_torch import yuv
from libiqo_tpu_torch.experiments import _harness
from libiqo_tpu_torch.tools import (_bench, bench, bench_configs, bench_decomp,
                                    bench_fallback, bench_video64, check_wheel,
                                    card_check, tile_sweep, timer_ab)

ROOT = Path(__file__).resolve().parents[1]
MODULES = [bench, bench_configs, bench_video64, bench_fallback, bench_decomp, tile_sweep]


def _constants(path: Path) -> dict:
    """The module-level assignments of a script whose values are literals
    or ``dict(...)`` of literals, evaluated without running the script."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            names = ([target.id] if isinstance(target, ast.Name)
                     else [t.id for t in getattr(target, "elts", [])
                           if isinstance(t, ast.Name)])
            try:
                value = eval(compile(ast.Expression(node.value), str(path), "eval"),
                             {"__builtins__": {}, "dict": dict})
            except (NameError, TypeError, SyntaxError):
                continue
            if len(names) == 1:
                out[names[0]] = value
            elif isinstance(value, tuple) and len(value) == len(names):
                out.update(zip(names, value))
    return out


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_bench_constants_equal_bench_py():
    c = _constants(ROOT / "bench.py")
    assert bench.METRIC == c["_METRIC"]
    assert bench.BASELINE_LUMA_MPIX_S == c["BASELINE_LUMA_MPIX_S"] == 1222.0
    assert (bench.SRC_W, bench.SRC_H, bench.DST_W, bench.DST_H) == \
        (c["SRC_W"], c["SRC_H"], c["DST_W"], c["DST_H"])
    assert bench.BATCH == 16        # bench.py's batch on its chip


def test_configs_equal_bench_configs_py():
    c = _constants(ROOT / "scripts" / "bench_configs.py")
    assert bench_configs.CONFIGS == c["CONFIGS"]
    assert bench_configs.BASELINES == c["BASELINES"]


def test_video64_and_decomp_shapes_equal_the_scripts():
    v = _constants(ROOT / "scripts" / "bench_video64.py")
    d = _constants(ROOT / "scripts" / "bench_decomp.py")
    for mod, c in ((bench_video64, v), (bench_decomp, d)):
        assert (mod.SRC_W, mod.SRC_H, mod.DST_W, mod.DST_H) == \
            (c["SRC_W"], c["SRC_H"], c["DST_W"], c["DST_H"])
    assert bench_video64.FRAMES == 64
    assert bench_decomp.BATCHES[0] == d["BATCH"]


def test_fallback_cases_equal_bench_fallback_py():
    c = _constants(ROOT / "scripts" / "bench_fallback.py")
    assert bench_fallback.CASES == c["CASES"]
    assert [w[1:] for w in bench_fallback.WIDE] == card_check.WIDE_WINDOW


def test_tile_sweep_geoms_equal_tile_sweep_py():
    assert tile_sweep.GEOMS == _constants(ROOT / "scripts" / "tile_sweep.py")["GEOMS"]


@pytest.mark.parametrize("ms,with_sync,ok", [
    (1.0, 1.0, True),                 # the slope may equal the with-sync time
    (1.0, 1.0 - 1e-9, False),         # ... and not exceed it
    (0.0, 1.0, False), (-0.1, 1.0, False),
])
def test_guard_slope_against_with_sync(ms, with_sync, ok):
    assert (_bench.guards(ms, with_sync, 1e6) == []) is ok


def test_guard_bytes_envelope():
    ms = 1.0
    at = _bench.COPY_BYTES_PER_S * ms * 1e-3          # bytes at the envelope
    assert _bench.guards(ms, 2.0, math.nextafter(at, 0)) == []
    assert len(_bench.guards(ms, 2.0, at)) == 1
    assert len(_bench.guards(ms, 0.5, 2 * at)) == 2   # both guards fail
    assert _bench.COPY_BYTES_PER_S < _harness.HBM_BYTES_PER_S


def test_yuv_frame_bytes_and_bound():
    """15.55 MB a 4K -> 1080p YUV420 frame, 4.642 µs at 3.35 TB/s."""
    r = yuv.YUV420Resizer("lanczos3", 3840, 2160, 1920, 1080, device="cpu")
    assert _bench.yuv_bytes(r) == 3840 * 2160 * 3 // 2 + 1920 * 1080 * 3 // 2 == 15_552_000
    assert _bench.yuv_bytes(r, 16) == 16 * 15_552_000
    assert _bench.yuv_bytes(r) / _harness.HBM_BYTES_PER_S * 1e6 == \
        pytest.approx(4.642388059701492)
    assert _bench.plan_bytes(r._luma.plan) == 3840 * 2160 + 1920 * 1080


def test_oracle_rule():
    """numpy_ref on the 1280x720 sources and smaller, and on sources whose
    dense products are small (the fallback's 65536x16 plan)."""
    from libiqo_tpu_torch.core.plan import build_plan
    held = {k: _bench.oracle_ok(build_plan(*c[:5], **c[5]))
            for k, c in bench_configs.CONFIGS.items()}
    assert held == {"linear": True, "upsample": True, "area": False, "luma4k": False,
                    "chroma": False}
    assert _bench.oracle_ok(build_plan(*bench_fallback.CASES[0][1:6]))
    assert not _bench.oracle_ok(build_plan(*bench_fallback.CASES[1][1:6]))


def test_copies_differ_by_one_byte_and_pass_the_l2():
    a = torch.arange(6 * 1000, dtype=torch.uint8).reshape(6, 1000)
    b = torch.zeros(3, 500, dtype=torch.uint8) + 7
    xs = _bench.copies((a, b), min_bytes=20_000)
    assert len(xs) == math.ceil(20_000 / (a.numel() + b.numel())) == 3
    for i, (x, y) in enumerate(xs):
        assert x.view(-1)[0] == i and y.view(-1)[0] == i
        assert torch.equal(x.view(-1)[1:], a.view(-1)[1:])
        assert torch.equal(y.view(-1)[1:], b.view(-1)[1:])
    assert len(_bench.copies((a,), min_bytes=1)) == 2
    # past 256 copies the uint8 byte wraps instead of overflowing
    assert int(_harness.perturbed(a[:1], 300)[-1].view(-1)[0]) == 299 % 256


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_module_without_card_exits_nonzero(mod, no_card, capsys):
    with pytest.raises(SystemExit) as e:
        mod.main(["--quick"])
    assert e.value.code == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err
    assert not [ln for ln in out.out.splitlines() if ln.startswith("{")]


def test_timer_ab_needs_the_old_script(capsys):
    assert timer_ab.main([]) == 2
    assert timer_ab.main(["old_chip_smoke.py", "no_such_phase"]) == 2


def test_check_wheel_without_card_exits_nonzero(no_card, monkeypatch, tmp_path):
    """No card: the result says so with ok false and the exit code is 2
    (the wheel's own steps are stubbed here: they take a minute)."""
    seen = {}

    def stub(results, work):
        seen["work"] = work
        results["error"] = "no CUDA device: the card's half did not run"
        return False
    monkeypatch.setattr(check_wheel, "check", stub)
    out = tmp_path / "result.json"
    assert check_wheel.main(["--out", str(out)]) == 2
    res = json.loads(out.read_text())
    assert res["card"] is None and res["ok"] is False
    assert not seen["work"].exists()             # the scratch tree is removed


def test_committed_wheel_result():
    """Where the committed result exists: the wheel built, shipped every
    source, installed, and on an H100 built the kernels with nvcc from the
    installed sources under its cache, launched them and matched
    numpy_ref, on the CPU and on the card."""
    if not check_wheel.RESULT.exists():
        pytest.skip("no committed check_wheel_result.json")
    res = json.loads(check_wheel.RESULT.read_text())
    assert res["ok"] is True and "H100" in res["card"] and " W" in res["card"]
    assert res["sources_in_wheel"] == len(check_wheel.required_sources())
    for key in ("installed", "resize_cli_cpu_byte_exact", "kernels_built_from_wheel",
                "resize_cli_card_byte_exact", "benchmark_cli_runs"):
        assert res[key] is True, key
    build = res["card_build"]
    assert build["rc"] == 0 and build["library"] and build["built_here_s"] > 0
    assert build["build_dir"].startswith("<work>/cache/")
    assert "site-packages" in build["package"] and sum(build["launches"].values()) > 0


def _glob_match(path: str, pattern: str) -> bool:
    """setuptools' package-data glob: ``*`` stays inside one directory."""
    return (len(PurePosixPath(path).parts) == len(PurePosixPath(pattern).parts)
            and PurePosixPath(path).match(pattern))


def test_wheel_manifest_is_the_package_sources():
    pkg = ROOT / "libiqo_tpu_torch"
    want = sorted([str(p.relative_to(ROOT)) for p in (pkg / "csrc").rglob("*.cu")]
                  + [str(p.relative_to(ROOT)) for p in (pkg / "csrc").rglob("*.cuh")]
                  + ["libiqo_tpu_torch/native/iqo_tables.cpp"])
    assert check_wheel.required_sources() == want
    assert len(want) > 20
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    patterns = data["tool"]["setuptools"]["package-data"]
    for src in want:
        parts = src.split("/")
        covered = any(
            _glob_match("/".join(parts[len(pkg_name.split(".")):]), pat)
            for pkg_name, pats in patterns.items()
            if parts[:len(pkg_name.split("."))] == pkg_name.split(".")
            for pat in pats)
        assert covered, src


def test_seeded_planes_are_bench_py_s():
    y, u, v = _bench.seeded_planes((2, 8, 16))
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(y, rng.integers(0, 256, (2, 8, 16), np.uint8))
    np.testing.assert_array_equal(u, rng.integers(0, 256, (2, 4, 8), np.uint8))
    np.testing.assert_array_equal(v, rng.integers(0, 256, (2, 4, 8), np.uint8))
