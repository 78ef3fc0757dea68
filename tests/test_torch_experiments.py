"""The H100 probes (``libiqo_tpu_torch/experiments``) against the TPU scripts
they port (``scripts/exp_dma_ceiling.py``, ``exp_int8_mxu.py``,
``exp_banded_dots.py``), on the CPU at small sizes.

Each script is loaded from ``scripts/`` with ``importlib``, its size
constants (``H``, ``W``, ``TH``, ``M``, ``K``, ``N``, ``STEPS``, ``GRID``) set
small, and its own Pallas kernels run in interpret mode (``pl.pallas_call``
patched with ``interpret=True`` inside each test only).  The same seeded
inputs go through the port's wrappers on CPU tensors, which run the plain
versions.  Tolerance 0: every result is an integer function of integer
inputs, and the float dots on both sides are exact, since every output's sum
of |terms| stays below 2^24 (the plain versions assert it).  Tests that need
the card are ``cuda``-marked and skip without one.
"""

from __future__ import annotations

import ast
import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import (_harness, exp_banded_dots,
                                          exp_dma_ceiling, exp_int8_mxu)
from libiqo_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
SMALL_H, SMALL_W, SMALL_TH = 16, 256, 8
MXU_SHAPE = dict(M=16, K=64, N=32, STEPS=3)
GRID = 2


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of this test in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def dma(monkeypatch, interpret):
    """exp_dma_ceiling at H x W = 16 x 256 (row tiles of 8), with main's
    nested kernels and expectations (``mix_call``, ``copy_call``,
    ``expect_mix``, ``expect_copy``) taken from its source."""
    mod = _script("exp_dma_ceiling")
    for k, v in (("H", SMALL_H), ("W", SMALL_W), ("TH", SMALL_TH)):
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(exp_dma_ceiling, "H", SMALL_H)
    monkeypatch.setattr(exp_dma_ceiling, "W", SMALL_W)
    main = next(n for n in ast.parse((ROOT / "scripts" / "exp_dma_ceiling.py")
                                     .read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    wanted = {"H4", "C", "mix_kernel", "mix_call", "expect_mix", "copy_kernel",
              "copy_call", "expect_copy"}
    body = [s for s in main.body
            if (isinstance(s, ast.FunctionDef) and s.name in wanted)
            or (isinstance(s, ast.Assign) and isinstance(s.targets[0], ast.Name)
                and s.targets[0].id in wanted)]
    assert len(body) == len(wanted)
    ns = dict(vars(mod))
    exec(compile(ast.Module(body=body, type_ignores=[]), "exp_dma_ceiling.py",
                 "exec"), ns)
    mod.nested = ns
    return mod


def _tpu(call, *args):
    return np.asarray(call(*args))


def _u8(rng, shape):
    return rng.integers(0, 256, shape, np.uint8)


def _i32(rng, shape):
    return rng.integers(-2**31, 2**31, shape, np.int64).astype(np.int32)


# ---- kernel A and B: exp_dma_ceiling ------------------------------------

@pytest.mark.parametrize("op, height", [
    ("inc_u8", 1), ("inc_u8", 4), ("inc_i32", 1), ("inc_i32", 4),
    ("mix_i32", 4), ("copy", 4)])       # the script's mix and copy run at 4 H
def test_stream_map_equals_script(dma, op, height):
    h = height * SMALL_H
    rng = np.random.default_rng(height)
    if op == "inc_u8":
        x, call = _u8(rng, (h, SMALL_W)), dma.make_inc(jnp.uint8, SMALL_W, h)
    elif op == "inc_i32":
        x = _i32(rng, (h, SMALL_W // 4))
        call = dma.make_inc(jnp.int32, SMALL_W // 4, h)
    elif op == "mix_i32":
        x, call = _i32(rng, (h, SMALL_W // 4)), dma.nested["mix_call"]
    else:
        x, call = _u8(rng, (h, SMALL_W)), dma.nested["copy_call"]
    got = exp_dma_ceiling.stream_map(torch.from_numpy(x), op)
    np.testing.assert_array_equal(got.numpy(), _tpu(call, x))


def test_stream_map_wraps_at_the_edges(dma):
    x8 = np.array([[0, 1, 254, 255] * (SMALL_W // 4)] * SMALL_H, np.uint8)
    got = exp_dma_ceiling.stream_map(torch.from_numpy(x8), "inc_u8")
    np.testing.assert_array_equal(got.numpy(),
                                  _tpu(dma.make_inc(jnp.uint8, SMALL_W, SMALL_H), x8))
    edges = np.array([-2**31, -1, 0, 2**31 - 1], np.int64).astype(np.int32)
    x32 = np.tile(edges, (4 * SMALL_H, SMALL_W // 16))
    for op, call in (("inc_i32", dma.make_inc(jnp.int32, SMALL_W // 4, 4 * SMALL_H)),
                     ("mix_i32", dma.nested["mix_call"])):
        got = exp_dma_ceiling.stream_map(torch.from_numpy(x32), op)
        np.testing.assert_array_equal(got.numpy(), _tpu(call, x32))


def test_readsum_equals_script(dma):
    x = _u8(np.random.default_rng(3), (SMALL_H, SMALL_W))
    got = exp_dma_ceiling.readsum(torch.from_numpy(x))
    assert got.shape == (SMALL_H, 128)
    np.testing.assert_array_equal(got.numpy(), _tpu(dma.make_readsum(), x))


@pytest.mark.parametrize("inner", [1, 32, 544])
@pytest.mark.parametrize("which", ["inc_u8", "inc_i32", "mix", "copy"])
def test_expectations_equal_script(dma, which, inner):
    rng = np.random.default_rng(inner)
    if which == "inc_u8":
        x0 = _u8(rng, (SMALL_H, SMALL_W))
        port, tpu = exp_dma_ceiling.expect_inc(torch.uint8), dma._expect_inc(np.uint8)
    elif which == "inc_i32":
        x0 = _i32(rng, (SMALL_H, SMALL_W // 4))
        port, tpu = exp_dma_ceiling.expect_inc(torch.int32), dma._expect_inc(np.int32)
    elif which == "mix":
        x0 = _i32(rng, (SMALL_H, SMALL_W // 4))
        port, tpu = exp_dma_ceiling.expect_mix, dma.nested["expect_mix"]
    else:
        x0 = _u8(rng, (SMALL_H, SMALL_W))
        port, tpu = exp_dma_ceiling.expect_copy, dma.nested["expect_copy"]
    assert port(x0, inner) == tpu(x0, inner)
    assert port(torch.from_numpy(x0), inner) == tpu(x0, inner)


@pytest.mark.parametrize("op, expect", [
    ("inc_u8", exp_dma_ceiling.expect_inc(torch.uint8)),
    ("inc_i32", exp_dma_ceiling.expect_inc(torch.int32)),
    ("mix_i32", exp_dma_ceiling.expect_mix),
    ("copy", exp_dma_ceiling.expect_copy)])
def test_chain_checksum_holds_on_cpu(op, expect):
    rng = np.random.default_rng(5)
    # 480 bytes: one u8 application more always moves the sum (480 is not
    # a multiple of 256)
    x0 = torch.from_numpy(_u8(rng, (8, 60)) if op in ("inc_u8", "copy")
                          else _i32(rng, (8, 16)))
    for inner in (0, 1, 7):
        fin = _harness.run_chain(
            lambda a, b: exp_dma_ceiling.stream_map(a, op, b), x0, inner)
        assert _harness.checksum(fin) == expect(x0, inner)
    # a chain that skips an application fails its checksum
    if op != "copy":
        x0 = x0.clone()
        x0.view(-1)[0] = 0
        short = _harness.run_chain(
            lambda a, b: exp_dma_ceiling.stream_map(a, op, b), x0, 6)
        assert _harness.checksum(short) != expect(x0, 7)


def test_checksum_views_the_sum_as_int32():
    assert _harness.checksum(torch.full((4,), 2**30, dtype=torch.int32)) == 0
    assert _harness.checksum(torch.tensor([2**31 - 1, 1], dtype=torch.int32)) == -2**31
    assert _harness.checksum(torch.tensor([255] * 3, dtype=torch.uint8)) == 765


# ---- kernel C: exp_int8_mxu ---------------------------------------------

@pytest.mark.parametrize("row", list(exp_int8_mxu.ROWS))
def test_mma_steps_equals_script(monkeypatch, interpret, row):
    mod = _script("exp_int8_mxu")
    for k, v in MXU_SHAPE.items():
        monkeypatch.setattr(mod, k, v)
        monkeypatch.setattr(exp_int8_mxu, k, v)
    in_dt, acc = exp_int8_mxu.ROWS[row]
    a, b = exp_int8_mxu.inputs(in_dt, "cpu")
    # the script's own draws (bench, :42-44)
    rng = np.random.default_rng(0)
    want_a = rng.integers(-100, 100, (MXU_SHAPE["STEPS"], MXU_SHAPE["M"], MXU_SHAPE["K"]))
    np.testing.assert_array_equal(a.float().numpy(), want_a)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.int8: jnp.int8}[in_dt]
    jacc = {torch.float32: jnp.float32, torch.int32: jnp.int32}[acc]
    ja, jb = (jnp.asarray(t.float().numpy(), dtype=jdt) for t in (a, b))
    want = _tpu(mod.make(jnp.dtype(jdt).name, jacc), ja, jb)
    got = exp_int8_mxu.mma_steps(a, exp_int8_mxu.k_major(b), acc)
    assert got.dtype == acc and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_mma_plain_refuses_inexact_inputs():
    a = torch.full((1, 64, 128), 0.5)
    bt = torch.ones((64, 128))
    with pytest.raises(ValueError, match="integer"):
        exp_int8_mxu.mma_steps_plain(a, bt, torch.float32)
    big = torch.full((1, 64, 1024), 2048.0, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="2\\^24"):
        exp_int8_mxu.mma_steps_plain(big, torch.full((64, 1024), 16.0,
                                                      dtype=torch.bfloat16),
                                     torch.float32)
    with pytest.raises(ValueError, match="TF32"):
        exp_int8_mxu.mma_steps_plain(torch.full((1, 64, 128), 4097.0), bt,
                                     torch.float32)


def test_mma_s8_sums_wrap_and_convert_like_the_card():
    a = torch.full((1, 64, 128), -128, dtype=torch.int8)
    bt = torch.full((64, 128), -128, dtype=torch.int8)
    s32 = exp_int8_mxu.mma_steps(a, bt, torch.int32)
    assert int(s32[0, 0, 0]) == 128 * 128 * 128
    f32 = exp_int8_mxu.mma_steps(a, bt, torch.float32)
    assert f32.dtype == torch.float32 and float(f32[0, 0, 0]) == 2.0**21
    with pytest.raises(ValueError, match="no mma_steps row"):
        exp_int8_mxu.mma_steps(a, bt, torch.float16)


def test_mma_bound_follows_the_issue_shapes():
    ms, by, nbytes, ops = exp_int8_mxu.bound(torch.bfloat16, torch.float32)
    assert (by, nbytes, ops) == ("bytes", 68157440, 2.0 * 64 * 256 * 1024 * 512)
    ms, by, nbytes, _ = exp_int8_mxu.bound(torch.int8, torch.int32)
    assert (by, nbytes) == ("bytes", 50855936)
    assert exp_int8_mxu.bound(torch.float32, torch.float32)[1] == "operations"


# ---- kernel D: exp_banded_dots ------------------------------------------

@pytest.fixture(scope="module")
def banded_inputs():
    return exp_banded_dots.inputs("cpu", GRID)


@pytest.mark.parametrize("ymode, xmode", exp_banded_dots.PAIRS,
                         ids=[f"{y}-{x}" for y, x in exp_banded_dots.PAIRS])
def test_banded_tile_equals_script(monkeypatch, interpret, banded_inputs, ymode, xmode):
    mod = _script("exp_banded_dots")
    monkeypatch.setattr(mod, "GRID", GRID)
    band, cy, cxs = banded_inputs
    # the script's own draws (bench, :117-122)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(band.numpy(), rng.integers(
        0, 256, (GRID, mod.BH, mod.BW), np.uint8))
    np.testing.assert_array_equal(cy.float().numpy(), rng.integers(
        -64, 64, (mod.TH, mod.BH)))
    jcy, *jcx = (jnp.asarray(t.float().numpy(), dtype=mod.BF) for t in (cy, *cxs))
    want = _tpu(mod.make(ymode, xmode), band.numpy(), jcy, *jcx)
    ops = exp_banded_dots.pack(cy, *cxs)
    got = exp_banded_dots.banded_tile(ops, band, ymode, xmode)
    assert got.shape == want.shape == (GRID, 160, 384)
    np.testing.assert_array_equal(got.numpy(), want)


def test_banded_modes_are_different_functions(banded_inputs):
    band, cy, cxs = banded_inputs
    ops = exp_banded_dots.pack(cy, *cxs)
    outs = {p: exp_banded_dots.banded_tile(ops, band, *p) for p in exp_banded_dots.PAIRS}
    assert not torch.equal(outs["mono", "mono"], outs["grouped", "grouped"])
    assert not torch.equal(outs["mono", "mono"], outs["mono", "grouped"])


def test_banded_plain_asserts_the_f32_bound(banded_inputs):
    band, _, _ = banded_inputs
    # w = 127 * 257 = 32639 on every work element: a = b = 127, a + b = 254,
    # so D2 sums 896 terms of 254 * 128, past 2^24
    cy = torch.zeros((160, 336))
    cy[:, :257] = 127
    worst = torch.full((896, 384), -128.0).to(torch.bfloat16)
    ops = exp_banded_dots.pack(cy.to(torch.bfloat16), worst, worst, worst)
    ones = torch.ones_like(band)
    with pytest.raises(ValueError, match="2\\^24"):
        exp_banded_dots.banded_tile(ops, ones, "mono", "mono")
    # the same coefficients on a zero band stay exact
    exp_banded_dots.banded_tile(ops, torch.zeros_like(band), "mono", "mono")


def test_banded_bounds_follow_the_issue():
    assert round(exp_banded_dots.macs("mono", "mono") / 1e9, 2) == 7.47
    assert round(exp_banded_dots.macs("grouped", "grouped") / 1e9, 2) == 2.96
    ms, by, nbytes, _ = exp_banded_dots.bound("mono", "mono")
    assert by == "operations" and round(ms * 1e3, 1) == 15.1
    assert nbytes == 35 * (336 * 896 + 160 * 384) + 160 * 336 * 2 + 3 * 896 * 384 * 2
    assert exp_banded_dots.bound("skip", "skip")[1] == "bytes"


# ---- the wrappers' devices, counts and entry points ----------------------

def test_wrappers_refuse_other_devices(banded_inputs):
    meta8 = torch.empty((16, 256), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        exp_dma_ceiling.stream_map(meta8, "inc_u8")
    with pytest.raises(ValueError, match="unsupported device"):
        exp_dma_ceiling.readsum(meta8)
    a = torch.empty((1, 64, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        exp_int8_mxu.mma_steps(a, torch.empty((64, 128), dtype=torch.int8,
                                              device="meta"), torch.int32)
    band, cy, cxs = banded_inputs
    with pytest.raises(ValueError, match="unsupported device"):
        exp_banded_dots.pack(*(t.to("meta") for t in (cy, *cxs)))
    ops = exp_banded_dots.pack(cy, *cxs)
    with pytest.raises(ValueError, match="several devices"):
        exp_banded_dots.banded_tile(ops, band.to("meta"), "mono", "mono")
    with pytest.raises(ValueError, match="several devices"):
        exp_dma_ceiling.stream_map(torch.zeros((4, 16), dtype=torch.uint8),
                                   "copy", torch.empty((4, 16), dtype=torch.uint8,
                                                       device="meta"))


def test_launches_stay_zero_on_cpu(banded_inputs):
    for mod in (exp_dma_ceiling, exp_int8_mxu, exp_banded_dots):
        mod.reset_launches()
    exp_dma_ceiling.stream_map(torch.zeros((4, 16), dtype=torch.uint8), "inc_u8")
    exp_dma_ceiling.readsum(torch.zeros((4, 128), dtype=torch.uint8))
    exp_int8_mxu.mma_steps(torch.zeros((1, 64, 128), dtype=torch.int8),
                           torch.zeros((64, 128), dtype=torch.int8), torch.int32)
    band, cy, cxs = banded_inputs
    exp_banded_dots.banded_tile(exp_banded_dots.pack(cy, *cxs), band, "skip", "skip")
    for mod in (exp_dma_ceiling, exp_int8_mxu, exp_banded_dots):
        assert mod.LAUNCHES.total() == 0


@pytest.mark.parametrize("mod", [exp_dma_ceiling, exp_int8_mxu, exp_banded_dots],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_raises_without_a_card(monkeypatch, mod):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


@pytest.mark.parametrize("name", ["exp_dma_ceiling", "exp_int8_mxu", "exp_banded_dots"])
def test_module_entry_point_fails_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", f"libiqo_tpu_torch.experiments.{name}"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_probe_library_is_built_apart_from_the_resize_library():
    assert [p.name for p in _build.exp_sources()] == [
        "exp_band.cu", "exp_band_ring.cu", "exp_banded.cu", "exp_banded_wgmma.cu", "exp_clamp.cu",
        "exp_colsum_walk.cu", "exp_mma.cu", "exp_mma_wgmma.cu",
        "exp_slice.cu", "exp_slice_wgmma.cu", "exp_stream.cu", "exp_vpu.cu", "exp_vpu_f32.cu",
        "exp_xpass.cu", "exp_xpass_gemm.cu", "exp_xpass_s8.cu"]
    assert not set(_build.exp_sources()) & set(_build.sources())
    assert [p.name for p in _build.sources()] == [
        "resize_fused.cu", "resize_tiled.cu", "resize_tiled_carry.cu",
        "resize_tiled_relaxed.cu", "resize_tiled_relaxed_carry.cu", "resize_wide.cu"]
    assert _build.exp_build_dir() != _build.build_dir()
    assert _build.exp_build_dir().parent == _build.build_dir().parent


def test_probe_library_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "exp_build_dir", lambda: tmp_path / "exp")
    monkeypatch.setattr(_build, "_exp_lib", None)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.load_experiments()
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _harness.lib()


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the probes' kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_probe_kernels_equal_plain_on_card(cuda_device):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_u8(rng, (64, 512))).to(cuda_device)
    x32 = torch.from_numpy(_i32(rng, (64, 128))).to(cuda_device)
    for op, v in (("inc_u8", x), ("inc_i32", x32), ("mix_i32", x32), ("copy", x)):
        assert torch.equal(exp_dma_ceiling.stream_map(v, op),
                           exp_dma_ceiling.stream_map_plain(v, op))
    assert torch.equal(exp_dma_ceiling.readsum(x), exp_dma_ceiling.readsum_plain(x))
    for in_dt, acc in exp_int8_mxu.ROWS.values():
        a = torch.from_numpy(rng.integers(-100, 100, (2, 64, 128)).astype(np.float32))
        b = torch.from_numpy(rng.integers(-100, 100, (128, 64)).astype(np.float32))
        a, bt = a.to(in_dt).to(cuda_device), exp_int8_mxu.k_major(b.to(in_dt)).to(cuda_device)
        assert torch.equal(exp_int8_mxu.mma_steps(a, bt, acc),
                           exp_int8_mxu.mma_steps_plain(a, bt, acc))
    band, cy, cxs = exp_banded_dots.inputs(cuda_device, GRID)
    ops = exp_banded_dots.pack(cy, *cxs)
    for y, xm in exp_banded_dots.PAIRS:
        assert torch.equal(exp_banded_dots.banded_tile(ops, band, y, xm),
                           exp_banded_dots.banded_tile_plain(ops, band, y, xm))
