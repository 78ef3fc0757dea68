"""The X-pass probes (``libiqo_tpu_torch/experiments/exp_x_schemes``,
``exp_vpu_xpass``, ``exp_vpu_rate``, ``exp_slice_align``) against the TPU
scripts they port, on the CPU.

Each script is loaded from ``scripts/`` with ``importlib``, its repeat or
step count set small (``exp_x_schemes.R`` 2, ``exp_vpu_xpass.R`` 2,
``exp_vpu_rate.STEPS`` 2, ``exp_slice_align.GRID`` 2; nothing is derived
from them, and the work tiles, coefficient planes and the 15 groups keep
their full sizes), and its own Pallas kernels run in interpret mode
(``pl.pallas_call`` patched with ``interpret=True`` inside each test only).
The same inputs go through the port's wrappers on CPU tensors, which run the
plain versions.  Tolerance 0 for every integer variant, ``f32_2dot``,
``dense4``, ``corr_f32``, ``vpu_rate`` and ``slice_align``; ``bf16_1dot`` and
``muls_f32`` are held within the stated f32 rounding bounds
(``exp_x_schemes.bf16_bound``, ``exp_vpu_xpass.f32_bound``): XLA does not
sum them in the order the plain versions take.  Tests that need the card are
``cuda``-marked and skip without one.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import (exp_slice_align, exp_vpu_rate, exp_vpu_xpass,
                                          exp_x_schemes)

ROOT = Path(__file__).resolve().parent.parent
NEW_MODULES = (exp_x_schemes, exp_vpu_xpass, exp_vpu_rate, exp_slice_align)
REPS = 2


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of this test in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _script(name: str, monkeypatch=None, **constants):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in constants.items():
        monkeypatch.setattr(mod, k, v)
    return mod


@pytest.fixture(scope="module")
def xs_inputs():
    return exp_x_schemes.inputs("cpu")


@pytest.fixture(scope="module")
def vx_ops():
    return exp_vpu_xpass.operands("cpu")


# ---- kernel I: exp_x_schemes ----------------------------------------------

def _script_x_scheme(mod, variant):
    cv = mod.build_cvals(variant)
    call, names = mod.make(variant, cv)
    args = [jnp.asarray(mod.W16)]
    for n in names:
        args.extend(cv[n])
    return np.asarray(call(*args))


@pytest.mark.parametrize("variant", exp_x_schemes.VARIANTS)
def test_x_scheme_equals_script(monkeypatch, interpret, xs_inputs, variant):
    mod = _script("exp_x_schemes", monkeypatch, R=REPS)
    w, c = xs_inputs
    cvals = exp_x_schemes.build_cvals(variant, c)
    got = exp_x_schemes.x_scheme(variant, w, cvals, REPS)
    want = _script_x_scheme(mod, variant)
    assert got.dtype == torch.int32 and got.shape == want.shape == (160, 384)
    if variant == "bf16_1dot":
        err = np.abs(got.numpy().astype(np.int64) - want)
        bound = exp_x_schemes.bf16_bound(w, cvals, REPS).numpy()
        assert err.max() > 0 and (err <= bound).all()
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_x_scheme_inputs_reproduce_the_script(xs_inputs):
    mod = _script("exp_x_schemes")
    w, c = xs_inputs
    np.testing.assert_array_equal(w.numpy(), mod.W16)
    np.testing.assert_array_equal(c.numpy(), mod.C)
    np.testing.assert_array_equal(exp_x_schemes.gold(w, c).numpy(), mod.gold())
    for variant in exp_x_schemes.VARIANTS:
        theirs = mod.build_cvals(variant)
        ours = exp_x_schemes.build_cvals(variant, c)
        for name, planes in theirs.items():
            want = np.stack([np.asarray(p.astype(jnp.float32) if p.dtype == jnp.bfloat16 else p)
                             for p in planes])
            np.testing.assert_array_equal(ours[name].to(torch.float32).numpy()
                                          if ours[name].dtype == torch.bfloat16
                                          else ours[name].numpy(), want)


def test_x_scheme_checks_equal_the_scripts(interpret, xs_inputs, capsys):
    """``check_f32_exact``, ``check_s16_exact`` and ``check_bf16_error``, one
    application each: the port's answers equal the scripts' printed ones."""
    mod = _script("exp_x_schemes")
    mod.check_f32_exact()
    mod.check_s16_exact()
    mod.check_bf16_error()
    out = capsys.readouterr().out
    w, c = xs_inputs
    want = exp_x_schemes.gold(w, c)
    for variant in ("f32_2dot", "s16_1dot"):
        ok = torch.equal(exp_x_schemes.x_scheme(variant, w, exp_x_schemes.build_cvals(variant, c),
                                                1), want)
        assert ok and f"{variant} exact vs numpy i32-wrap: {ok}" in out
    cv = exp_x_schemes.build_cvals("bf16_1dot", c)
    mx, mean = exp_x_schemes.lsb_error(exp_x_schemes.x_scheme("bf16_1dot", w, cv, 1), want)
    theirs = float(re.search(r"bf16_1dot max err: ([0-9.]+) LSB", out).group(1))
    slack = float(exp_x_schemes.bf16_bound(w, cv, 1).max()) / exp_x_schemes.LSB
    assert abs(mx - theirs) <= slack + 1e-3
    assert 2.0 < mx < 2.3 and 0.3 < mean < 0.4       # not the docstring's ~1.5 LSB


@pytest.mark.parametrize("variant", ["s8_4dot", "s8_2dot_cat"])
def test_s8_variants_are_not_the_banded_product(xs_inputs, variant):
    """The script's zero ``corr`` leaves the wrapped low byte and the -128
    rebase uncorrected, so its s8 variants differ from ``gold`` (on both sides
    alike: the port holds them to the script's formula)."""
    w, c = xs_inputs
    got = exp_x_schemes.x_scheme(variant, w, exp_x_schemes.build_cvals(variant, c), 1)
    assert not torch.equal(got, exp_x_schemes.gold(w, c))
    assert torch.equal(got, exp_x_schemes.x_scheme(
        "s8_4dot", w, exp_x_schemes.build_cvals("s8_4dot", c), 1))


def test_x_scheme_repeats_perturb_the_work_values(xs_inputs):
    """reps = 2 is body(w) + body(w + 1), wrapped: the repeat is not
    hoisted out of the sum."""
    w, c = xs_inputs
    cv = exp_x_schemes.build_cvals("s16_1dot", c)
    two = exp_x_schemes.x_scheme("s16_1dot", w, cv, 2).to(torch.int64)
    parts = [exp_x_schemes.gold(w + r, c).to(torch.int64) for r in (0, 1)]
    assert torch.equal(two, ((parts[0] + parts[1] + 2**31) % 2**32) - 2**31)


# ---- kernel J: exp_vpu_xpass ----------------------------------------------

@pytest.mark.parametrize("variant", exp_vpu_xpass.VARIANTS)
def test_vpu_xpass_equals_script(monkeypatch, interpret, vx_ops, variant):
    mod = _script("exp_vpu_xpass", monkeypatch, R=REPS)
    args = (jnp.asarray(mod.W_E), jnp.asarray(mod.W_O), jnp.asarray(mod.W_DENSE),
            jnp.asarray(mod.CX_HI, jnp.bfloat16), jnp.asarray(mod.CX_LO, jnp.bfloat16))
    want = np.asarray(mod.make(variant)(*args))
    got = exp_vpu_xpass.vpu_xpass(variant, vx_ops, REPS)
    assert got.dtype == torch.int32 and got.shape == want.shape == (160, 384)
    if variant == "muls_f32":
        err = np.abs(got.numpy().astype(np.int64) - want)
        assert (err <= exp_vpu_xpass.f32_bound(vx_ops, REPS).numpy()).all()
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_vpu_xpass_operands_reproduce_the_script(vx_ops):
    mod = _script("exp_vpu_xpass")
    for ours, theirs in ((vx_ops.we, mod.W_E), (vx_ops.wo, mod.W_O), (vx_ops.wd, mod.W_DENSE),
                         (vx_ops.cxh, mod.CX_HI), (vx_ops.cxl, mod.CX_LO)):
        np.testing.assert_array_equal(ours.to(torch.float64).numpy(), theirs)
    assert list(vx_ops.taps) == mod.C
    assert torch.equal(vx_ops.cxt[1], vx_ops.cxl.t())


def test_corr_i32_check_exact(interpret, vx_ops, capsys):
    mod = _script("exp_vpu_xpass")
    mod.check_exact()
    assert "corr_i32 exact vs numpy: True" in capsys.readouterr().out
    got = exp_vpu_xpass.vpu_xpass("corr_i32", vx_ops, 1)
    np.testing.assert_array_equal(got.numpy(), mod.gold_corr(mod.W_E, mod.W_O))
    assert torch.equal(got, exp_vpu_xpass.gold_corr(vx_ops.we, vx_ops.wo, vx_ops.taps))
    assert exp_vpu_xpass.check_exact(vx_ops)


def test_muls_f32_saturates(vx_ops):
    """One application of ``muls_f32`` passes 2^31 on 1.8 % of the outputs;
    the conversion saturates there, as XLA's does."""
    conv = exp_vpu_xpass.f32_to_i32(torch.tensor([3e9, -3e9, float("nan"), 1.9, -1.9, 2.0**31]))
    assert conv.tolist() == [2**31 - 1, -2**31, 0, 1, -1, 2**31 - 1]
    exact = sum(vx_ops.taps[2 * k] * vx_ops.we[:, :384].to(torch.float64) +
                vx_ops.taps[2 * k + 1] * vx_ops.wo[:, :384].to(torch.float64) for k in range(6))
    over = exact.abs() >= 2**31
    assert 1000 < int(over.sum()) < 1200
    got = exp_vpu_xpass.vpu_xpass("muls_f32", vx_ops, 1).to(torch.int64)
    assert torch.equal(got[over], torch.where(exact[over] > 0, 2**31 - 1, -2**31).to(torch.int64))


def test_dense4_sums_stay_below_2_24(vx_ops):
    """At every repeat r < 24, the largest sum of |products| of dense4's four
    dots is 16,540,189, 1.4 % under 2^24: its f32 sums are exact in any order."""
    worst = 0.0
    for r in range(exp_vpu_xpass.R):
        wd = vx_ops.wd.to(torch.int64) + r
        for plane in ((wd >> 8).abs(), wd & 255):
            for cc in (vx_ops.cxh, vx_ops.cxl):
                worst = max(worst, float(torch.matmul(plane.to(torch.float64),
                                                      cc.to(torch.float64).abs()).max()))
    assert worst == 16_540_189 < 2**24


# ---- kernel K: exp_vpu_rate -----------------------------------------------

@pytest.mark.parametrize("p", exp_vpu_rate.PS)
@pytest.mark.parametrize("mix", exp_vpu_rate.MIXES)
def test_op_mix_equals_script(monkeypatch, interpret, mix, p):
    mod = _script("exp_vpu_rate", monkeypatch, STEPS=2)
    monkeypatch.setattr(exp_vpu_rate, "STEPS", 2)
    src = exp_vpu_rate.inputs("cpu")
    assert tuple(src.shape) == (2 * 96, 1920)
    want = np.asarray(mod.build(mix, p)(src.numpy()))
    got = exp_vpu_rate.op_mix(src, mix, p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_op_mix_inputs_reproduce_the_script():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(exp_vpu_rate.inputs("cpu").numpy(),
                                  rng.integers(-2**20, 2**20, (12 * 96, 1920)).astype(np.int32))


def test_op_mix_wraps():
    """``mad`` wraps in int32 and ``split``'s ``v * 65536`` too."""
    v = torch.tensor([[2**31 - 1] * 1920], dtype=torch.int32)
    want = ((2**31 - 1) * 3 + 7 + 2**31) % 2**32 - 2**31
    assert int(exp_vpu_rate.op_mix(v, "mad", 1)[0, 0]) == want
    assert int(exp_vpu_rate.op_mix(v, "split", 1)[0, 0]) == (-1) ^ 127


# ---- kernel L: exp_slice_align --------------------------------------------

@pytest.fixture(scope="module")
def slice_inputs():
    return exp_slice_align.inputs("cpu", grid=2)


@pytest.mark.parametrize("config", exp_slice_align.CONFIGS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_slice_groups_equals_script(monkeypatch, interpret, slice_inputs, config):
    mod = _script("exp_slice_align", monkeypatch, GRID=2)
    w, ops = slice_inputs
    want = np.asarray(mod.make(*config)(jnp.asarray(w.numpy()),
                                        *(jnp.asarray(c.to(torch.float32).numpy(), jnp.bfloat16)
                                          for c in ops.c)))
    got = exp_slice_align.slice_groups(w, ops, *config)
    assert got.dtype == torch.uint8 and got.shape == want.shape == (2, 32, 1920)
    np.testing.assert_array_equal(got.numpy(), want)


def test_slice_inputs_reproduce_the_script(slice_inputs):
    w, ops = slice_inputs
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(w.numpy(), rng.integers(-30000, 30000, (2, 32, 3840))
                                  .astype(np.int16))
    for c in ops.c:
        np.testing.assert_array_equal(c.to(torch.float32).numpy(),
                                      rng.integers(-100, 100, (3840, 1920)).astype(np.float32))
    assert torch.equal(ops.ct[2], ops.c[2].t())


def test_slice_check_mode_gives_the_sums(slice_inputs):
    """The check mode's int32 ``s`` rounds and clips to the u8 output, which
    is 94 % saturated: only ~6 % of pixels land in 1..254."""
    w, ops = slice_inputs
    s = exp_slice_align.slice_groups(w, ops, 128, 512, check=True)
    u8 = exp_slice_align.slice_groups(w, ops, 128, 512)
    assert s.dtype == torch.int32
    s64 = s.to(torch.int64)
    rounded = ((s64 + 2**19 + 2**31) % 2**32 - 2**31) >> 20
    assert torch.equal(rounded.clamp(0, 255).to(torch.uint8), u8)
    inside = float(((u8 > 0) & (u8 < 255)).to(torch.float64).mean())
    assert 0.05 < inside < 0.08


def test_slice_groups_windows():
    assert exp_slice_align.groups(128, 512)[:3] == [(0, 0), (128, 128), (256, 384)]
    assert exp_slice_align.groups(128, 512)[-1] == (1792, 3328)       # clamped to 3840 - 512
    assert exp_slice_align.groups(64, 384)[1] == (128, 192)
    assert exp_slice_align.groups(32, 384)[1] == (128, 224)
    assert all(k0 % 8 == 0 for al, kl in exp_slice_align.CONFIGS
               for _, k0 in exp_slice_align.groups(al, kl))


# ---- bounds, devices, counts, entry points --------------------------------

def test_bounds_of_each_probe():
    _, by, app_us, _ = exp_x_schemes.bound("s8_4dot")
    assert round(app_us, 3) == 0.095 and by == "operations"
    assert round(exp_x_schemes.bound("bf16_1dot")[2], 3) == 0.048
    assert round(exp_x_schemes.bound("f32_2dot")[2], 2) == 1.41
    assert round(exp_x_schemes.bound("s16_1dot")[2], 2) == 1.41
    assert exp_x_schemes.macs("s8_2dot_cat") == (94_371_840, "int8")
    ms, by, app_us, _ = exp_vpu_xpass.bound("dense4")
    assert round(app_us, 2) == 0.45 and by == "operations"
    assert round(exp_vpu_xpass.bound("corr_i32")[2], 3) == 0.044
    ms, by, nbytes, ops = exp_vpu_rate.bound("mad", 1)
    assert by == "bytes" and nbytes == 2 * 4 * 1152 * 1920 and round(ms * 1e3, 1) == 5.3
    ms, by, _, ops = exp_vpu_rate.bound("epi", 8)
    assert by == "operations" and ops == 141_557_760 and round(ms * 1e3, 1) == 8.5
    ms, by, nbytes, macs = exp_slice_align.bound(512)
    assert by == "operations" and round(ms * 1e3, 1) == 6.5 and round(macs / 1e9, 2) == 3.21
    assert nbytes == 8_355_840 + 5_898_240 + 2_088_960
    ms, by, _, macs = exp_slice_align.bound(384)
    assert round(ms * 1e3, 1) == 4.9 and round(macs / 1e9, 2) == 2.41
    assert exp_slice_align.issued_bytes(512) == 15 * 2 * 34 * 32 * 512 * 2 + 270 * 3 * 64 * 512 * 2


def test_op_mix_bound_counts_the_cards_instructions():
    # 5.57 SASS instructions per element and repeat (epi, P = 8) at 64 a clock
    # per SM: 5.9 us of operations, above the 5.28 us of bytes
    ms, by, _, ops = exp_vpu_rate.bound("epi", 8, per_rep=39 / 7)
    assert by == "operations" and round(ms * 1e3, 1) == 5.9
    assert ops == 39 / 7 * 8 * 1152 * 1920
    # mad at 1.57 a repeat stays under its bytes at every P
    assert all(exp_vpu_rate.bound("mad", p, per_rep=11 / 7)[1] == "bytes"
               for p in exp_vpu_rate.PS)


@pytest.mark.parametrize("first, second, bound_by, why", [
    # mad in one chip run: its repeats lie under its bytes
    ({1: 7.172e-3, 8: 7.276e-3}, {1: 7.180e-3, 8: 7.352e-3}, "bytes",
     "P=1 bound by bytes: the slope is the cost above the byte time"),
    ({1: 7.068e-3, 8: 7.284e-3}, {1: 7.300e-3, 8: 7.290e-3}, "operations",
     "t(8) - t(1) within the runs' spread"),
    ({1: 7.052e-3, 8: 7.048e-3}, {1: 7.060e-3, 8: 7.070e-3}, "operations",
     "t(8) - t(1) within the runs' spread"),                    # below zero
    ({1: 7.176e-3, 8: 9.300e-3}, {1: 7.180e-3, 8: 9.224e-3}, "operations", None),
])
def test_op_mix_slope_is_a_rate_only_where_p1_is_bound_by_operations(first, second, bound_by,
                                                                      why):
    per_rep, got = exp_vpu_rate.slope(first, second, bound_by)
    assert got == why
    assert per_rep == (min(first[8], second[8]) - min(first[1], second[1])) / 7


def test_splits_rebuild_their_work_values():
    w = torch.from_numpy(np.random.default_rng(3).integers(-30000, 30000, (2, 32, 3840))
                         .astype(np.int16))
    a, b, ab = exp_slice_align.split(w)
    assert torch.equal(a * 256 + b, w.to(torch.int64)) and torch.equal(ab, a + b)
    assert int(ab.abs().max()) <= 246
    wr = exp_x_schemes.repeats(torch.full((160, 896), -7, dtype=torch.int32), 3, 5)
    assert tuple(wr.shape) == (2, 160, 896) and wr[:, 0, 0].tolist() == [-4, -3]
    hi, lo = exp_x_schemes.split("f32_2dot", wr)
    assert torch.equal(hi * 256 + lo, wr)
    sa_, sb_ = exp_x_schemes.split("s8_4dot", wr)
    assert torch.equal(sa_ * 256 + sb_ + 128, _wrap16(wr)) and int(sa_.abs().max()) < 128
    with pytest.raises(ValueError, match="no work planes"):
        exp_x_schemes.split("empty", wr)
    dh, dl = exp_vpu_xpass.split_dense(torch.zeros((160, 896), dtype=torch.int32),
                                       torch.tensor([-1, 300]))
    assert dh[:, 0, 0].tolist() == [-1, 1] and dl[:, 0, 0].tolist() == [255, 44]


def _wrap16(v):
    return ((v + 32768) & 65535) - 32768


def test_wrappers_refuse_other_devices_and_bad_calls(xs_inputs, vx_ops, slice_inputs):
    w, c = xs_inputs
    cv = exp_x_schemes.build_cvals("f32_2dot", c)
    with pytest.raises(ValueError, match="unsupported device"):
        exp_x_schemes.x_scheme("f32_2dot", w.to("meta"), {k: v.to("meta") for k, v in cv.items()})
    with pytest.raises(ValueError, match="several devices"):
        exp_x_schemes.x_scheme("f32_2dot", w, {k: v.to("meta") for k, v in cv.items()})
    with pytest.raises(ValueError, match="takes cvals"):
        exp_x_schemes.x_scheme("s8_4dot", w, cv, 1)
    with pytest.raises(ValueError, match="variants are"):
        exp_x_schemes.x_scheme("nope", w, cv, 1)
    with pytest.raises(ValueError, match="several devices"):
        exp_vpu_xpass.vpu_xpass("empty", dataclasses.replace(vx_ops, we=vx_ops.we.to("meta")), 1)
    with pytest.raises(ValueError, match="P is one of"):
        exp_vpu_rate.op_mix(exp_vpu_rate.inputs("cpu")[:96], "mad", 2)
    with pytest.raises(ValueError, match="unsupported device"):
        exp_vpu_rate.op_mix(exp_vpu_rate.inputs("cpu")[:96].to("meta"), "mad", 1)
    sw, ops = slice_inputs
    with pytest.raises(ValueError, match="align, kl"):
        exp_slice_align.slice_groups(sw, ops, 64, 512)
    with pytest.raises(ValueError, match="several devices"):
        exp_slice_align.slice_groups(sw.to("meta"), ops, 128, 512)


def test_launches_stay_zero_on_cpu(xs_inputs, vx_ops, slice_inputs):
    for mod in NEW_MODULES:
        mod.reset_launches()
    w, c = xs_inputs
    exp_x_schemes.x_scheme("empty", w, exp_x_schemes.build_cvals("empty", c), 1)
    exp_vpu_xpass.vpu_xpass("corr_i32", vx_ops, 1)
    exp_vpu_rate.op_mix(exp_vpu_rate.inputs("cpu")[:96], "epi", 1)
    sw, ops = slice_inputs
    exp_slice_align.slice_groups(sw[:1], ops, 32, 384)
    for mod in NEW_MODULES:
        assert mod.LAUNCHES.total() == 0
    assert set(exp_x_schemes.LAUNCHES) == {*exp_x_schemes.VARIANTS, "f32_2dot[gemm]",
                                           "bf16_1dot[gemm]", "s16_1dot[gemm]",
                                           "s8_4dot[gemm]", "s8_2dot_cat[gemm]"}
    assert set(exp_vpu_xpass.LAUNCHES) == {*exp_vpu_xpass.VARIANTS, "dense4[gemm]",
                                           "corr_f32[wide]", "muls_f32[wide]"}
    assert len(exp_vpu_rate.LAUNCHES) == 9 and len(exp_slice_align.LAUNCHES) == 6


def test_sass_counts_need_the_toolkit(monkeypatch):
    from libiqo_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "_exp_lib", None)
    assert exp_vpu_rate.sass_per_rep() is None


@pytest.mark.parametrize("mod", NEW_MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_raises_without_a_card(monkeypatch, mod):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


@pytest.mark.parametrize("name", ["exp_x_schemes", "exp_vpu_xpass", "exp_vpu_rate",
                                  "exp_slice_align"])
def test_module_entry_point_fails_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", f"libiqo_tpu_torch.experiments.{name}"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_new_modules_import_neither_jax_nor_the_jax_package():
    for mod in NEW_MODULES:
        tree = ast.parse(Path(mod.__file__).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "libiqo_tpu")]


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the probes' kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_xpass_kernels_equal_plain_on_card(cuda_device):
    w, c = exp_x_schemes.inputs(cuda_device)
    for variant in exp_x_schemes.VARIANTS:
        cv = exp_x_schemes.build_cvals(variant, c)
        got = exp_x_schemes.x_scheme(variant, w, cv, 4)
        want = exp_x_schemes.x_scheme_plain(variant, w, cv, 4)
        if variant == "bf16_1dot":
            err = (got.to(torch.int64) - want.to(torch.int64)).abs().to(torch.float64)
            assert bool((err <= exp_x_schemes.bf16_bound(w, cv, 4)).all())
        else:
            assert torch.equal(got, want), variant
    ops = exp_vpu_xpass.operands(cuda_device)
    for variant in exp_vpu_xpass.VARIANTS:
        assert torch.equal(exp_vpu_xpass.vpu_xpass(variant, ops, 3),
                           exp_vpu_xpass.vpu_xpass_plain(variant, ops, 3)), variant
    src = exp_vpu_rate.inputs(cuda_device)
    for mix in exp_vpu_rate.MIXES:
        for p in exp_vpu_rate.PS:
            assert torch.equal(exp_vpu_rate.op_mix(src, mix, p),
                               exp_vpu_rate.op_mix_plain(src, mix, p))
    sw, sops = exp_slice_align.inputs(cuda_device, grid=5)
    for align, kl in exp_slice_align.CONFIGS:
        for check in (False, True):
            assert torch.equal(exp_slice_align.slice_groups(sw, sops, align, kl, check),
                               exp_slice_align.slice_groups_plain(sw, sops, align, kl, check))
