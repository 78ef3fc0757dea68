"""Kernel J's float32 variants in their wide form (``vpu_xpass(variant,
ops, reps, form="wide")``, ``libiqo_tpu_torch/csrc/exp/exp_vpu_f32.cu``)
against ``scripts/exp_vpu_xpass.py``, on the CPU.

The script is loaded from ``scripts/`` with ``importlib``, its ``R`` set to
2, and its Pallas kernel runs in interpret mode, as
``tests/test_torch_xpass.py`` runs it; the wrapper on CPU tensors runs the
plain version.  ``corr_f32`` is held to the script exactly; ``muls_f32``
within ``exp_vpu_xpass.f32_bound`` (XLA does not sum it in the script's
order).  The kernel's thread map, its int -> float conversions and its
warp-uniform path choice are modelled in NumPy
(``libiqo_tpu_torch/experiments/vpu_f32.py``) and held to the plain version
bit for bit.  Tests that need the card are ``cuda``-marked and skip without
one.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import exp_vpu_xpass as vx
from libiqo_tpu_torch.experiments import vpu_f32, xpass_gemm
from libiqo_tpu_torch.tools import vpu_f32_ablate

ROOT = Path(__file__).resolve().parent.parent
REPS = 2


@pytest.fixture(scope="module")
def ops():
    return vx.operands("cpu")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _script(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "_tpu_exp_vpu_xpass_wide", ROOT / "scripts" / "exp_vpu_xpass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "R", REPS)
    return mod


def extremes(ops):
    """we and wo at -32768 and 32767 in a pattern of rows and columns."""
    we, wo = ops.we.clone(), ops.wo.clone()
    we[::2, ::3], wo[::2, 1::3] = -32768, 32767
    we[1::2, 1::3], wo[1::2, ::3] = 32767, -32768
    return dataclasses.replace(ops, we=we, wo=wo)


def past_2_22(ops):
    """Three work values at or past 2^22 in magnitude: their warps take I2F."""
    we, wo = ops.we.clone(), ops.wo.clone()
    we[7, 100], wo[90, 300], we[150, 5] = 2**22 + 5, -(2**28) - 3, -(2**22)
    return dataclasses.replace(ops, we=we, wo=wo)


# ---- against the script ----------------------------------------------------

@pytest.mark.parametrize("variant", vx.WIDE_VARIANTS)
@pytest.mark.parametrize("form", [None, "wide"])
def test_wide_form_equals_script(monkeypatch, interpret, ops, variant, form):
    mod = _script(monkeypatch)
    args = (jnp.asarray(mod.W_E), jnp.asarray(mod.W_O), jnp.asarray(mod.W_DENSE),
            jnp.asarray(mod.CX_HI, jnp.bfloat16), jnp.asarray(mod.CX_LO, jnp.bfloat16))
    want = np.asarray(mod.make(variant)(*args))
    got = vx.vpu_xpass(variant, ops, REPS, form)
    assert got.dtype == torch.int32 and got.shape == want.shape == (160, 384)
    if variant == "muls_f32":
        err = np.abs(got.numpy().astype(np.int64) - want)
        assert (err <= vx.f32_bound(ops, REPS).numpy()).all()
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", ["corr_f32", "muls_f32", "corr_i32"])
def test_plain_wraps_the_repeats_as_the_script(monkeypatch, interpret, ops, variant):
    """we + r passes 2^31 at we[0, 0] = 2^31 - 1: the script adds in int32,
    so the plain version wraps there too (its int64 add did not), and the
    wide form's model, which wraps as the kernel does, agrees."""
    mod = _script(monkeypatch)
    we = mod.W_E.copy()
    we[0, 0] = 2**31 - 1
    args = (jnp.asarray(we), jnp.asarray(mod.W_O), jnp.asarray(mod.W_DENSE),
            jnp.asarray(mod.CX_HI, jnp.bfloat16), jnp.asarray(mod.CX_LO, jnp.bfloat16))
    want = np.asarray(mod.make(variant)(*args))
    o = dataclasses.replace(ops, we=torch.from_numpy(we))
    got = vx.vpu_xpass_plain(variant, o, REPS).numpy()
    if variant == "muls_f32":
        assert (np.abs(got.astype(np.int64) - want) <= vx.f32_bound(o, REPS).numpy()).all()
        assert got[0, 0] == want[0, 0]
    else:
        np.testing.assert_array_equal(got, want)
    if variant != "corr_i32":
        model, fast = vpu_f32.model(variant, we, mod.W_O, ops.taps, REPS)
        assert not fast.all()
        np.testing.assert_array_equal(model, got)


# ---- forms and launch keys -------------------------------------------------

@pytest.mark.parametrize("variant", vx.VARIANTS)
@pytest.mark.parametrize("form", [None, *xpass_gemm.FORMS, "cluster"])
def test_form_of_takes_wide_only_for_the_float32_variants(variant, form):
    wide = variant in ("corr_f32", "muls_f32")
    has = {"serial"} | ({"wide"} if wide else set()) | ({"gemm"} if variant == "dense4" else set())
    if form is None:
        assert vx._form(variant, None) == ("wide" if wide else "gemm" if variant == "dense4"
                                           else "serial")
    elif form in has:
        assert vx._form(variant, form) == form
    else:
        with pytest.raises(ValueError, match="takes form"):
            vx._form(variant, form)


def test_x_schemes_take_no_wide_form():
    assert xpass_gemm.form_of("s16_1dot", None, ("s16_1dot",)) == "gemm"
    with pytest.raises(ValueError, match="takes form 'serial' or 'gemm', got 'wide'"):
        xpass_gemm.form_of("s16_1dot", "wide", ("s16_1dot",))


def test_launch_keys_and_rows(ops):
    vx.reset_launches()
    for variant in vx.WIDE_VARIANTS:
        for form in (None, "wide", "serial"):
            vx.vpu_xpass(variant, ops, 1, form)
    assert vx.LAUNCHES.total() == 0
    assert {"corr_f32[wide]", "muls_f32[wide]"} <= set(vx.LAUNCHES)
    assert set(vx.LAUNCHES) == {vx.launch_key(v, f) for v, f in vx.ROWS}
    assert [r for r in vx.ROWS if r[1] == "wide"] == [("corr_f32", "wide"), ("muls_f32", "wide")]


# ---- the thread map ----------------------------------------------------------

def test_thread_map_writes_every_output_once():
    assert (vpu_f32.cover() == 1).all()
    assert vpu_f32.BLOCKS == 480 and vpu_f32.THREADS == 96
    assert vpu_f32.BLOCKS * vpu_f32.SLICES == 1440          # warps; 10.9 an SM on 132
    row, c0 = vpu_f32.thread_map()
    # the slices of a block share their outputs; lanes hold adjacent quads
    assert (row == row[:, :1]).all() and (c0 == c0[:, :1]).all()
    assert (np.diff(c0[:, 0], axis=-1) == vpu_f32.OUTS).all()
    assert int(c0.max()) + vpu_f32.OUTS == 384


@pytest.mark.parametrize("reps", [1, 2, 3, 4, 23, 24, 25, 1000])
def test_slices_split_the_repeats(reps):
    ranges = [vpu_f32.repeat_range(reps, s) for s in range(vpu_f32.SLICES)]
    assert ranges[0][0] == 0 and ranges[-1][1] == reps
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [r1 - r0 for r0, r1 in ranges]
    assert max(sizes) - min(sizes) <= 1
    if reps % 3 == 0:       # R = 24 and R / 8 = 3: every warp the same share
        assert len(set(sizes)) == 1


@pytest.mark.parametrize("variant", vx.WIDE_VARIANTS)
def test_value_windows(ops, variant):
    """corr_f32's thread reads 9 + 9 work values for its 4 outputs
    (columns c0 .. c0 + 8), muls_f32's 4 + 4."""
    win = vpu_f32.window(ops.we.numpy(), variant)
    n = 9 if variant == "corr_f32" else 4
    assert n == vpu_f32.n_values(variant)
    assert win.shape == (vpu_f32.BLOCKS, vpu_f32.LANES, n)
    row, c0 = vpu_f32.thread_map()
    b, lane = 100, 17
    want = ops.we.numpy()[row[b, 0, lane], c0[b, 0, lane]:c0[b, 0, lane] + n]
    np.testing.assert_array_equal(win[b, lane], want)


@pytest.mark.parametrize("variant", vx.WIDE_VARIANTS)
@pytest.mark.parametrize("reps", [1, 3, 24, 25])
def test_model_equals_plain(ops, variant, reps):
    out, fast = vpu_f32.model(variant, ops.we.numpy(), ops.wo.numpy(), ops.taps, reps)
    assert fast.all()                     # the script's values all take the trick
    np.testing.assert_array_equal(out, vx.vpu_xpass_plain(variant, ops, reps).numpy())


@pytest.mark.parametrize("variant", vx.WIDE_VARIANTS)
@pytest.mark.parametrize("reps", [3, 25])
def test_model_equals_plain_at_the_int16_extremes(ops, variant, reps):
    o = extremes(ops)
    out, fast = vpu_f32.model(variant, o.we.numpy(), o.wo.numpy(), o.taps, reps)
    assert fast.all()
    np.testing.assert_array_equal(out, vx.vpu_xpass_plain(variant, o, reps).numpy())


@pytest.mark.parametrize("variant", vx.WIDE_VARIANTS)
@pytest.mark.parametrize("reps", [3, 24])
def test_model_past_2_22_takes_i2f_and_equals_plain(ops, variant, reps):
    o = past_2_22(ops)
    out, fast = vpu_f32.model(variant, o.we.numpy(), o.wo.numpy(), o.taps, reps)
    row, c0 = vpu_f32.thread_map()
    n = vpu_f32.n_values(variant)
    hit = np.zeros(vpu_f32.BLOCKS, bool)
    for r, c in ((7, 100), (90, 300), (150, 5)):
        hit |= ((row[:, 0] == r) & (c0[:, 0] <= c) & (c < c0[:, 0] + n)).any(axis=-1)
    assert hit.sum() >= 3
    np.testing.assert_array_equal(fast[:, 0], ~hit)          # exactly those warps on I2F
    np.testing.assert_array_equal(out, vx.vpu_xpass_plain(variant, o, reps).numpy())


def test_model_refuses_other_variants(ops):
    with pytest.raises(ValueError, match="corr_f32 or muls_f32"):
        vpu_f32.model("corr_i32", ops.we.numpy(), ops.wo.numpy(), ops.taps, 1)


# ---- the bound's count -----------------------------------------------------

@pytest.mark.parametrize("variant", vx.WIDE_VARIANTS)
def test_bound_counts_the_scripts_float_ops(monkeypatch, variant):
    """``bound()`` counts the float32 multiplies and adds of the script's
    ``body_of`` per output: its traced float32 ``mul``/``add`` over the
    (TH, TW) tile, 2 planes x (12 + 11) for corr_f32, 12 + 11 for muls_f32."""
    mod = _script(monkeypatch)
    we = jnp.zeros((vx.TH, vx.TW + vx.TAPS), jnp.int32)
    jaxpr = jax.make_jaxpr(lambda a, b: mod.body_of(variant, a, b, None, None, None))(we, we)
    ops = [e for e in jaxpr.jaxpr.eqns if e.primitive.name in ("mul", "add")
           and e.outvars[0].aval.dtype == jnp.float32]
    assert all(e.outvars[0].aval.shape == (vx.TH, vx.TW) for e in ops)
    muls = sum(e.primitive.name == "mul" for e in ops)
    planes = 2 if variant == "corr_f32" else 1
    assert (muls, len(ops) - muls) == (planes * 12, planes * 11)
    assert vx.F32_OPS_PER_OUTPUT[variant] == len(ops)
    _, by, app_us, _ = vx.bound(variant)
    assert by == "operations"
    assert app_us == len(ops) * vx.TH * vx.TW / (vx.FP32_OPS_PER_S / 2) * 1e6


# ---- the conversions -----------------------------------------------------------

def test_exponent_trick_is_exact_on_every_int_below_2_22():
    v = np.arange(-2**22, 2**22, dtype=np.int32)
    got = vpu_f32.exact_f32(v)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, v.astype(np.float32))


def test_byte_trick_is_exact_on_every_byte():
    b = np.arange(256, dtype=np.int32)
    np.testing.assert_array_equal(vpu_f32.byte_f32(b), b.astype(np.float32))
    # x & 255 of any int32, the low plane's input
    x = np.random.default_rng(3).integers(-2**31, 2**31, 4096).astype(np.int32)
    np.testing.assert_array_equal(vpu_f32.byte_f32(x & 255), (x & 255).astype(np.float32))


def test_exponent_trick_fails_past_2_22():
    """Why the kernel tests the range: one past, the trick is wrong."""
    v = np.array([2**22, -2**22 - 1], np.int32)
    assert not np.array_equal(vpu_f32.exact_f32(v), v.astype(np.float32))


@pytest.mark.parametrize("values, reps, fits", [
    ([0, 1, -1], 24, True), ([2**22 - 25], 24, True), ([2**22 - 24], 24, False),
    ([-(2**22) + 2], 1, True), ([-(2**22) + 1], 1, False), ([2**31 - 1], 1, False),
    ([-2**31], 1, False), ([32767, -32768], 25, True)])
def test_warp_range_test(values, reps, fits):
    """|x| + reps < 2^22 over every value of every lane, else I2F."""
    lanes = np.zeros((vpu_f32.LANES, 4), np.int32)
    lanes[5, :len(values)] = values
    assert bool(vpu_f32.warp_fits(lanes, reps)) is fits


# ---- the ablation (tools/vpu_f32_ablate.py) ----------------------------------

@pytest.mark.parametrize("name", list(vpu_f32_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_source(name):
    """Each variant's texts are in the kernel source once; none touches the
    barrier, the float -> int step or the rounded float ops."""
    text = vpu_f32_ablate.variant_source(name)
    source = vpu_f32_ablate.SOURCE.read_text()
    for call in ("__syncthreads()", "__float2int_rz(", "__fmul_rn(", "__fadd_rn("):
        assert text.count(call) == source.count(call), (name, call)
    assert (text == source) == (name == "kernel")


# ---- the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the wide form has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", vx.WIDE_VARIANTS)
def test_wide_form_equals_plain_on_card(cuda_device, variant):
    o = vx.operands(cuda_device)
    cases = [(o, r) for r in (1, 3, 24, 25)] + [(extremes(o), r) for r in (3, 25)] + \
        [(past_2_22(o), r) for r in (3, 24)]
    for x, reps in cases:
        assert torch.equal(vx.vpu_xpass(variant, x, reps, "wide"),
                           vx.vpu_xpass_plain(variant, x, reps)), (variant, reps)
