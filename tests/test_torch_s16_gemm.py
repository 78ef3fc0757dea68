"""Kernel I's ``s16_1dot`` in its ``gemm`` form (``xscheme_s16_gemm`` in
``libiqo_tpu_torch/csrc/exp/exp_xpass_gemm.cu``) on the CPU: the int16 dot
as four byte-plane products on the s8 tensor cores, its geometry and the
NumPy model of its schedule (``experiments/xpass_gemm.py``) against the plain
version, ``gold`` and the TPU script's own Pallas kernel in interpret mode.

With ``x = 256 xh + xl`` and ``c = 256 ch + cl`` (high byte s8, low byte u8),
``x c = 65536 xh ch + 256 (xh cl + xl ch) + xl cl``: every partial sum is an
exact integer and the recombination is the int32 wrap, so tolerance 0
throughout.  Tests that need the card are ``cuda``-marked and skip without
one.
"""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import exp_x_schemes as xs
from libiqo_tpu_torch.experiments import xpass_gemm as xg

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_xpass_gemm.cu"
INT16_ENDS = np.array([-32768, -32767, -257, -256, -129, -128, -1, 0, 1, 127, 128, 255, 256,
                       32767], np.int64)
TAP_ENDS = np.array([-8192, -8191, -256, -255, -129, -1, 0, 1, 128, 255, 256, 8191, 8192],
                    np.int64)


@pytest.fixture(scope="module")
def xs_inputs():
    return xs.inputs("cpu")


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of this test in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _model(w, c, reps, sms=xg.H100_SMS):
    return xg.s16_gemm_model(w.numpy(), c.numpy(), reps, sms)


def _wrap32(v):
    return ((np.asarray(v, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


# ---- the byte planes and their recombination ---------------------------------

def test_byte_planes_rebuild_every_int16():
    x = np.arange(-2**15, 2**15)
    hi, lo = xg.byte_planes(x)
    assert hi.min() == -128 and hi.max() == 127 and lo.min() == 0 and lo.max() == 255
    np.testing.assert_array_equal(256 * hi + lo, x)
    with pytest.raises(ValueError, match="int16"):
        xg.byte_planes(np.array([2**15]))


def test_recombination_is_the_int32_product_at_the_extremes():
    """Every product of the int16 extremes with taps at +-8192 and the byte
    edges: 65536 xh ch + 256 (xh cl + xl ch) + xl cl in uint32 is x c
    wrapped to 32 bits."""
    x, c = np.meshgrid(INT16_ENDS, TAP_ENDS, indexing="ij")
    xh, xl = xg.byte_planes(x)
    ch, cl = xg.byte_planes(c)
    got = xg.s16_recombine(xh * ch, xh * cl + xl * ch, xl * cl).view(np.int32)
    np.testing.assert_array_equal(got, _wrap32(x * c))


@pytest.mark.parametrize("seed", [0, 1])
def test_recombined_dots_wrap_like_the_plain_version(seed):
    """Dots of K = 384 over the extremes (|x c| up to 2^28 a term), summed
    over repeats past 2^31: the partial sums stay in int32, and their
    recombination in uint32 equals the wrapped exact dot."""
    rng = np.random.default_rng(seed)
    x = rng.choice(INT16_ENDS, (8, 384))
    c = rng.choice(TAP_ENDS, (384, 16))
    xh, xl = xg.byte_planes(x)
    ch, cl = xg.byte_planes(c)
    hh, mid, ll = xh @ ch, xh @ cl + xl @ ch, xl @ cl
    assert max(np.abs(a).max() for a in (hh, mid, ll)) < 2**31
    exact = x @ c
    assert np.abs(exact).max() > 2**31
    np.testing.assert_array_equal(xg.s16_recombine(hh, mid, ll).view(np.int32), _wrap32(exact))


def test_a_slice_of_64_steps_cannot_leave_int32():
    """The kernel's cap on a slice: 64 steps of the largest byte-plane sums
    (384 x 255 x 255 for the low bytes, 384 x 128 x 255 twice for the middle
    ones) stay below 2^31, so no s32 sum relies on a wrap."""
    assert xg.S16_GEMM.max_steps == 64
    assert 64 * 384 * 255 * 255 < 2**31 and 64 * 2 * 384 * 128 * 255 < 2**31
    for reps in (512, 513, 4096):
        assert xg.geometry(xg.S16_GEMM, reps).steps_per_slice <= 64


# ---- the model against the plain version, gold and the script -----------------

@pytest.mark.parametrize("reps", [1, 3, 9])
def test_s16_gemm_model_equals_plain(xs_inputs, reps):
    w, c = xs_inputs
    want = xs.x_scheme_plain("s16_1dot", w, xs.build_cvals("s16_1dot", c), reps)
    np.testing.assert_array_equal(_model(w, c, reps), want.numpy())


@pytest.mark.parametrize("reps, sms", [(17, 132), (33, 40)])
def test_s16_gemm_model_over_slices_of_several_steps(xs_inputs, reps, sms):
    """Slices of several steps of 8 repeats, the last step partial: the
    warps' sums over a slice and the slices' meeting in uint32."""
    w, c = xs_inputs
    launch = xg.geometry(xg.S16_GEMM, reps, sms)
    assert launch.steps_per_slice > 1 and launch.slices > 1
    want = xs.x_scheme_plain("s16_1dot", w, xs.build_cvals("s16_1dot", c), reps)
    np.testing.assert_array_equal(_model(w, c, reps, sms), want.numpy())


def test_s16_gemm_model_equals_gold_at_one_application(xs_inputs):
    w, c = xs_inputs
    np.testing.assert_array_equal(_model(w, c, 1), xs.gold(w, c).numpy())


def test_s16_gemm_model_at_the_int16_extremes(xs_inputs):
    """Work values at -32768 and 32767 that the repeats wrap, and taps at
    +-8192 and the byte edges: each repeat's dot wraps int32."""
    w, c = xs_inputs
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.choice(INT16_ENDS, (160, 896)).astype(np.int32))
    nz = c != 0
    c = c.clone()
    c[nz] = torch.from_numpy(rng.choice(TAP_ENDS[TAP_ENDS != 0], int(nz.sum()))).to(c.dtype)
    want = xs.x_scheme_plain("s16_1dot", w, xs.build_cvals("s16_1dot", c), 3)
    np.testing.assert_array_equal(_model(w, c, 3), want.numpy())
    assert np.abs(xs.gold(w, c).numpy().astype(np.int64)).max() > 2**30


def test_s16_gemm_model_equals_the_script(monkeypatch, interpret, xs_inputs):
    """The script's own ``make("s16_1dot")`` at R = 2, in interpret mode."""
    spec = importlib.util.spec_from_file_location("_tpu_exp_x_schemes",
                                                  ROOT / "scripts" / "exp_x_schemes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "R", 2)
    cv = mod.build_cvals("s16_1dot")
    call, names = mod.make("s16_1dot", cv)
    args = [jnp.asarray(mod.W16)]
    for n in names:
        args.extend(cv[n])
    w, c = xs_inputs
    np.testing.assert_array_equal(_model(w, c, 2), np.asarray(call(*args)))


# ---- the window and the taps as the kernel lays them out ------------------------

def test_window_offsets_give_each_lane_its_fragments():
    """Each int16 of the block's window has its own 2 bytes; lane (g, q)'s
    two 16-byte words of K step kk hold A fragment registers 0-3 (rows g,
    g + 8; k 4 q .., 16 + 4 q ..) of mma's m16n8k32 layout, 4 values each."""
    offs = {(r, k): xg.window_offset(r, k) for r in range(16) for k in range(384)}
    assert sorted(offs.values()) == list(range(0, 16 * 384 * 2, 2))
    for kk in (0, 5, 11):
        for lane in (0, 7, 13, 31):
            g, q = lane // 4, lane % 4
            words = [((kk * 2 + h) * 32 + lane) * 16 for h in range(2)]
            regs = [(g, 32 * kk + 4 * q), (g + 8, 32 * kk + 4 * q), (g, 32 * kk + 16 + 4 * q),
                    (g + 8, 32 * kk + 16 + 4 * q)]
            for i, (row, k0) in enumerate(regs):
                # register i: x0 holds regs 0 and 2 (row g), x1 regs 1 and 3
                base = words[i % 2] + 8 * (i // 2)
                assert [offs[row, k0 + e] for e in range(4)] == [base + 2 * e for e in range(4)]


def test_build_cvals_lays_the_byte_planes_out_k_major(xs_inputs):
    _, c = xs_inputs
    cv = xs.build_cvals("s16_1dot", c)
    t = cv["c16_k"]
    assert t.shape == (3, 2, 128, 384) and t.dtype == torch.uint8 and t.is_contiguous()
    v = c.to(torch.int64)
    assert torch.equal(t[:, 0].transpose(1, 2).to(torch.int64), (v >> 8) & 255)
    assert torch.equal(t[:, 1].transpose(1, 2).to(torch.int64), v & 255)
    hi = t[:, 0].to(torch.int64)
    assert torch.equal((((hi + 128) & 255) - 128) * 256 + t[:, 1].to(torch.int64),
                       v.transpose(1, 2))


def test_gemm_form_takes_the_k_major_byte_planes(xs_inputs):
    w, c = xs_inputs
    cv = xs.build_cvals("s16_1dot", c)
    with pytest.raises(ValueError, match="c16_k"):
        xs.x_scheme("s16_1dot", w, {"c16": cv["c16"]}, 1, "gemm")
    with pytest.raises(ValueError, match="c16_k"):
        xs.x_scheme("s16_1dot", w, {**cv, "c16_k": cv["c16_k"].to(torch.int8)}, 1, "gemm")
    # the serial form reads c16 only
    assert torch.equal(xs.x_scheme("s16_1dot", w, {"c16": cv["c16"]}, 1, "serial"),
                       xs.x_scheme_plain("s16_1dot", w, cv, 1))


def test_gemm_is_the_default_form_and_runs_plain_on_cpu(xs_inputs):
    xs.reset_launches()
    w, c = xs_inputs
    cv = xs.build_cvals("s16_1dot", c)
    assert xs.GEMM_VARIANT[-1] == "s16_1dot"
    assert xs._form("s16_1dot", None) == "gemm"
    assert torch.equal(xs.x_scheme("s16_1dot", w, cv, 2), xs.x_scheme_plain("s16_1dot", w, cv, 2))
    assert xs.LAUNCHES.total() == 0
    with pytest.raises(ValueError, match="takes form"):
        xs.x_scheme("s16_1dot", w, cv, 1, "wgmma")


# ---- geometry and bound ----------------------------------------------------------

def test_bounds_of_both_routes():
    """The gemm form's bound is four s8 products on the tensor cores (0.0954
    us an application, 48.8 us a launch at R); the serial form keeps the
    IMAD figure (1.41 us an application)."""
    ms, by, app_us, nbytes = xs.bound("s16_1dot", form="gemm")
    assert by == "operations" and round(app_us, 4) == 0.0954 and round(ms * 1e3, 1) == 48.8
    assert xs.macs("s16_1dot", "gemm") == (4 * 160 * 384 * 128 * 3, "int8")
    assert round(xs.bound("s16_1dot", form="serial")[2], 2) == 1.41
    assert nbytes == xs.bound("s16_1dot")[3]


@pytest.mark.parametrize("reps", [1, 3, 64, 67, 512])
def test_s16_tiles_cover_every_output_once(reps):
    counts = xg.cover(xg.S16_GEMM, reps)
    assert (counts[:reps] == 1).all() and (counts[reps:] == 0).all()


def test_s16_grid_at_r_is_one_wave():
    launch = xg.geometry(xg.S16_GEMM, xs.R)
    assert (launch.slices, launch.steps_per_slice, launch.blocks) == (2, 32, 120)
    assert launch.blocks <= xg.H100_SMS * xg.S16_GEMM.blocks_per_sm
    assert xg.S16_GEMM.smem == 62_464 <= xg.SMEM_LIMIT


def _constexprs(namespace: str) -> dict[str, int]:
    body = re.search(rf"namespace {namespace} {{(.*?)}}  // namespace {namespace}",
                     SOURCE.read_text(), re.S).group(1)
    out = {}
    for stmt in re.findall(r"constexpr int ([^;]+);", body):
        for part in stmt.split(","):
            name, expr = (x.strip() for x in part.split("="))
            out[name] = eval(re.sub(r"//.*", "", expr), {}, dict(out))   # noqa: S307
    return out


def test_host_geometry_is_the_sources():
    k = _constexprs("gs")
    f = xg.S16_GEMM
    assert (k["kThreads"], k["kRows"], k["kRepStep"], k["kCols"], k["kK"], k["kKC"]) == \
        (f.threads, f.rows, f.rep_step, f.cols, f.k, f.kc)
    assert (k["kKBlocks"], k["kSmem"], k["kMaxSliceSteps"]) == (f.chunks, f.smem, f.max_steps)
    assert (k["kTW"] // k["kCols"], k["kTH"] // k["kRows"]) == (f.tiles_y, f.tiles_z)


def test_source_names_what_it_replaces():
    head = SOURCE.read_text().split("#include")[0]
    for ref in ("xscheme_s16_gemm", ":248", "check_s16_exact", ".s32.s8.s8", ".u8.u8",
                "0.0954 us", "c16_k"):
        assert ref in head
    serial = (SOURCE.parent / "exp_xpass.cu").read_text().split("#include")[0]
    assert "IMAD" in serial and "byte-plane products" in serial


# ---- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the gemm form's kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 3, 64, 67, xs.R])
def test_s16_gemm_equals_plain_on_card(cuda_device, reps):
    w, c = xs.inputs(cuda_device)
    cv = xs.build_cvals("s16_1dot", c)
    got = xs.x_scheme("s16_1dot", w, cv, reps, "gemm")
    assert torch.equal(got, xs.x_scheme_plain("s16_1dot", w, cv, reps))
    if reps == 1:
        assert torch.equal(got, xs.gold(w, c))
