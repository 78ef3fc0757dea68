"""Kernel I's ``s8_4dot`` and ``s8_2dot_cat`` in their ``gemm`` form
(``xscheme_s8_gemm<kCat>`` in ``libiqo_tpu_torch/csrc/exp/exp_xpass_s8.cu``)
on the CPU: the byte split, the persistent walk of (tile, step) units and
the NumPy model of the kernel's schedule (``experiments/xpass_gemm.py``)
against the plain version and the TPU script's own Pallas kernel in
interpret mode.

``a = int8((w + r) >> 8)`` and ``b = int8(((w + r) & 255) - 128)`` are the
bytes of ``int16(w + r)`` (the high one, the low one XOR 0x80); every s32
sum between two flushes stays in int32 and the recombination is the int32
wrap, so tolerance 0 throughout.  Tests that need the card are
``cuda``-marked and skip without one.
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
from libiqo_tpu_torch.tools import s8_ablate

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_xpass_s8.cu"
VARIANTS = ("s8_4dot", "s8_2dot_cat")
# work values at the byte extremes, and beyond int16 (only their low 16 bits count)
WORK_ENDS = np.array([-32768, -32767, -257, -256, -129, -128, -1, 0, 1, 127, 128, 255, 256, 257,
                      32767, 2**20 + 129, -(2**20) - 257, 2**31 - 1, -2**31], np.int64)
# taps whose e = c >> 8 and f = int8(c & 255) reach -128 and 127
TAP_ENDS = np.array([-32768, -32641, -129, -128, 127, 128, 255, 32512, 32639, 32767, 8192,
                     -8192], np.int64)


@pytest.fixture(scope="module")
def xs_inputs():
    return xs.inputs("cpu")


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of this test in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _corr(seed):
    """A nonzero ``corr`` drawn from a seed, over the whole int32 range."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, (3, 128)).astype(np.int32))


def _cvals(variant, c, corr=None):
    cv = xs.build_cvals(variant, c)
    return cv if corr is None else {**cv, "corr": corr}


def _model(variant, w, c, corr, reps, sms=xg.H100_SMS):
    return xg.s8_gemm_model(w.numpy(), c.numpy(), corr.numpy(), reps, variant == "s8_2dot_cat",
                            sms)


# ---- the byte split ------------------------------------------------------------

@pytest.mark.parametrize("lo, hi", [(-2**15, 2**15), (2**20 - 2**15, 2**20 + 2**15),
                                    (-2**31, -2**31 + 2**16)])
def test_split_is_the_plain_versions_over_every_low_half(lo, hi):
    """The kernel's split of the int16 window plus r (high byte; low byte
    XOR 0x80) is the plain version's ``int8(w >> 8)``, ``int8((w & 255) -
    128)`` for every low 16 bits, inside and beyond int16."""
    x = np.arange(lo, hi, dtype=np.int64)
    a, b = xg.s8_split(x)
    want_a, want_b = xs.split("s8_4dot", torch.from_numpy(x))
    np.testing.assert_array_equal(a, want_a.numpy())
    np.testing.assert_array_equal(b, want_b.numpy())
    assert a.min() == -128 and a.max() == 127 and b.min() == -128 and b.max() == 127


def test_split_takes_the_window_plus_r_in_16_bits():
    """``int16(w) + r`` wrapped to 16 bits splits as ``w + r`` does."""
    w = WORK_ENDS[:, None]
    r = np.array([0, 1, 255, 256, 511, 65535, 65536])[None, :]
    wrapped = ((w & 0xFFFF) + r) & 0xFFFF
    for got, want in zip(xg.s8_split(wrapped), xg.s8_split(w + r)):
        np.testing.assert_array_equal(got, want)


def test_a_flush_of_64_steps_cannot_leave_int32():
    """64 steps of the largest s8 sums (384 x 128 x 128 a repeat, twice for
    the middle one) stay below 2^31: no s32 sum relies on a wrap."""
    assert xg.S8_GEMM.max_steps == 64
    assert 64 * 384 * 128 * 128 * 2 < 2**31
    a = np.full((64, 384), -128)
    e = np.full((384, 1), -128)
    assert 2 * (a @ e).sum() < 2**31


# ---- the model against the plain version and the script --------------------------

@pytest.mark.parametrize("nonzero_corr", [False, True])
@pytest.mark.parametrize("reps", [1, 3, 9])
@pytest.mark.parametrize("variant", VARIANTS)
def test_s8_gemm_model_equals_plain(xs_inputs, variant, reps, nonzero_corr):
    w, c = xs_inputs
    corr = _corr(reps) if nonzero_corr else torch.zeros((3, 128), dtype=torch.int32)
    want = xs.x_scheme_plain(variant, w, _cvals(variant, c, corr), reps)
    np.testing.assert_array_equal(_model(variant, w, c, corr, reps), want.numpy())


@pytest.mark.parametrize("reps, sms", [(17, 132), (33, 40), (20, 97)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_s8_gemm_model_over_the_walk(xs_inputs, variant, reps, sms):
    """Runs of several steps that cross tiles, the last step partial, with a
    nonzero ``corr``: the flushes at each new tile and their meeting in
    uint32."""
    w, c = xs_inputs
    launch = xg.s8_launch(reps, sms)
    assert any(len(launch.segments(b)) > 1 for b in range(launch.blocks))
    corr = _corr(reps + sms)
    want = xs.x_scheme_plain(variant, w, _cvals(variant, c, corr), reps)
    np.testing.assert_array_equal(_model(variant, w, c, corr, reps, sms), want.numpy())


@pytest.mark.parametrize("variant", VARIANTS)
def test_s8_gemm_model_with_more_sms_than_units(xs_inputs, variant):
    """At R = 12 on 250 SMs the walk has 120 units and as many blocks, one
    unit each: every flush is one step."""
    w, c = xs_inputs
    launch = xg.s8_launch(12, 250)
    assert launch.blocks == launch.units == 120
    assert all(launch.run(b) == (b, b + 1) for b in range(launch.blocks))
    corr = _corr(12)
    want = xs.x_scheme_plain(variant, w, _cvals(variant, c, corr), 12)
    np.testing.assert_array_equal(_model(variant, w, c, corr, 12, 250), want.numpy())


@pytest.mark.parametrize("variant", VARIANTS)
def test_s8_gemm_model_cut_at_64_steps(xs_inputs, variant):
    """A walk on 7 blocks at R = 600: runs of 75 steps of one tile, each cut
    into flushes of at most 64 steps."""
    w, c = xs_inputs
    corr = _corr(600)
    want = xs.x_scheme_plain(variant, w, _cvals(variant, c, corr), 600)
    np.testing.assert_array_equal(_model(variant, w, c, corr, 600, 7), want.numpy())


@pytest.mark.parametrize("variant", VARIANTS)
def test_s8_gemm_model_equals_the_script(monkeypatch, interpret, xs_inputs, variant):
    """The script's own ``make(variant)`` at R = 2, in interpret mode (its
    zero ``corr``)."""
    spec = importlib.util.spec_from_file_location("_tpu_exp_x_schemes",
                                                  ROOT / "scripts" / "exp_x_schemes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "R", 2)
    cv = mod.build_cvals(variant)
    call, names = mod.make(variant, cv)
    args = [jnp.asarray(mod.W16)]
    for n in names:
        args.extend(cv[n])
    w, c = xs_inputs
    corr = torch.zeros((3, 128), dtype=torch.int32)
    np.testing.assert_array_equal(_model(variant, w, c, corr, 2), np.asarray(call(*args)))


@pytest.mark.parametrize("reps", [3, 9])
@pytest.mark.parametrize("variant", VARIANTS)
def test_s8_gemm_model_at_the_byte_extremes(xs_inputs, variant, reps):
    """Work values at +-32768, +-257, +-128, 0 and beyond int16, and taps
    whose e and f reach -128 and 127, with a nonzero ``corr``."""
    w, c = xs_inputs
    rng = np.random.default_rng(reps)
    w = torch.from_numpy(rng.choice(WORK_ENDS, (160, 896)).astype(np.int32))
    nz = c != 0
    c = c.clone()
    c[nz] = torch.from_numpy(rng.choice(TAP_ENDS, int(nz.sum()))).to(c.dtype)
    cv = _cvals(variant, c, _corr(7))
    planes = (cv["e"], cv["f"]) if variant == "s8_4dot" else (cv["ef"],)
    assert all(int(p.min()) == -128 and int(p.max()) == 127 for p in planes)
    want = xs.x_scheme_plain(variant, w, cv, reps)
    np.testing.assert_array_equal(_model(variant, w, c, cv["corr"], reps), want.numpy())


def test_both_variants_compute_one_function(xs_inputs):
    """``s8_4dot`` and ``s8_2dot_cat`` differ only in the products' shape:
    their models, and their plain versions, agree."""
    w, c = xs_inputs
    corr = _corr(2)
    got = [_model(v, w, c, corr, 5) for v in VARIANTS]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(
        xs.x_scheme_plain("s8_4dot", w, _cvals("s8_4dot", c, corr), 5).numpy(), got[1])


# ---- the walk ----------------------------------------------------------------------

@pytest.mark.parametrize("sms", [xg.H100_SMS, 40])
@pytest.mark.parametrize("reps", [1, 3, 64, 67, 512])
def test_the_units_are_each_taken_once(reps, sms):
    launch = xg.s8_launch(reps, sms)
    counts = xg.s8_unit_cover(launch)
    assert counts.shape == (60, -(-reps // 8)) and (counts == 1).all()


@pytest.mark.parametrize("reps, sms", [(512, 132), (67, 132), (600, 7), (33, 40), (1, 132)])
def test_the_walk_gives_equal_contiguous_runs(reps, sms):
    """min(SMs, units) blocks; runs in order, back to back, differing by at
    most one unit."""
    launch = xg.s8_launch(reps, sms)
    assert launch.blocks == min(sms, 60 * launch.steps)
    runs = [launch.run(b) for b in range(launch.blocks)]
    assert runs[0][0] == 0 and runs[-1][1] == launch.units
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    sizes = [u1 - u0 for u0, u1 in runs]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


def test_runs_of_75_steps_are_cut_at_64():
    """At (reps, sms) = (600, 7) a block walks 75 steps of one tile: its
    flushes come after at most 64 steps, and at each new tile."""
    launch = xg.s8_launch(600, 7)
    assert launch.steps == 75
    segs = [s for b in range(launch.blocks) for s in launch.segments(b)]
    assert max(s1 - s0 for _, s0, s1 in segs) == 64
    assert any(s1 - s0 == 11 and s0 == 64 for _, s0, s1 in segs)
    for b in range(launch.blocks):
        u0, u1 = launch.run(b)
        assert sum(s1 - s0 for _, s0, s1 in launch.segments(b)) == u1 - u0
        assert all(0 <= s0 < s1 <= launch.steps for _, s0, s1 in launch.segments(b))


@pytest.mark.parametrize("reps, sms", [(4096, 132), (512, 3), (9000, 16)])
def test_no_flush_exceeds_64_steps(reps, sms):
    launch = xg.s8_launch(reps, sms)
    assert max(s1 - s0 for b in range(launch.blocks) for _, s0, s1 in launch.segments(b)) <= 64


def test_wave_efficiency_of_the_walk_and_of_the_slicing():
    """At R = 512: the walk's 3840 units on 132 blocks (runs of 29 or 30),
    0.970; s16_1dot's slicing, 120 blocks of 32 steps in one wave, 0.909."""
    walk = xg.s8_launch(xs.R)
    assert (walk.blocks, walk.units) == (132, 3840)
    assert {u1 - u0 for u0, u1 in map(walk.run, range(132))} == {29, 30}
    assert round(walk.wave_efficiency, 3) == 0.970
    s16 = xg.geometry(xg.S16_GEMM, xs.R)
    assert (s16.blocks, s16.steps_per_slice) == (120, 32)
    assert round(walk.units / (xg.H100_SMS * s16.steps_per_slice), 3) == 0.909


def test_s8_launch_refuses_no_repeats():
    with pytest.raises(ValueError, match="reps"):
        xg.s8_launch(0)


# ---- the wrapper and the taps as the kernel reads them ---------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_build_cvals_lays_the_taps_out_k_major(xs_inputs, variant):
    _, c = xs_inputs
    cv = xs.build_cvals(variant, c)
    t = cv["ef_k"]
    assert t.shape == (3, 256, 384) and t.dtype == torch.int8 and t.is_contiguous()
    v = c.to(torch.int64)
    assert torch.equal(t[:, :128].transpose(1, 2).to(torch.int64), xs.wrap(v >> 8, 8))
    assert torch.equal(t[:, 128:].transpose(1, 2).to(torch.int64), xs.wrap(v & 255, 8))
    if variant == "s8_2dot_cat":
        assert torch.equal(t, cv["ef"].transpose(1, 2))


@pytest.mark.parametrize("variant", VARIANTS)
def test_gemm_form_takes_the_k_major_taps(xs_inputs, variant):
    """Without ``ef_k``, with it off shape or type, or strided, the gemm
    form refuses; the serial form reads the script's planes only."""
    w, c = xs_inputs
    cv = xs.build_cvals(variant, c)
    bare = {k: v for k, v in cv.items() if k != "ef_k"}
    with pytest.raises(ValueError, match="ef_k"):
        xs.x_scheme(variant, w, bare, 1, "gemm")
    with pytest.raises(ValueError, match="ef_k"):
        xs.x_scheme(variant, w, {**cv, "ef_k": cv["ef_k"].to(torch.uint8)}, 1, "gemm")
    with pytest.raises(ValueError, match="ef_k"):
        xs.x_scheme(variant, w, {**cv, "ef_k": cv["ef_k"][:, :128]}, 1, "gemm")
    strided = torch.empty((3, 256, 2 * 384), dtype=torch.int8)[..., ::2]
    strided.copy_(cv["ef_k"])
    with pytest.raises(ValueError, match="contiguous"):
        xs.x_scheme(variant, w, {**cv, "ef_k": strided}, 1, "gemm")
    assert torch.equal(xs.x_scheme(variant, w, bare, 1, "serial"),
                       xs.x_scheme_plain(variant, w, cv, 1))


@pytest.mark.parametrize("variant", VARIANTS)
def test_gemm_is_the_default_form_and_runs_plain_on_cpu(xs_inputs, variant):
    xs.reset_launches()
    w, c = xs_inputs
    cv = _cvals(variant, c, _corr(3))
    assert xs._form(variant, None) == "gemm"
    assert torch.equal(xs.x_scheme(variant, w, cv, 2), xs.x_scheme_plain(variant, w, cv, 2))
    assert xs.LAUNCHES.total() == 0


def test_rows_and_launch_keys():
    assert ("s8_4dot", "gemm") in xs.ROWS and ("s8_2dot_cat", "gemm") in xs.ROWS
    assert {"s8_4dot[gemm]", "s8_2dot_cat[gemm]"} <= set(xs.LAUNCHES)
    assert xs.GEMM_VARIANT[:2] == VARIANTS


def test_bounds_of_the_gemm_forms():
    """Four s8 products on the tensor cores in either form: 0.0954 us an
    application, 48.8 us a launch at R."""
    for variant in VARIANTS:
        ms, by, app_us, _ = xs.bound(variant, form="gemm")
        assert by == "operations" and round(app_us, 4) == 0.0954 and round(ms * 1e3, 1) == 48.8
        assert xs.macs(variant, "gemm") == xs.macs(variant) == (4 * 160 * 384 * 128 * 3, "int8")


# ---- the source --------------------------------------------------------------------

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
    k = _constexprs("g8")
    f = xg.S8_GEMM
    assert (k["kThreads"], k["kRows"], k["kRepStep"], k["kCols"], k["kK"], k["kKC"]) == \
        (f.threads, f.rows, f.rep_step, f.cols, f.k, f.kc)
    assert (k["kKBlocks"], k["kSmem"], k["kMaxRunSteps"]) == (f.chunks, f.smem, f.max_steps)
    assert (k["kTilesY"], k["kTilesZ"], k["kTiles"]) == (f.tiles_y, f.tiles_z, f.tiles)
    assert f.smem == 168_960 <= xg.SMEM_LIMIT and f.blocks_per_sm == 1


def test_source_names_what_it_replaces():
    head = SOURCE.read_text().split("#include")[0]
    for ref in ("xscheme_s8_gemm", ":156", "s8_4dot", "s8_2dot_cat", "m64n64k32", "m64n128k32",
                ".s32.s8.s8", "0.0954 us", "ef_k", "64 x 384 x 128 x 128 x 2 < 2^31"):
        assert ref in head
    hopper = (SOURCE.parent / "hopper.cuh").read_text()
    assert "#define IQO_WGMMA_I8(" in hopper and "#define IQO_WGMMA_I8_N128(" in hopper
    assert "m64n128k32.s32." in hopper


def test_source_flushes_where_the_host_model_does():
    """The kernel's runs and cuts are the host's: the walk's equal runs and
    a flush at each new tile or after kMaxRunSteps steps."""
    text = SOURCE.read_text()
    assert "long long u = units * blockIdx.x / gridDim.x;" in text
    assert "const long long u1 = units * (blockIdx.x + 1) / gridDim.x;" in text
    assert "int s1 = min(steps, s0 + kMaxRunSteps);" in text
    assert "steps_per_slice" not in text


# ---- the walk against the slicing (tools/s8_ablate.py) ----------------------------

@pytest.mark.parametrize("variant", list(s8_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_source(variant):
    """Each variant's texts are in the kernel source once, and none touches a
    barrier, a wait or a copy."""
    text = s8_ablate.variant_source(variant)
    source = SOURCE.read_text()
    for call in ("wgmma_wait<", "cp_wait<", "cp_async16(", "__syncthreads()", "atomicAdd("):
        assert text.count(call) == source.count(call), (variant, call)
    assert (text == source) == (variant == "kernel")


@pytest.mark.parametrize("reps", [1, 3, 64, 67, 512, 600])
def test_the_slices_variant_takes_each_unit_once(reps):
    """The ``slices`` variant's runs, ``sps = ceil(steps / slices)`` steps of
    a tile a block on ``S16_GEMM``'s slices, cover every (tile, step) unit
    once, as the walk's do."""
    blocks = s8_ablate.blocks("slices", reps, xg.H100_SMS)
    steps = -(-reps // 8)
    slices = blocks // 60
    assert blocks == 60 * slices and 1 <= slices <= steps
    sps = -(-steps // slices)
    counts = np.zeros((60, steps), np.int64)
    for b in range(blocks):
        tile, s = divmod(b, slices)
        counts[tile, s * sps:min((s + 1) * sps, steps)] += 1
    assert (counts == 1).all()


def test_ablation_blocks_at_r():
    """At R = 512: the walk's 132 blocks against the slicing's 120."""
    assert s8_ablate.blocks("kernel", xs.R, xg.H100_SMS) == 132
    assert s8_ablate.blocks("slices", xs.R, xg.H100_SMS) == 120


def test_ablation_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        s8_ablate.main([])
    with pytest.raises(SystemExit, match="unknown variants"):
        s8_ablate.main(["no_such_variant"])


# ---- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the gemm form's kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 3, 64, 67, xs.R])
@pytest.mark.parametrize("variant", VARIANTS)
def test_s8_gemm_equals_plain_on_card(cuda_device, variant, reps):
    w, c = xs.inputs(cuda_device)
    cv = _cvals(variant, c, _corr(reps).to(cuda_device))
    got = xs.x_scheme(variant, w, cv, reps, "gemm")
    assert torch.equal(got, xs.x_scheme_plain(variant, w, cv, reps))
