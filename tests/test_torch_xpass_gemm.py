"""The redesigned X-pass probe forms (``f32_2dot``, ``bf16_1dot`` and
``dense4`` in their ``gemm`` form,
``libiqo_tpu_torch/csrc/exp/exp_xpass_gemm.cu``) on the CPU: their geometry
and the NumPy model of their schedules
(``libiqo_tpu_torch/experiments/xpass_gemm.py``) against the plain versions
and the TPU scripts' own Pallas kernels in interpret mode.

The kernels run only on the card; here the model walks the same blocks,
repeat slices, steps and K chunks, with the split of ``w + r`` in int32 and
the slices meeting in uint32.  Tolerance 0, bit for bit, for ``f32_2dot``
and ``dense4``: every f32 sum they take is an integer whose |terms| sum
below 2^24 (the model asserts it).  ``bf16_1dot``'s sums pass 2^24, so its
f32 result depends on the order of summation: its model sums in one order
the tensor cores could take and is held within ``exp_x_schemes.bf16_bound``
(the f32 summation bound, unchanged), bit for bit only where the order does
not enter (the slices' uint32 meeting).  Tests that need the card are
``cuda``-marked and skip without one.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import exp_vpu_xpass as vx
from libiqo_tpu_torch.experiments import exp_x_schemes as xs
from libiqo_tpu_torch.experiments import xpass_gemm as xg

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_xpass_gemm.cu"
FORMS = {"f32_2dot": (xg.F32_GEMM, xs.R), "dense4": (xg.DENSE4_GEMM, vx.R),
         "bf16_1dot": (xg.BF16_GEMM, xs.R)}


@pytest.fixture(scope="module")
def xs_inputs():
    return xs.inputs("cpu")


@pytest.fixture(scope="module")
def vx_ops():
    return vx.operands("cpu")


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of this test in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _script(name: str, monkeypatch, **constants):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in constants.items():
        monkeypatch.setattr(mod, k, v)
    return mod


def _f32_model(w, c, reps, sms=xg.H100_SMS):
    return xg.f32_gemm_model(w.numpy(), c.numpy(), reps, sms)


def _dense4_model(ops, reps, sms=xg.H100_SMS):
    return xg.dense4_gemm_model(ops.wd.numpy(), ops.cxh.to(torch.float32).numpy(),
                                ops.cxl.to(torch.float32).numpy(), reps, sms)


# ---- the models against the plain versions and the scripts ----------------

@pytest.mark.parametrize("reps", [1, 3, 8])
def test_f32_gemm_model_equals_plain(xs_inputs, reps):
    w, c = xs_inputs
    want = xs.x_scheme_plain("f32_2dot", w, xs.build_cvals("f32_2dot", c), reps)
    np.testing.assert_array_equal(_f32_model(w, c, reps), want.numpy())


@pytest.mark.parametrize("reps", [1, 3, 10])
def test_dense4_gemm_model_equals_plain(vx_ops, reps):
    want = vx.vpu_xpass_plain("dense4", vx_ops, reps)
    np.testing.assert_array_equal(_dense4_model(vx_ops, reps), want.numpy())


@pytest.mark.parametrize("reps, sms", [(16, 4), (13, 4), (67, 4)])
def test_f32_gemm_model_over_slices_of_several_steps(xs_inputs, reps, sms):
    """With few SMs the geometry gives slices of several steps (at 67
    repeats the last slice short and its last step partial): the slices
    still meet to the plain sum."""
    w, c = xs_inputs
    launch = xg.geometry(xg.F32_GEMM, reps, sms)
    assert launch.steps_per_slice > 1 and launch.slices > 1
    want = xs.x_scheme_plain("f32_2dot", w, xs.build_cvals("f32_2dot", c), reps)
    np.testing.assert_array_equal(_f32_model(w, c, reps, sms), want.numpy())


@pytest.mark.parametrize("reps, sms", [(27, 8), (45, 8)])
def test_dense4_gemm_model_over_slices_of_several_steps(vx_ops, reps, sms):
    launch = xg.geometry(xg.DENSE4_GEMM, reps, sms)
    assert launch.steps_per_slice > 1 and launch.slices > 1
    want = vx.vpu_xpass_plain("dense4", vx_ops, reps)
    np.testing.assert_array_equal(_dense4_model(vx_ops, reps, sms), want.numpy())


def test_f32_gemm_model_equals_the_script(monkeypatch, interpret, xs_inputs):
    """The script's own ``make("f32_2dot")`` at R = 2, in interpret mode."""
    mod = _script("exp_x_schemes", monkeypatch, R=2)
    cv = mod.build_cvals("f32_2dot")
    call, names = mod.make("f32_2dot", cv)
    args = [jnp.asarray(mod.W16)]
    for n in names:
        args.extend(cv[n])
    w, c = xs_inputs
    np.testing.assert_array_equal(_f32_model(w, c, 2), np.asarray(call(*args)))


def test_dense4_gemm_model_equals_the_script(monkeypatch, interpret, vx_ops):
    mod = _script("exp_vpu_xpass", monkeypatch, R=2)
    want = np.asarray(mod.make("dense4")(
        jnp.asarray(mod.W_E), jnp.asarray(mod.W_O), jnp.asarray(mod.W_DENSE),
        jnp.asarray(mod.CX_HI, jnp.bfloat16), jnp.asarray(mod.CX_LO, jnp.bfloat16)))
    np.testing.assert_array_equal(_dense4_model(vx_ops, 2), want)


def test_f32_gemm_model_equals_gold_at_one_application(xs_inputs):
    w, c = xs_inputs
    np.testing.assert_array_equal(_f32_model(w, c, 1), xs.gold(w, c).numpy())


def test_models_refuse_sums_past_2_24(xs_inputs):
    """A sum of |terms| at 2^24 would make the kernels' f32 order matter."""
    w, c = xs_inputs
    big = c.clone()
    big[0, :, 0] = 2**16
    with pytest.raises(ValueError, match="not below 2\\^24"):
        _f32_model(w, big, 1)


def _bf16_model(w, c, reps, sms=xg.H100_SMS):
    cbf = xs.build_cvals("bf16_1dot", c)["cbf"].to(torch.float32).numpy()
    return xg.bf16_gemm_model(w.numpy(), cbf, reps, sms)


def _within_bf16_bound(got, want, w, c, reps):
    """|got - want| <= bf16_bound at every output; returns the largest share
    of the bound."""
    err = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64)).astype(np.float64)
    bound = xs.bf16_bound(w, xs.build_cvals("bf16_1dot", c), reps).numpy()
    assert (err <= bound).all(), f"{int((err > bound).sum())} outputs outside the bound"
    return float((err / bound).max())


@pytest.mark.parametrize("reps", [1, 3, 9])
def test_bf16_gemm_model_within_the_bound_of_plain(xs_inputs, reps):
    """Each repeat's f32 dot summed K step by K step (an order the tensor
    cores could take), truncated, the repeats and slices met in uint32:
    within bf16_bound of the plain version's f32 rounding of the exact sum."""
    w, c = xs_inputs
    want = xs.x_scheme_plain("bf16_1dot", w, xs.build_cvals("bf16_1dot", c), reps)
    assert _within_bf16_bound(_bf16_model(w, c, reps), want.numpy(), w, c, reps) < 1.0


@pytest.mark.parametrize("reps, sms", [(67, 13), (67, 20)])
def test_bf16_gemm_model_over_slices_of_several_steps(xs_inputs, reps, sms):
    """Slices of several steps of 8 repeats (the last step partial at 67):
    the meeting of the slices still stays within the bound of plain."""
    w, c = xs_inputs
    launch = xg.geometry(xg.BF16_GEMM, reps, sms)
    assert launch.steps_per_slice > 1 and launch.slices > 1
    want = xs.x_scheme_plain("bf16_1dot", w, xs.build_cvals("bf16_1dot", c), reps)
    _within_bf16_bound(_bf16_model(w, c, reps, sms), want.numpy(), w, c, reps)


def test_bf16_gemm_model_within_the_bound_of_the_script(monkeypatch, interpret, xs_inputs):
    """The script's own ``make("bf16_1dot")`` at R = 3, in interpret mode
    (XLA's order of summation): within the same bound of the model."""
    mod = _script("exp_x_schemes", monkeypatch, R=3)
    cv = mod.build_cvals("bf16_1dot")
    call, names = mod.make("bf16_1dot", cv)
    args = [jnp.asarray(mod.W16)]
    for n in names:
        args.extend(cv[n])
    w, c = xs_inputs
    _within_bf16_bound(_bf16_model(w, c, 3), np.asarray(call(*args)), w, c, 3)


@pytest.mark.parametrize("reps, sms", [(40, 20), (67, 132)])
def test_bf16_gemm_slices_meet_to_the_serial_sum_where_it_wraps(xs_inputs, reps, sms):
    """Over 20 or 67 repeats the sums pass 2^31 (each dot reaches ~1.3e9):
    the slices, each summed in uint32 and met in uint32 in the output, equal
    the serial int32-wrapped sum of the same per-repeat dots, bit for bit."""
    w, c = xs_inputs
    cbf = xs.build_cvals("bf16_1dot", c)["cbf"].to(torch.float32).numpy()
    wn = w.numpy()
    serial = np.zeros((160, 384), np.int64)
    for g in range(3):
        wt = wn[:, 256 * g:256 * g + 384]
        for r in range(reps):
            serial[:, 128 * g:128 * (g + 1)] += xg.bf16_dot_f32(wt, cbf[g], r)
    assert np.abs(serial).max() > 2**31
    serial = ((serial + 2**31) % 2**32 - 2**31).astype(np.int32)
    assert xg.geometry(xg.BF16_GEMM, reps, sms).slices > 1
    np.testing.assert_array_equal(xg.bf16_gemm_model(wn, cbf, reps, sms), serial)


def test_the_int_path_probe_leaves_the_dots_in_int32(xs_inputs):
    """The card test and chip_smoke.py send one block down the kernel's int32
    path by raising work column 800 of the first row tile past 2^24: no tap
    of any group reads that column, so no dot changes."""
    w, c = xs_inputs
    assert int(c[:, 266:].abs().sum()) == 0             # taps end at k 265
    wide = w.clone()
    wide[:16, 800] += 2**24
    cv = xs.build_cvals("bf16_1dot", c)
    assert torch.equal(xs.x_scheme_plain("bf16_1dot", wide, cv, 3),
                       xs.x_scheme_plain("bf16_1dot", w, cv, 3))
    assert all(not 256 * g <= 800 < 256 * g + 384 for g in (0, 1))


def test_bf16_round_is_torchs():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.integers(-2**24, 2**24, 4096), np.arange(-1000, 1000),
                        [255.5, 256.5, 257.5, 0.0, -0.0]]).astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(xg.bf16_round(x), want)


# ---- geometry ---------------------------------------------------------------

@pytest.mark.parametrize("variant", FORMS)
@pytest.mark.parametrize("reps", ["1", "3", "R/8", "R"])
def test_slices_and_tiles_cover_every_output_once(variant, reps):
    """Every (repeat, row, column) is computed and kept by exactly one thread
    of one block, from each kernel's thread mapping; padded repeats of the
    last step by none."""
    form, r_full = FORMS[variant]
    n = {"1": 1, "3": 3, "R/8": r_full // 8, "R": r_full}[reps]
    counts = xg.cover(form, n)
    assert (counts[:n] == 1).all() and (counts[n:] == 0).all()


@pytest.mark.parametrize("variant", FORMS)
@pytest.mark.parametrize("reps", [1, 2, 3, 5, 8, 24, 63, 64, 100, 512])
@pytest.mark.parametrize("sms", [1, 132])
def test_slices_cover_the_steps(variant, reps, sms):
    """``slices x steps_per_slice`` covers the steps with no empty slice: the
    kernels' entry points refuse any other pair."""
    form, _ = FORMS[variant]
    launch = xg.geometry(form, reps, sms)
    assert launch.steps == -(-reps // form.rep_step)
    assert (launch.slices - 1) * launch.steps_per_slice < launch.steps
    assert launch.slices * launch.steps_per_slice >= launch.steps
    steps = [s for i in range(launch.slices) for s in launch.slice_steps(i)]
    assert steps == list(range(launch.steps))


@pytest.mark.parametrize("variant", FORMS)
def test_the_grid_fills_the_card_at_r(variant):
    """At R the grid holds at least two blocks per SM of the H100 (f32_2dot,
    dense4), or one wave of blocks on nine tenths of the SMs (bf16_1dot,
    whose block's set-up weighs a step: the fewest blocks win), with at
    least two warps per scheduler on each SM."""
    form, r_full = FORMS[variant]
    launch = xg.geometry(form, r_full)
    assert launch.blocks >= form.fill * xg.H100_SMS
    if form.fill == 0:
        assert 0.9 * xg.H100_SMS <= launch.blocks <= xg.H100_SMS * form.blocks_per_sm
    assert form.blocks_per_sm * form.threads // 32 >= 8


@pytest.mark.parametrize("variant", FORMS)
def test_shared_memory_fits(variant):
    form, _ = FORMS[variant]
    assert form.smem <= xg.SMEM_LIMIT
    assert form.blocks_per_sm >= 1
    assert form.blocks_per_sm * (form.smem + 1024) <= xg.SMEM_PER_SM
    assert {"f32_2dot": 229_376, "dense4": 52_224, "bf16_1dot": 123_904}[variant] == form.smem
    assert {"f32_2dot": 1, "dense4": 2, "bf16_1dot": 1}[variant] == form.blocks_per_sm


def _constexprs(namespace: str) -> dict[str, int]:
    """The ``constexpr int`` names of one namespace of the kernel source."""
    body = re.search(rf"namespace {namespace} {{(.*?)}}  // namespace {namespace}",
                     SOURCE.read_text(), re.S).group(1)
    out = {}
    for stmt in re.findall(r"constexpr int ([^;]+);", body):
        for part in stmt.split(","):
            name, expr = (x.strip() for x in part.split("="))
            out[name] = eval(re.sub(r"//.*", "", expr), {}, dict(out))   # noqa: S307
    return out


@pytest.mark.parametrize("namespace, form", [("gi", xg.F32_GEMM), ("gj", xg.DENSE4_GEMM),
                                             ("gb", xg.BF16_GEMM)])
def test_host_geometry_is_the_sources(namespace, form):
    """The host's geometry is the one ``exp_xpass_gemm.cu`` is compiled with
    (on the card, ``iqo_exp_xpass_gemm_shape`` says the same)."""
    k = _constexprs(namespace)
    assert (k["kThreads"], k["kRows"], k["kRepStep"], k["kKC"], k["kK"]) == \
        (form.threads, form.rows, form.rep_step, form.kc, form.k)
    assert k["kM"] == form.m and k["kChunks"] == form.chunks
    smem = k["kSmem"]
    assert smem == form.smem
    if namespace in ("gi", "gb"):
        assert (k["kN"], k["kTH"] // k["kRows"], k["kGroups"]) == (form.cols, form.tiles_z,
                                                                    form.tiles_y)
    else:
        assert (k["kCols"], k["kTW"] // k["kCols"], k["kTH"] // k["kRows"]) == \
            (form.cols, form.tiles_y, form.tiles_z)


def test_source_names_what_it_replaces():
    head = SOURCE.read_text().split("#include")[0]
    for ref in ("scripts/exp_x_schemes.py", ":156", ":271", "scripts/exp_vpu_xpass.py",
                "1.41 us", "0.0477 us", "0.445 us", "mad.lo.u32", "bf16_bound"):
        assert ref in head


# ---- the meeting of the slices, the split -----------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uint32_meeting_equals_the_serial_sum_where_it_wraps(seed):
    """Partial sums of repeat slices, added into a zeroed output in any order
    by uint32 addition, equal the serial int32-wrapped sum, also where every
    partial and the total pass 2^31."""
    rng = np.random.default_rng(seed)
    parts = rng.integers(2**30, 2**31, (7, 64)).astype(np.int64) * rng.choice([-1, 1], (7, 64))
    serial = (parts.sum(0) + 2**31) % 2**32 - 2**31
    assert (np.abs(parts.sum(0)) > 2**31).any()
    for order in (range(7), rng.permutation(7)):
        out = np.zeros(64, np.uint32)
        for i in order:
            out = xg.wrap_add(out, parts[i])
        np.testing.assert_array_equal(out.view(np.int32), serial)


def test_split_is_the_plain_versions():
    x = np.array([-2**31, -32769, -257, -256, -1, 0, 255, 256, 32767, 2**31 - 1], np.int32)
    hi, lo = xg.split_f32(x)
    wr = torch.from_numpy(x.astype(np.int64))[None, None]
    want_hi, want_lo = xs.split("f32_2dot", wr)
    assert hi.tolist() == want_hi.ravel().tolist() and lo.tolist() == want_lo.ravel().tolist()
    dh, dl = vx.split_dense(torch.from_numpy(x).view(1, -1), torch.tensor([0]))
    assert hi.tolist() == dh.ravel().tolist() and lo.tolist() == dl.ravel().tolist()


# ---- the wrappers -------------------------------------------------------------

def test_forms_and_launch_keys():
    assert xs.ROWS[-3:] == (("f32_2dot", "gemm"), ("bf16_1dot", "gemm"), ("s16_1dot", "gemm"))
    assert vx.ROWS[-1] == ("dense4", "gemm")
    assert set(xs.LAUNCHES) == {*xs.VARIANTS, "f32_2dot[gemm]", "bf16_1dot[gemm]",
                                "s16_1dot[gemm]", "s8_4dot[gemm]", "s8_2dot_cat[gemm]"}
    assert xs.launch_key("s16_1dot", "gemm") == "s16_1dot[gemm]"
    assert xs.launch_key("bf16_1dot", "gemm") == "bf16_1dot[gemm]"
    assert set(vx.LAUNCHES) == {*vx.VARIANTS, "dense4[gemm]", "corr_f32[wide]", "muls_f32[wide]"}
    assert xs.launch_key("f32_2dot", "serial") == "f32_2dot"


@pytest.mark.parametrize("variant, form", [("f32_2dot", "nope"), ("s8_2dot_cat", "wgmma"),
                                           ("s16_1dot", "wgmma"), ("empty", "dense"),
                                           ("bf16_1dot", "wgmma")])
def test_x_scheme_refuses_a_bad_form(xs_inputs, variant, form):
    w, c = xs_inputs
    with pytest.raises(ValueError, match="takes form"):
        xs.x_scheme(variant, w, xs.build_cvals(variant, c), 1, form)


@pytest.mark.parametrize("variant, form", [("dense4", "serial2"), ("corr_i32", "gemm")])
def test_vpu_xpass_refuses_a_bad_form(vx_ops, variant, form):
    with pytest.raises(ValueError, match="takes form"):
        vx.vpu_xpass(variant, vx_ops, 1, form)


def test_bf16_gemm_takes_the_k_major_taps(xs_inputs):
    """The gemm form reads ``cbf_k``, the taps laid out K-major once by
    build_cvals; without it, or with it off shape or strided, it refuses."""
    w, c = xs_inputs
    cv = xs.build_cvals("bf16_1dot", c)
    assert torch.equal(cv["cbf_k"], cv["cbf"].transpose(1, 2)) and cv["cbf_k"].is_contiguous()
    with pytest.raises(ValueError, match="cbf_k"):
        xs.x_scheme("bf16_1dot", w, {"cbf": cv["cbf"]}, 1, "gemm")
    with pytest.raises(ValueError, match="cbf_k"):
        xs.x_scheme("bf16_1dot", w, {**cv, "cbf_k": cv["cbf"]}, 1, "gemm")
    strided = torch.empty((3, 128, 2 * 384), dtype=torch.bfloat16)[..., ::2]
    strided.copy_(cv["cbf_k"])
    with pytest.raises(ValueError, match="contiguous"):
        xs.x_scheme("bf16_1dot", w, {**cv, "cbf_k": strided}, 1, "gemm")
    # the serial form reads cbf only
    assert torch.equal(xs.x_scheme("bf16_1dot", w, {"cbf": cv["cbf"]}, 1, "serial"),
                       xs.x_scheme_plain("bf16_1dot", w, cv, 1))


def test_wrappers_refuse_non_contiguous_tensors(xs_inputs, vx_ops):
    w, c = xs_inputs
    cv = xs.build_cvals("f32_2dot", c)
    strided = torch.empty((160, 2 * 896), dtype=torch.int32)[:, ::2]
    strided.copy_(w)
    with pytest.raises(ValueError, match="contiguous"):
        xs.x_scheme("f32_2dot", strided, cv, 1)
    cxt = torch.empty((2, 384, 2 * 896), dtype=torch.bfloat16)[..., ::2]
    cxt.copy_(vx_ops.cxt)
    with pytest.raises(ValueError, match="contiguous"):
        vx.vpu_xpass("dense4", dataclasses.replace(vx_ops, cxt=cxt), 1)


def test_wrappers_refuse_other_devices(xs_inputs, vx_ops):
    w, c = xs_inputs
    cv = {k: v.to("meta") for k, v in xs.build_cvals("f32_2dot", c).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        xs.x_scheme("f32_2dot", w.to("meta"), cv, 1, "gemm")
    with pytest.raises(ValueError, match="several devices"):
        xs.x_scheme("f32_2dot", w, cv, 1, "gemm")
    ops = dataclasses.replace(vx_ops, wd=vx_ops.wd.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        vx.vpu_xpass("dense4", ops, 1, "gemm")


def test_gemm_forms_run_the_plain_versions_on_cpu(xs_inputs, vx_ops):
    """On CPU tensors every form is the plain version, and nothing counts as
    a launch."""
    xs.reset_launches()
    vx.reset_launches()
    w, c = xs_inputs
    cv = xs.build_cvals("f32_2dot", c)
    assert torch.equal(xs.x_scheme("f32_2dot", w, cv, 2),
                       xs.x_scheme("f32_2dot", w, cv, 2, "serial"))
    assert torch.equal(vx.vpu_xpass("dense4", vx_ops, 1),
                       vx.vpu_xpass_plain("dense4", vx_ops, 1))
    cvb = xs.build_cvals("bf16_1dot", c)
    assert torch.equal(xs.x_scheme("bf16_1dot", w, cvb, 2),
                       xs.x_scheme_plain("bf16_1dot", w, cvb, 2))
    assert xs.LAUNCHES.total() == 0 and vx.LAUNCHES.total() == 0


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the gemm forms' kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 3, xs.R // 8])
def test_f32_gemm_equals_plain_on_card(cuda_device, reps):
    w, c = xs.inputs(cuda_device)
    cv = xs.build_cvals("f32_2dot", c)
    got = xs.x_scheme("f32_2dot", w, cv, reps, "gemm")
    assert torch.equal(got, xs.x_scheme_plain("f32_2dot", w, cv, reps))
    if reps == 1:
        assert torch.equal(got, xs.gold(w, c))


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("reps", [1, 3, 64, 67, xs.R])
def test_bf16_gemm_within_the_bound_of_plain_on_card(cuda_device, reps, wide):
    """On the script's tile every block takes the float path; with work
    column 800 of the first row tile raised by 2^24 (in group 2's window
    only, where no tap reads it) that block takes the int32 path."""
    w, c = xs.inputs(cuda_device)
    if wide:
        w[:16, 800] += 2**24
    cv = xs.build_cvals("bf16_1dot", c)
    got = xs.x_scheme("bf16_1dot", w, cv, reps, "gemm")
    err = (got.to(torch.int64) - xs.x_scheme_plain("bf16_1dot", w, cv, reps).to(torch.int64))
    assert bool((err.abs().to(torch.float64) <= xs.bf16_bound(w, cv, reps)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, vx.R // 8, vx.R])   # R / 8 is 3
def test_dense4_gemm_equals_plain_on_card(cuda_device, reps):
    ops = vx.operands(cuda_device)
    assert torch.equal(vx.vpu_xpass("dense4", ops, reps, "gemm"),
                       vx.vpu_xpass_plain("dense4", ops, reps))
