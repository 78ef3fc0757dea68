"""The band-fetch probes (``libiqo_tpu_torch/experiments/exp_band_shape``,
``exp_i32_band``, ``exp_overlap``, ``exp_blocked_halo``) against the TPU
scripts they port, on the CPU at small sizes.

Each script is loaded from ``scripts/`` with ``importlib``, its size
constants and the constants derived from them set small (``H``, ``W``,
``N_T``, ``CLAMP_HI``; for exp_overlap also ``ND`` and ``N_TY``), and its own
Pallas kernels run in interpret mode (``pl.pallas_call`` patched with
``interpret=True`` inside each test only).  The same seeded inputs go
through the port's wrappers on CPU tensors, which run the plain versions.
Tolerance 0: every result is an integer function of integer inputs, and the
plain versions' float64 dots are exact (every sum stays below 2^24).  The
streamed operands of ``streams``/``vmem`` are nonzero here, so that a
mis-indexed ``j % 1920`` or ``j % 128`` shows.  Tests that need the card are
``cuda``-marked and skip without one.
"""

from __future__ import annotations

import ast
import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import (exp_band_shape, exp_blocked_halo, exp_i32_band,
                                          exp_overlap)
from libiqo_tpu_torch.tools import sass_loads

ROOT = Path(__file__).resolve().parent.parent
BAND_SHAPE = dict(H=320, W=256, N_T=(320 - 96) // 64 + 1, CLAMP_HI=320 - 96)
OVERLAP_SHAPE = dict(H=700, W=256, ND=128, N_TY=4, CLAMP_HI=(700 - 208) // 32 * 32)
HALO_CONFIGS = (("small", 4, 64, 64, 256), ("small-halo32", 4, 64, 32, 256),
                ("narrow", 6, 64, 64, 128))
NEW_MODULES = (exp_band_shape, exp_i32_band, exp_overlap, exp_blocked_halo)


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


def _shrunk(monkeypatch, name: str, port, shape: dict):
    """The script ``name`` and the port's module, both at ``shape``."""
    mod = _script(name)
    for k, v in shape.items():
        monkeypatch.setattr(mod, k, v)
        if hasattr(port, k):
            monkeypatch.setattr(port, k, v)
    return mod


@pytest.fixture
def band_shape(monkeypatch, interpret):
    return _shrunk(monkeypatch, "exp_band_shape", exp_band_shape, BAND_SHAPE)


@pytest.fixture
def i32_band(monkeypatch, interpret):
    return _shrunk(monkeypatch, "exp_i32_band", exp_i32_band,
                   {k: BAND_SHAPE[k] for k in ("H", "W", "N_T")})


@pytest.fixture
def overlap(monkeypatch, interpret):
    return _shrunk(monkeypatch, "exp_overlap", exp_overlap, OVERLAP_SHAPE)


def _tpu(call, *args):
    return np.asarray(call(*args))


def _ops(seed):
    return exp_band_shape.operands("cpu", BAND_SHAPE["N_T"], seed)


def _script_band_shape(mod, form, coef, src, ops):
    """The script's variant ``form`` on (coef, src), called as its main does
    (``:207-216``) with ``ops`` as its streamed operands."""
    call, ndim = mod.build(form, coef.numpy())
    x = src.numpy() if ndim == 2 else src.numpy()[None]
    rows = [r.numpy() for r in ops.rows]
    cols = [c.numpy() for c in ops.cols]
    if form == "streams":
        return _tpu(call, coef.numpy(), x, *rows, *cols)
    if form == "vmem":
        return _tpu(call, coef.numpy(), x, ops.slab.numpy(), *rows, *cols)
    return _tpu(call, coef.numpy(), x)


def _port_band_shape(form, coef, src, ops):
    x = src[None] if form in ("grid3", "clamp", "u8out", "streams", "vmem") else src
    return exp_band_shape.band_ydot(coef, x, form,
                                    ops if form in ("streams", "vmem") else None)


# ---- kernel E: exp_band_shape and exp_i32_band ---------------------------

@pytest.mark.parametrize("form", exp_band_shape.FORMS)
def test_band_ydot_equals_script(band_shape, form):
    coef, src = exp_band_shape.inputs("cpu")
    ops = _ops(seed=7)
    want = _script_band_shape(band_shape, form, coef, src, ops)
    got = _port_band_shape(form, coef, src, ops)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_streamed_operands_reach_every_column(band_shape):
    """streams/vmem with nonzero operands differ from u8out: each operand
    moves the output, and the row and column operands are read by index."""
    coef, src = exp_band_shape.inputs("cpu")
    ops = _ops(seed=7)
    u8 = _port_band_shape("u8out", coef, src, None).to(torch.int64)
    streams = _port_band_shape("streams", coef, src, ops).to(torch.int64)
    rows = sum(r.to(torch.int64) for r in ops.rows)
    cols = sum(c.to(torch.int64) for c in ops.cols)[0]
    w = BAND_SHAPE["W"]
    np.testing.assert_array_equal(streams.numpy(), ((u8 + rows + cols[:w]) & 255).numpy())
    vmem = _port_band_shape("vmem", coef, src, ops).to(torch.int64)
    slab = ops.slab[0].to(torch.int64)
    np.testing.assert_array_equal(
        vmem.numpy(), ((streams + slab.repeat(w // 128)[:w]) & 255).numpy())
    assert not torch.equal(vmem, streams)


def test_vmem_is_base_masked(band_shape):
    """The script's vmem stores ``r & 255`` in int32 (``:86-87``) and so
    never equals its unmasked base (``:223``): with the script's zero
    operands it is exactly ``base & 255``, on both sides."""
    coef, src = exp_band_shape.inputs("cpu")
    zero = _ops(seed=None)
    base = _script_band_shape(band_shape, "base", coef, src, zero)
    vmem = _script_band_shape(band_shape, "vmem", coef, src, zero)
    assert vmem.dtype == np.int32 and (vmem[0] != base).any()
    np.testing.assert_array_equal(vmem[0], base & 255)
    port = _port_band_shape("vmem", coef, src, zero)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port[0].numpy(), base & 255)


def test_vmem_copies_the_slab_into_scratch():
    coef, src = exp_band_shape.inputs("cpu")
    ops = exp_band_shape.operands("cpu", 2, seed=3)
    scratch = torch.zeros_like(ops.slab)
    exp_band_shape.band_ydot(coef, src[None, :160, :256].contiguous(), "vmem", ops, scratch)
    assert torch.equal(scratch, ops.slab) and ops.slab.abs().sum() > 0


def test_clamp_forms_clamp_to_the_last_window():
    """The clamp forms' offsets stop at H - 96 (the script's ``off``,
    ``:79-84``); at the scripts' sizes no window needs it, and every window
    lies inside the plane."""
    assert exp_band_shape._offsets(320, True) == exp_band_shape._offsets(320, False)
    assert exp_band_shape._offsets(2160, True)[-1] == 2048 <= 2160 - 96
    assert exp_band_shape._offsets(200, True) == [0, 64]


@pytest.mark.parametrize("row", ["u8", "i32"])
def test_i32_band_equals_script(i32_band, row):
    coef, src = exp_i32_band.inputs("cpu")
    if row == "u8":
        want = _tpu(i32_band.build_u8(coef.numpy()), coef.numpy(), src.numpy())
        got = exp_band_shape.band_ydot(coef, src, "base")
    else:
        words = exp_i32_band.to_words(src)
        want = _tpu(i32_band.build_i32(coef.numpy()), coef.numpy(), words.numpy())
        got = exp_band_shape.band_ydot(coef, words, "i32")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_i32_words_and_permutation(i32_band):
    coef, src = exp_i32_band.inputs("cpu")
    words = exp_i32_band.to_words(src)
    # the script's packing (:167-170): byte b of word q is column 4 q + b
    s32 = src.numpy().reshape(src.shape[0], -1, 4).astype(np.int64)
    s32 = s32[..., 0] | s32[..., 1] << 8 | s32[..., 2] << 16 | s32[..., 3] << 24
    np.testing.assert_array_equal(words.numpy(), ((s32 + 2**31) % 2**32 - 2**31))
    w = BAND_SHAPE["W"]
    perm = exp_i32_band.permutation(w)
    assert perm[:3].tolist() == [0, 4, 8] and int(perm[w // 4]) == 1
    assert int(perm[-1]) == w - 1
    o_u8, o_i32 = exp_i32_band.rows(coef, src)
    np.testing.assert_array_equal(o_i32[:, 3 * w // 4 + 5].numpy(), o_u8[:, 4 * 5 + 3].numpy())


# ---- kernel G: exp_overlap ------------------------------------------------

@pytest.mark.parametrize("p", exp_overlap.PS)
@pytest.mark.parametrize("variant", exp_overlap.VARIANTS)
def test_overlap_dots_equals_script(overlap, variant, p):
    src, coef = exp_overlap.inputs("cpu")
    want = _tpu(overlap.build(variant, p), src.numpy(), coef.numpy())
    got = exp_overlap.overlap_dots(src, coef, variant, p)
    n_rows = OVERLAP_SHAPE["N_TY"] * 96
    assert got.dtype == torch.uint8 and got.shape == want.shape == (n_rows, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_overlap_blocked_reads_zeros_past_the_plane(overlap):
    """H = 700 and 4 blocks of 192 rows: the last block covers rows
    576-767, so 68 of its rows lie past the plane and read as zeros."""
    src, coef = exp_overlap.inputs("cpu")
    h, nd = OVERLAP_SHAPE["H"], OVERLAP_SHAPE["ND"]
    assert 3 * 192 < h < 4 * 192
    padded = np.zeros((4 * 192, nd), np.int64)
    padded[:h] = src.numpy()[:, :nd]
    c = coef.numpy().astype(np.int64)
    want = np.concatenate([
        sum(c @ padded[192 * t + 8 * i:192 * t + 8 * i + 128].astype(np.uint8)
            .view(np.int8).astype(np.int64) for i in range(8)) & 255
        for t in range(4)]).astype(np.uint8)
    got = exp_overlap.overlap_dots(src, coef, "blocked", 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _tpu(overlap.build("blocked", 8),
                                                    src.numpy(), coef.numpy()))
    # P = 0 copies the block's first 96 rows: all in the plane here
    np.testing.assert_array_equal(exp_overlap.overlap_dots(src, coef, "blocked", 0)[288:].numpy(),
                                  src.numpy()[576:672, :nd])


def test_overlap_elem_windows_clamp():
    src, coef = exp_overlap.inputs("cpu")
    out = exp_overlap.overlap_dots(src[:700], coef, "elem", 0, nd=128, n_ty=4)
    # tile 3 wants row 576 but clamps to (700 - 208) // 32 * 32 = 480
    np.testing.assert_array_equal(out[288:].numpy(), src[480:576, :128].numpy())


# ---- kernel H: exp_blocked_halo -------------------------------------------

@pytest.mark.parametrize("variant", exp_blocked_halo.VARIANTS)
@pytest.mark.parametrize("config", HALO_CONFIGS, ids=[c[0] for c in HALO_CONFIGS])
def test_band_colsum_equals_script(interpret, config, variant):
    mod = _script("exp_blocked_halo")
    _, n_t, step, halo, w = config
    call, n_rows = mod.build(variant, n_t, step, halo, w)
    x = np.random.default_rng(n_t + halo).integers(0, 256, (n_rows, w), np.uint8)
    got = exp_blocked_halo.band_colsum(torch.from_numpy(x), variant, n_t, step, halo)
    want = _tpu(call, x)
    assert got.dtype == torch.int32 and got.shape == want.shape == (8 * n_t, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_band_colsum_halo_comes_from_the_second_plane():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (4 * 64 + 32, 128), np.uint8))
    y = torch.from_numpy(rng.integers(0, 256, (4 * 64 + 32, 128), np.uint8))
    got = exp_blocked_halo.band_colsum(x, "blocked2", 4, 64, 32, y)
    t = 2
    want = (x[64 * t:64 * t + 64].to(torch.int64).sum(0)
            + y[64 * t + 64:64 * t + 96].to(torch.int64).sum(0))
    np.testing.assert_array_equal(got[8 * t:8 * t + 8].numpy(),
                                  want.expand(8, -1).numpy())
    assert torch.equal(exp_blocked_halo.band_colsum(x, "blocked2", 4, 64, 32, x),
                       exp_blocked_halo.band_colsum(x, "element", 4, 64, 32))


def test_halo_sources_follow_the_script_order():
    rng = np.random.default_rng(0)
    seen = list(exp_blocked_halo.sources("cpu", HALO_CONFIGS))
    assert [(s[0], s[5]) for s in seen] == [(c[0], v) for c in HALO_CONFIGS
                                            for v in exp_blocked_halo.VARIANTS]
    for name, n_t, step, halo, w, variant, x in seen:
        np.testing.assert_array_equal(
            x.numpy(), rng.integers(0, 256, (n_t * step + halo, w), np.uint8))


# ---- draws, bounds, devices, counts, entry points -------------------------

def test_inputs_reproduce_the_scripts_draws(monkeypatch):
    for port in (exp_band_shape, exp_i32_band, exp_overlap):
        monkeypatch.setattr(port, "H", 320)
        monkeypatch.setattr(port, "W", 256)
    for port in (exp_band_shape, exp_i32_band):      # coef, then src
        rng = np.random.default_rng(0)
        coef, src = port.inputs("cpu")
        np.testing.assert_array_equal(coef.numpy(), rng.integers(-64, 64, (32, 96), np.int8))
        np.testing.assert_array_equal(src.numpy(), rng.integers(0, 256, (320, 256), np.uint8))
    rng = np.random.default_rng(0)                   # src, then coef
    src, coef = exp_overlap.inputs("cpu")
    np.testing.assert_array_equal(src.numpy(), rng.integers(0, 256, (320, 256), np.uint8))
    np.testing.assert_array_equal(coef.numpy(),
                                  rng.integers(-64, 64, (96, 128)).astype(np.int8))
    assert coef.dtype == torch.int8


def test_bounds_of_each_probe():
    ms, by, nbytes, macs, fetched = exp_band_shape.bound("base")
    assert by == "bytes" and nbytes == 2144 * 3840 + 32 * 96 + 1056 * 3840 * 4
    assert round(ms * 1e3, 1) == 7.3 and fetched == 33 * 96 * 3840
    assert round(macs / 1e9, 2) == 0.39
    assert round(exp_band_shape.bound("u8out")[0] * 1e3, 1) == 3.7
    assert exp_band_shape.bound("streams")[2] == exp_band_shape.bound("u8out")[2] + \
        3 * 1056 * 4 + 3 * 1920 * 4
    assert exp_band_shape.bound("vmem")[2] == exp_band_shape.bound("grid3")[2] + \
        3 * 1056 * 4 + 3 * 1920 * 4 + 2 * 4718592
    assert exp_band_shape.bound("i32")[2] == nbytes
    ms, by, nbytes, macs, fetched = exp_overlap.bound("elem", 8)
    assert by == "operations" and macs == 96 * 128 * 1920 * 12 * 8
    assert round(ms * 1e3, 1) == 2.3 and round(nbytes / 3.35e12 * 1e6, 1) == 1.8
    assert fetched == (11 * 208 + 208) * 1920
    # P = 0 reads 96 rows of each window; blocked's last block stops at H
    assert exp_overlap.bound("parallel", 0)[2] == (11 * 96 + 32) * 1920 + 1152 * 1920
    assert exp_overlap.bound("blocked", 8)[4] == (2160 - 0) * 1920
    ms, by, nbytes, fetched = exp_blocked_halo.bound("element", 64, 64, 64, 3840)
    assert (nbytes, fetched) == (15974400 + 7864320, 64 * 128 * 3840)
    assert round(ms * 1e3, 1) == 7.1 and round(fetched / 1e6, 1) == 31.5
    ms, _, nbytes, _ = exp_blocked_halo.bound("element", 256, 64, 64, 512)
    assert nbytes == 8421376 + 4194304 and round(ms * 1e3, 1) == 3.8
    assert exp_blocked_halo.bound("blocked1", 64, 64, 64, 3840)[2] == 4096 * 3840 + 7864320


def test_wrappers_refuse_other_devices_and_bad_calls():
    coef, src = exp_band_shape.inputs("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        exp_band_shape.band_ydot(coef.to("meta"), src.to("meta"), "base")
    with pytest.raises(ValueError, match="several devices"):
        exp_band_shape.band_ydot(coef, src.to("meta"), "base")
    with pytest.raises(ValueError, match="3-D"):
        exp_band_shape.band_ydot(coef, src, "grid3")
    with pytest.raises(ValueError, match="StreamOperands"):
        exp_band_shape.band_ydot(coef, src[None], "streams")
    with pytest.raises(ValueError, match="forms are"):
        exp_band_shape.band_ydot(coef, src, "nope")
    osrc, ocoef = exp_overlap.inputs("cpu")
    with pytest.raises(ValueError, match="several devices"):
        exp_overlap.overlap_dots(osrc, ocoef.to("meta"), "elem", 1)
    with pytest.raises(ValueError, match="read past"):
        exp_overlap.overlap_dots(osrc, ocoef, "blocked", 10)
    x = torch.zeros((4 * 64 + 64, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="several devices"):
        exp_blocked_halo.band_colsum(x, "blocked2", 4, 64, 64, x.to("meta"))
    with pytest.raises(ValueError, match="must be"):
        exp_blocked_halo.band_colsum(x[:-1], "element", 4, 64, 64)
    exp_blocked_halo.band_colsum(x[:-64], "blocked1", 4, 64, 64)   # the step rows suffice


def test_launches_stay_zero_on_cpu():
    for mod in (exp_band_shape, exp_overlap, exp_blocked_halo):
        mod.reset_launches()
    coef, src = exp_band_shape.inputs("cpu")
    small = src[:160, :256].contiguous()
    exp_band_shape.band_ydot(coef, small, "base")
    exp_band_shape.band_ydot(coef, exp_i32_band.to_words(small), "i32")
    osrc, ocoef = exp_overlap.inputs("cpu")
    exp_overlap.overlap_dots(osrc[:208], ocoef, "parallel", 1, nd=128, n_ty=1)
    exp_blocked_halo.band_colsum(torch.zeros((72, 128), dtype=torch.uint8), "element", 1, 64, 8)
    for mod in (exp_band_shape, exp_overlap, exp_blocked_halo):
        assert mod.LAUNCHES.total() == 0
    forms = set(exp_band_shape.FORMS) | {"i32"}
    assert set(exp_band_shape.LAUNCHES) == forms | {f"{f}[ring]" for f in forms}
    assert len(exp_overlap.LAUNCHES) == 40 and len(exp_blocked_halo.LAUNCHES) == 6


@pytest.mark.parametrize("mod", NEW_MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_raises_without_a_card(monkeypatch, mod):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


@pytest.mark.parametrize("name", ["exp_band_shape", "exp_i32_band", "exp_overlap",
                                  "exp_blocked_halo"])
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


def test_sass_load_depths():
    sass = """
        /*0000*/                   LDG.E.CONSTANT R2, desc[UR6][R4.64] ;
        /*0010*/                   LDG.E.CONSTANT R3, desc[UR6][R6.64] ;
        /*0020*/              @P0  LDG.E.CONSTANT R8, desc[UR6][R6.64] ;
        /*0030*/                   IADD3 R9, R2, R3, RZ ;
        /*0040*/                   STS [R8], R9 ;
        /*0050*/                   LDG.E.U8.CONSTANT R12, desc[UR6][R4.64+0x4] ;
        /*0060*/                   MOV R12, RZ ;
        /*0070*/                   LDGSTS.E.BYPASS.LTC128B.128 [R5], desc[UR6][R2.64] ;
    """
    # R12 is overwritten, never read: it counts every later load (none)
    assert sass_loads.load_depths(sass) == [2, 1, 0, 0]


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the probes' kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_band_kernels_equal_plain_on_card(cuda_device):
    coef, src = (t.to(cuda_device) for t in exp_band_shape.inputs("cpu"))
    small = src[:320, :256].contiguous()
    ops = exp_band_shape.operands(cuda_device, 4, seed=7)
    for form in exp_band_shape.FORMS:
        got = _port_band_shape(form, coef, small, ops)
        x = small[None] if got.ndim == 3 else small
        want = exp_band_shape.band_ydot_plain(coef, x, form,
                                              ops if form in ("streams", "vmem") else None)
        assert torch.equal(got, want), form
    words = exp_i32_band.to_words(small)
    assert torch.equal(exp_band_shape.band_ydot(coef, words, "i32"),
                       exp_band_shape.band_ydot_plain(coef, words, "i32"))
    osrc, ocoef = (t.to(cuda_device) for t in exp_overlap.inputs("cpu"))
    osrc = osrc[:700, :256].contiguous()
    for variant in exp_overlap.VARIANTS:
        for p in exp_overlap.PS:
            assert torch.equal(exp_overlap.overlap_dots(osrc, ocoef, variant, p, 128, 4),
                               exp_overlap.overlap_dots_plain(osrc, ocoef, variant, p, 128, 4))
    for name, n_t, step, halo, w, variant, x in exp_blocked_halo.sources(cuda_device,
                                                                         HALO_CONFIGS):
        assert torch.equal(exp_blocked_halo.band_colsum(x, variant, n_t, step, halo),
                           exp_blocked_halo.band_colsum_plain(x, variant, n_t, step, halo))
