"""The tiled resize kernel's host side (``cuda_resize.tiled_*``) and a NumPy
model of ``csrc/resize_tiled.cu``.

The kernel runs only on an NVIDIA card.  Here a NumPy model reads the very
tile records the kernel is handed, word by word as the kernel reads them,
and computes what the kernel computes: per (row tile, column tile) the
staged band at an arbitrary misalignment, with uninitialised shared memory
filled with noise; the Y pass as the merged s8 matrix against the band
rebased by ``^ 0x80`` plus the correction ``128 * sum cy``, or as the
IMAD taps; the 16-bit work tile; the X pass from each output's unclamped
first tap and its phase's coefficients; the epilogue.  The model is held
to ``numpy_ref`` on the kernel-host test's plans and a seeded fuzz of all
three algorithms, and to the JAX package's Pallas kernel in interpret mode
on small plans.  Tests marked ``cuda`` run the kernel and skip without a
card.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.ops.pallas_resize import make_resize_fn
from libiqo_tpu_torch.coeffs.engine import trunc_div
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize, torch_resize
from libiqo_tpu_torch.tools import tiled_ablate

from test_torch_kernel_host import (MAIN_PLANS, MODEL_PLANS, U16_PLANS,  # noqa: F401
                                    cuda_device)

TH = cuda_resize.TILE_ROWS
HEAD = 4


def _wrap16(v):
    low = np.asarray(v).astype(np.int64) & 0xFFFF
    return low - ((low & 0x8000) << 1)


def _swz(r, c, pitch):
    """The kernel's swizzled byte offset of band (row r, byte column c)."""
    return r * pitch + ((((c >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (c & 15)


def _tiled_model(plan, k: cuda_resize.TiledTables, src, mis_of, noise):
    """What resize_tiled.cu computes for one frame; ``mis_of(rt, ct)`` is
    the band's misalignment (the source address's low 4 bits) and
    ``noise`` draws the bytes of shared memory nobody wrote."""
    lay = k.layout
    rrec, crec = k.rrec.numpy(), k.crec.numpy()
    tw, pitch, kr, wp, ml = (lay.tw, lay.pitch, lay.k_rows, lay.work_pitch,
                             lay.margin)
    ty, tx, nu_max = k.taps_y, k.taps_x, lay.max_phases
    dst_h, dst_w = plan.y.n_dst, plan.x.n_dst
    src_h, src_w = src.shape
    half = 1 << (plan.out_shift - 1)
    out = np.full((dst_h, dst_w), 7, np.uint8)
    for rt, rr in enumerate(rrec):
        rlo, bh = int(rr[0]), int(rr[1])
        corr = rr[HEAD:HEAD + TH].astype(np.int64)
        ydiv = rr[HEAD + TH:HEAD + 2 * TH].astype(np.int64)
        ytab = rr[HEAD + 2 * TH:]
        for ct, cr in enumerate(crec):
            lo, width, nu = int(cr[0]), int(cr[1]), int(cr[2])
            mis = mis_of(rt, ct)
            # the band: byte columns [0, mis + width) are source columns
            # lo - mis + c where they lie in the row; the rest is noise
            band = noise(kr * pitch).astype(np.int64)
            c = np.arange(16 * -(-(mis + width) // 16))
            col = lo - mis + c
            c, col = c[(col >= 0) & (col < src_w)], col[(col >= 0) & (col < src_w)]
            r = np.arange(bh)[:, None]
            band[_swz(r, c[None], pitch)] = src[rlo + r, col[None]]
            work = noise(TH * wp * 2).view(np.uint16).astype(np.int64)
            work = work.reshape(TH, wp)
            if lay.s8y:
                ka = kr + 16
                a = ytab[:TH * ka // 4].view(np.uint8).reshape(TH, ka)
                a = a.astype(np.int8).astype(np.int64)[:, :kr]
                ncols = 32 * -(-(mis + width) // 32)
                cols = np.arange(ncols)
                b = np.stack([band[_swz(r, cols, pitch)] for r in range(kr)])
                b = (b ^ 0x80).astype(np.uint8).view(np.int8).astype(np.int64)
                dot = a @ b                               # s32, no overflow
                assert np.abs(dot).max(initial=0) < 2**31
                acc = (dot + corr[:, None]) & 0xFFFFFFFF
            else:
                cy = ytab[:ty * TH].reshape(ty, TH).astype(np.int64)
                iyr = ytab[ty * TH:2 * ty * TH].reshape(ty, TH)
                ncols = 8 * -(-(mis + width) // 8)
                cols = np.arange(ncols)
                acc = np.zeros((TH, ncols), np.int64)
                for t in range(ty):
                    acc += cy[t][:, None] * band[_swz(iyr[t][:, None], cols, pitch)]
                acc &= 0xFFFFFFFF
            if plan.wrap16:
                w = _wrap16(acc)
                d = ydiv != 0
                w[d] = _wrap16(trunc_div(w[d] * plan.y.bias, ydiv[d, None]))
                work[:, ml:ml + ncols] = w & 0xFFFF
                wv = _wrap16(work)
            else:
                assert acc[:, mis:mis + width].max(initial=0) <= 65280
                work[:, ml:ml + ncols] = acc & 0xFFFF
                wv = work
            xs = cr[HEAD:HEAD + tw].astype(np.int64)
            ph = cr[HEAD + tw:HEAD + 2 * tw]
            xdiv = cr[HEAD + 2 * tw:HEAD + 3 * tw].astype(np.int64)
            cxu = cr[HEAD + 3 * tw:HEAD + 3 * tw + tx * nu_max]
            cxu = cxu.reshape(tx, nu_max).astype(np.int64)
            r0, c0 = rt * TH, ct * tw
            rows, ncol = min(TH, dst_h - r0), min(tw, dst_w - c0)
            idx = ml + mis + xs[:ncol, None] + np.arange(tx)     # (ncol, tx)
            assert idx.min() >= 0 and idx.max() < wp
            c = (cxu[:, :1] if nu == 1 else cxu[:, ph[:ncol]]).T
            s = (wv[:rows][:, idx] * c).sum(axis=2) & 0xFFFFFFFF
            s = (s + half) & 0xFFFFFFFF
            if plan.wrap16:
                si = s - ((s & 0x80000000) << 1)
                d = xdiv[:ncol]
                v = _wrap16(np.where(d != 0, trunc_div(si, np.where(d, d, 1)),
                                     si >> plan.out_shift))
            else:
                assert (s < 2**31).all()
                v = s >> plan.out_shift
            out[r0:r0 + rows, c0:c0 + ncol] = np.clip(v, 0, 255)
    return out


def _model(plan, src, seed=0):
    k = cuda_resize.tiled_tables(plan)
    rng = np.random.default_rng(seed)
    mis = rng.integers(0, 16, (len(k.rrec), len(k.crec)))
    return _tiled_model(plan, k, src, lambda r, c: int(mis[r, c]),
                        lambda n: rng.integers(0, 256, n, dtype=np.uint8))


def _fuzz_plans(n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        algo = ("lanczos", "area", "linear")[i % 3]
        src = rng.integers(9, 160, 2) | (i % 2)
        if i % 4 < 2:
            dst = np.maximum(1, src // rng.integers(1, 5, 2))
        else:
            dst = src * rng.integers(1, 3, 2) + rng.integers(0, 7, 2)
        kw = (dict(degree=int(2 + i % 4), px_scale=int(1 + (i // 3) % 2))
              if algo == "lanczos" else {})
        yield algo, kw, int(src[0]), int(src[1]), int(dst[0]), int(dst[1])


@pytest.mark.parametrize("algo,kw,sw,sh,dw,dh", MODEL_PLANS)
def test_tiled_model_matches_oracle(algo, kw, sw, sh, dw, dh):
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    assert cuda_resize.tiled_ok(plan)
    src = np.random.default_rng(sw * dh).integers(0, 256, (sh, sw), np.uint8)
    np.testing.assert_array_equal(_model(plan, src, sw + dh),
                                  numpy_ref.resize_u8(plan, src))


@pytest.mark.parametrize("case", list(_fuzz_plans(24, 20261017)),
                         ids=lambda c: f"{c[0]}{c[1] or ''}-{c[2]}x{c[3]}-{c[4]}x{c[5]}")
def test_tiled_model_fuzz(case):
    algo, kw, sw, sh, dw, dh = case
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    if not cuda_resize.supports_plan(plan):
        pytest.fail(f"fuzz plan outside the kernel's scope: {case}")
    assert cuda_resize.tiled_ok(plan)
    src = np.random.default_rng(sw + 7 * dh).integers(0, 256, (sh, sw), np.uint8)
    np.testing.assert_array_equal(_model(plan, src, sh),
                                  numpy_ref.resize_u8(plan, src))


@pytest.mark.parametrize("algo,kw,sw,sh,dw,dh", [
    ("lanczos", dict(degree=3), 128, 96, 64, 48),                 # 2:1
    ("lanczos", dict(degree=3, px_scale=2), 96, 64, 48, 32),      # px2 chroma-like
    ("area", {}, 144, 96, 48, 32),                                # 3:1
    ("linear", {}, 40, 30, 96, 70),                               # upscale
])
def test_tiled_model_matches_pallas_interpret(algo, kw, sw, sh, dw, dh):
    """The model equals the JAX package's Pallas kernel, run in interpret
    mode on the CPU, at 0 LSB."""
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    src = np.random.default_rng(sw * sh).integers(0, 256, (sh, sw), np.uint8)
    fn, ops = make_resize_fn(jax_build_plan(algo, sw, sh, dw, dh, **kw),
                             interpret=True)
    want = np.asarray(jax.jit(fn)(*ops, jnp.asarray(src)))
    np.testing.assert_array_equal(_model(plan, src, 3), want)


@pytest.mark.parametrize("name", sorted(MAIN_PLANS) + sorted(U16_PLANS))
def test_tiled_bands_cover_every_tap(name):
    plan = build_plan(**{**MAIN_PLANS, **U16_PLANS}[name])
    k = cuda_resize.tiled_tables(plan)
    lay = k.layout
    rrec, crec = k.rrec.numpy(), k.crec.numpy()
    iy = torch_resize.clamped_taps(plan.y)
    rt = np.arange(plan.y.n_dst) // TH
    rlo, bh = rrec[rt, 0][:, None], rrec[rt, 1][:, None]
    assert ((iy >= rlo) & (iy < rlo + bh)).all()
    assert (rrec[:, 1] <= lay.k_rows).all()
    ix = torch_resize.clamped_taps(plan.x)
    ct = np.arange(plan.x.n_dst) // lay.tw
    lo, width = crec[ct, 0][:, None], crec[ct, 1][:, None]
    assert ((ix >= lo) & (ix < lo + width)).all()
    assert (crec[:, 1] + 15 <= lay.pitch).all()
    # taps inside the plane are read at their own columns: unclamped
    # first tap + t == the clamped index wherever the coefficient is not 0
    xs = crec[ct, HEAD + np.arange(plan.x.n_dst) % lay.tw]
    taps = lo + xs[:, None] + np.arange(plan.x.num_coefs)
    nz = plan.x.coef != 0
    assert (taps[nz] == ix[nz]).all()


@pytest.mark.parametrize("name", sorted(MAIN_PLANS) + sorted(U16_PLANS))
def test_tiled_merged_y_and_gate(name):
    plan = build_plan(**{**MAIN_PLANS, **U16_PLANS}[name])
    lay = cuda_resize.tiled_layout(plan)
    rwin = cuda_resize.tile_windows(plan.y, TH).astype(np.int64)
    a = cuda_resize._merged_y(plan, rwin, lay.k_rows)
    # merged rows sum to the raw taps, and the dense matrix agrees
    n = plan.y.n_dst
    flat = a.reshape(-1, lay.k_rows)[:n]
    np.testing.assert_array_equal(flat.sum(axis=1), plan.y.coef.sum(axis=1))
    dense = plan.y.dense(np.int64)
    for i in (0, 1, n // 2, n - 1):
        lo = rwin[i // TH, 0]
        row = np.zeros(plan.y.n_src, np.int64)
        row[lo:lo + lay.k_rows] = flat[i][:plan.y.n_src - lo]
        # dense() drops out-of-range taps; clamping adds them to the edge
        # rows with coefficient 0, so the two agree
        np.testing.assert_array_equal(row, dense[i])
    fits = bool(a.min() >= -128 and a.max() <= 127)
    assert lay.s8y == fits
    # the main Lanczos and Area 360p planes pass the gate; Area 2:1 (taps
    # of 128) and the Linear upscales do not
    assert lay.s8y == (name in ("luma", "chroma", "area360p_luma",
                                "area360p_chroma"))
    rrec = lay.rrec
    corr = rrec[:, HEAD:HEAD + TH].astype(np.int64).reshape(-1)[:n]
    np.testing.assert_array_equal(corr, 128 * plan.y.coef.astype(np.int64).sum(axis=1))


def test_tiled_width_fills_the_card():
    for name in ("area360p_luma", "area360p_chroma"):
        plan = build_plan(**U16_PLANS[name])
        tw = cuda_resize.tiled_width(plan)
        rows = -(-plan.y.n_dst // TH)
        batch = 2 if name.endswith("chroma") else 1     # U and V in one call
        blocks = -(-plan.x.n_dst // tw) * rows * batch
        assert tw == 32
        if name.endswith("luma"):
            assert blocks >= cuda_resize.TILED_BLOCKS
        else:   # 240: the most that TW 32 gives a 320 x 180 pair
            assert blocks == 240
    for name in MAIN_PLANS:
        assert cuda_resize.tiled_width(build_plan(**MAIN_PLANS[name])) == 128


def test_tiled_ok_refuses_over_budget_and_keeps_windowed_route(monkeypatch):
    plan = build_plan("lanczos", 3840, 2160, 1920, 16, degree=3)   # 135:1 rows
    assert cuda_resize.supports_plan(plan)
    assert not cuda_resize.tiled_ok(plan)
    assert cuda_resize.tiled_layout(plan).smem > cuda_resize.SMEM_BUDGET
    # no tiled width fits: the wide-window kernel, and with wide=False the
    # windowed kernel
    tables = cuda_resize.kernel_tables(plan)
    assert isinstance(tables, cuda_resize.WideTables)
    assert cuda_resize.variant(tables) == "wrap16_wide"
    walk = cuda_resize.kernel_tables(plan, wide=False)
    assert isinstance(walk, cuda_resize.KernelTables)
    assert cuda_resize.variant(walk) == "wrap16"
    small = build_plan("lanczos", 128, 96, 64, 48, degree=3)
    assert cuda_resize.tiled_ok(small)
    monkeypatch.setattr(cuda_resize, "SMEM_BUDGET",
                        cuda_resize.tiled_layout(small).smem - 1)
    assert not cuda_resize.tiled_ok(small)


def test_tiled_routes(monkeypatch):
    plan = build_plan(**MAIN_PLANS["luma"])
    t = cuda_resize.kernel_tables(plan)
    assert cuda_resize.variant(t) == "wrap16_tiled"
    assert cuda_resize.variant(cuda_resize.kernel_tables(plan, tiled=False)) == "wrap16"
    # carry and relaxed take the tiled kernel's forms; tiled=False the
    # windowed kernel's
    assert cuda_resize.carry_ok(plan)
    assert cuda_resize.variant(
        cuda_resize.kernel_tables(plan, carry=True)) == "wrap16_carry_tiled"
    assert cuda_resize.variant(cuda_resize.kernel_tables(
        plan, carry=True, tiled=False)) == "wrap16_carry"
    assert cuda_resize.variant(
        cuda_resize.kernel_tables(plan, relaxed=True)) == "wrap16_relaxed_tiled"
    assert cuda_resize.variant(cuda_resize.kernel_tables(
        plan, relaxed=True, tiled=False)) == "wrap16_relaxed"
    chroma = build_plan(**MAIN_PLANS["chroma"])
    assert not cuda_resize.carry_ok(chroma)
    assert cuda_resize.tiled_carry_layout(chroma) is None
    assert cuda_resize.variant(
        cuda_resize.kernel_tables(chroma, carry=True)) == "wrap16_tiled"
    area = build_plan(**U16_PLANS["area360p_luma"])
    assert cuda_resize.variant(cuda_resize.kernel_tables(area)) == "u16_tiled"
    # the CPU keeps no kernel tables: the plain path runs, nothing launches
    ops = cuda_resize.pack_operands(area)
    assert ops.tables is None
    cuda_resize.reset_launches()
    src = torch.zeros((1, 1080, 1920), dtype=torch.uint8)
    assert cuda_resize.resize_fused(ops, src).shape == (1, 360, 640)
    assert cuda_resize.LAUNCHES == 0


OVER_BUDGET = dict(algorithm="lanczos", src_w=3840, src_h=2160, dst_w=1920,
                   dst_h=16, degree=3)        # 135:1 rows: a band over budget


@pytest.mark.parametrize("kw", [*MAIN_PLANS.values(), *U16_PLANS.values(),
                                OVER_BUDGET],
                         ids=[*MAIN_PLANS, *U16_PLANS, "over_budget"])
def test_kernel_tables_builds_one_layout_and_follows_tiled_ok(monkeypatch, kw):
    """kernel_tables takes the tiled route exactly where tiled_ok holds,
    builds the plan's tiled layout once to decide and fill it, and its
    default route is pack_operands's."""
    plan = build_plan(**kw)
    built = []
    layout = cuda_resize.tiled_layout
    monkeypatch.setattr(cuda_resize, "tiled_layout",
                        lambda p, *a: built.append(p) or layout(p, *a))
    tables = cuda_resize.kernel_tables(plan)
    assert len(built) == 1
    assert isinstance(tables, cuda_resize.TiledTables) == cuda_resize.tiled_ok(plan)
    assert tables.tiled == cuda_resize.tiled_ok(plan)
    defaults = [inspect.signature(f).parameters["tiled"].default
                for f in (cuda_resize.kernel_tables, cuda_resize.pack_operands)]
    assert defaults == [True, True]


def test_tiled_records_are_int32_words():
    plan = build_plan(**MAIN_PLANS["luma"])
    lay = cuda_resize.tiled_layout(plan)
    for rec in (lay.rrec, lay.crec):
        assert rec.dtype == np.int32 and rec.shape[1] % 4 == 0
    assert lay.pitch % cuda_resize.BAND_ALIGN == 0
    assert lay.work_pitch % 64 == 32 and lay.margin % 8 == 0
    assert lay.k_rows % 32 == 0
    assert lay.smem <= cuda_resize.SMEM_BUDGET


@pytest.mark.parametrize("name", sorted(tiled_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_source(name):
    """Each of tools/tiled_ablate.py's variants finds its texts in the
    current kernel source, and changes it unless it is the kernel itself."""
    text = tiled_ablate.variant_source(name)
    assert (text == tiled_ablate.SOURCE.read_text()) == (name == "kernel")
    if name != "kernel":
        with pytest.raises(ValueError):
            tiled_ablate.variant_source(name, source="// no kernel here")


def test_ablation_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="unknown variants"):
        tiled_ablate.main(["no_such_variant"])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tiled_ablate.main(["no_x"])


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MAIN_PLANS) + sorted(U16_PLANS))
@pytest.mark.parametrize("offset", [0, 5])
def test_tiled_kernel_matches_plain_on_card(cuda_device, name, offset):
    """Byte-equal to the plain path, from an aligned source and from one
    whose rows start ``offset`` bytes into a wider, odd-pitched buffer."""
    plan = build_plan(**{**MAIN_PLANS, **U16_PLANS}[name])
    ops = cuda_resize.pack_operands(plan, cuda_device)
    assert ops.tables.tiled
    h, w = plan.y.n_src, plan.x.n_src
    rng = np.random.default_rng(11)
    wide = torch.from_numpy(rng.integers(0, 256, (2, h, w + 2 * offset + 1),
                                         np.uint8)).to(cuda_device)
    src = wide[:, :, offset:offset + w] if offset else wide[:, :, :w].contiguous()
    v = cuda_resize.variant(ops.tables)
    before = cuda_resize.LAUNCHES_BY_VARIANT[v]
    got = cuda_resize.resize_fused(ops, src)
    assert cuda_resize.LAUNCHES_BY_VARIANT[v] == before + 1
    assert torch.equal(got, cuda_resize.resize_plain(ops, src))
