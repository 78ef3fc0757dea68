"""The tiled resize kernel's host side (``cuda_resize.tiled_*``) and a NumPy
model of ``csrc/resize_tiled.cu``.

The kernel runs only on an NVIDIA card.  Here a NumPy model reads the very
tile records the kernel is handed, word by word as the kernel reads them,
and computes what the kernel computes: per (row tile, column tile) the
staged band at an arbitrary misalignment, with uninitialised shared memory
filled with noise; the Y pass as the merged s8 matrix against the band
rebased by ``^ 0x80`` plus the correction ``128 * sum cy``, or as the
IMAD taps; the 16-bit work tile; the X pass from each output's unclamped
first tap and its phase's coefficients, per tap or, in the window form,
from each thread's 32-bit words of the work row; the epilogue.  The model
is held to ``numpy_ref`` on the kernel-host test's plans and a seeded fuzz
of all three algorithms, and to the JAX package's Pallas kernel in
interpret mode on small plans.  Tests marked ``cuda`` run the kernel and
skip without a card.
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


def _x_sums(plan, lay, work, cr, tx, mis, rows, ncol):
    """The exact X pass's uint32 sums (rows, ncol) of one tile from the
    16-bit work tile ``work`` and column record ``cr``, as the kernel reads
    them: per tap, each output's taps at its own unclamped first tap; in
    the window form, each thread's ``(x_window + 2) // 2`` words from its
    first value rounded down to even (held inside the work row), its
    outputs' taps ``x_step`` apart in them."""
    tw, ml, wp = lay.tw, lay.margin, lay.work_pitch
    nu = int(cr[2])
    xs = cr[HEAD:HEAD + tw].astype(np.int64)
    ph = cr[HEAD + tw:HEAD + 2 * tw]
    cxu = cr[HEAD + 3 * tw:HEAD + 3 * tw + tx * lay.max_phases]
    cxu = cxu.reshape(tx, lay.max_phases).astype(np.int64)
    wv = _wrap16(work) if plan.wrap16 else work
    if not lay.x_step:
        idx = ml + mis + xs[:ncol, None] + np.arange(tx)     # (ncol, tx)
        assert idx.min() >= 0 and idx.max() < wp
        c = cxu[:, ph[:ncol] if nu > 1 else np.zeros(ncol, np.int64)].T
        return (wv[:rows][:, idx] * c).sum(axis=2) & 0xFFFFFFFF
    per, nw = tw // TH, (lay.x_window + 2) // 2
    s0 = ml + mis + xs[::per]                             # each thread's first value
    w0 = s0 >> 1
    assert w0.min() >= 0 and (w0 + nw).max() <= wp // 2   # its words lie in the row
    words = work[:rows, 0::2] | (work[:rows, 1::2] << 16)
    win = words[:, w0[:, None] + np.arange(nw)]            # (rows, 16, nw)
    vals = np.stack([win & 0xFFFF, win >> 16], axis=-1).reshape(rows, TH, 2 * nw)
    if plan.wrap16:
        vals = _wrap16(vals)
    q = ((s0 & 1)[:, None, None] + lay.x_step * np.arange(per)[:, None]
         + np.arange(tx))                                  # (16, per, tx)
    assert q.max() < 2 * nw
    taps = vals[:, np.arange(TH)[:, None, None], q]        # (rows, 16, per, tx)
    pj = ph.reshape(TH, per) if nu > 1 else np.zeros((TH, per), np.int64)
    c = cxu[:, pj].transpose(1, 2, 0)                      # (16, per, tx)
    s = (taps * c).sum(axis=3).reshape(rows, tw)
    return s[:, :ncol] & 0xFFFFFFFF


def _tiled_model(plan, k: cuda_resize.TiledTables, src, mis_of, noise):
    """What resize_tiled.cu computes for one frame; ``mis_of(rt, ct)`` is
    the band's misalignment (the source address's low 4 bits) and
    ``noise`` draws the bytes of shared memory nobody wrote."""
    lay = k.layout
    rrec, crec = k.rrec.numpy(), k.crec.numpy()
    tw, pitch, kr, wp, ml = (lay.tw, lay.pitch, lay.k_rows, lay.work_pitch,
                             lay.margin)
    ty, tx = k.taps_y, k.taps_x
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
            lo, width = int(cr[0]), int(cr[1])
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
            else:
                assert acc[:, mis:mis + width].max(initial=0) <= 65280
                work[:, ml:ml + ncols] = acc & 0xFFFF
            xdiv = cr[HEAD + 2 * tw:HEAD + 3 * tw].astype(np.int64)
            r0, c0 = rt * TH, ct * tw
            rows, ncol = min(TH, dst_h - r0), min(tw, dst_w - c0)
            s = _x_sums(plan, lay, work, cr, tx, mis, rows, ncol)
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
    # the window form's pitch (its X pass takes the luma plane)
    assert lay.x_step == 2 and lay.work_pitch % 64 == 36 and lay.margin % 8 == 0
    assert lay.k_rows % 32 == 0
    assert lay.smem <= cuda_resize.SMEM_BUDGET


def _steps(plan, tw):
    """The steps between the first taps of a thread's adjacent outputs
    (``tw // 16`` a thread), over every thread of the plan."""
    per, start = tw // TH, plan.x.start.astype(np.int64)
    return {int(start[j + 1] - start[j]) for j in range(plan.x.n_dst - 1)
            if (j + 1) % per}


WINDOW_PLANS = {**MAIN_PLANS, **U16_PLANS, **{
    f"fuzz{i}": dict(algorithm=a, **kw, src_w=sw, src_h=sh, dst_w=dw, dst_h=dh)
    for i, (a, kw, sw, sh, dw, dh) in enumerate(_fuzz_plans(24, 20261017))}}


@pytest.mark.parametrize("name", sorted(WINDOW_PLANS))
def test_x_window_covers_taps_and_stays_in_the_row(name):
    """The X pass takes its window form exactly where every thread's
    outputs start one whole step apart, a step of at most X_STEPS, and the
    window fits X_WINDOW; there each thread's window holds its outputs'
    taps and its word loads stay inside the work-tile row at every band
    misalignment."""
    plan = build_plan(**WINDOW_PLANS[name])
    lay = cuda_resize.tiled_layout(plan)
    per, tx = lay.tw // TH, plan.x.num_coefs
    steps = _steps(plan, lay.tw)
    step = steps.pop() if len(steps) == 1 else 0
    window = step * (per - 1) + tx
    takes = (not steps and 1 <= step <= cuda_resize.X_STEPS
             and window <= cuda_resize.X_WINDOW)
    assert (lay.x_step, lay.x_window) == ((step, window) if takes else (0, 0))
    if not takes:
        assert lay.work_pitch % 64 == 32
        return
    assert lay.work_pitch % 64 == 36
    nw = (window + 2) // 2
    xs = lay.crec[:, HEAD:HEAD + lay.tw].astype(np.int64)
    for ct in range(len(xs)):
        cols = min(lay.tw, plan.x.n_dst - ct * lay.tw)
        for j0 in range(0, lay.tw, per):
            for mis in range(16):
                s0 = lay.margin + mis + xs[ct, j0]
                assert 0 <= s0 >> 1 and (s0 >> 1) + nw <= lay.work_pitch // 2
                j = np.arange(j0, min(j0 + per, cols))
                first = lay.margin + mis + xs[ct, j]
                assert (first >= s0).all() and (first + tx <= s0 + window).all()


@pytest.mark.parametrize("kw, tw", [
    (dict(algorithm="lanczos", src_w=7680, src_h=4320, dst_w=960, dst_h=540, degree=3),
     64),                                                   # 8:1, 48 taps: 72 values
    (dict(algorithm="lanczos", src_w=512, src_h=64, dst_w=64, dst_h=8, degree=3), 32),
    (U16_PLANS["linear4k_luma"], 128),                      # steps of 0 and 1
], ids=["8k_to_960x540", "lanczos_8to1", "linear_up"])
def test_plans_past_the_window_keep_the_per_tap_form(kw, tw):
    plan = build_plan(**kw)
    lay = cuda_resize.tiled_layout(plan)
    assert lay.tw == tw and (lay.x_step, lay.x_window) == (0, 0)
    assert lay.work_pitch % 64 == 32


def test_x_window_of_the_main_planes_and_the_relaxed_form():
    """The benchmark cells' planes take the window (Lanczos3 4K -> 1080p
    luma 26 values, its px2 chroma 18, Area 1080p -> 360p 6, Area 2:1 16);
    the relaxed form never does."""
    windows = {name: cuda_resize.tiled_layout(build_plan(**kw)).x_window
               for name, kw in {**MAIN_PLANS, **U16_PLANS}.items()}
    assert windows == {"luma": 26, "chroma": 18, "area360p_luma": 6, "area360p_chroma": 6,
                       "area1080p": 16, "linear4k_luma": 0, "linear4k_chroma": 0}
    for kw in MAIN_PLANS.values():
        lay = cuda_resize.tiled_layout(build_plan(**kw), relaxed=True)
        assert lay.x_step == 0 and lay.work_pitch % 64 == 32
    assert cuda_resize.launch_form(cuda_resize.kernel_tables(build_plan(**MAIN_PLANS["luma"]))
                                   ) == "tiled.x_window"
    assert cuda_resize.launch_form(cuda_resize.kernel_tables(
        build_plan(**MAIN_PLANS["luma"]), relaxed=True)) == "tiled.x_taps"
    assert cuda_resize.launch_form(cuda_resize.kernel_tables(
        build_plan(**MAIN_PLANS["luma"]), tiled=False)) is None


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
