"""The wide-window kernel (``libiqo_tpu_torch/csrc/resize_wide.cu``) on the
CPU: its schedule, and a NumPy model that computes in the kernel's own
order.

The exact plans whose 16-row work tile does not fit shared memory
(``cuda_resize.work_rows`` < 16) and that the tiled kernel refuses take
this kernel.  :func:`wide_model` walks a :class:`cuda_resize.WideLayout`
block by block as the kernel does: 16-byte pieces (or bytes) of source
rows from the window's start rounded down to the load width, the bytes
past the row's end that a piece brings along drawn as noise, the Y
taps in ``ks`` slices whose uint32 sums meet afterwards (the u16 form's
16-bit lanes checked to hold each slice's sum), the int16 wrap and border
renormalisation once on the complete sum, uninitialised shared memory as
noise, each output's X taps split over ``group`` lanes and met by a
butterfly, then the epilogue.  On small plans under reduced budgets and
block targets (so that the slices, splits, narrow tiles and shrunk rows
happen) it equals ``numpy_ref`` and the plain path; at the byte extremes
it exercises the int16 and int32 wraps and the border divides; and on Area
8192x4 -> 16x4 it equals the JAX package's Pallas kernel in interpret mode,
on a Lanczos wide plan its XLA path, and on 16-row plans that no tiled
width takes (the thumbnails) both.  Tolerance 0: the contract is
byte-exact.  Its relaxed form rounds each complete work value to bf16 and
sums each output's relaxed plane, then its residual plane, in float32 on
one thread, one rounded product and one rounded add a tap in tap order;
it equals ``torch_resize.resize_relaxed`` at 0 LSB (the relaxed form's
contract with its plain version) and is within 2 LSB of the JAX package's
exact output (the relaxed contract).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.ops import pallas_resize
from libiqo_tpu_torch import api
from libiqo_tpu_torch.coeffs.engine import trunc_div
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize as cr
from libiqo_tpu_torch.tools import card_check

CARD = torch.device("cuda", 0)
M32 = np.uint64(2**32 - 1)
FACADE_PLANS = card_check.WIDE_FACADE


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _u32(a):
    return np.asarray(a).astype(np.int64).astype(np.uint64) & M32


def _wrap16(v):
    low = np.asarray(v).astype(np.int64) & 0xFFFF
    return low - ((low & 0x8000) << 1)


def _as_i32(v):
    v = np.asarray(v).astype(np.int64) & 0xFFFFFFFF
    return v - ((v & 0x80000000) << 1)


def _loaded(src, lo_al: int, ng: int, align: int, noise) -> np.ndarray:
    """(src_h, 16 ng) uint64: the bytes a block's Y items load, pieces of
    ``align`` bytes from ``lo_al``: a piece that starts past the row's end
    is zeros, a piece that starts inside it brings the bytes past the end
    along (the next row's, or the buffer's: noise here)."""
    sh, sw = src.shape
    width = cr.WIDE_GROUP_COLS * ng
    cols = lo_al + np.arange(width)
    out = noise.integers(0, 256, (sh, width)).astype(np.uint64)
    inside = cols < sw
    out[:, inside] = src[:, cols[inside]]
    piece = (cols - lo_al) // align * align + lo_al
    out[:, piece >= sw] = 0
    return out


def _float_taps(plane: np.ndarray, w: np.ndarray) -> int:
    """sum_t plane[t] * w[t] in float32, one rounded product and one
    rounded add a tap, in tap order, truncated toward zero, as uint32."""
    acc = np.float32(0)
    for c, v in zip(plane, w):
        acc = np.float32(acc + np.float32(c * v))
    return int(np.trunc(acc)) & 0xFFFFFFFF


def wide_model(plan, lay: cr.WideLayout, src: np.ndarray, align: int = 16,
               seed: int = 0) -> np.ndarray:
    """What ``resize_wide.cu`` computes for one frame, block by block, in
    its order (see the module docstring), in the layout's form, exact or
    relaxed; ``align`` is the load width the kernel picks from the source's
    alignment (16 or 1)."""
    noise = np.random.default_rng(seed)
    sh, sw = src.shape
    dh, dw = plan.y.n_dst, plan.x.n_dst
    cy, cx = plan.y.coef.astype(np.int64), plan.x.coef.astype(np.int64)
    ys, xs = plan.y.start.astype(np.int64), plan.x.start.astype(np.int64)
    ydiv = np.where(plan.y.is_border, np.where(plan.y.deno == 0, 1, plan.y.deno), 0)
    xdiv = cr._x_divisors(plan)
    half = 1 << (plan.out_shift - 1)
    taps_y, taps_x = lay.taps_y, lay.taps_x
    assert lay.wp % 4 == 0 and lay.group & (lay.group - 1) == 0 and lay.group <= 32
    if lay.relaxed:         # one thread an output; its planes, output-major
        assert lay.group == 1
        planes = [p.numpy().T.astype(np.float32) for p in cr.relaxed_plane(plan.x)
                  if p is not None]
        assert len(planes) == lay.planes
    assert lay.n_ct == -(-dw // lay.tc) and lay.n_rt == -(-dh // lay.tr)
    out = np.zeros((dh, dw), np.uint8)
    written = np.zeros((dh, dw), np.int64)
    slice_ = -(-taps_y // lay.ks)
    for b in range(lay.blocks):
        ct, rt = b % lay.n_ct, b // lay.n_ct
        r0, c0 = rt * lay.tr, ct * lay.tc
        rows, cols = min(lay.tr, dh - r0), min(lay.tc, dw - c0)
        lo, hi = (int(v) for v in lay.win[ct])
        lo_al = lo - lo % align
        ng = -(-(hi - lo_al) // cr.WIDE_GROUP_COLS)
        assert ng <= lay.ng and ng * cr.WIDE_GROUP_COLS <= lay.wp
        band = _loaded(src, lo_al, ng, align, noise)
        # uninitialised shared memory, or zeros where the slices meet
        work = (np.zeros if lay.ks > 1 else
                lambda s, dtype: noise.integers(-2**31, 2**31, s).astype(dtype))(
                    (lay.tr, lay.wp), np.int64)
        for r in range(rows):
            i = r0 + r
            total = np.zeros(band.shape[1], np.uint64)
            for k in range(lay.ks):
                t = np.arange(k * slice_, min((k + 1) * slice_, taps_y))
                part = (_u32(cy[i, t])[:, None] * band[np.clip(ys[i] + t, 0, sh - 1)]
                        ).sum(axis=0) & M32 if len(t) else np.zeros_like(total)
                if not plan.wrap16:     # the 16-bit lanes hold each slice's sum
                    assert (cy[i, t] >= 0).all() and int(part.max(initial=0)) < 2**16
                total = (total + part) & M32
            w = total.astype(np.int64)
            if plan.wrap16:
                w = _wrap16(w)
                if ydiv[i]:
                    w = _wrap16(trunc_div(w * plan.y.bias, np.int64(ydiv[i])))
            if lay.relaxed:     # bf16 of the exact value, as float32 bits
                w = cr._bf16(w).astype(np.float32).view(np.int32)
            work[r, :len(w)] = w
        for o in range(lay.tr * lay.tc):
            r, jt = o % lay.tr, o // lay.tr
            if r >= rows or jt >= cols:
                continue
            j = c0 + jt
            idx = np.clip(xs[j] + np.arange(taps_x), 0, sw - 1) - lo_al
            assert ((idx >= lo - lo_al) & (idx < hi - lo_al)).all()
            if lay.relaxed:
                w = work[r, idx].astype(np.int32).view(np.float32)
                acc = sum(_float_taps(p[j], w) for p in planes) & 0xFFFFFFFF
            else:
                terms = (_u32(cx[j]) * _u32(work[r, idx])) & M32
                lanes = np.zeros(lay.group, np.uint64)
                np.add.at(lanes, np.arange(taps_x) % lay.group, terms)
                lanes &= M32
                off = lay.group // 2
                while off:
                    lanes = (lanes + lanes[np.arange(lay.group) ^ off]) & M32
                    off //= 2
                acc = int(lanes[0])
            if plan.wrap16 or lay.relaxed:
                s = int(_as_i32(acc + half))
                v = int(_wrap16(trunc_div(np.int64(s), np.int64(xdiv[j])) if xdiv[j]
                                else s >> plan.out_shift))
            else:
                v = ((acc + half) & 0xFFFFFFFF) >> plan.out_shift
            out[r0 + r, j] = min(max(v, 0), 255)
            written[r0 + r, j] += 1
    assert (written == 1).all()
    return out


def _swz(r, c, pitch):
    """The byte offset of band (row r, byte column c) in a slab: 16-byte
    pieces swizzled by row, as ``resize_tiled.cuh`` ``swz``."""
    return r * pitch + ((((c >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (c & 15)


def wide_s8_model(plan, s8: cr.WideS8, src: np.ndarray, offset: int = 0,
                  row_stride: int | None = None, seed: int = 0) -> np.ndarray:
    """What ``resize_wide_kernel_s8y`` computes for one frame, block by
    block in its order, from the records it is handed (``s8.rec``): the
    source's first byte at ``offset`` mod 16 and its rows ``row_stride``
    bytes apart set each block's misalignment; shared memory starts as
    noise; slab k of the band (source rows ``first + 32 k`` up to the
    tile's end, the bytes of each row inside the plane) lands in ring stage
    ``k % stages`` over whatever the stage held, and the Y dot reads all 32
    rows of the stage, A (zero past the band) against the bytes rebased by
    ``^ 0x80``, into s32 sums held to |sum| < 2^31; then ``128 * sum cy``
    back in uint32, the int16 wrap and border renormalisation into the
    16-bit work tile over the spent ring, and the per-tap X pass and
    epilogue of the tiled kernel."""
    noise = np.random.default_rng(seed)
    rec = s8.rec
    th, tw, pitch, kr = cr.TILE_ROWS, rec.tw, rec.pitch, rec.k_rows
    ml, wp, nph = rec.margin, rec.work_pitch, rec.max_phases
    sh, sw = src.shape
    stride = sw if row_stride is None else row_stride
    dh, dw = plan.y.n_dst, plan.x.n_dst
    tx, half = plan.x.num_coefs, 1 << (plan.out_shift - 1)
    assert plan.wrap16 and rec.s8y and not rec.x_step and pitch <= cr.WIDE_S8_COLS
    assert kr % 32 == 0
    assert len(rec.rrec) == -(-dh // th) and len(rec.crec) == -(-dw // tw)
    out = np.zeros((dh, dw), np.uint8)
    written = np.zeros((dh, dw), np.int64)
    for rt, rr in enumerate(rec.rrec.astype(np.int64)):
        first, end = int(rr[2]), int(rr[3])
        assert rr[0] == first and 0 <= first < end <= sh
        corr, ydiv = rr[4:4 + th] & M32.astype(np.int64), rr[4 + th:4 + 2 * th]
        a = rec.rrec[rt, 4 + 2 * th:].view(np.uint8)[:th * (kr + 16)].reshape(th, kr + 16)
        a = a.view(np.int8).astype(np.int64)
        assert not a[:, kr:].any()
        slabs = -(-(end - first) // 32)
        for ct, cw in enumerate(rec.crec.astype(np.int64)):
            lo, width = int(cw[0]), int(cw[1])
            mis = (offset + first * stride + lo) % 16
            cols = np.arange(32 * -(-(mis + width) // 32))
            assert len(cols) <= pitch
            region = noise.integers(0, 256, max(s8.stages * 32 * pitch, 2 * th * wp),
                                    dtype=np.uint8)
            acc = np.zeros((th, len(cols)), np.int64)
            piece = np.arange(16 * -(-(mis + width) // 16))
            col = lo - mis + piece
            inside = (col >= 0) & (col < sw)
            for k in range(slabs):
                base = (k % s8.stages) * 32 * pitch
                r = np.arange(min(32, end - first - 32 * k))[:, None]
                region[base + _swz(r, piece[inside][None], pitch)] = \
                    src[first + 32 * k + r, col[inside][None]]
                b = region[base + _swz(np.arange(32)[:, None], cols[None], pitch)]
                acc += a[:, 32 * k:32 * k + 32] @ (b ^ 0x80).view(np.int8).astype(np.int64)
            assert np.abs(acc).max(initial=0) < 2**31
            w = _wrap16((acc + corr[:, None]) & 0xFFFFFFFF)
            d = ydiv != 0
            w[d] = _wrap16(trunc_div(w[d] * plan.y.bias, ydiv[d, None]))
            work = region[:2 * th * wp].view("<u2").reshape(th, wp).astype(np.int64)
            work[:, ml:ml + len(cols)] = w & 0xFFFF
            wv = _wrap16(work)
            r0, c0 = rt * th, ct * tw
            rows, ncol = min(th, dh - r0), min(tw, dw - c0)
            xs, ph = cw[4:4 + tw][:ncol], cw[4 + tw:4 + 2 * tw][:ncol]
            xdiv = cw[4 + 2 * tw:4 + 3 * tw][:ncol]
            cxu = cw[4 + 3 * tw:4 + 3 * tw + tx * nph].reshape(tx, nph)
            idx = ml + mis + xs[:, None] + np.arange(tx)
            assert idx.min() >= 0 and idx.max() < wp
            c = cxu[:, ph if cw[2] > 1 else np.zeros(ncol, np.int64)].T
            si = _as_i32(((wv[:rows][:, idx] * c).sum(axis=2) + half) & 0xFFFFFFFF)
            v = _wrap16(np.where(xdiv != 0, trunc_div(si, np.where(xdiv, xdiv, 1)),
                                 si >> plan.out_shift))
            out[r0:r0 + rows, c0:c0 + ncol] = np.clip(v, 0, 255)
            written[r0:r0 + rows, c0:c0 + ncol] += 1
    assert (written == 1).all()
    return out


def route_model(plan, k, src: np.ndarray, align: int = 16) -> np.ndarray:
    """The model of the form the wide-window kernel's tables ``k`` launch:
    :func:`wide_s8_model` for the s8 Y form's (:class:`WideS8Tables`), else
    :func:`wide_model`."""
    if k.y_s8:
        return wide_s8_model(plan, k.layout, src, offset=0 if align == 16 else 5)
    return wide_model(plan, k.layout, src, align)


def _plan(case):
    alg, sw, sh, dw, dh, kw = case
    return build_plan(alg, sw, sh, dw, dh, **kw)


# ---- the schedule -----------------------------------------------------------


@pytest.mark.parametrize("case", FACADE_PLANS, ids=card_check.case_name)
def test_schedule_fills_the_card_and_fits(case):
    """A pure function of the plan; two blocks an SM, or a block an output
    where the plan has fewer outputs; within SMEM_BUDGET; the facade's
    route on the card is this kernel."""
    plan = _plan(case)
    assert cr.supports_plan(plan) and not cr.tiled_ok(plan)
    assert cr.work_rows(plan) < cr.TILE_ROWS
    lay = cr.wide_layout(plan)
    again = cr.wide_layout(_plan(case))
    assert (lay.tc, lay.tr, lay.ks, lay.group, lay.ng, lay.wp) == \
        (again.tc, again.tr, again.ks, again.group, again.ng, again.wp)
    assert np.array_equal(lay.win, again.win)
    assert lay.smem <= cr.SMEM_BUDGET
    assert lay.blocks >= cr.WIDE_BLOCKS or (lay.tc == 1 and lay.tr == 1)
    assert lay.tc & (lay.tc - 1) == 0 and lay.tc <= cr.TILE_COLS
    # each column tile's window lies inside its 128-column tile's
    big = cr.tile_windows(plan.x)
    owner = np.arange(lay.n_ct) * lay.tc // cr.TILE_COLS
    assert (lay.win[:, 0] >= big[owner, 0]).all() and (lay.win[:, 1] <= big[owner, 1]).all()
    k = cr.kernel_tables(plan)
    s8 = cr.wide_s8(plan) is not None
    assert k.wide and k.y_s8 == s8 and cr.variant(k) == (
        "wrap16_wide_s8" if s8 else "wrap16_wide" if plan.wrap16 else "u16_wide")
    assert api.Resizer.from_plan(plan, device="cpu")._backend_for(CARD) == "cuda"


def test_schedule_of_each_facade_plan():
    """The tiles, slices and lane groups the rule picks (PERF.md's table)."""
    got = {card_check.case_name(c): (lambda l: (l.tc, l.tr, l.ks, l.group, l.blocks))(
        cr.wide_layout(_plan(c))) for c in FACADE_PLANS}
    assert got == {
        "area 8192x4->16x4": (1, 1, 1, 32, 64),
        "area 4096x4096->128x128": (16, 2, 1, 8, 512),
        "area 3840x2160->128x72": (16, 2, 1, 8, 288),
        "area 7680x4320->240x135": (32, 4, 1, 2, 272),
        "lanczos3 7680x4320->240x135": (32, 4, 4, 2, 272)}


def test_item_slices_fill_the_threads():
    """Y taps slice only from WIDE_SLICE_TAPS an output row, into the
    fewest slices that fill the threads' last round."""
    for case in FACADE_PLANS:
        lay = cr.wide_layout(_plan(case))
        items = lay.tr * lay.ng * lay.ks
        share = items / (cr.WIDE_THREADS * -(-items // cr.WIDE_THREADS))
        assert lay.ks == 1 or share >= cr.WIDE_ITEM_SHARE or lay.ks == lay.taps_y // 4, case
        assert (lay.ks > 1) == (lay.taps_y >= cr.WIDE_SLICE_TAPS), case
        assert lay.ks <= max(1, lay.taps_y // 4)
        assert lay.tr * lay.tc * lay.group >= cr.WIDE_THREADS or lay.group in (
            32, 1 << (lay.taps_x - 1).bit_length()), case


def test_shared_memory_caps_rows_only_through_the_budget():
    """A reduced budget shrinks the rows, then the columns; the tile keeps
    every window inside its 128-column tile; one output a block that does
    not fit is None (the windowed walk then keeps the plan)."""
    plan = _plan(("lanczos", 7680, 60, 240, 30, dict(degree=3)))
    full = cr.wide_layout(plan)
    small = cr.wide_layout(plan, budget=full.smem // 3)
    assert small.smem <= full.smem // 3 and (small.tr, small.tc) < (full.tr, full.tc)
    assert cr.wide_layout(plan, budget=64) is None
    tall = build_plan("area", 8192, 240000, 16, 4)       # 60000 Y taps an output
    assert cr.supports_plan(tall) and cr.work_rows(tall) < cr.TILE_ROWS
    assert cr.wide_layout(tall) is None
    k = cr.kernel_tables(tall)
    assert isinstance(k, cr.KernelTables) and k.rows == cr.work_rows(tall)


def test_refused_layout_route_of_the_card_run():
    """``chip_smoke.py`` phase 3b's REFUSED_WIDE, Area 4096x232448 -> 16x4,
    takes the windowed kernel's walk on the facade: inside
    ``supports_plan``, 14 work rows (< 16), ``wide_layout`` refused (58112 Y
    taps an output do not fit shared memory), windowed tables on the u16
    instantiation."""
    import ast
    import re
    text = (Path(__file__).resolve().parent.parent / "chip_smoke.py").read_text()
    case = ast.literal_eval(re.search(r"^REFUSED_WIDE = (.*)$", text, re.M).group(1))
    assert case == ("area", 4096, 232448, 16, 4, {})
    plan = _plan(case)
    assert plan.y.num_coefs == 58112 and plan.x.num_coefs == 256
    assert cr.supports_plan(plan) and not cr.tiled_ok(plan)
    assert cr.work_rows(plan) == 14 < cr.TILE_ROWS
    assert cr.wide_layout(plan) is None
    k = cr.kernel_tables(plan)
    assert isinstance(k, cr.KernelTables) and k.rows == 14 and cr.variant(k) == "u16"


def test_old_walk_stays_reachable():
    """``wide=False`` keeps the windowed kernel's wide-window walk, for the
    timing turns; a plan with a 16-row tile that no tiled width takes now
    takes the new kernel, and the windowed kernel with ``wide=False``."""
    plan = _plan(FACADE_PLANS[0])
    k = cr.kernel_tables(plan, wide=False)
    assert isinstance(k, cr.KernelTables) and k.rows == cr.work_rows(plan) == 7
    assert cr.variant(k) == "u16"
    narrow = build_plan("lanczos", 3840, 2160, 1920, 16, degree=3)
    assert cr.work_rows(narrow) == cr.TILE_ROWS and not cr.tiled_ok(narrow)
    assert isinstance(cr.kernel_tables(narrow, tiled=False), cr.WideTables)
    walk = cr.kernel_tables(narrow, tiled=False, wide=False)
    assert isinstance(walk, cr.KernelTables) and walk.rows == cr.TILE_ROWS
    for case in card_check.WIDE_WINDOW[:2] + card_check.WIDE_WINDOW[6:]:
        p = _plan(case)
        assert cr.tiled_ok(p) and isinstance(cr.kernel_tables(p), cr.TiledTables)
        assert isinstance(cr.kernel_tables(p, tiled=False), cr.WideTables)


def test_relaxed_and_carry_keep_their_kernels():
    plan = _plan(FACADE_PLANS[4])
    assert not cr.supports_plan(plan, relaxed=True)
    assert cr.carry_layout(plan) is None
    assert isinstance(cr.kernel_tables(plan, carry=True), cr.WideS8Tables)
    strip = build_plan("lanczos", 3840, 2160, 256, 144, degree=3)
    wide = cr.kernel_tables(strip, relaxed=True, tiled=False)
    assert isinstance(wide, cr.WideTables) and cr.variant(wide) == "wrap16_relaxed_wide"
    walk = cr.kernel_tables(strip, relaxed=True, tiled=False, wide=False)
    assert isinstance(walk, cr.KernelTables) and cr.variant(walk) == "wrap16_relaxed"


def test_tables_are_output_major():
    plan = _plan(FACADE_PLANS[4])
    k = cr.wide_tables(plan)
    assert k.cy.shape == (plan.y.n_dst, plan.y.num_coefs) and k.cy.dtype == torch.int32
    assert k.cx.shape == (plan.x.n_dst, plan.x.num_coefs)
    assert torch.equal(k.ys, torch.from_numpy(plan.y.start.astype(np.int32)))
    np.testing.assert_array_equal(k.win.numpy(), k.layout.win)
    assert (k.ydiv.numpy() != 0).sum() == plan.y.is_border.sum() > 0
    assert (k.xdiv.numpy() != 0).sum() == plan.x.is_border.sum() > 0


def test_cpu_tensor_takes_the_plain_path():
    plan = _plan(FACADE_PLANS[0])
    ops = cr.KernelOperands(plain=cr.torch_resize.pack_operands(plan),
                            tables=cr.wide_tables(plan))
    src = card_check.source(FACADE_PLANS[0], 0)
    cr.reset_launches()
    got = cr.resize_fused(ops, torch.from_numpy(src)[None])[0].numpy()
    assert cr.LAUNCHES == 0
    np.testing.assert_array_equal(got, numpy_ref.resize_u8(plan, src))


# ---- the model against the oracle --------------------------------------------

# (case, budget, blocks): small plans under a reduced budget and block target,
# so that narrow tiles, shrunk rows, Y slices and lane splits happen
MODEL_CASES = [
    (("area", 8192, 4, 16, 4, {}), cr.SMEM_BUDGET, cr.WIDE_BLOCKS),
    (("area", 512, 96, 16, 3, {}), cr.SMEM_BUDGET, cr.WIDE_BLOCKS),      # 32 Y taps
    (("area", 512, 1024, 16, 4, {}), cr.SMEM_BUDGET, cr.WIDE_BLOCKS),    # 256 Y taps, ks
    (("area", 1000, 70, 37, 9, {}), 6000, 40),                          # ragged tiles
    (("lanczos", 2000, 90, 25, 11, dict(degree=3)), 12000, 30),         # wrap16 borders
    (("lanczos", 300, 1200, 23, 17, dict(degree=3)), 8000, 50),         # the same, ks
    (("lanczos", 600, 400, 37, 21, dict(degree=2)), cr.SMEM_BUDGET, 64),
    (("lanczos", 300, 200, 23, 17, dict(degree=3, px_scale=2)), 5000, 50),
    (("linear", 300, 40, 90, 13, {}), 3000, 20),
    (("lanczos", 90, 60, 180, 120, dict(degree=3)), 8000, 200),         # upscale
    (("area", 3000, 200, 300, 50, {}), cr.SMEM_BUDGET, 8),              # a lane an output
]


def _ids(c):
    case, budget, blocks = c
    return f"{card_check.case_name(case)}-b{budget}-n{blocks}"


@pytest.mark.parametrize("case,budget,blocks", MODEL_CASES, ids=[_ids(c) for c in MODEL_CASES])
@pytest.mark.parametrize("align", [16, 1])
def test_model_equals_oracle_and_plain(case, budget, blocks, align):
    plan = _plan(case)
    assert cr.supports_plan(plan)
    lay = cr.wide_layout(plan, budget=budget, blocks=blocks)
    assert lay.smem <= budget
    src = card_check.source(case, 0)
    want = numpy_ref.resize_u8(plan, src)
    np.testing.assert_array_equal(wide_model(plan, lay, src, align), want)
    plain = cr.resize_plain(cr.pack_operands(plan), torch.from_numpy(src)[None])[0]
    np.testing.assert_array_equal(plain.numpy(), want)


def test_model_cases_split_the_sums():
    """The model cases between them slice the Y taps, split X over lanes,
    shrink the rows under the budget and take ragged last tiles."""
    lays = [cr.wide_layout(_plan(c), budget=b, blocks=n) for c, b, n in MODEL_CASES]
    assert any(l.ks > 1 for l in lays) and any(l.group > 1 for l in lays)
    assert any(l.group == 32 for l in lays) and any(l.group == 1 for l in lays)
    assert any(l.tc > 1 and l.tr > 1 for l in lays)
    plans = [_plan(c) for c, _, _ in MODEL_CASES]
    assert any(p.y.n_dst % l.tr and p.x.n_dst % l.tc for p, l in zip(plans, lays))
    assert any(p.wrap16 and p.y.is_border.any() and l.ks > 1 for p, l in zip(plans, lays))


def _extreme(kind: str, shape) -> np.ndarray:
    h, w = shape
    if kind == "checker":
        return (((np.arange(h)[:, None] + np.arange(w)[None]) % 2) * 255).astype(np.uint8)
    return np.full(shape, {"zeros": 0, "ones": 255}[kind], np.uint8)


@pytest.mark.parametrize("kind", ["ones", "checker", "zeros"])
@pytest.mark.parametrize("case", [
    ("lanczos", 2000, 90, 25, 11, dict(degree=3)),
    ("lanczos", 363, 614, 30, 18, dict(degree=4)),
    ("lanczos", 300, 200, 23, 17, dict(degree=3, px_scale=2)),
    ("lanczos", 256, 70, 40, 5, dict(degree=7)),
], ids=card_check.case_name)
def test_model_at_byte_extremes(case, kind):
    """All-255 and checkerboards drive the int16 work wrap, the int32 X
    wrap and the border divides; under a small budget with lane splits,
    and with Y slices on the plans of at least WIDE_SLICE_TAPS Y taps."""
    plan = _plan(case)
    assert plan.wrap16 and cr.supports_plan(plan)
    lay = cr.wide_layout(plan, budget=6000, blocks=40)
    src = _extreme(kind, (case[2], case[1]))
    np.testing.assert_array_equal(wide_model(plan, lay, src), numpy_ref.resize_u8(plan, src))


def test_model_equals_the_jax_kernel_in_interpret_mode():
    """Area 8192x4 -> 16x4 through the JAX package's Pallas kernel on the
    CPU, as tests/test_pallas.py runs it."""
    import jax

    case = FACADE_PLANS[0]
    jplan = jax_build_plan(*case[:5])
    assert pallas_resize.supports_plan(jplan)
    fn, ops = pallas_resize.make_resize_fn(jplan, interpret=True)
    src = card_check.source(case, 0)
    want = np.asarray(jax.jit(fn)(*ops, src))
    plan = _plan(case)
    np.testing.assert_array_equal(wide_model(plan, cr.wide_layout(plan), src), want)


def test_model_equals_the_jax_xla_path_on_a_lanczos_wide_plan():
    """A Lanczos3 plan whose window is too wide for 16 rows, under the
    kernel's own layout, against the JAX package's XLA path."""
    from libiqo_tpu.ops.xla_resize import resize_xla

    case = ("lanczos", 7680, 30, 240, 15, dict(degree=3))
    plan = _plan(case)
    assert cr.work_rows(plan) < cr.TILE_ROWS
    src = card_check.source(case, 0)
    want = np.asarray(resize_xla(jax_build_plan(*case[:5], **case[5]), src))
    np.testing.assert_array_equal(wide_model(plan, cr.wide_layout(plan), src), want)


@pytest.mark.parametrize("case", card_check.WIDE_TIMED + card_check.THUMBNAILS[:-1],
                         ids=card_check.case_name)
def test_ablation_neighbours_fit(case):
    """``tools/wide_ablate.py``'s neighbours of each timed plan's layout fit
    the budget and are layouts the kernel takes; the Y slices are turned
    both ways where the plan has taps to slice."""
    from libiqo_tpu_torch.tools import wide_ablate

    plan = _plan(case)
    lay = cr.wide_layout(plan)
    got = wide_ablate.variants(plan, lay)
    assert got and all(v.smem <= cr.SMEM_BUDGET and v.ks <= v.taps_y for v in got.values())
    assert ("ks 1" in got) == (lay.ks > 1)
    assert ("ks 4" in got) == (lay.ks == 1 and lay.taps_y >= 8)


def test_load_width_is_asked_of_a_card_tensor():
    """``wide_load_bytes`` answers for CUDA tensors only (the kernel's own
    rule, in its library)."""
    with pytest.raises(ValueError):
        cr.wide_load_bytes(torch.zeros((1, 4, 16), dtype=torch.uint8))


@pytest.mark.cuda
def test_pitched_rows_take_16_byte_loads_on_card(cuda_device):
    """Rows of 8191 bytes 16-byte aligned in a pitch of 8224: each row's
    last 16-byte load runs past its end into the pitch, and the kernel ==
    plain == numpy_ref; 5 bytes in, the byte loads."""
    case = ("area", 8191, 4, 16, 4, {})
    plan = _plan(case)
    ops = cr.pack_operands(plan, cuda_device, tiled=False)
    assert cr.variant(ops.tables) == "u16_wide"
    buf = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (1, 4, 8224), np.uint8)).to(cuda_device)
    for off, width in ((0, 16), (5, 1)):
        x = buf[:, :, off:off + 8191]
        assert cr.wide_load_bytes(x) == width
        got = cr.resize_fused(ops, x)
        assert torch.equal(got, cr.resize_plain(ops, x))
        np.testing.assert_array_equal(got[0].cpu().numpy(),
                                      numpy_ref.resize_u8(plan, x[0].cpu().numpy()))


# ---- 16-row thumbnails and the relaxed form ----------------------------------

# small plans whose 16-row work tile fits the windowed kernel but whose band
# fits no tiled width (the 4K -> 256x144 thumbnail's 15:1 and the strips'
# shape, cut down), so that they take this kernel on the facade
THUMBNAILS = [
    ("lanczos", 960, 540, 64, 36, dict(degree=3)),      # 15:1, 90 taps both ways
    ("area", 960, 540, 64, 4, {}),                      # 135 Y taps: slices
    ("lanczos", 640, 360, 40, 9, dict(degree=3, px_scale=2)),
]


@pytest.mark.parametrize("case", THUMBNAILS, ids=card_check.case_name)
def test_thumbnails_take_this_kernel_at_16_rows(case):
    """Their route, exact and relaxed: 16 work rows, no tiled width fits,
    this kernel's tables in both forms, one thread an output relaxed."""
    plan = _plan(case)
    assert cr.work_rows(plan) == cr.TILE_ROWS
    for relaxed in (False, True):
        assert cr.supports_plan(plan, relaxed) and not cr.tiled_ok(plan, relaxed)
        k = cr.kernel_tables(plan, relaxed=relaxed)
        assert k.wide and k.relaxed == relaxed
        assert k.y_s8 == (not relaxed and cr.wide_s8(plan) is not None)
        if not k.y_s8:
            assert (k.layout.group == 1) if relaxed else (k.layout.group >= 1)
        assert isinstance(cr.kernel_tables(plan, relaxed=relaxed, wide=False), cr.KernelTables)


@pytest.mark.parametrize("case", THUMBNAILS, ids=card_check.case_name)
def test_model_equals_the_jax_package_on_16_row_thumbnails(case):
    """The exact model under the kernel's own layout == the JAX package's
    Pallas kernel in interpret mode == its XLA path, on the CPU.
    Tolerance 0."""
    import jax
    from libiqo_tpu.ops.xla_resize import resize_xla

    jplan = jax_build_plan(*case[:5], **case[5])
    assert pallas_resize.supports_plan(jplan)
    src = card_check.source(case, 0)
    fn, ops = pallas_resize.make_resize_fn(jplan, interpret=True)
    want = np.asarray(jax.jit(fn)(*ops, src))
    np.testing.assert_array_equal(np.asarray(resize_xla(jplan, src)), want)
    plan = _plan(case)
    np.testing.assert_array_equal(wide_model(plan, cr.wide_layout(plan), src), want)


# (case, budget, blocks): relaxed plans under reduced budgets and block
# targets, so that narrow tiles, Y slices (u16 and wrap16) and ragged tiles
# happen; RELAXED_RESIDUAL's plan carries a residual plane
RELAXED_MODEL_CASES = [
    (("area", 512, 96, 16, 3, {}), cr.SMEM_BUDGET, cr.WIDE_BLOCKS),
    (("area", 512, 1024, 16, 4, {}), cr.SMEM_BUDGET, cr.WIDE_BLOCKS),    # 256 Y taps, ks
    (("area", 1000, 70, 37, 9, {}), 6000, 40),
    (("lanczos", 200, 700, 23, 17, dict(degree=3)), 9000, 50),          # 248 Y taps, ks
    (("lanczos", 600, 400, 37, 21, dict(degree=2)), cr.SMEM_BUDGET, 64),
    (("lanczos", 300, 200, 23, 17, dict(degree=3, px_scale=2)), 5000, 50),
    (("linear", 300, 40, 90, 13, {}), 3000, 20),
    (("lanczos", 90, 60, 180, 120, dict(degree=3)), 8000, 200),         # upscale
    (("lanczos", 552, 40, 15, 30, dict(degree=4, px_scale=2)), 9000, 30),   # residual
    (THUMBNAILS[0], cr.SMEM_BUDGET, cr.WIDE_BLOCKS),
]


@pytest.mark.parametrize("case,budget,blocks", RELAXED_MODEL_CASES,
                         ids=[_ids(c) for c in RELAXED_MODEL_CASES])
@pytest.mark.parametrize("align", [16, 1])
def test_relaxed_model_equals_relaxed_plain(case, budget, blocks, align):
    """The relaxed form's model == ``torch_resize.resize_relaxed`` on the
    same planes, at 0 LSB, under forced small layouts."""
    plan = _plan(case)
    assert cr.supports_plan(plan, relaxed=True)
    lay = cr.wide_layout(plan, budget=budget, blocks=blocks, relaxed=True)
    assert lay.relaxed and lay.group == 1 and lay.smem <= budget
    src = card_check.source(case, 0)
    ops = cr.pack_operands(plan, relaxed=True)
    want = cr.resize_plain(ops, torch.from_numpy(src)[None])[0].numpy()
    np.testing.assert_array_equal(wide_model(plan, lay, src, align), want)


def test_relaxed_model_cases_cover_the_form():
    """Between them: Y slices in both instantiations, a residual plane,
    narrow and ragged tiles."""
    plans = [_plan(c) for c, _, _ in RELAXED_MODEL_CASES]
    lays = [cr.wide_layout(p, budget=b, blocks=n, relaxed=True)
            for p, (_, b, n) in zip(plans, RELAXED_MODEL_CASES)]
    assert any(l.ks > 1 and p.wrap16 for p, l in zip(plans, lays))
    assert any(l.ks > 1 and not p.wrap16 for p, l in zip(plans, lays))
    assert any(l.planes == 2 for l in lays) and all(l.group == 1 for l in lays)
    assert any(p.y.n_dst % l.tr and p.x.n_dst % l.tc for p, l in zip(plans, lays))
    assert all(l.smem == 4 * (l.tr * (l.wp + l.taps_y + 1) + l.tc * (l.planes * l.taps_x + 1))
               for l in lays)


@pytest.mark.parametrize("case", THUMBNAILS, ids=card_check.case_name)
def test_relaxed_model_within_2_lsb_of_the_jax_package(case):
    """The relaxed model under its own layout is within 2 LSB of the JAX
    package's exact XLA output (the relaxed contract); flat fields exact."""
    from libiqo_tpu.ops.xla_resize import resize_xla

    plan = _plan(case)
    lay = cr.wide_layout(plan, relaxed=True)
    src = card_check.source(case, 0)
    want = np.asarray(resize_xla(jax_build_plan(*case[:5], **case[5]), src))
    got = wide_model(plan, lay, src)
    assert int(np.abs(got.astype(np.int64) - want).max()) <= 2
    for v in (0, 128, 255):
        flat = np.full_like(src, v)
        np.testing.assert_array_equal(wide_model(plan, lay, flat), numpy_ref.resize_u8(plan, flat))


def test_relaxed_tables_carry_the_planes_output_major():
    """The kernel's X table in the relaxed form: each output's relaxed taps
    then its residual taps, as float32 bits; the planes tap-major beside
    them for the plain version; a relaxed layout's tables only."""
    case = RELAXED_MODEL_CASES[8][0]
    plan = _plan(case)
    k = cr.wide_tables(plan, relaxed=True)
    cxr, cxd = cr.relaxed_plane(plan.x)
    assert k.relaxed and k.layout.planes == 2 and cr.variant(k) == "wrap16_relaxed_wide"
    assert torch.equal(k.cxr, cxr) and torch.equal(k.cxd, cxd)
    assert k.cx.dtype == torch.int32 and k.cx.shape == (plan.x.n_dst, 2 * plan.x.num_coefs)
    assert torch.equal(k.cx.view(torch.float32), torch.cat([cxr, cxd]).T)
    exact = cr.wide_tables(plan)
    assert not exact.relaxed and exact.cxr.numel() == 0 and cr.variant(exact) == "wrap16_wide"
    with pytest.raises(ValueError):
        cr.wide_tables(plan, layout=dataclasses.replace(k.layout, planes=1))


def test_ablation_thumbnails_are_the_wide_ones():
    """``wide_ablate --thumbnails`` runs THUMBNAILS but the 8K proxy, which
    the tiled kernel takes."""
    from libiqo_tpu_torch.tools import wide_ablate

    assert wide_ablate.thumbnails() == card_check.THUMBNAILS[:-1]


# ---- the s8 Y form -------------------------------------------------------------

# plans of the s8 Y form, small enough for numpy_ref: the 144p rung's 15:1
# cut down, the strips' 2176-row band at 960 columns and a 38-slab band (the
# route keeps both on the scalar form: WIDE_S8_BAND_ROWS), tall bands of 20
# and 29 slabs, 16:1 and odd sizes, degrees 4 and 5, TW 16
S8_CASES = [
    ("lanczos", 960, 540, 64, 36, dict(degree=3)),
    ("lanczos", 960, 2160, 480, 16, dict(degree=3)),
    ("lanczos", 300, 1200, 23, 17, dict(degree=3)),
    ("lanczos", 363, 614, 30, 18, dict(degree=4)),
    ("lanczos", 1920, 1080, 120, 68, dict(degree=3)),
    ("lanczos", 1001, 777, 61, 47, dict(degree=3)),
    ("lanczos", 700, 900, 35, 30, dict(degree=5)),
    ("lanczos", 1500, 1000, 50, 40, dict(degree=3)),
    ("lanczos", 640, 2000, 40, 50, dict(degree=4)),
]
# (first byte's address mod 16, row stride past the width): aligned; 5 in
# with a pitch not a multiple of 16 (the byte-load path); 3 in, pitch % 16 0
PLACES = [(0, 0), (5, 11), (3, 16)]


def _s8_form(plan) -> cr.WideS8:
    """The s8 form of a plan at the widest width it fits, the route's rules
    aside (as ``wide_ablate`` builds it)."""
    return next(f for w in cr.WIDE_S8_WIDTHS if (f := cr.wide_s8_form(plan, w)) is not None)


@pytest.mark.parametrize("place", PLACES, ids=lambda p: f"at{p[0]}+{p[1]}")
@pytest.mark.parametrize("case", S8_CASES, ids=card_check.case_name)
def test_s8_model_equals_oracle_and_plain(case, place):
    """The s8 form's model, from a source at each placement, == numpy_ref
    == the plain path.  Tolerance 0."""
    plan = _plan(case)
    assert not cr.tiled_ok(plan) and cr.wide_layout(plan) is not None
    src = card_check.source(case, 0)
    want = numpy_ref.resize_u8(plan, src)
    offset, pad = place
    np.testing.assert_array_equal(
        wide_s8_model(plan, _s8_form(plan), src, offset, src.shape[1] + pad, seed=offset),
        want)
    plain = cr.resize_plain(cr.pack_operands(plan), torch.from_numpy(src)[None])[0]
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("kind", ["ones", "checker", "zeros"])
@pytest.mark.parametrize("case", S8_CASES, ids=card_check.case_name)
def test_s8_model_at_byte_extremes(case, kind):
    """All-255, all-0 and checkerboards through the s8 form: the ^ 0x80
    rebase at both ends of the byte, the int16 wrap and the border
    divides, == numpy_ref."""
    plan = _plan(case)
    s8 = _s8_form(plan)
    src = _extreme(kind, (case[2], case[1]))
    np.testing.assert_array_equal(wide_s8_model(plan, s8, src, offset=7),
                                  numpy_ref.resize_u8(plan, src))


@pytest.mark.parametrize("tw", cr.WIDE_S8_WIDTHS)
@pytest.mark.parametrize("stages", [2, 3, 4, 7])
def test_s8_model_over_any_ring(stages, tw):
    """Bands of 9, 10 and 4 slabs (315, 330 and 100 rows: not multiples of
    32) through rings of 2-7 stages, each slab over the stale rows of the
    one the stage held, == numpy_ref."""
    case = S8_CASES[0]
    plan = _plan(case)
    s8 = cr.wide_s8_form(plan, tw, stages)
    assert s8.stages == stages and s8.tw == tw
    band = s8.rec.rrec[:, 3] - s8.rec.rrec[:, 2]
    assert (band % 32).all() and (-(-band // 32) % stages).any()
    src = card_check.source(case, 1)
    np.testing.assert_array_equal(wide_s8_model(plan, s8, src, offset=stages),
                                  numpy_ref.resize_u8(plan, src))


@pytest.mark.parametrize("case", [c for c in card_check.WIDE_TIMED + card_check.THUMBNAILS
                                  if cr.wide_s8(_plan(c)) is not None]
                         + [card_check.THUMBNAILS[1]], ids=card_check.case_name)
def test_s8_model_equals_plain_at_full_size(case):
    """Every plan of the card's lists that the s8 form takes, and 1920x1080
    -> 128x72, which its grid keeps off the route (WIDE_S8_MIN_BLOCKS), at
    its size, == the plain path."""
    plan = _plan(case)
    src = card_check.source(case, 0)
    plain = cr.resize_plain(cr.pack_operands(plan), torch.from_numpy(src)[None])[0]
    np.testing.assert_array_equal(wide_s8_model(plan, cr.wide_s8(plan) or _s8_form(plan),
                                                src, offset=9), plain.numpy())


def test_s8_layout_of_each_plan():
    """The width, ring and blocks the rule picks (PERF.md §6): TW 32 where
    the band's pitch fits WIDE_S8_COLS, else 16; the most stages that fit
    two blocks an SM, at most WIDE_S8_MAX_STAGES."""
    got = {card_check.case_name(c): (lambda s: (s.tw, s.stages, s.blocks))(
        cr.wide_s8(_plan(c))) for c in wide_s8_plans()}
    assert got == {
        "lanczos3 7680x4320->240x135": (16, 4, 135),
        "lanczos3 3840x2160->256x144": (32, 5, 72),
        "lanczos3 7680x4320->480x270": (32, 5, 255),
        "lanczos3 7680x4320->320x180": (16, 5, 240)}


def wide_s8_plans():
    from libiqo_tpu_torch.tools import wide_ablate

    return wide_ablate.s8_plans()


@pytest.mark.parametrize("case", S8_CASES + card_check.THUMBNAILS[:2], ids=card_check.case_name)
def test_s8_form_fits_two_blocks_an_sm(case):
    """The s8 form's records are the tiled kernel's at its width with the X
    pass per tap; its pitch fits the warps' sums, its ring 3-8 slabs, and
    its block two an SM."""
    plan = _plan(case)
    s8 = _s8_form(plan)
    rec = s8.rec
    assert rec.s8y and rec.x_step == 0 and rec.pitch <= cr.WIDE_S8_COLS
    tiled = cr.tiled_layout(plan, tw=s8.tw)
    assert np.array_equal(rec.rrec, tiled.rrec) and np.array_equal(rec.crec, tiled.crec)
    assert cr.WIDE_S8_MIN_STAGES <= s8.stages <= cr.WIDE_S8_MAX_STAGES
    assert s8.smem <= cr.WIDE_S8_SMEM and 2 * (s8.smem + 1024) <= 233472
    assert s8.smem == max(s8.stages * 32 * rec.pitch, 32 * rec.work_pitch) + 4 * (
        rec.rrec.shape[1] + rec.crec.shape[1])
    assert s8.blocks == -(-plan.y.n_dst // cr.TILE_ROWS) * -(-plan.x.n_dst // s8.tw)


def test_s8_routes():
    """The 144p rung's luma takes the s8 form (``wide.y_s8``) on
    ``wrap16_wide_s8``, its tables the form's records alone; plans whose
    merged Y does not fit s8 (Linear 4K ->
    256x144, Area 8192x4 -> 16x4), those under WIDE_S8_TAPS_A_ROW Y taps a
    source row (Area: 1, Lanczos2: 4, px_scale 2: 2), those whose bands
    pass WIDE_S8_BAND_ROWS (the 4K -> 1920x16 strips), those whose frame
    has fewer than WIDE_S8_MIN_BLOCKS blocks at every width (1920x1080 ->
    128x72) and every relaxed plan keep the scalar form; the rung's chroma
    keeps the tiled kernel."""
    rung = build_plan("lanczos", 3840, 2160, 256, 144, degree=3)
    k = cr.kernel_tables(rung)
    assert isinstance(k, cr.WideS8Tables) and k.y_s8
    assert (k.layout.tw, k.layout.stages) == (32, 5)
    assert (cr.variant(k), cr.launch_form(k)) == ("wrap16_wide_s8", "wide.y_s8")
    assert torch.equal(k.rrec, torch.from_numpy(k.layout.rec.rrec))
    assert torch.equal(k.crec, torch.from_numpy(k.layout.rec.crec))
    assert not any(hasattr(k, f) for f in ("cy", "ys", "cx", "xs", "xdiv", "win"))
    for case in (("linear", 3840, 2160, 256, 144, {}), ("area", 8192, 4, 16, 4, {})):
        plan = _plan(case)
        assert not cr.tiled_layout(plan).s8y
        k = cr.kernel_tables(plan)
        assert isinstance(k, cr.WideTables) and not k.y_s8
        assert cr.launch_form(k) == "wide.y_whole" and cr.variant(k).endswith("_wide")
    for case in (card_check.WIDE_FACADE[1:4] + card_check.THUMBNAILS[3:4]
                 + card_check.THUMBNAILS[7:8] + [("lanczos", 640, 360, 40, 9,
                                                  dict(degree=3, px_scale=2))]):
        plan = _plan(case)
        assert cr.tiled_layout(plan).s8y and cr.wide_s8(plan) is None
        assert plan.y.num_coefs * plan.y.n_dst < cr.WIDE_S8_TAPS_A_ROW * plan.y.n_src
        k = cr.kernel_tables(plan)
        assert isinstance(k, cr.WideTables) and not k.y_s8
        assert cr.launch_form(k) in ("wide.y_whole", "wide.y_sliced")
    for case in card_check.THUMBNAILS[1:2] + [("lanczos", 960, 540, 64, 36, dict(degree=3))]:
        plan = _plan(case)
        forms = [cr.wide_s8_form(plan, w) for w in cr.WIDE_S8_WIDTHS]
        assert all(f.blocks < cr.WIDE_S8_MIN_BLOCKS for f in forms)
        k = cr.kernel_tables(plan)
        assert isinstance(k, cr.WideTables) and cr.launch_form(k) == "wide.y_whole"
    for case in card_check.THUMBNAILS[2:3] + S8_CASES[1:3]:
        plan = _plan(case)
        band = cr.tile_windows(plan.y, cr.TILE_ROWS)
        assert int((band[:, 1] - band[:, 0]).max()) > cr.WIDE_S8_BAND_ROWS
        assert cr.wide_s8(plan) is None and cr.wide_s8_form(plan, 32) is not None
        k = cr.kernel_tables(plan)
        assert isinstance(k, cr.WideTables) and not k.y_s8
        assert cr.launch_form(k) in ("wide.y_whole", "wide.y_sliced")
    for case in card_check.RELAXED_THUMBNAILS[:-1] + [S8_CASES[1]]:
        plan = _plan(case)
        if not cr.supports_plan(plan, relaxed=True) or cr.tiled_ok(plan, relaxed=True):
            continue
        k = cr.kernel_tables(plan, relaxed=True)
        assert isinstance(k, cr.WideTables) and k.relaxed and not k.y_s8
        assert cr.launch_form(k) in ("wide.y_whole", "wide.y_sliced")
    chroma = build_plan("lanczos", 1920, 1080, 128, 72, degree=3, px_scale=2)
    assert cr.launch_form(cr.kernel_tables(chroma)) == "tiled.x_taps"


def test_s8_form_refuses_what_it_cannot_hold():
    """None where the merged Y does not fit s8, where no width's band fits
    the warps' sums (a 4K-wide window at 32 rows), and on a u16 plan; a
    given ring out of range is refused, one past WIDE_S8_SMEM (one block an
    SM) taken; the tables of a plan the form cannot take are refused."""
    linear = build_plan("linear", 3840, 2160, 256, 144)
    assert cr.wide_s8(linear) is None and cr.wide_s8_form(linear, 32) is None
    assert cr.wide_s8(build_plan("area", 16384, 64, 8, 4)) is None
    wide_band = build_plan("lanczos", 16384, 64, 8, 4, degree=3)
    assert all(cr.wide_s8_form(wide_band, w) is None for w in cr.WIDE_S8_WIDTHS)
    assert cr.wide_s8_form(build_plan("area", 960, 540, 64, 36), 32) is None
    rung = build_plan("lanczos", 3840, 2160, 256, 144, degree=3)
    assert cr.wide_s8_form(rung, 32, 1) is None and cr.wide_s8_form(rung, 32, 9) is None
    wide = cr.wide_s8_form(rung, 32, 7)                   # 7 slabs of 640 bytes
    assert cr.WIDE_S8_SMEM < wide.smem <= cr.SMEM_BUDGET
    with pytest.raises(ValueError):
        cr.wide_s8_tables(linear)



def test_ablation_times_the_s8_form_against_the_scalar_form():
    """``wide_ablate``'s neighbours of the 144p rung: the scalar form's in
    the scalar form only, the s8 form's at the other width and one ring
    stage either side; its ``--s8`` plans are those the form takes."""
    from libiqo_tpu_torch.tools import wide_ablate

    plan = build_plan("lanczos", 3840, 2160, 256, 144, degree=3)
    lay = cr.wide_layout(plan)
    assert all(isinstance(v, cr.WideLayout) for v in wide_ablate.variants(plan, lay).values())
    got = wide_ablate.s8_variants(plan, cr.wide_s8(plan))
    assert {k: (v.tw, v.stages) for k, v in got.items()} == {
        "s8 tw 16": (16, 8), "s8 stages 4": (32, 4), "s8 stages 6": (32, 6)}
    assert all(isinstance(v, cr.WideS8) and v.smem <= cr.SMEM_BUDGET for v in got.values())
    plans = wide_ablate.s8_plans()
    assert card_check.THUMBNAILS[0] in plans and card_check.THUMBNAILS[4] not in plans
    assert card_check.STRESS[8] not in plans
