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
on a Lanczos wide plan its XLA path.  Tolerance 0: the contract is
byte-exact.
"""

from __future__ import annotations

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


def wide_model(plan, lay: cr.WideLayout, src: np.ndarray, align: int = 16,
               seed: int = 0) -> np.ndarray:
    """What ``resize_wide.cu`` computes for one frame, block by block, in
    its order (see the module docstring); ``align`` is the load width the
    kernel picks from the source's alignment (16 or 1)."""
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
            work[r, :len(w)] = w
        for o in range(lay.tr * lay.tc):
            r, jt = o % lay.tr, o // lay.tr
            if r >= rows or jt >= cols:
                continue
            j = c0 + jt
            idx = np.clip(xs[j] + np.arange(taps_x), 0, sw - 1) - lo_al
            assert ((idx >= lo - lo_al) & (idx < hi - lo_al)).all()
            terms = (_u32(cx[j]) * _u32(work[r, idx])) & M32
            lanes = np.zeros(lay.group, np.uint64)
            np.add.at(lanes, np.arange(taps_x) % lay.group, terms)
            lanes &= M32
            off = lay.group // 2
            while off:
                lanes = (lanes + lanes[np.arange(lay.group) ^ off]) & M32
                off //= 2
            acc = int(lanes[0])
            if plan.wrap16:
                s = int(_as_i32(acc + half))
                v = int(_wrap16(trunc_div(np.int64(s), np.int64(xdiv[j])) if xdiv[j]
                                else s >> plan.out_shift))
            else:
                v = ((acc + half) & 0xFFFFFFFF) >> plan.out_shift
            out[r0 + r, j] = min(max(v, 0), 255)
            written[r0 + r, j] += 1
    assert (written == 1).all()
    return out


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
    assert isinstance(k, cr.WideTables) and cr.variant(k) == ("wrap16_wide" if plan.wrap16
                                                              else "u16_wide")
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
    timing turns; plans with a 16-row tile never take the new kernel."""
    plan = _plan(FACADE_PLANS[0])
    k = cr.kernel_tables(plan, wide=False)
    assert isinstance(k, cr.KernelTables) and k.rows == cr.work_rows(plan) == 7
    assert cr.variant(k) == "u16"
    narrow = build_plan("lanczos", 3840, 2160, 1920, 16, degree=3)
    assert cr.work_rows(narrow) == cr.TILE_ROWS
    assert isinstance(cr.kernel_tables(narrow, tiled=False), cr.KernelTables)
    for case in card_check.WIDE_WINDOW[:2] + card_check.WIDE_WINDOW[6:]:
        p = _plan(case)
        assert cr.tiled_ok(p) and isinstance(cr.kernel_tables(p), cr.TiledTables)
        assert isinstance(cr.kernel_tables(p, tiled=False), cr.WideTables)


def test_relaxed_and_carry_keep_their_kernels():
    plan = _plan(FACADE_PLANS[4])
    assert not cr.supports_plan(plan, relaxed=True)
    assert cr.carry_layout(plan) is None
    assert isinstance(cr.kernel_tables(plan, carry=True), cr.WideTables)
    strip = build_plan("lanczos", 3840, 2160, 256, 144, degree=3)
    assert isinstance(cr.kernel_tables(strip, relaxed=True, tiled=False), cr.KernelTables)


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


@pytest.mark.parametrize("case", card_check.WIDE_TIMED, ids=card_check.case_name)
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
