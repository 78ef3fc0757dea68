"""The tiled kernel's opt-in forms, on the CPU: relaxed precision
(``kRelaxed``, the TPU's K7) and the row-halo carry (``kCarry``, K9) in
``libiqo_tpu_torch/csrc/resize_tiled.cuh``.

The kernel runs only on an NVIDIA card.  Here a NumPy model reads the very
tile records the kernel is handed and follows its schedule: per column tile
and run of row tiles, a ring of band rows (``slots`` rows in the carry
form, the band's own rows otherwise) filled as the kernel's copies fill it,
the next tile's fresh rows held back until the tile's reads are done (and
checked to touch other slots), the band at an arbitrary misalignment, and
every byte of shared memory nobody wrote drawn as noise, the 16-bit work
tile's with bf16 Inf and NaN patterns among it.  Relaxed, the work tile
holds bf16 bits, the tiles at the plane's edges fill the columns outside
the plane with the edge column, and the X pass sums float32 products tap by
tap in order, as the kernel does.

The relaxed model is held byte-equal to the relaxed plain version
(``torch_resize.resize_relaxed``) and within 2 LSB of the JAX package's
relaxed kernel in interpret mode; the carry model byte-equal to the tiled
model and ``numpy_ref``.  Tests marked ``cuda`` run the kernel and skip
without a card.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.ops import pallas_resize
from libiqo_tpu_torch import api, yuv
from libiqo_tpu_torch.coeffs.engine import trunc_div
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize

from test_torch_kernel_host import cuda_device  # noqa: F401
from test_torch_tiled import (HEAD, TH, _fuzz_plans, _swz, _tiled_model, _wrap16,
                              _x_sums)

JAX_LSB = 2          # against the JAX package's relaxed kernel (interpret mode)
BF16_SPECIALS = np.array([0x7F80, 0xFF80, 0x7FC0, 0xFFC1, 0x7F81], np.uint16)


def _noise(rng):
    """Draws for bytes and 16-bit words nobody wrote: uniform, and a third
    of the words bf16 Inf or NaN."""
    def bytes_(n):
        return rng.integers(0, 256, n, dtype=np.uint8)

    def words(n):
        w = rng.integers(0, 65536, n, dtype=np.uint16)
        special = rng.random(n) < 1 / 3
        w[special] = rng.choice(BF16_SPECIALS, int(special.sum()))
        return w
    return bytes_, words


def _bf16_bits(v):
    """The bf16 bits (as int64) of integer work values, rounded to nearest
    even through float32, as __float2bfloat16_rn."""
    f = torch.from_numpy(np.asarray(v, np.float32))
    return f.to(torch.bfloat16).view(torch.int16).numpy().astype(np.int64) & 0xFFFF


def _bits_f32(bits):
    return (np.asarray(bits, np.int64).astype(np.uint32) << 16).view(np.float32)


def _form_model(plan, k: cuda_resize.TiledTables, src, mis_of, rng):
    """What resize_tiled.cuh computes for one frame in the form its tables
    were built for (exact or relaxed, with or without carry), block by
    block; ``mis_of(first row tile, column tile)`` is the band's
    misalignment."""
    lay = k.layout
    noise8, noise16 = _noise(rng)
    rrec, crec = k.rrec.numpy(), k.crec.numpy()
    tw, pitch, kr, wp, ml = (lay.tw, lay.pitch, lay.k_rows, lay.work_pitch,
                             lay.margin)
    ty, tx, nu_max = k.taps_y, k.taps_x, lay.max_phases
    slots = lay.slots if lay.carry else kr
    dst_h, dst_w = plan.y.n_dst, plan.x.n_dst
    src_w = src.shape[1]
    half = 1 << (plan.out_shift - 1)
    n_rt = len(rrec)
    out = np.full((dst_h, dst_w), 7, np.uint8)
    for ct, cr in enumerate(crec):
        lo, width, nu, border = (int(v) for v in cr[:HEAD])
        xs = cr[HEAD:HEAD + tw].astype(np.int64)
        ph = cr[HEAD + tw:HEAD + 2 * tw]
        xdiv = cr[HEAD + 2 * tw:HEAD + 3 * tw].astype(np.int64)
        tab = cr[HEAD + 3 * tw:HEAD + 3 * tw + lay.planes * tx * nu_max]
        for t0 in range(0, n_rt, lay.run):
            t1 = min(t0 + lay.run, n_rt)
            mis = mis_of(t0, ct)
            band = noise8(slots * pitch).astype(np.int64)
            held = np.full(slots, -1)                 # source row in each slot
            work = noise16(TH * wp).astype(np.int64).reshape(TH, wp)
            cols = np.arange(16 * -(-(mis + width) // 16))
            src_col = lo - mis + cols
            inrow = (src_col >= 0) & (src_col < src_w)

            def slot(row, first):
                return row % slots if lay.carry else row - first

            def stage(rows, first):
                written = []
                for s in rows:
                    sl = slot(s, first)
                    band[_swz(sl, cols[inrow], pitch)] = src[s, src_col[inrow]]
                    held[sl] = s
                    written.append(sl)
                return written

            first0 = int(rrec[t0, 2])
            stage(range(first0, int(rrec[t0, 3])), first0)
            for t in range(t0, t1):
                rr = rrec[t]
                origin, first, end = int(rr[0]), int(rr[2]), int(rr[3])
                assert all(held[slot(s, first0)] == s for s in range(first, end))
                pending = []
                if t + 1 < t1:
                    nxt = rrec[t + 1]
                    pending = list(range(max(end, int(nxt[2])), int(nxt[3])))
                    pending_slots = {slot(s, first0) for s in pending}
                    assert len(pending_slots) == len(pending)
                corr = rr[HEAD:HEAD + TH].astype(np.int64)
                ydiv = rr[HEAD + TH:HEAD + 2 * TH].astype(np.int64)
                ytab = rr[HEAD + 2 * TH:]
                base = origin if lay.carry else first
                if lay.s8y:
                    ka = kr + 16
                    a = ytab[:TH * ka // 4].view(np.uint8).reshape(TH, ka)
                    a = a.astype(np.int8).astype(np.int64)[:, :kr]
                    read = [slot(base + j, first0) for j in range(kr)]
                    ncols = 32 * -(-(mis + width) // 32)
                    b = np.stack([band[_swz(s, np.arange(ncols), pitch)] for s in read])
                    b = (b ^ 0x80).astype(np.uint8).view(np.int8).astype(np.int64)
                    dot = a @ b
                    assert np.abs(dot).max(initial=0) < 2**31
                    acc = (dot + corr[:, None]) & 0xFFFFFFFF
                else:
                    cy = ytab[:ty * TH].reshape(ty, TH).astype(np.int64)
                    iyr = ytab[ty * TH:2 * ty * TH].reshape(ty, TH).astype(np.int64)
                    read = [slot(base + j, first0) for j in np.unique(iyr)]
                    ncols = 8 * -(-(mis + width) // 8)
                    acc = np.zeros((TH, ncols), np.int64)
                    for ti in range(ty):
                        sl = np.array([slot(base + j, first0) for j in iyr[ti]])
                        acc += cy[ti][:, None] * band[_swz(sl[:, None], np.arange(ncols), pitch)]
                    acc &= 0xFFFFFFFF
                if pending:
                    # no read of tile t (padded rows included) touches a slot
                    # that tile t + 1's copies fill meanwhile
                    assert not pending_slots & set(read), (t, sorted(pending_slots & set(read)))
                if plan.wrap16:
                    w = _wrap16(acc)
                    d = ydiv != 0
                    w[d] = _wrap16(trunc_div(w[d] * plan.y.bias, ydiv[d, None]))
                else:
                    w = acc & 0xFFFF
                work[:, ml:ml + ncols] = _bf16_bits(w) if lay.relaxed else w & 0xFFFF
                if lay.relaxed:
                    c0 = ml + mis
                    if lo == 0:
                        work[:, :c0] = work[:, c0:c0 + 1]
                    if lo + width == src_w:
                        work[:, c0 + width:] = work[:, c0 + width - 1:c0 + width]
                r0, c0 = t * TH, ct * tw
                rows, ncol = min(TH, dst_h - r0), min(tw, dst_w - c0)
                idx = ml + mis + xs[:ncol, None] + np.arange(tx)     # (ncol, tx)
                assert idx.min() >= 0 and idx.max() < wp
                pj = ph[:ncol] if nu > 1 else np.zeros(ncol, np.int64)
                if lay.relaxed:
                    wf = _bits_f32(work[:rows][:, idx])              # (rows, ncol, tx)
                    planes = tab.view(np.float32).reshape(lay.planes, tx, nu_max)
                    s = np.zeros((rows, ncol), np.int64)
                    for p in planes:
                        f = np.zeros((rows, ncol), np.float32)
                        for ti in range(tx):
                            f = (f + (p[ti, pj] * wf[:, :, ti]).astype(np.float32)
                                 ).astype(np.float32)
                        assert np.isfinite(f).all()
                        s += f.astype(np.int32)
                    s = (s + half) & 0xFFFFFFFF
                else:
                    s = _x_sums(plan, lay, work, cr, tx, mis, rows, ncol)
                    s = (s + half) & 0xFFFFFFFF
                if plan.wrap16 or lay.relaxed:
                    si = s - ((s & 0x80000000) << 1)
                    d = xdiv[:ncol] if border else np.zeros(ncol, np.int64)
                    v = _wrap16(np.where(d != 0, trunc_div(si, np.where(d, d, 1)),
                                         si >> plan.out_shift))
                else:
                    assert (s < 2**31).all()
                    v = s >> plan.out_shift
                out[r0:r0 + rows, c0:c0 + ncol] = np.clip(v, 0, 255)
                stage(pending, first0)
    return out


def _run_model(plan, k, src, seed):
    rng = np.random.default_rng(seed)
    mis = rng.integers(0, 16, (len(k.rrec), len(k.crec)))
    return _form_model(plan, k, src, lambda r, c: int(mis[r, c]), rng)


def _src(plan, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (plan.y.n_src, plan.x.n_src), np.uint8)


def _relaxed_tables(plan):
    ops = cuda_resize.pack_operands(plan, relaxed=True)
    assert ops.tables.tiled and ops.tables.relaxed and not ops.tables.carry
    return ops


def _plain_relaxed(ops, src):
    return cuda_resize.resize_plain(ops, torch.from_numpy(src)).numpy()


def _out_of_plane_relaxed_taps(plan) -> int:
    plane, _ = cuda_resize.relaxed_plane(plan.x)
    taps = plan.x.start[:, None] + np.arange(plan.x.num_coefs)
    outside = (taps < 0) | (taps >= plan.x.n_src)
    return int(((plane.numpy().T != 0) & outside).sum())


# the 3:2 geometry of Lanczos2 720p -> 1080p, scaled down: 3 relaxed taps
# outside the plane are nonzero, as at full size
L2_UP = ("lanczos", dict(degree=2), 128, 72, 192, 108)
# a px2 plan whose column-sum repair does not converge: a residual plane
RESIDUAL = ("lanczos", dict(degree=4, px_scale=2), 552, 40, 15, 30)
RELAXED_PLANS = [
    ("lanczos", dict(degree=3), 480, 270, 240, 135),
    ("lanczos", dict(degree=3, px_scale=2), 240, 135, 120, 67),
    ("lanczos", dict(degree=5, px_scale=4), 100, 70, 37, 90),
    ("area", {}, 480, 270, 160, 90),
    ("area", {}, 123, 77, 41, 19),
    ("linear", {}, 240, 135, 480, 270),
    ("linear", {}, 97, 61, 40, 150),
    L2_UP,
    RESIDUAL,
]


def _ids(c):
    algo, kw, sw, sh, dw, dh = c
    return f"{algo}{kw.get('degree', '')}px{kw.get('px_scale', 1)}-{sw}x{sh}-{dw}x{dh}"


def _plan(case):
    algo, kw, sw, sh, dw, dh = case
    return build_plan(algo, sw, sh, dw, dh, **kw)


# -- relaxed ----------------------------------------------------------------

def test_relaxed_cases_exercise_the_edges_and_the_residual():
    """The set's special plans really have what they are there for."""
    assert _out_of_plane_relaxed_taps(_plan(L2_UP)) == 3
    full = build_plan("lanczos", 1280, 720, 1920, 1080, degree=2)
    assert _out_of_plane_relaxed_taps(full) == 3
    plan = _plan(RESIDUAL)
    assert cuda_resize.relaxed_plane(plan.x)[1] is not None
    assert _relaxed_tables(plan).tables.layout.planes == 2


@pytest.mark.parametrize("case", RELAXED_PLANS, ids=_ids)
def test_relaxed_model_matches_relaxed_plain(case):
    algo, kw, sw, sh, dw, dh = case
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    ops = _relaxed_tables(plan)
    src = _src(plan, sw + dh)
    got = _run_model(plan, ops.tables, src, sh)
    np.testing.assert_array_equal(got, _plain_relaxed(ops, src))
    assert np.abs(got.astype(int) - numpy_ref.resize_u8(plan, src)).max() <= 2


@pytest.mark.parametrize("case", list(_fuzz_plans(24, 20261018)),
                         ids=lambda c: f"{c[0]}{c[1] or ''}-{c[2]}x{c[3]}-{c[4]}x{c[5]}")
def test_relaxed_model_fuzz(case):
    algo, kw, sw, sh, dw, dh = case
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    if not cuda_resize.supports_plan(plan, relaxed=True):
        pytest.fail(f"fuzz plan outside the relaxed scope: {case}")
    ops = _relaxed_tables(plan)
    src = _src(plan, 3 * sw + dh)
    np.testing.assert_array_equal(_run_model(plan, ops.tables, src, dw),
                                  _plain_relaxed(ops, src))


@pytest.mark.parametrize("flat", [0, 128, 255])
@pytest.mark.parametrize("case", [L2_UP, RESIDUAL], ids=_ids)
def test_relaxed_model_flat_fields_exact(case, flat):
    algo, kw, sw, sh, dw, dh = case
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    src = np.full((sh, sw), flat, np.uint8)
    np.testing.assert_array_equal(_run_model(plan, _relaxed_tables(plan).tables, src, 1),
                                  numpy_ref.resize_u8(plan, src))


@pytest.mark.parametrize("case", [
    ("lanczos", dict(degree=3), 320, 96, 160, 48),
    ("lanczos", dict(degree=2, px_scale=2), 160, 64, 80, 32),
    ("lanczos", dict(degree=2), 160, 64, 320, 128),
    ("area", {}, 320, 96, 150, 40),
    ("linear", {}, 160, 64, 320, 128),
], ids=_ids)
def test_relaxed_model_within_bound_of_jax_interpret(case):
    """Within 2 LSB of the JAX package's relaxed kernel in interpret mode
    (which rounds only the coefficients to bf16, not the work rows: see
    tests/test_torch_relaxed.py)."""
    algo, kw, sw, sh, dw, dh = case
    fn, ops = pallas_resize.make_resize_fn(jax_build_plan(algo, sw, sh, dw, dh, **kw),
                                           interpret=True, relaxed=True)
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    src = _src(plan, dw + dh)
    want = np.asarray(jax.jit(fn)(*ops, src))
    got = _run_model(plan, _relaxed_tables(plan).tables, src, 5)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= JAX_LSB


def test_relaxed_records_carry_phase_planes():
    """Each column tile's relaxed planes, by phase, are the per-output
    relaxed plane's columns; phases group equal integer taps."""
    plan = build_plan("lanczos", 480, 270, 240, 135, degree=3)
    ops = _relaxed_tables(plan)
    lay, k = ops.tables.layout, ops.tables
    exact = cuda_resize.tiled_layout(plan)
    assert lay.planes == 1 and lay.max_phases == exact.max_phases
    crec = k.crec.numpy()
    tw, tx = lay.tw, plan.x.num_coefs
    for ct, cr in enumerate(crec):
        ph = cr[HEAD + tw:HEAD + 2 * tw]
        tab = cr[HEAD + 3 * tw:HEAD + 3 * tw + tx * lay.max_phases].view(np.float32)
        tab = tab.reshape(tx, lay.max_phases)
        n = min(tw, plan.x.n_dst - ct * tw)
        np.testing.assert_array_equal(tab[:, ph[:n]], k.cxr.numpy()[:, ct * tw:ct * tw + n])


# -- carry ------------------------------------------------------------------

CARRY_PLANS = [
    ("lanczos", dict(degree=3), 960, 540, 480, 270),
    ("lanczos", dict(degree=2), 640, 360, 960, 540),
    ("lanczos", dict(degree=4), 512, 520, 256, 130),      # clamped tail tiles
    ("linear", {}, 160, 480, 321, 960),
    ("lanczos", dict(degree=5), 300, 411, 130, 97),
    ("linear", {}, 101, 77, 303, 233),
]


@pytest.mark.parametrize("case", CARRY_PLANS, ids=_ids)
@pytest.mark.parametrize("tw,run", [(None, None), (32, 2), (64, 3), (128, 5)])
def test_carry_model_matches_tiled_and_oracle(case, tw, run):
    """Runs of 2 to 5 row tiles (ragged where the run does not divide the
    row tiles), each width: the carry model == the tiled model ==
    numpy_ref."""
    algo, kw, sw, sh, dw, dh = case
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    lay = cuda_resize.tiled_carry_layout(plan, tw=tw, run=run)
    assert lay is not None and lay.run == (run or lay.run) and lay.tw == (tw or lay.tw)
    k = cuda_resize.tiled_tables(plan, "cpu", lay)
    src = _src(plan, sw * 3 + sh)
    want = numpy_ref.resize_u8(plan, src)
    np.testing.assert_array_equal(_run_model(plan, k, src, dh), want)
    rng = np.random.default_rng(2)
    np.testing.assert_array_equal(
        _tiled_model(plan, cuda_resize.tiled_tables(plan), src, lambda r, c: 3,
                     lambda n: rng.integers(0, 256, n, dtype=np.uint8)), want)


def test_carry_runs_are_ragged_and_varied():
    """The set above has runs that do not divide the row tiles, runs above
    2, and every width."""
    seen = set()
    for case in CARRY_PLANS:
        algo, kw, sw, sh, dw, dh = case
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        for tw, run in [(None, None), (32, 2), (64, 3), (128, 5)]:
            lay = cuda_resize.tiled_carry_layout(plan, tw=tw, run=run)
            if lay is not None:
                seen.add((lay.tw, lay.run, len(lay.rrec) % lay.run != 0))
    assert {tw for tw, _, _ in seen} == {32, 64, 128}
    assert any(ragged for _, _, ragged in seen)
    assert any(run > 2 for _, run, _ in seen)


@pytest.mark.parametrize("case", CARRY_PLANS[:3] + [RESIDUAL], ids=_ids)
def test_relaxed_carry_model_matches_relaxed_plain(case):
    algo, kw, sw, sh, dw, dh = case
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    lay = cuda_resize.tiled_carry_layout(plan, relaxed=True, run=None if
                                         case is not RESIDUAL else 2)
    if lay is None:
        pytest.skip("carry refuses this plan")
    k = cuda_resize.tiled_tables(plan, "cpu", lay)
    ops = cuda_resize.pack_operands(plan, relaxed=True)
    src = _src(plan, dw)
    np.testing.assert_array_equal(_run_model(plan, k, src, sw), _plain_relaxed(ops, src))


def test_carry_refuses_non_monotone_rows_and_small_savings():
    plan = build_plan("lanczos", 960, 540, 480, 270, degree=3)
    start = plan.y.start.copy()
    start[TH:2 * TH] -= 40          # tile 1 reads rows above tile 0's
    bad = dataclasses.replace(plan, y=dataclasses.replace(plan.y, start=start))
    assert cuda_resize.tiled_carry_layout(plan) is not None
    assert cuda_resize.tiled_carry_layout(bad) is None
    assert cuda_resize.tiled_carry_layout(bad, tw=32, run=2) is None
    # Area and px2 chroma re-read too little for carry to pay
    for kw in (dict(algorithm="area", src_w=1920, src_h=1080, dst_w=640, dst_h=360),
               dict(algorithm="lanczos", src_w=1920, src_h=1080, dst_w=960,
                    dst_h=540, degree=3, px_scale=2)):
        assert cuda_resize.tiled_carry_layout(build_plan(**kw)) is None
    # one row tile: nothing to carry
    assert cuda_resize.tiled_carry_layout(
        build_plan("lanczos", 3840, 2160, 1920, 16, degree=3)) is None


# full-size planes where carry engages (chip_smoke.py's CARRY_PLANES)
FULL_CARRY = {
    "lanczos3 4K->1080p luma": ("lanczos", dict(degree=3), 3840, 2160, 1920, 1080),
    "linear 1080p->4K luma": ("linear", {}, 1920, 1080, 3840, 2160),
    "linear 1080p->4K chroma": ("linear", {}, 960, 540, 1920, 1080),
    "lanczos3 8K->1080p": ("lanczos", dict(degree=3), 7680, 4320, 1920, 1080),
    "lanczos2 720p->1080p": ("lanczos", dict(degree=2), 1280, 720, 1920, 1080),
}


@pytest.mark.parametrize("name", sorted(FULL_CARRY))
def test_ring_slots_disjoint_at_full_size(name):
    """On each full-size carry plane, for every step of every run: tile t's
    K window (padded rows included) and tile t + 1's fresh rows lie in
    distinct ring slots; tile t's own band rows are in the ring when it
    reads them; the grid holds about TILED_BLOCKS blocks; and the ring,
    work tile and two row records fit shared memory."""
    plan = _plan(FULL_CARRY[name])
    lay = cuda_resize.tiled_carry_layout(plan)
    assert lay is not None and lay.smem <= cuda_resize.SMEM_BUDGET
    assert lay.slots % 32 == 0 and lay.slots >= lay.k_rows
    rrec = lay.rrec
    origin, first, end = rrec[:, 0], rrec[:, 2], rrec[:, 3]
    np.testing.assert_array_equal(origin, end - lay.k_rows)
    n_rt = len(rrec)
    for t0 in range(0, n_rt, lay.run):
        held = {}
        for s in range(first[t0], end[t0]):
            held[s % lay.slots] = s
        for t in range(t0, min(t0 + lay.run, n_rt)):
            assert all(held[s % lay.slots] == s for s in range(first[t], end[t]))
            read = {(origin[t] + j) % lay.slots for j in range(lay.k_rows)}
            if t + 1 < min(t0 + lay.run, n_rt):
                fresh = range(max(end[t], first[t + 1]), end[t + 1])
                assert not read & {s % lay.slots for s in fresh}, (name, t)
                for s in fresh:
                    held[s % lay.slots] = s
    n_ct = -(-plan.x.n_dst // lay.tw)
    blocks = n_ct * -(-n_rt // lay.run)
    assert blocks >= cuda_resize.TILED_BLOCKS
    assert lay.fetch < (1 - cuda_resize.CARRY_MIN_SAVING) * lay.band


def test_full_size_carry_choices():
    """TW and the run on the full-size planes: Lanczos3 4K luma keeps TW
    128 with runs of 3 (345 blocks); Linear 4K luma runs 15 row tiles."""
    luma = cuda_resize.tiled_carry_layout(_plan(FULL_CARRY["lanczos3 4K->1080p luma"]))
    assert (luma.tw, luma.run, luma.slots, luma.k_rows) == (128, 3, 96, 64)
    linear = cuda_resize.tiled_carry_layout(build_plan("linear", 1920, 1080, 3840, 2160))
    assert (linear.tw, linear.run) == (128, 15)


# -- routes -----------------------------------------------------------------

def test_routes_of_the_opt_ins(monkeypatch):
    """kernel_tables and pack_operands under relaxed, carry and
    tiled=False: the tiled forms where their layouts fit, the windowed
    forms with tiled=False or where only they fit, and no carry where none
    applies."""
    luma = build_plan("lanczos", 3840, 2160, 1920, 1080, degree=3)
    v = cuda_resize.variant
    kt = cuda_resize.kernel_tables
    assert v(kt(luma, relaxed=True)) == "wrap16_relaxed_tiled"
    assert v(kt(luma, carry=True)) == "wrap16_carry_tiled"
    assert v(kt(luma, relaxed=True, carry=True)) == "wrap16_relaxed_carry_tiled"
    assert v(kt(luma, relaxed=True, tiled=False)) == "wrap16_relaxed"
    assert v(kt(luma, carry=True, tiled=False)) == "wrap16_carry"
    assert v(kt(luma, relaxed=True, carry=True, tiled=False)) == "wrap16_relaxed_carry"
    linear = build_plan("linear", 1920, 1080, 3840, 2160)
    assert v(kt(linear, carry=True)) == "u16_carry_tiled"
    assert v(kt(linear, relaxed=True, carry=True)) == "u16_relaxed_carry_tiled"
    area = build_plan("area", 1920, 1080, 640, 360)
    assert v(kt(area, relaxed=True)) == "u16_relaxed_tiled"
    assert v(kt(area, relaxed=True, carry=True)) == "u16_relaxed_tiled"
    # a strip whose luma band fits no tiled width: the wide-window forms,
    # and with wide=False the windowed ones
    strip = build_plan("lanczos", 3840, 2160, 1920, 16, degree=3)
    assert not cuda_resize.tiled_ok(strip, relaxed=True)
    assert v(kt(strip, relaxed=True)) == "wrap16_relaxed_wide"
    assert v(kt(strip, carry=True)) == "wrap16_wide"
    assert v(kt(strip, relaxed=True, wide=False)) == "wrap16_relaxed"
    assert v(kt(strip, carry=True, wide=False)) == "wrap16"
    # where the tiled carry layout does not fit but carry_ok holds, the
    # windowed carry form takes the plan
    monkeypatch.setattr(cuda_resize, "tiled_carry_layout", lambda *a, **k: None)
    assert v(kt(luma, carry=True)) == "wrap16_carry"
    monkeypatch.undo()
    # relaxed tables are built on any device, and keep the planes per output
    ops = cuda_resize.pack_operands(area, relaxed=True)
    assert ops.tables.tiled and ops.device.type == "cpu"
    assert ops.tables.cxr.shape == (area.x.num_coefs, area.x.n_dst)
    assert ops.tables.cxd.numel() == 0
    assert cuda_resize.pack_operands(area, relaxed=True, tiled=False).tables.tiled is False
    # exact tables stay CUDA-only
    assert cuda_resize.pack_operands(area).tables is None
    assert set(cuda_resize.VARIANTS) == set(cuda_resize.LAUNCHES_BY_VARIANT)


def test_relaxed_and_carry_on_cpu_launch_nothing(monkeypatch):
    """backend="cuda" on the CPU with the opt-ins runs the plain versions
    over the tiled forms' tables: relaxed == resize_relaxed, carry ==
    numpy_ref, and no launch is counted."""
    monkeypatch.setenv("LIBIQO_TPU_CARRY", "1")
    api.clear_operand_cache()
    try:
        r = yuv.YUV420Resizer("lanczos3", 640, 360, 320, 180, backend="cuda",
                              precision="relaxed", device="cpu")
        rng = np.random.default_rng(6)
        f = yuv.YUV420Frame(rng.integers(0, 256, (360, 640), np.uint8),
                            rng.integers(0, 256, (180, 320), np.uint8),
                            rng.integers(0, 256, (180, 320), np.uint8))
        before = cuda_resize.LAUNCHES
        out = r.resize(f)
        luma = build_plan("lanczos", 640, 360, 320, 180)
        ops = r._luma._operands(torch.device("cpu"), relaxed=True)
        assert cuda_resize.variant(ops.tables) == "wrap16_relaxed_carry_tiled"
        np.testing.assert_array_equal(out.y, _plain_relaxed(
            cuda_resize.pack_operands(luma, relaxed=True), f.y))
        assert cuda_resize.LAUNCHES == before
    finally:
        api.clear_operand_cache()


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", RELAXED_PLANS, ids=_ids)
def test_relaxed_tiled_kernel_matches_plain_on_card(cuda_device, case):
    algo, kw, sw, sh, dw, dh = case
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    ops = cuda_resize.pack_operands(plan, cuda_device, relaxed=True)
    assert ops.tables.tiled
    src = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (3, sh, sw), np.uint8)).to(cuda_device)
    assert torch.equal(cuda_resize.resize_fused(ops, src),
                       cuda_resize.resize_plain(ops, src))


@pytest.mark.cuda
@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("case", CARRY_PLANS, ids=_ids)
def test_carry_tiled_kernel_matches_tiled_on_card(cuda_device, case, relaxed):
    algo, kw, sw, sh, dw, dh = case
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    carry = cuda_resize.pack_operands(plan, cuda_device, relaxed, carry=True)
    assert carry.tables.tiled and carry.tables.carry
    plain = cuda_resize.pack_operands(plan, cuda_device, relaxed)
    src = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, sh, sw), np.uint8)).to(cuda_device)
    assert torch.equal(cuda_resize.resize_fused(carry, src),
                       cuda_resize.resize_fused(plain, src))
