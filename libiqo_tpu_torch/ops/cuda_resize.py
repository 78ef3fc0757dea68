"""The fused resize kernels for Hopper: host-side operands, scope, routes and
wrapper.

Three kernels replace the TPU's fused Pallas kernel
(``libiqo_tpu/ops/pallas_resize.py:_make_padless_fn``).  The tiled kernel
(``csrc/resize_tiled.cuh``) runs every plan whose band fits its shared
memory: one block stages its source band and tile records
(:func:`tiled_layout`) in shared memory, runs the Y pass on s8 ``mma.sync``
where the merged Y taps fit s8 (else integer multiply-adds), keeps a 16-bit
work tile and runs the X pass on CUDA cores.  It has four forms, each in a
``wrap16`` (Lanczos: int16 work rows, border divides) and a ``u16`` (Area,
Linear: u16 work rows, no borders) instantiation: exact (``*_tiled``, where
:func:`tiled_ok` holds); relaxed (``*_relaxed_tiled``, ``precision=
"relaxed"``: the X pass over bf16-rounded work rows and coefficient planes
in float32, within 2 LSB of the exact output, flat fields exact); the
row-halo carry form (``*_carry_tiled``, the TPU's ``LIBIQO_TPU_CARRY`` mode,
opted into with ``LIBIQO_TPU_CARRY=1`` or ``2``: a block walks a run of row
tiles and keeps their band rows in a ring in shared memory, byte-equal to
the tiled form, where :func:`tiled_carry_layout` takes the plan); and the
relaxed carry form (``*_relaxed_carry_tiled``).  The windowed kernel
(``csrc/resize_fused.cu``) serves the plans whose band does not fit, in the
same forms (``wrap16``, ``u16``, ``*_relaxed``, ``*_carry`` where
:func:`carry_ok` holds, ``*_relaxed_carry``), and every plan with
``tiled=False``, except the exact plans whose window is too wide for its
16-row work tile: the wide-window kernel (``csrc/resize_wide.cu``,
``wrap16_wide``, ``u16_wide``, :func:`wide_layout`) takes those.  This module packs a :class:`ResizePlan` into the kernels' operands, decides
which plans they take (:func:`supports_plan`, :func:`tiled_ok`), and
launches the one the operands were built for (:func:`resize_fused`).
:func:`resize_plain` is the same function in plain PyTorch over the same
operands, for the CPU and for comparison on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import threading

import numpy as np
import torch

from ..core.plan import AxisPlan, ResizePlan
from . import _build, torch_resize

__all__ = ["LAUNCHES", "LAUNCHES_BY_VARIANT", "VARIANTS", "CarryLayout",
           "KernelOperands", "KernelTables", "TiledLayout", "TiledTables",
           "WideLayout", "WideTables", "carry_layout", "carry_ok",
           "carry_requested", "kernel_tables", "pack_operands",
           "relaxed_plane", "reset_launches", "resize_fused", "resize_plain",
           "smem_bytes", "supports_plan", "tile_windows", "tiled_carry_layout",
           "tiled_layout", "tiled_ok", "tiled_tables", "tiled_width",
           "variant", "wide_layout", "wide_load_bytes", "wide_tables",
           "work_rows"]

# Must match kTileRows/kTileCols in csrc/resize_fused.cu (checked at load).
TILE_ROWS = 16
TILE_COLS = 128
MIN_WORK_ROWS = 4         # fewest rows in the wide-window walk's work tile
SMEM_BUDGET = 232448      # dynamic shared memory one sm_90 block may use
_MAX_GRID_YZ = 65535      # CUDA's limit on gridDim.y (row tiles) and .z (frames)
_I32_MAX = 2**31 - 1
_F32_EXACT_COEF_SUM = 65535   # the JAX package's per-row sum(|coef|) bound
_RELAXED_WALK = 24            # most taps the column-sum repair nudges
CARRY_BLOCKS = 264        # blocks a carry grid aims for: two per SM of 132
CARRY_MIN_SAVING = 0.1    # carry must fetch <= 90 % of the windowed rows
RING_ALIGN = 16           # bytes: the ring's row pitch is a multiple
# Must match kWidths in csrc/resize_tiled.cu (checked at load).
TILED_WIDTHS = (128, 64, 32)   # output columns per block of the tiled kernel
TILED_BLOCKS = 264        # blocks a tiled grid aims for: two per SM of 132
BAND_ALIGN = 128          # bytes: the staged band's row pitch is a multiple
# Must match kThreads/kGroupCols in csrc/resize_wide.cu (checked at load).
WIDE_THREADS = 256        # threads a block of the wide-window kernel
WIDE_GROUP_COLS = 16      # work columns a Y item: one 16-byte load a tap
WIDE_BLOCKS = 264         # blocks a wide-window grid aims for: two per SM of 132
WIDE_SLICE_TAPS = 128     # Y taps an output row from which the Y pass slices them
WIDE_ITEM_SHARE = 0.9     # the Y items' least share of the threads' last round

VARIANTS = ("wrap16", "u16", "wrap16_relaxed", "u16_relaxed",
            "wrap16_carry", "u16_carry", "wrap16_relaxed_carry",
            "u16_relaxed_carry", "wrap16_tiled", "u16_tiled",
            "wrap16_relaxed_tiled", "u16_relaxed_tiled", "wrap16_carry_tiled",
            "u16_carry_tiled", "wrap16_relaxed_carry_tiled",
            "u16_relaxed_carry_tiled", "wrap16_wide", "u16_wide")
LAUNCHES = 0              # kernel launches in this process
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)   # the same, by instantiation
_launch_lock = threading.Lock()


def reset_launches() -> None:
    """Set every launch count to 0."""
    global LAUNCHES
    with _launch_lock:
        LAUNCHES = 0
        for k in LAUNCHES_BY_VARIANT:
            LAUNCHES_BY_VARIANT[k] = 0


def variant(plan, relaxed: bool = False, carry: bool = False) -> str:
    """The kernel instantiation that a plan takes on the windowed
    ``resize_fused``, exact or ``relaxed``, without or with ``carry`` (one
    of :data:`VARIANTS`); given its :class:`KernelTables`,
    :class:`TiledTables` or :class:`WideTables`, the one they were built
    for, whose name ends in ``_tiled`` for the tiled kernel's and in
    ``_wide`` for the wide-window kernel's."""
    name = "wrap16" if plan.wrap16 else "u16"
    if getattr(plan, "wide", False):
        return name + "_wide"
    if getattr(plan, "relaxed", relaxed):
        name += "_relaxed"
    if getattr(plan, "carry", carry):
        name += "_carry"
    return name + "_tiled" if getattr(plan, "tiled", False) else name


def tile_windows(ax: AxisPlan, tile: int = TILE_COLS) -> np.ndarray:
    """(n_tiles, 2) int32 ``[lo, hi)``: the source indices that the clamped
    taps of each ``tile``-long run of outputs read (column tiles by
    default; ``TILE_ROWS`` on the Y axis gives the row tiles' source rows).
    ``start`` is not assumed monotonic."""
    idx = torch_resize.clamped_taps(ax)
    first = np.arange(0, ax.n_dst, tile)
    lo = np.minimum.reduceat(idx.min(axis=1), first)
    hi = np.maximum.reduceat(idx.max(axis=1), first) + 1
    return np.stack([lo, hi], axis=1).astype(np.int32)


def smem_bytes(plan: ResizePlan) -> int:
    """Shared memory of one block: the TILE_ROWS x window int32 work tile."""
    w = tile_windows(plan.x)
    return TILE_ROWS * int((w[:, 1] - w[:, 0]).max()) * 4


def work_rows(plan: ResizePlan) -> int:
    """Output rows one block of the windowed ``resize_fused`` takes (the
    height of its work tile), or 0 where no height fits.

    TILE_ROWS wherever that work tile fits SMEM_BUDGET.  Else the most rows
    that fit, at least MIN_WORK_ROWS: the scope of the plans whose widest
    column-tile window is too wide for 16 rows (Area 8192x4 -> 16x4: one
    partial column tile of 8192 source columns, 7 rows; Area 8192x2160 ->
    256x540: two column tiles of 4096, 14 rows), which the wide-window
    kernel (:func:`wide_layout`) takes, and ``pack_operands(...,
    wide=False)`` the windowed kernel's wide-window walk at these rows.
    With fewer than 4 rows it would take windows past 14528 columns, which
    the JAX package's kernel refuses (Area 16384x4 -> 16x4, 65536x16 ->
    16x16)."""
    w = tile_windows(plan.x)
    win = int((w[:, 1] - w[:, 0]).max())
    rows = min(TILE_ROWS, SMEM_BUDGET // (4 * win))
    return rows if rows >= MIN_WORK_ROWS else 0


def _x_divisors(plan: ResizePlan) -> np.ndarray:
    deno = np.where(plan.x.deno == 0, 1, plan.x.deno).astype(np.int64)
    return np.where(plan.x.is_border, deno * plan.y.bias, 0)


def _u16_exact(plan: ResizePlan) -> bool:
    """Whether the u16 instantiation is exact for a non-wrap16 plan: no
    border outputs, Y taps >= 0 with row sums <= 256 (so work rows are
    <= 65280, the JAX package's ``_u16_work_ok``), X taps >= 0, and
    ``255 * max_row_sum_y * max_row_sum_x + half < 2^31`` (so the X sums
    plus the half fit the kernel's int32 epilogue)."""
    y, x = plan.y, plan.x
    if y.is_border.any() or x.is_border.any():
        return False
    cy, cx = y.coef.astype(np.int64), x.coef.astype(np.int64)
    if cy.min() < 0 or cx.min() < 0:
        return False
    sum_y, sum_x = int(cy.sum(axis=1).max()), int(cx.sum(axis=1).max())
    return (sum_y <= 256
            and 255 * sum_y * sum_x + (1 << (plan.out_shift - 1)) <= _I32_MAX)


def _exact_f32_ok(plan: ResizePlan) -> bool:
    """The JAX package's bounds for its exact bf16 schemes
    (``pallas_resize._exact_f32_ok``): per-row sum(|coef|) <= 65535 and at
    most 258 taps, on both axes."""
    return all(
        int(np.abs(ax.coef.astype(np.int64)).sum(axis=1).max()) <= _F32_EXACT_COEF_SUM
        and ax.num_coefs <= 258 for ax in (plan.y, plan.x))


def _bf16(a) -> np.ndarray:
    """Values rounded to bfloat16 through float32, each step to nearest
    even (as ``astype`` does in the JAX package), returned as float64."""
    f32 = torch.from_numpy(np.asarray(a, dtype=np.float64).astype(np.float32))
    return f32.to(torch.bfloat16).to(torch.float64).numpy()


def _repaired_bf16(c: np.ndarray) -> np.ndarray:
    """(taps, n_dst) integer taps -> one bf16 plane (as float64) whose
    column sums are repaired toward the exact integer sums: walking each
    column's taps by stable descending |c|, for at most min(taps, 24)
    steps, each step adds the column's remaining residual to one tap and
    rounds it to bf16 again."""
    target = c.sum(axis=0).astype(np.float64)
    plane = _bf16(c)
    order = np.argsort(-np.abs(c), axis=0, kind="stable")
    for k in range(min(c.shape[0], _RELAXED_WALK)):
        resid = target - plane.sum(axis=0)
        if not resid.any():
            break
        idx = order[k:k + 1]
        np.put_along_axis(plane, idx, np.take_along_axis(plane, idx, axis=0)
                          + resid[None], axis=0)
        plane = _bf16(plane)
    return plane


def _relaxed_planes(ax: AxisPlan):
    """(plane, residual or None, ok), tap-major float64: the repaired plane,
    the residual plane ``c - plane`` where some column's sum is still not
    exact, and whether that residual is bf16-exact."""
    c = ax.coef.T.astype(np.int64)
    plane = _repaired_bf16(c)
    if (plane.sum(axis=0) == c.sum(axis=0)).all():
        return plane, None, True
    resid = c - plane
    return plane, resid, bool((_bf16(resid) == resid).all())


def relaxed_plane(ax: AxisPlan) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The relaxed X coefficient planes of an axis: float32 tensors holding
    bf16 values, tap-major (taps, n_dst) like the kernel's ``cx``.

    The port of ``pallas_resize._bf16_relaxed_plane`` (``:163-197``) and
    of the residual-plane rule of the relaxed build (``:994-1021``): the
    taps are rounded to bf16 and each output's column sum is repaired
    toward its exact sum (:func:`_repaired_bf16`); if some column's sum is
    still off, the second plane ``c - plane`` is returned too (else None),
    and it must be bf16-exact, or this raises ValueError.  The walk runs
    over each output's own taps.  The JAX package's padless build walks
    the column tile's slab window instead, so where an output's nonzero
    taps cannot absorb the residual (px2 chroma, a few columns in a
    thousand) it nudges a source position outside the filter, and the port
    nudges a zero tap inside the output's tap list.  Both end with exact
    column sums, so flat fields stay exact."""
    plane, resid, ok = _relaxed_planes(ax)
    if not ok:
        raise ValueError("the residual of the bf16 coefficient plane is not "
                         "bf16-exact; the plan is outside the relaxed scheme")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    return t(plane), None if resid is None else t(resid)


def _relaxed_ok(plan: ResizePlan) -> bool:
    """The relaxed scheme's own conditions (see :func:`supports_plan`)."""
    if not _exact_f32_ok(plan):
        return False
    plane, resid, ok = _relaxed_planes(plan.x)
    if not ok:
        return False
    wmax = 32768 if plan.wrap16 else 65280    # wrapped w reaches -32768
    planes = [plan.x.coef.T.astype(np.int64), plane]
    if resid is not None:
        planes.append(resid)
    csum = max(int(np.abs(p).sum(axis=0).max()) for p in planes)
    return wmax * csum < 2**31


def supports_plan(plan: ResizePlan, relaxed: bool = False) -> bool:
    """True when the kernel computes this plan exactly, or with
    ``relaxed=True``, when its relaxed form takes the plan.  A pure
    function of the plan.

    Exact: wrap16 (Lanczos) plans at any px_scale: the kernel's uint32 sums
    wrap as the reference's C accumulators, so 16-bit taps of any value are
    exact, provided the border divisors fit int32.  Other (Area, Linear)
    plans when :func:`_u16_exact` holds.  Either way the tap tables must
    index in int32, a work tile must fit the shared-memory budget
    (:func:`work_rows`: 16 rows, or the wide-window walk's 4-15 rows on any
    number of column tiles, so that every plan the JAX package's kernel
    takes runs on a kernel here) and its row tiles the grid.

    Relaxed: all of that, and the JAX package's relaxed guards
    (``pallas_resize.py:943-1024``): ``wmax * max_j sum|cx| < 2^31``, with
    wmax 32768 for wrap16 plans and 65280 for u16 ones (the sum is also
    taken over the rounded planes, so the float32 sums stay inside int32),
    and :func:`relaxed_plane` must succeed, and the 16-row work tile must
    fit (the wide-window walk is exact only: a relaxed plan whose window is
    too wide for 16 rows takes the exact kernel, ``api.Resizer``'s ladder).  Plans outside
    :func:`_exact_f32_ok` are refused as well: the port's Y pass is exact
    integer arithmetic for every plan, so the JAX package's Y-exactness
    refusal has nothing to guard here, but the port's relaxed scope does
    not exceed the JAX package's.

    Every plan the kernel refuses goes to the exact ``torch`` path."""
    if plan.wrap16:
        if np.abs(_x_divisors(plan)).max() > _I32_MAX:
            return False
    elif not _u16_exact(plan):
        return False
    if max(ax.num_coefs * ax.n_dst for ax in (plan.y, plan.x)) > _I32_MAX:
        return False
    rows = work_rows(plan)
    if rows == 0 or -(-plan.y.n_dst // rows) > _MAX_GRID_YZ:
        return False
    return not relaxed or (rows == TILE_ROWS and _relaxed_ok(plan))


def carry_requested() -> bool:
    """Whether the row-halo carry form is asked for: ``LIBIQO_TPU_CARRY``
    is "1" or "2", the JAX package's own opt-in
    (``libiqo_tpu/ops/pallas_resize.py:689,809``)."""
    return os.environ.get("LIBIQO_TPU_CARRY", "") in ("1", "2")


@dataclasses.dataclass(frozen=True)
class CarryLayout:
    """How the carry form walks a plan: each block owns one column tile
    and ``run`` consecutive row tiles, whose source rows it keeps in a ring
    of ``ring_rows`` rows of ``ring_pitch`` bytes."""
    run: int
    ring_rows: int
    ring_pitch: int
    rwin: np.ndarray        # (n_row_tiles, 2) int32 [lo, hi) source rows
    fetch: int              # source rows one column tile loads with carry
    band: int               # ... and without: the sum of the row windows


def _carry_runs(rwin: np.ndarray, run: int) -> tuple[bool, int, int]:
    """For row tiles' source windows ``rwin`` walked in runs of ``run``:
    whether each window is non-decreasing in both ends inside every run,
    the source rows a column tile fetches with carry (each run's first
    window, then each next tile's fresh rows) and without (the sum of the
    windows)."""
    lo, hi = rwin[:, 0].astype(np.int64), rwin[:, 1].astype(np.int64)
    inner = np.arange(1, len(rwin)) % run != 0     # pairs (t, t+1) in one run
    monotone = bool(((lo[1:] >= lo[:-1]) & (hi[1:] >= hi[:-1]))[inner].all())
    fresh = hi[1:] - np.maximum(hi[:-1], lo[1:])
    starts = np.arange(0, len(rwin), run)
    fetch = int((hi - lo)[starts].sum() + fresh[inner].sum())
    return monotone, fetch, int((hi - lo).sum())


def carry_layout(plan: ResizePlan) -> CarryLayout | None:
    """The windowed kernel's carry form's layout of a plan, or None where
    it does not apply.

    ``run`` is the most row tiles per block that still leaves about
    CARRY_BLOCKS blocks per frame (two per SM of an H100), and at least 2.
    Carry applies when, inside every run, each row tile's source window
    ``[lo, hi)`` (its clamped taps) is non-decreasing in both ends; when the
    ring (the largest ``hi[t+1] - lo[t]`` of a run, so tile t+1's rows can
    land while tile t is computed) and the work tile fit SMEM_BUDGET; and
    when carry fetches at most 90 % of the rows the windowed form reads
    (the JAX package refuses at ``fetch >= 0.9 * band``,
    ``pallas_resize.py:589``)."""
    rwin = tile_windows(plan.y, TILE_ROWS).astype(np.int64)
    lo, hi = rwin[:, 0], rwin[:, 1]
    n_rt = len(rwin)
    n_ct = -(-plan.x.n_dst // TILE_COLS)
    run = max(2, n_rt // -(-CARRY_BLOCKS // n_ct))
    inner = np.arange(1, n_rt) % run != 0        # pairs (t, t+1) in one run
    monotone, fetch, band = _carry_runs(rwin, run)
    if not monotone or fetch >= (1 - CARRY_MIN_SAVING) * band:
        return None
    ring_rows = int(max((hi - lo).max(),
                        (hi[1:] - lo[:-1])[inner].max(initial=0)))
    win = tile_windows(plan.x)
    pitch = -(-int((win[:, 1] - win[:, 0]).max()) // RING_ALIGN) * RING_ALIGN
    if smem_bytes(plan) + ring_rows * pitch > SMEM_BUDGET:
        return None
    return CarryLayout(run=run, ring_rows=ring_rows, ring_pitch=pitch,
                       rwin=rwin.astype(np.int32), fetch=fetch, band=band)


def carry_ok(plan: ResizePlan) -> bool:
    """True when the windowed kernel's carry form applies to the plan
    (:func:`carry_layout`).  A pure function of the plan; the tiled
    kernel's carry form (:func:`tiled_carry_layout`) takes the plan first
    where its ring fits."""
    return carry_layout(plan) is not None


def tiled_width(plan: ResizePlan) -> int:
    """The tiled kernel's output columns per block for a plan: the largest
    of TILED_WIDTHS whose grid for one frame still holds TILED_BLOCKS
    blocks (two per SM of an H100), else the smallest.  Batches only add
    blocks, so a one-frame grid is the floor."""
    row_tiles = -(-plan.y.n_dst // TILE_ROWS)
    for tw in TILED_WIDTHS:
        if -(-plan.x.n_dst // tw) * row_tiles >= TILED_BLOCKS:
            return tw
    return TILED_WIDTHS[-1]


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class TiledLayout:
    """How the tiled kernel (``csrc/resize_tiled.cuh``) walks a plan.  One
    block computes TILE_ROWS x ``tw`` outputs.  It stages its source band
    (``k_rows`` rows at a ``pitch``-byte pitch, 16-byte pieces swizzled by
    row) and its row and column tile records in shared memory, runs the Y
    pass into a 16-bit work tile of ``work_pitch`` columns (band column c
    at ``margin + c``), then the X pass.  In the carry form (``run`` > 1) a
    block walks ``run`` row tiles of one column tile and keeps their band
    rows in a ring of ``slots`` rows instead.

    Row record, int32 words, one per row tile: [origin, band rows, first
    row, end row] (the tile reads source rows [first, end); origin is the
    source row of A's column 0 and of iyr 0: first, or in the carry form
    ``end - k_rows``), corr (16: ``128 * sum cy`` per output row, the s8
    rebase), ydiv (16: border divisors, 0 on main rows), then with ``s8y``
    the merged Y matrix A (16 rows of ``k_rows + 16`` s8 bytes), else cy
    and iyr (taps_y x 16 each, tap-major).  Column record, one per column
    tile: [lo, width, phases, whether any column has a border divisor], xs
    (tw: each output's first tap ``start - lo``, unclamped), ph (tw: its
    phase), xdiv (tw), then cxu (taps_x x ``max_phases``, tap-major: the
    tile's distinct X rows), or in the relaxed form ``planes`` such tables
    of float32 bits (the relaxed plane, and the residual plane where the
    plan has one)."""
    tw: int
    s8y: bool
    k_rows: int             # band rows staged: max rows of a tile, to 32
    pitch: int              # band bytes per row: window + 15, to 128
    margin: int             # work columns left of band column 0
    work_pitch: int         # work tile columns per row (= 32 mod 64)
    max_phases: int
    rrec: np.ndarray        # (n_row_tiles, rrec_words) int32
    crec: np.ndarray        # (n_col_tiles, crec_words) int32
    relaxed: bool = False
    planes: int = 1         # X coefficient planes per phase in crec
    run: int = 1            # row tiles per block; > 1 in the carry form
    slots: int = 0          # ring rows of the carry form
    fetch: int = 0          # carry: source rows a column tile fetches
    band: int = 0           # ... and without carry

    @property
    def carry(self) -> bool:
        return self.run > 1

    @property
    def smem(self) -> int:
        rows = self.slots if self.carry else self.k_rows
        return (rows * self.pitch + TILE_ROWS * self.work_pitch * 2
                + 4 * ((2 if self.carry else 1) * self.rrec.shape[1]
                       + self.crec.shape[1]))


_REC_HEAD = 4               # header words of each record
_Y_TABLES = _REC_HEAD + 2 * TILE_ROWS     # where A (or cy, iyr) starts


def _merged_y(plan: ResizePlan, rwin: np.ndarray, k_rows: int,
              origin: np.ndarray | None = None) -> np.ndarray:
    """(n_row_tiles, TILE_ROWS, k_rows) int64: the Y matrix of each row
    tile over its band, A[i, k] = sum of the taps of output row r0 + i
    that read source row origin + k (clamped taps that repeat a row add;
    origin is the window's first row by default); zero rows past dst_h and
    zero columns outside the band."""
    y = plan.y
    n_rt = len(rwin)
    origin = rwin[:, 0] if origin is None else origin
    rows = np.arange(n_rt * TILE_ROWS)
    valid = rows < y.n_dst
    idx = torch_resize.clamped_taps(y)
    a = np.zeros((n_rt * TILE_ROWS, k_rows), np.int64)
    r = rows[valid]
    k = idx - origin[r // TILE_ROWS][:, None]
    np.add.at(a, (np.repeat(r, y.num_coefs), k.ravel()),
              y.coef.astype(np.int64).ravel())
    return a.reshape(n_rt, TILE_ROWS, k_rows)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """a (n_dst, ...) padded with zero rows to n rows."""
    out = np.zeros((n,) + a.shape[1:], np.int64)
    out[:len(a)] = a
    return out


def _x_values(plan: ResizePlan, relaxed: bool) -> tuple[np.ndarray, np.ndarray, int]:
    """(key, values, planes), one row per output column: the X taps, or in
    the relaxed form the float32 bits of each relaxed plane's column
    (``planes`` of them, taps each); phases are the distinct keys of a
    column tile (the integer taps, and the relaxed values besides)."""
    cx = plan.x.coef.astype(np.int64)
    if not relaxed:
        return cx, cx, 1
    plane, resid = relaxed_plane(plan.x)
    planes = [plane] + ([] if resid is None else [resid])
    bits = np.concatenate([np.ascontiguousarray(p.numpy().T).view(np.int32)
                           for p in planes], axis=1).astype(np.int64)
    return np.concatenate([cx, bits], axis=1), bits, len(planes)


def tiled_layout(plan: ResizePlan, relaxed: bool = False, tw: int | None = None,
                 run: int = 1) -> TiledLayout:
    """The tiled kernel's layout and tile records for a plan (see
    :class:`TiledLayout`), exact or ``relaxed``, at ``tw`` output columns
    per block (:func:`tiled_width` by default), and with ``run`` > 1 in the
    carry form; whether it fits is :func:`tiled_ok`'s question, and
    whether carry applies :func:`tiled_carry_layout`'s."""
    y, x = plan.y, plan.x
    tw = tiled_width(plan) if tw is None else tw
    rwin = tile_windows(y, TILE_ROWS).astype(np.int64)
    n_rt = len(rwin)
    k_rows = _round_up(int((rwin[:, 1] - rwin[:, 0]).max()), 32)
    # carry: each tile's K window ends at its band's last row
    origin = rwin[:, 0] if run == 1 else rwin[:, 1] - k_rows
    a = _merged_y(plan, rwin, k_rows, origin)
    s8y = bool(a.min() >= -128 and a.max() <= 127)
    cy = _pad_rows(y.coef, n_rt * TILE_ROWS)
    corr = (128 * cy.sum(axis=1)).reshape(n_rt, TILE_ROWS)
    ydiv = np.where(y.is_border, np.where(y.deno == 0, 1, y.deno), 0) \
        if plan.wrap16 else np.zeros(y.n_dst, np.int64)
    ydiv = _pad_rows(ydiv, n_rt * TILE_ROWS).reshape(n_rt, TILE_ROWS)
    head = np.stack([origin, rwin[:, 1] - rwin[:, 0], rwin[:, 0], rwin[:, 1]],
                    axis=1)
    if s8y:
        pad = np.zeros((n_rt, TILE_ROWS, k_rows + 16), np.uint8)
        pad[:, :, :k_rows] = (a & 0xFF).astype(np.uint8)
        ytab = pad.reshape(n_rt, -1).view("<u4").astype(np.int64)
    else:
        idx = _pad_rows(torch_resize.clamped_taps(y), n_rt * TILE_ROWS)
        idx = idx.reshape(n_rt, TILE_ROWS, -1) - origin[:, None, None]
        idx[np.arange(n_rt * TILE_ROWS).reshape(n_rt, TILE_ROWS)
            >= y.n_dst] = 0
        ytab = np.concatenate([
            cy.reshape(n_rt, TILE_ROWS, -1).transpose(0, 2, 1).reshape(n_rt, -1),
            idx.transpose(0, 2, 1).reshape(n_rt, -1)], axis=1)
    rrec = np.concatenate([head, corr, ydiv, ytab], axis=1)

    win = tile_windows(x, tw).astype(np.int64)
    n_ct = len(win)
    cols = np.arange(n_ct * tw)
    valid = cols < x.n_dst
    xs = np.zeros(n_ct * tw, np.int64)
    xs[valid] = x.start - win[cols[valid] // tw, 0]
    xdiv = np.zeros(n_ct * tw, np.int64)
    if plan.wrap16:
        xdiv[valid] = _x_divisors(plan)
    key, vals, planes = _x_values(plan, relaxed)
    key = _pad_rows(key, n_ct * tw).reshape(n_ct, tw, -1)
    vals = _pad_rows(vals, n_ct * tw).reshape(n_ct, tw, -1)
    phases = [np.unique(key[t][:min(tw, x.n_dst - t * tw)], axis=0,
                        return_index=True, return_inverse=True)
              for t in range(n_ct)]
    max_phases = max(len(u) for u, _, _ in phases)
    ph = np.zeros((n_ct, tw), np.int64)
    tab = np.zeros((n_ct, planes, x.num_coefs, max_phases), np.int64)
    for t, (u, first, inv) in enumerate(phases):
        ph[t, :len(inv)] = inv.ravel()
        tab[t, :, :, :len(u)] = vals[t][first].reshape(
            len(u), planes, x.num_coefs).transpose(1, 2, 0)
    head = np.zeros((n_ct, _REC_HEAD), np.int64)
    head[:, 0], head[:, 1] = win[:, 0], win[:, 1] - win[:, 0]
    head[:, 2] = [len(u) for u, _, _ in phases]
    head[:, 3] = (xdiv.reshape(n_ct, tw) != 0).any(axis=1)
    crec = np.concatenate([head, xs.reshape(n_ct, tw), ph,
                           xdiv.reshape(n_ct, tw), tab.reshape(n_ct, -1)],
                          axis=1)

    pitch = _round_up(int((win[:, 1] - win[:, 0]).max()) + 15, BAND_ALIGN)
    margin = _round_up(max(0, -int(xs.min())), 8)
    need = margin + max(pitch, 15 + max(0, int(xs.max())) + x.num_coefs)
    work_pitch = _round_up(max(need - 32, 0), 64) + 32

    def words(rec):
        rec = np.pad(rec, ((0, 0), (0, -rec.shape[1] % 4)))
        return ((rec + 2**31) % 2**32 - 2**31).astype(np.int32)   # uint32 bits

    carry = {}
    if run > 1:
        _, fetch, band = _carry_runs(rwin, run)
        hi = rwin[:, 1]
        inner = np.arange(1, n_rt) % run != 0
        # tile t + 1's fresh rows land while tile t reads its K window
        # [hi_t - k_rows, hi_t): both fit the ring apart
        need_slots = k_rows + int((hi[1:] - hi[:-1])[inner].max(initial=0))
        carry = dict(run=run, slots=_round_up(need_slots, 32), fetch=fetch,
                     band=band)
    return TiledLayout(tw=tw, s8y=s8y, k_rows=k_rows, pitch=pitch,
                       margin=margin, work_pitch=work_pitch,
                       max_phases=max_phases, rrec=words(rrec),
                       crec=words(crec), relaxed=relaxed, planes=planes,
                       **carry)


def _fits(layout: TiledLayout) -> bool:
    return layout.smem <= SMEM_BUDGET


def tiled_ok(plan: ResizePlan, relaxed: bool = False) -> bool:
    """True when the tiled kernel takes a plan, exact or ``relaxed``:
    inside :func:`supports_plan`, and its band, work tile and tile records
    fit SMEM_BUDGET at the chosen width (:func:`tiled_layout`).  A pure
    function of the plan; plans where it is False keep the windowed
    ``resize_fused`` route."""
    return supports_plan(plan, relaxed) and _fits(tiled_layout(plan, relaxed))


def tiled_carry_layout(plan: ResizePlan, relaxed: bool = False,
                       tw: int | None = None, run: int | None = None
                       ) -> TiledLayout | None:
    """The tiled kernel's carry form for a plan (see
    :class:`TiledLayout`), or None where it does not apply.

    TW and the run are chosen together: from the exact form's width
    (:func:`tiled_width`) down, the run is the most row tiles per block
    that still leaves about TILED_BLOCKS blocks per frame (two per SM of an
    H100), and at least 2; the first width whose layout applies is taken
    (``tw`` and ``run`` fix either).  Carry applies, as the JAX package's
    does (``pallas_resize.py:542-591``), when inside every run each row
    tile's source window ``[lo, hi)`` is non-decreasing in both ends and
    carry fetches less than 90 % of the rows the tiled form reads; and when
    the ring (a tile's K window and the next tile's fresh rows, apart) fits
    SMEM_BUDGET beside the work tile and two row records."""
    rwin = tile_windows(plan.y, TILE_ROWS)
    n_rt = len(rwin)
    if n_rt < 2:
        return None
    widths = TILED_WIDTHS[TILED_WIDTHS.index(tiled_width(plan)):] \
        if tw is None else (tw,)
    for w in widths:
        n_ct = -(-plan.x.n_dst // w)
        r = min(n_rt, max(2, n_rt // -(-TILED_BLOCKS // n_ct))) \
            if run is None else run
        monotone, fetch, band = _carry_runs(rwin, r)
        if not monotone or fetch >= (1 - CARRY_MIN_SAVING) * band:
            continue
        layout = tiled_layout(plan, relaxed, w, r)
        if _fits(layout):
            return layout
    return None


@dataclasses.dataclass(frozen=True)
class TiledTables:
    """The tiled kernel's operands: its layout's scalars and the two
    record tables on the device; in the relaxed form also the relaxed
    planes per output (tap-major, as :class:`KernelTables`), which the
    relaxed plain version reads.  Read-only once built."""
    rrec: torch.Tensor      # (n_row_tiles, rrec_words) int32
    crec: torch.Tensor      # (n_col_tiles, crec_words) int32
    layout: TiledLayout
    taps_y: int
    taps_x: int
    wrap16: bool
    cxr: torch.Tensor       # (taps_x, dst_w) relaxed plane; empty when exact
    cxd: torch.Tensor       # (taps_x, dst_w) residual plane, or empty
    relaxed: bool = False
    carry: bool = False
    tiled: bool = True
    wide: bool = False


def _relaxed_tensors(plan: ResizePlan, relaxed: bool, device):
    """(cxr, cxd) on ``device``: the relaxed planes, the residual empty
    where there is none; both empty when not ``relaxed``."""
    empty = torch.empty((0, plan.x.n_dst), dtype=torch.float32, device=device)
    if not relaxed:
        return empty, empty
    cxr, resid = relaxed_plane(plan.x)
    return cxr.to(device), empty if resid is None else resid.to(device)


def tiled_tables(plan: ResizePlan, device="cpu",
                 layout: TiledLayout | None = None) -> TiledTables:
    """The tiled kernel's tables for a plan where :func:`tiled_ok` holds,
    from its ``layout`` where the caller has built it (the relaxed or carry
    form's, from :func:`tiled_layout` or :func:`tiled_carry_layout`)."""
    lay = tiled_layout(plan) if layout is None else layout
    cxr, cxd = _relaxed_tensors(plan, lay.relaxed, device)
    return TiledTables(
        rrec=torch.from_numpy(lay.rrec).to(device),
        crec=torch.from_numpy(lay.crec).to(device), layout=lay,
        taps_y=plan.y.num_coefs, taps_x=plan.x.num_coefs, wrap16=plan.wrap16,
        cxr=cxr, cxd=cxd, relaxed=lay.relaxed, carry=lay.carry)


@dataclasses.dataclass(frozen=True)
class WideLayout:
    """How the wide-window kernel (``csrc/resize_wide.cu``) walks a plan.
    Block b computes the ``tr`` x ``tc`` outputs of row tile ``b // n_ct``
    and column tile ``b % n_ct``.  Its Y pass walks items of (``ks`` slices
    of the Y taps, output row, WIDE_GROUP_COLS work columns from the column
    window's start rounded down to 16 bytes), ``ng`` groups a row at most,
    into a ``tr`` x ``wp`` int32 work tile; its X pass gives each output's
    taps to ``group`` lanes of a warp."""
    tc: int                 # output columns a block
    tr: int                 # output rows a block
    ks: int                 # slices of the Y taps
    group: int              # lanes an output's X taps split over
    ng: int                 # 16-column groups of the widest window
    wp: int                 # work tile row pitch, int32 words
    win: np.ndarray         # (n_col_tiles, 2) int32 [lo, hi) source columns
    n_rt: int               # row tiles
    taps_y: int
    taps_x: int

    @property
    def n_ct(self) -> int:
        return len(self.win)

    @property
    def blocks(self) -> int:
        """Blocks a frame."""
        return self.n_ct * self.n_rt

    @property
    def smem(self) -> int:
        """Bytes of shared memory a block: the work tile, the block's Y and
        X tables and their starts."""
        return 4 * (self.tr * (self.wp + self.taps_y + 1)
                    + self.tc * (self.taps_x + 1))


def _wide_groups(win: np.ndarray) -> int:
    """16-column groups of the widest window, from its start rounded down to
    16 columns (the 16-byte loads' alignment)."""
    lo = win[:, 0].astype(np.int64)
    return int((-(-(win[:, 1] - (lo - lo % WIDE_GROUP_COLS)) // WIDE_GROUP_COLS)).max())


def _item_share(items: int) -> float:
    """The share of the threads that Y items fill over their rounds."""
    return items / (WIDE_THREADS * -(-items // WIDE_THREADS))


def wide_layout(plan: ResizePlan, budget: int = SMEM_BUDGET,
                blocks: int = WIDE_BLOCKS, tc: int | None = None,
                tr: int | None = None) -> WideLayout | None:
    """The wide-window kernel's layout of a plan (see :class:`WideLayout`),
    or None where even one output a block does not fit ``budget`` bytes of
    shared memory.  A pure function of the plan.

    The tile: from TILE_ROWS x TILE_COLS (rows capped at the plan's),
    halve the columns and the rows in turn until a frame's grid holds
    ``blocks`` blocks (two per SM of an H100) or each output has a block of
    its own; then the rows, and if need be the columns, shrink until the
    block's shared memory fits ``budget`` (``tc`` and ``tr`` fix either).
    Columns stay powers of two, so each column tile's window lies inside
    the 128-column tile's.  ``ks``: 1 below WIDE_SLICE_TAPS Y taps (the
    slices' zero fill and shared-memory atomics cost more than they gain
    there); else the fewest slices (at least 4 taps a slice) whose items
    fill the threads' last round to WIDE_ITEM_SHARE, else the best.
    ``group``: the fewest lanes, a power of two up to 32, that give every
    thread an output's share of taps."""
    dw, dh = plan.x.n_dst, plan.y.n_dst
    taps_y, taps_x = plan.y.num_coefs, plan.x.num_coefs
    fixed_c, fixed_r = tc is not None, tr is not None
    tc = TILE_COLS if tc is None else tc
    tr = min(TILE_ROWS, dh) if tr is None else tr
    turn = 0
    while -(-dw // tc) * -(-dh // tr) < blocks:
        can_c, can_r = tc > 1 and not fixed_c, tr > 1 and not fixed_r
        if not (can_c or can_r):
            break
        if can_c and (turn % 2 == 0 or not can_r):
            tc //= 2
        else:
            tr = -(-tr // 2)
        turn += 1
    while True:
        win = tile_windows(plan.x, tc)
        ng = _wide_groups(win)
        wp = ng * WIDE_GROUP_COLS + 4          # rows 4 banks apart
        room = budget // 4 - tc * (taps_x + 1)
        fit = room // (wp + taps_y + 1) if room > 0 else 0
        if fit >= 1:
            tr = min(tr, fit)
            break
        if tc == 1 or fixed_c:
            return None
        tc //= 2
    items = tr * ng
    top = max(1, min(taps_y // 4, WIDE_THREADS)) if taps_y >= WIDE_SLICE_TAPS else 1
    shares = [_item_share(items * k) for k in range(1, top + 1)]
    ks = next((k for k, v in enumerate(shares, 1) if v >= WIDE_ITEM_SHARE),
              1 + int(np.argmax(shares)))
    group = 1
    while group < 32 and tr * tc * group < WIDE_THREADS and group < taps_x:
        group *= 2
    return WideLayout(tc=tc, tr=tr, ks=ks, group=group, ng=ng, wp=wp,
                      win=win, n_rt=-(-dh // tr), taps_y=taps_y, taps_x=taps_x)


@dataclasses.dataclass(frozen=True)
class WideTables:
    """The wide-window kernel's operands, output-major int32 tables on the
    device, and its layout.  Read-only once built."""
    cy: torch.Tensor        # (dst_h, taps_y)
    ys: torch.Tensor        # (dst_h,) first source row, unclamped
    ydiv: torch.Tensor      # (dst_h,) border divisor, 0 on main rows
    cx: torch.Tensor        # (dst_w, taps_x)
    xs: torch.Tensor        # (dst_w,) first source column, unclamped
    xdiv: torch.Tensor      # (dst_w,) deno_x * y_bias, 0 on main columns
    win: torch.Tensor       # (n_col_tiles, 2) source columns [lo, hi)
    layout: WideLayout
    wrap16: bool
    relaxed: bool = False
    carry: bool = False
    tiled: bool = False
    wide: bool = True


def wide_tables(plan: ResizePlan, device="cpu",
                layout: WideLayout | None = None) -> WideTables:
    """The wide-window kernel's tables for an exact plan, at ``layout``
    (:func:`wide_layout` by default, which must take the plan)."""
    lay = wide_layout(plan) if layout is None else layout
    if lay is None:
        raise ValueError("one output a block does not fit the wide-window "
                         "kernel's shared memory")
    ydeno = np.where(plan.y.deno == 0, 1, plan.y.deno)

    def t(a):
        a = np.ascontiguousarray(np.asarray(a).astype(np.int32))
        return torch.from_numpy(a).to(device)

    return WideTables(
        cy=t(plan.y.coef), ys=t(plan.y.start),
        ydiv=t(np.where(plan.y.is_border, ydeno, 0)), cx=t(plan.x.coef),
        xs=t(plan.x.start), xdiv=t(_x_divisors(plan)), win=t(lay.win),
        layout=lay, wrap16=plan.wrap16)


@dataclasses.dataclass(frozen=True)
class KernelTables:
    """The kernel's operands, tap-major: int32 tables, and in the relaxed
    form float32 coefficient planes of bf16 values.  Read-only once
    built."""
    cy: torch.Tensor        # (taps_y, dst_h)
    iy: torch.Tensor        # (taps_y, dst_h), clamped source rows
    ydiv: torch.Tensor      # (dst_h,), border divisor, 0 on main rows
    cx: torch.Tensor        # (taps_x, dst_w)
    ix: torch.Tensor        # (taps_x, dst_w), clamped source columns
    xdiv: torch.Tensor      # (dst_w,), deno_x * y_bias, 0 on main columns
    win: torch.Tensor       # (n_col_tiles, 2) source window [lo, hi)
    win_max: int
    wrap16: bool            # which instantiation: see :func:`variant`
    cxr: torch.Tensor       # (taps_x, dst_w) relaxed plane; empty when exact
    cxd: torch.Tensor       # (taps_x, dst_w) residual plane, or empty
    relaxed: bool
    carry: bool             # the carry form; the fields below are read only then
    rwin: torch.Tensor      # (n_row_tiles, 2) source rows [lo, hi), or empty
    iyr: torch.Tensor       # (taps_y, dst_h) ring slot of each Y tap, or empty
    ring_rows: int = 0
    ring_pitch: int = 0
    run: int = 0
    rows: int = TILE_ROWS   # output rows a block (:func:`work_rows`)
    tiled: bool = False     # these are resize_fused's tables, not the tiled kernel's
    wide: bool = False      # ... nor the wide-window kernel's


@dataclasses.dataclass(frozen=True)
class KernelOperands:
    """A plan on one device: the plain path's operands, and the kernel's
    tables (else None): exact ones on a CUDA device when
    :func:`supports_plan` holds (the tiled kernel's where :func:`tiled_ok`
    holds), relaxed ones on any device, since the relaxed plain version
    reads its planes from them."""
    plain: torch_resize.Operands
    tables: KernelTables | TiledTables | WideTables | None

    @property
    def device(self) -> torch.device:
        return self.plain.device

    @property
    def relaxed(self) -> bool:
        return self.tables is not None and self.tables.relaxed


def kernel_tables(plan: ResizePlan, device="cpu", relaxed: bool = False,
                  carry: bool = False, tiled: bool = True, wide: bool = True
                  ) -> KernelTables | TiledTables | WideTables:
    """The kernel's tables for a plan that :func:`supports_plan` takes
    (with the same ``relaxed``), exact or relaxed.  With ``tiled`` (the
    default), the tiled kernel's (:func:`tiled_tables`): with ``carry`` its
    carry form's where :func:`tiled_carry_layout` takes the plan; else,
    without a windowed carry (:func:`carry_ok`) to take its place, its
    plain form's where that layout fits (:func:`tiled_ok`).  Else the
    wide-window kernel's (:func:`wide_tables`) for an exact plan whose
    16-row work tile does not fit (:func:`work_rows` < TILE_ROWS) where
    :func:`wide_layout` takes it and ``wide`` holds (the default); else the
    windowed ``resize_fused`` form's: the carry form where ``carry`` and
    :func:`carry_ok` hold, the plain one otherwise (every other plan's with
    ``tiled=False``, and with ``wide=False`` the wide-window walk's at
    fewer rows a block)."""
    if tiled:
        lay = tiled_carry_layout(plan, relaxed) if carry else None
        if lay is None and not (carry and carry_ok(plan)):
            lay = tiled_layout(plan, relaxed)
        if lay is not None and _fits(lay):
            return tiled_tables(plan, device, lay)
    if wide and not relaxed and 0 < work_rows(plan) < TILE_ROWS:
        lay = wide_layout(plan)
        if lay is not None:
            return wide_tables(plan, device, lay)
    win = tile_windows(plan.x)
    ydeno = np.where(plan.y.deno == 0, 1, plan.y.deno)

    def t(a):
        a = np.ascontiguousarray(np.asarray(a).astype(np.int32))
        return torch.from_numpy(a).to(device)

    cxr, cxd = _relaxed_tensors(plan, relaxed, device)
    iy = torch_resize.clamped_taps(plan.y).T
    layout = carry_layout(plan) if carry else None
    if layout is None:
        ring = dict(rwin=t(np.empty((0, 2))), iyr=t(np.empty((0, 2))))
    else:
        ring = dict(rwin=t(layout.rwin), iyr=t(iy % layout.ring_rows),
                    ring_rows=layout.ring_rows, ring_pitch=layout.ring_pitch,
                    run=layout.run)
    return KernelTables(
        cy=t(plan.y.coef.T), iy=t(iy),
        ydiv=t(np.where(plan.y.is_border, ydeno, 0)),
        cx=t(plan.x.coef.T), ix=t(torch_resize.clamped_taps(plan.x).T),
        xdiv=t(_x_divisors(plan)), win=t(win),
        win_max=int((win[:, 1] - win[:, 0]).max()), wrap16=plan.wrap16,
        cxr=cxr, cxd=cxd, relaxed=relaxed, carry=layout is not None,
        rows=TILE_ROWS if layout is not None else work_rows(plan), **ring)


def pack_operands(plan: ResizePlan, device="cpu", relaxed: bool = False,
                  carry: bool = False, tiled: bool = True,
                  wide: bool = True) -> KernelOperands:
    """Turn a :class:`ResizePlan` into tensors on ``device``.  Exact: the
    kernel's tables are built only where it can launch, on a CUDA device
    for plans inside :func:`supports_plan`: the tiled kernel's where
    :func:`tiled_ok` holds, else the wide-window kernel's where the 16-row
    work tile does not fit, else the windowed ``resize_fused`` form's;
    ``tiled=False`` builds those of the other two for every plan (to run the
    kernels side by side), and ``wide=False`` the windowed kernel's
    wide-window walk in place of the wide-window kernel (to time the two in
    turns).  ``relaxed=True`` needs ``supports_plan(plan, relaxed=True)``
    (else ValueError) and builds the relaxed tables, by the same routes, on
    any device.  ``carry=True`` builds a carry form's tables where one takes
    the plan (:func:`kernel_tables`)."""
    device = torch.device(device)
    if relaxed:
        if not supports_plan(plan, relaxed=True):
            raise ValueError("plan is outside the relaxed kernel's scope "
                             "(supports_plan(relaxed=True))")
        tables = kernel_tables(plan, device, relaxed=True, carry=carry,
                               tiled=tiled)
    elif device.type == "cuda" and supports_plan(plan):
        tables = kernel_tables(plan, device, carry=carry, tiled=tiled, wide=wide)
    else:
        tables = None
    return KernelOperands(plain=torch_resize.pack_operands(plan, device),
                          tables=tables)


def resize_plain(ops: KernelOperands, src: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``torch_resize``), on the
    same operands and on src's device: the relaxed one when the tables are
    relaxed."""
    if ops.relaxed:
        k = ops.tables
        return torch_resize.resize_relaxed(ops.plain, k.cxr, k.cxd, src)
    return torch_resize.resize(ops.plain, src)


@functools.cache
def _lib():
    """The kernel library, checked once against the host's tile shape."""
    lib = _build.load()
    rows, cols = ctypes.c_int(), ctypes.c_int()
    lib.iqo_tile_shape(ctypes.byref(rows), ctypes.byref(cols))
    if (rows.value, cols.value) != (TILE_ROWS, TILE_COLS):
        raise RuntimeError(f"kernel tile {rows.value}x{cols.value} != host "
                           f"tile {TILE_ROWS}x{TILE_COLS}")
    widths = (ctypes.c_int * 8)()
    n = lib.iqo_tiled_shape(ctypes.byref(rows), widths, len(widths))
    if (rows.value, tuple(widths[:n])) != (TILE_ROWS, TILED_WIDTHS):
        raise RuntimeError(f"tiled kernel rows {rows.value}, widths "
                           f"{tuple(widths[:n])} != host {TILE_ROWS}, "
                           f"{TILED_WIDTHS}")
    lib.iqo_wide_shape(ctypes.byref(rows), ctypes.byref(cols))
    if (rows.value, cols.value) != (WIDE_THREADS, WIDE_GROUP_COLS):
        raise RuntimeError(f"wide-window kernel {rows.value} threads, "
                           f"{cols.value} columns an item != host "
                           f"{WIDE_THREADS}, {WIDE_GROUP_COLS}")
    return lib


@functools.cache
def _lib_for(device: torch.device):
    """The kernel library with the kernel's shared-memory limit raised to
    the budget on ``device``, once per device."""
    lib = _lib()
    with torch.cuda.device(device):
        rc = (lib.iqo_set_max_smem(SMEM_BUDGET)
              or lib.iqo_tiled_set_max_smem(SMEM_BUDGET)
              or lib.iqo_wide_set_max_smem(SMEM_BUDGET))
    if rc != 0:
        raise RuntimeError(f"resize_fused setup failed on {device}: "
                           f"{lib.iqo_error_string(rc).decode()} ({rc})")
    return lib


def wide_load_bytes(src: torch.Tensor) -> int:
    """The width in bytes of the loads the wide-window kernel takes on a
    (B, src_h, src_w) uint8 CUDA tensor: 16 where its start and strides are
    16-byte aligned, else 1 (the kernel's own rule, ``iqo_wide_load_bytes``)."""
    if src.device.type != "cuda" or src.dim() != 3:
        raise ValueError(f"a (B, src_h, src_w) CUDA tensor, not {src.dim()}-d on {src.device}")
    return _lib().iqo_wide_load_bytes(src.data_ptr(), src.shape[0], src.stride(0),
                                      src.stride(1))


def resize_fused(ops: KernelOperands, src: torch.Tensor) -> torch.Tensor:
    """(B, src_h, src_w) uint8 -> (B, dst_h, dst_w) uint8.

    Launches the kernel the tables were built for: the tiled kernel
    (``csrc/resize_tiled.cuh``) in its form for :class:`TiledTables`, the
    wide-window kernel (``csrc/resize_wide.cu``) for :class:`WideTables`,
    else ``resize_fused`` in its instantiation.  A CPU tensor goes through
    :func:`resize_plain`.  A CUDA tensor launches
    the kernel, or raises: there is no fallback.  Rows may be strided; the
    last dimension must be contiguous."""
    if src.device.type == "cpu":
        return resize_plain(ops, src)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    k = ops.tables
    if k is None:
        raise ValueError("plan is outside the kernel's scope (supports_plan)")
    if src.device != ops.device:
        raise ValueError(f"source on {src.device}, operands on {ops.device}")
    if src.dtype != torch.uint8:
        raise TypeError(f"source must be uint8, got {src.dtype}")
    (h, w), (dh, dw) = ops.plain.src_shape, ops.plain.dst_shape
    if src.ndim != 3 or tuple(src.shape[1:]) != (h, w):
        raise ValueError(f"source shape {tuple(src.shape)} != (B, {h}, {w})")
    if src.stride(-1) != 1:
        raise ValueError("source rows must be contiguous (last stride 1)")
    if src.shape[0] > _MAX_GRID_YZ:
        raise ValueError(f"{src.shape[0]} frames in one call; at most "
                         f"{_MAX_GRID_YZ}")
    lib = _lib_for(src.device)
    out = torch.empty((src.shape[0], dh, dw), dtype=torch.uint8,
                      device=src.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(src.device).cuda_stream
    if k.tiled:
        lay = k.layout
        rc = lib.iqo_resize_tiled(
            int(k.wrap16), int(lay.s8y), lay.tw, int(lay.relaxed),
            int(lay.carry), src.data_ptr(), out.data_ptr(), src.shape[0],
            src.stride(0), src.stride(1), w, dh, dw, k.rrec.data_ptr(),
            k.rrec.shape[1], k.crec.data_ptr(), k.crec.shape[1], k.taps_y,
            k.taps_x, lay.k_rows, lay.pitch, lay.margin, lay.work_pitch,
            lay.max_phases, ops.plain.y_bias, ops.plain.out_shift, lay.planes,
            lay.run, lay.slots, stream)
        return _launched(lib, rc, k, out, "resize_tiled")
    if k.wide:
        lay = k.layout
        rc = lib.iqo_resize_wide(
            int(k.wrap16), src.data_ptr(), out.data_ptr(), src.shape[0],
            src.stride(0), src.stride(1), h, w, dh, dw, k.cy.data_ptr(),
            k.ys.data_ptr(), k.ydiv.data_ptr(), lay.taps_y, ops.plain.y_bias,
            k.cx.data_ptr(), k.xs.data_ptr(), k.xdiv.data_ptr(), lay.taps_x,
            k.win.data_ptr(), lay.n_ct, lay.tc, lay.tr, lay.ks, lay.group,
            lay.wp, ops.plain.out_shift, stream)
        return _launched(lib, rc, k, out, "resize_wide")
    rc = lib.iqo_resize_fused(
        int(k.wrap16), int(k.relaxed), int(k.carry), src.data_ptr(),
        out.data_ptr(),
        src.shape[0], src.stride(0), src.stride(1), dh, dw, k.rows,
        k.cy.data_ptr(), k.iy.data_ptr(), k.ydiv.data_ptr(),
        k.cy.shape[0], ops.plain.y_bias,
        k.cx.data_ptr(), k.ix.data_ptr(), k.xdiv.data_ptr(),
        k.cx.shape[0],
        k.cxr.data_ptr() if k.relaxed else None,
        k.cxd.data_ptr() if k.cxd.numel() else None,
        k.win.data_ptr(), k.win_max, ops.plain.out_shift,
        k.rwin.data_ptr() if k.carry else None,
        k.iyr.data_ptr() if k.carry else None,
        k.ring_rows, k.ring_pitch, k.run, stream)
    return _launched(lib, rc, k, out, "resize_fused")


def _launched(lib, rc: int, k, out: torch.Tensor, name: str) -> torch.Tensor:
    """Raise if a launch returned an error, else count it and return out."""
    global LAUNCHES
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.iqo_error_string(rc).decode()} ({rc})")
    with _launch_lock:
        LAUNCHES += 1
        LAUNCHES_BY_VARIANT[variant(k)] += 1
    return out
