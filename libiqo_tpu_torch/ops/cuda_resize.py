"""The fused resize kernel for Hopper: host-side operands, scope and wrapper.

The kernel (``csrc/resize_fused.cu``) replaces the TPU's fused Pallas kernel
(``libiqo_tpu/ops/pallas_resize.py:_make_padless_fn``) in two exact
instantiations, ``wrap16`` for Lanczos plans (int16 work rows, border
divides) and ``u16`` for Area and Linear plans (u16 work rows, no borders),
and in a relaxed form of each (``wrap16_relaxed``, ``u16_relaxed``: the X
pass over bf16-rounded work rows and coefficient planes in float32, within
2 LSB of the exact output, flat fields exact).  Each of the four has a
row-halo carry form (``*_carry``, the TPU's ``LIBIQO_TPU_CARRY`` mode): a
block walks a run of row tiles and keeps their source rows in a ring in
shared memory, byte-equal to the windowed form; it is opted into with
``LIBIQO_TPU_CARRY=1`` (or ``2``) and engages where :func:`carry_ok` holds.
This module packs a :class:`ResizePlan` into the kernel's operands, decides
which plans the kernel takes (:func:`supports_plan`), and launches it
(:func:`resize_fused`).  :func:`resize_plain` is the same function in plain
PyTorch over the same operands, for the CPU and for comparison on the card.
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
           "KernelOperands", "KernelTables", "carry_layout", "carry_ok",
           "carry_requested", "kernel_tables", "pack_operands",
           "relaxed_plane", "reset_launches", "resize_fused", "resize_plain",
           "smem_bytes", "supports_plan", "tile_windows", "variant"]

# Must match kTileRows/kTileCols in csrc/resize_fused.cu (checked at load).
TILE_ROWS = 16
TILE_COLS = 128
SMEM_BUDGET = 232448      # dynamic shared memory one sm_90 block may use
_MAX_GRID_YZ = 65535      # CUDA's limit on gridDim.y (row tiles) and .z (frames)
_I32_MAX = 2**31 - 1
_F32_EXACT_COEF_SUM = 65535   # the JAX package's per-row sum(|coef|) bound
_RELAXED_WALK = 24            # most taps the column-sum repair nudges
CARRY_BLOCKS = 264        # blocks a carry grid aims for: two per SM of 132
CARRY_MIN_SAVING = 0.1    # carry must fetch <= 90 % of the windowed rows
RING_ALIGN = 16           # bytes: the ring's row pitch is a multiple

VARIANTS = ("wrap16", "u16", "wrap16_relaxed", "u16_relaxed",
            "wrap16_carry", "u16_carry", "wrap16_relaxed_carry",
            "u16_relaxed_carry")
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
    """The kernel instantiation that a plan takes, exact or ``relaxed``,
    windowed or ``carry`` (one of :data:`VARIANTS`); given its
    :class:`KernelTables`, the one they were built for."""
    name = "wrap16" if plan.wrap16 else "u16"
    if getattr(plan, "relaxed", relaxed):
        name += "_relaxed"
    return name + "_carry" if getattr(plan, "carry", carry) else name


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
    index in int32, the row tiles fit the grid, and the work tile fits the
    shared-memory budget.

    Relaxed: all of that, and the JAX package's relaxed guards
    (``pallas_resize.py:943-1024``): ``wmax * max_j sum|cx| < 2^31``, with
    wmax 32768 for wrap16 plans and 65280 for u16 ones (the sum is also
    taken over the rounded planes, so the float32 sums stay inside int32),
    and :func:`relaxed_plane` must succeed.  Plans outside
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
    if -(-plan.y.n_dst // TILE_ROWS) > _MAX_GRID_YZ:
        return False
    if smem_bytes(plan) > SMEM_BUDGET:
        return False
    return not relaxed or _relaxed_ok(plan)


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


def carry_layout(plan: ResizePlan) -> CarryLayout | None:
    """The carry form's layout of a plan, or None where it does not apply.

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
    if not ((lo[1:] >= lo[:-1]) & (hi[1:] >= hi[:-1]))[inner].all():
        return None
    fresh = hi[1:] - np.maximum(hi[:-1], lo[1:])
    starts = np.arange(0, n_rt, run)
    fetch = int((hi - lo)[starts].sum() + fresh[inner].sum())
    band = int((hi - lo).sum())
    if fetch >= (1 - CARRY_MIN_SAVING) * band:
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
    """True when the carry form applies to the plan (:func:`carry_layout`).
    A pure function of the plan; where it is False the windowed form runs
    and is counted under its own name."""
    return carry_layout(plan) is not None


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


@dataclasses.dataclass(frozen=True)
class KernelOperands:
    """A plan on one device: the plain path's operands, and the kernel's
    tables (else None): exact ones on a CUDA device when
    :func:`supports_plan` holds, relaxed ones on any device, since the
    relaxed plain version reads its planes from them."""
    plain: torch_resize.Operands
    tables: KernelTables | None

    @property
    def device(self) -> torch.device:
        return self.plain.device

    @property
    def relaxed(self) -> bool:
        return self.tables is not None and self.tables.relaxed


def kernel_tables(plan: ResizePlan, device="cpu", relaxed: bool = False,
                  carry: bool = False) -> KernelTables:
    """The kernel's tables for a plan that :func:`supports_plan` takes
    (with the same ``relaxed``); with ``carry``, those of the carry form
    where :func:`carry_ok` holds, else the windowed form's."""
    win = tile_windows(plan.x)
    ydeno = np.where(plan.y.deno == 0, 1, plan.y.deno)

    def t(a):
        a = np.ascontiguousarray(np.asarray(a).astype(np.int32))
        return torch.from_numpy(a).to(device)

    empty = torch.empty((0, plan.x.n_dst), dtype=torch.float32, device=device)
    cxr = cxd = empty
    if relaxed:
        cxr, resid = relaxed_plane(plan.x)
        cxr = cxr.to(device)
        cxd = empty if resid is None else resid.to(device)
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
        cxr=cxr, cxd=cxd, relaxed=relaxed, carry=layout is not None, **ring)


def pack_operands(plan: ResizePlan, device="cpu", relaxed: bool = False,
                  carry: bool = False) -> KernelOperands:
    """Turn a :class:`ResizePlan` into tensors on ``device``.  Exact: the
    kernel's tables are built only where it can launch, on a CUDA device
    for plans inside :func:`supports_plan`.  ``relaxed=True`` needs
    ``supports_plan(plan, relaxed=True)`` (else ValueError) and builds the
    relaxed tables on any device.  ``carry=True`` builds the carry form's
    tables where :func:`carry_ok` holds (the windowed form's elsewhere)."""
    device = torch.device(device)
    if relaxed:
        if not supports_plan(plan, relaxed=True):
            raise ValueError("plan is outside the relaxed kernel's scope "
                             "(supports_plan(relaxed=True))")
        tables = kernel_tables(plan, device, relaxed=True, carry=carry)
    elif device.type == "cuda" and supports_plan(plan):
        tables = kernel_tables(plan, device, carry=carry)
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
    return lib


@functools.cache
def _lib_for(device: torch.device):
    """The kernel library with the kernel's shared-memory limit raised to
    the budget on ``device``, once per device."""
    lib = _lib()
    with torch.cuda.device(device):
        rc = lib.iqo_set_max_smem(SMEM_BUDGET)
    if rc != 0:
        raise RuntimeError(f"resize_fused setup failed on {device}: "
                           f"{lib.iqo_error_string(rc).decode()} ({rc})")
    return lib


def resize_fused(ops: KernelOperands, src: torch.Tensor) -> torch.Tensor:
    """(B, src_h, src_w) uint8 -> (B, dst_h, dst_w) uint8.

    A CPU tensor goes through :func:`resize_plain`.  A CUDA tensor launches
    the kernel, or raises: there is no fallback.  Rows may be strided; the
    last dimension must be contiguous."""
    global LAUNCHES
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
    rc = lib.iqo_resize_fused(
        int(k.wrap16), int(k.relaxed), int(k.carry), src.data_ptr(),
        out.data_ptr(),
        src.shape[0], src.stride(0), src.stride(1), dh, dw,
        k.cy.data_ptr(), k.iy.data_ptr(), k.ydiv.data_ptr(),
        k.cy.shape[0], ops.plain.y_bias,
        k.cx.data_ptr(), k.ix.data_ptr(), k.xdiv.data_ptr(),
        k.cx.shape[0],
        k.cxr.data_ptr() if k.relaxed else None,
        k.cxd.data_ptr() if k.cxd.numel() else None,
        k.win.data_ptr(), k.win_max, ops.plain.out_shift,
        k.rwin.data_ptr() if k.carry else None,
        k.iyr.data_ptr() if k.carry else None,
        k.ring_rows, k.ring_pitch, k.run,
        torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resize_fused launch failed: "
                           f"{lib.iqo_error_string(rc).decode()} ({rc})")
    with _launch_lock:
        LAUNCHES += 1
        LAUNCHES_BY_VARIANT[variant(k)] += 1
    return out
