"""Launch geometry of the redesigned X-pass probes and NumPy models that walk it.

Kernel I's ``f32_2dot``, ``bf16_1dot``, ``s16_1dot``, ``s8_4dot`` and
``s8_2dot_cat`` and kernel J's ``dense4`` have a second form, ``gemm``
(``libiqo_tpu_torch/csrc/exp/exp_xpass_gemm.cu``, the s8 variants'
``exp_xpass_s8.cu``): a GEMM whose M stacks the repeats' work rows, with the
repeats spread over the grid in slices (the s8 variants: a persistent walk
of (tile, step) units instead) whose uint32 partial sums meet in the output by
``atomicAdd``.  This module states each form's geometry (:data:`F32_GEMM`,
:data:`BF16_GEMM`, :data:`S16_GEMM`, :data:`S8_GEMM`, :data:`DENSE4_GEMM`:
block tile, repeats a step stacks, K chunks, shared-memory stages), picks the
repeat slices for a launch (:func:`geometry`; the s8 variants' walk,
:func:`s8_launch`), and models the kernels' schedules in NumPy
(:func:`f32_gemm_model`, :func:`bf16_gemm_model`, :func:`s16_gemm_model`,
:func:`s8_gemm_model`, :func:`dense4_gemm_model`, :func:`cover`), so that
the CPU tests can hold the schedule against the plain versions; on the card
the kernels themselves are held against them.

A block of ``f32_2dot``'s form takes one group of 128 outputs, 16 work rows
and a slice of the repeats; a step stacks 4 repeats x 2 planes of its 16 rows
(128 A rows, ``m = 8 row + 2 repeat + plane``) against the group's taps, which
stay in shared memory for the whole slice.  A block of ``bf16_1dot``'s form
takes the same tile with two warpgroups; a step stacks 8 repeats of its 16
rows (one a warp, 128 A rows, ``m = 16 repeat + row``) against the group's
taps, laid out K-major and resident, with wgmma; each repeat's f32 dot is
whole over K before it is truncated.  A block of ``s16_1dot``'s form takes
64 outputs (half a group), 16 work rows and a slice; a step stacks 8
repeats of its 16 rows, one a warp, as the int16 work values' byte planes
against the taps' byte planes, K-major and resident (:func:`byte_planes`):
four s8/u8 wgmma products into three s32 accumulators that sum a warp's
repeats over the whole slice (:func:`s16_recombine` at its end).  A block of
the s8 variants' form takes the same tile and steps, as ``a = int8((w + r)
>> 8)`` and ``b = int8(((w + r) & 255) - 128)`` (:func:`s8_split`) against
the taps' planes ``e`` and ``f``, K-major and resident: four s8 wgmma
m64n64k32 (``s8_4dot``) or two m64n128k32 against ``[e | f]``
(``s8_2dot_cat``) a K step; it walks a contiguous run of the (tile, step)
units (:class:`S8Launch`) and flushes its sums at each new tile and after at
most 64 steps.  A block of ``dense4``'s form
takes 32 output columns, 16 work rows and a slice; a step stacks 8 repeats x
2 planes x 16 rows against 64 coefficient columns (cxh's 32, then cxl's),
streamed in K chunks with the chunk's work rows; each warp splits its rows'
work values into its A fragments in registers for wgmma.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = ["BF16_GEMM", "DENSE4_GEMM", "F32_GEMM", "FORMS", "FormGeometry", "Launch",
           "S16_GEMM", "S8_GEMM", "S8Launch", "SMEM_LIMIT",
           "bf16_dot_f32", "bf16_gemm_model", "bf16_round", "byte_planes", "check_s8_shape",
           "check_shape", "cover", "dense4_gemm_model", "f32_gemm_model", "form_of",
           "geometry", "launch_key", "lib", "s16_gemm_model", "s16_recombine", "s8_gemm_model",
           "s8_launch", "s8_lib", "s8_split", "s8_unit_cover", "sm_count", "split_f32",
           "window_offset", "wrap_add"]

SMEM_LIMIT = 232_448        # bytes of shared memory one block may use (H100)
SMEM_PER_SM = 233_472       # the SM's 228 KB, of which 1 KB is reserved per block
H100_SMS = 132
SLICE_OVERHEAD = 0.1        # a block's set-up, in steps, for picking the slices
_F32_EXACT = 2**24


FORMS = ("serial", "gemm", "wide")


def form_of(variant: str, form: str | None, gemm_variants: tuple[str, ...],
            wide_variants: tuple[str, ...] = ()) -> str:
    """``form``, or the variant's default: ``"gemm"`` for the variants that
    have that form, ``"wide"`` for those that have that one (kernel J's
    float32 variants), else ``"serial"``."""
    has = [f for f, vs in (("gemm", gemm_variants), ("wide", wide_variants)) if variant in vs]
    if form is None:
        return has[0] if has else "serial"
    if form != "serial" and form not in has:
        raise ValueError(f"{variant} takes form 'serial'"
                         + "".join(f" or {f!r}" for f in has) + f", got {form!r}")
    return form


def launch_key(variant: str, form: str) -> str:
    """A probe's ``LAUNCHES`` key of a variant's form: the variant's name for
    PR 7's serial form, ``variant[form]`` otherwise."""
    return variant if form == "serial" else f"{variant}[{form}]"


@dataclasses.dataclass(frozen=True)
class FormGeometry:
    """One form's fixed geometry, as ``exp_xpass_gemm.cu`` states it."""
    name: str
    threads: int            # a block's threads
    rows: int               # work rows of a block
    rep_step: int           # repeats a step stacks along M
    cols: int               # output columns of a block
    k: int                  # the contraction
    kc: int                 # K chunk
    tiles_y: int            # grid: output column tiles
    tiles_z: int            # grid: work row tiles
    stages: tuple[tuple[str, int, int], ...]   # (what, count, bytes each)
    reg_blocks: int         # blocks an SM holds by registers (its __launch_bounds__)
    planes: int = 2         # A planes a work row and repeat gives (hi and lo, or one)
    fill: int = 2           # blocks per SM the grid holds where the steps allow
    overhead: float = SLICE_OVERHEAD   # a block's set-up, in steps, for picking the slices
    max_steps: int | None = None       # most steps a slice (s8: a run between flushes) may take

    @property
    def chunks(self) -> int:
        return self.k // self.kc

    @property
    def tiles(self) -> int:
        return self.tiles_y * self.tiles_z

    @property
    def smem(self) -> int:
        return sum(n * b for _, n, b in self.stages)

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds, by shared memory and by registers."""
        return min(SMEM_PER_SM // (self.smem + 1024), self.reg_blocks)

    @property
    def m(self) -> int:
        """A rows a step stacks: rows x repeats x planes."""
        return self.planes * self.rows * self.rep_step


# kernel I, f32_2dot: 256 threads of 8 x 8; C_g (384 x 128 f32) resident, two
# A chunks of (32, 128) f32
F32_GEMM = FormGeometry(
    "f32_2dot[gemm]", threads=256, rows=16, rep_step=4, cols=128, k=384, kc=32,
    tiles_y=3, tiles_z=10,
    stages=(("C_g, resident (12 chunks)", 1, 384 * 128 * 4), ("A chunk", 2, 32 * 128 * 4)),
    reg_blocks=1)
# kernel I, bf16_1dot: two warpgroups, wgmma m64n128k16 with A (one repeat
# a warp) from registers; C_g K-major (6 K blocks of 128 x 64 bf16,
# swizzled) and the block's work window (16 x 384 i32) resident
BF16_GEMM = FormGeometry(
    "bf16_1dot[gemm]", threads=256, rows=16, rep_step=8, cols=128, k=384, kc=64,
    tiles_y=3, tiles_z=10,
    stages=(("C_g, K-major, resident (6 K blocks)", 1, 128 * 384 * 2),
            ("work window", 1, 16 * 384 * 4), ("alignment slack", 1, 1024)),
    reg_blocks=1, planes=1, fill=0, overhead=1.0)
# (a block loads 120 KB of taps and window before its first product, about a
# step's time, and its 8 warps need no second block on the SM: the fewest
# blocks win, one wave of 120 at R)
# kernel I, s16_1dot: two warpgroups, 4 wgmma m64n64k32 (s8/u8) a K step with
# A (one repeat a warp) from registers; both byte planes of the half group's
# taps K-major (3 K blocks of 64 x 128 bytes each, swizzled) and the work
# window as int16 (16 x 384) resident; at most 64 steps a slice, so that the
# s32 sums of a slice stay in int32
S16_GEMM = FormGeometry(
    "s16_1dot[gemm]", threads=256, rows=16, rep_step=8, cols=64, k=384, kc=128,
    tiles_y=6, tiles_z=10,
    stages=(("taps' byte planes, K-major, resident (3 K blocks x 2)", 1, 2 * 64 * 384),
            ("work window, int16", 1, 16 * 384 * 2), ("alignment slack", 1, 1024)),
    reg_blocks=1, planes=1, fill=0, overhead=1.0, max_steps=64)
# kernel I, s8_4dot and s8_2dot_cat: two warpgroups, 4 wgmma m64n64k32 or 2
# m64n128k32 (s8) a K step with A (one repeat a warp) from registers; a
# tile's taps e and f K-major (3 K blocks of 128 x 128 bytes, swizzled) and
# its work window as int16 (16 x 384), in two buffers (the next tile's loads
# land while a flush runs), the 8 warps' sums at a flush and a window of
# zeros that a repeat past reps reads; at most 64
# steps between two flushes, so that the s32 sums stay in int32.  Its
# tiles_y x tiles_z are the 60 tiles of the walk.
S8_GEMM = FormGeometry(
    "s8[gemm]", threads=256, rows=16, rep_step=8, cols=64, k=384, kc=128,
    tiles_y=6, tiles_z=10,
    stages=(("a tile's taps e and f, K-major (3 K blocks)", 2, 2 * 64 * 384),
            ("a tile's work window, int16", 2, 16 * 384 * 2),
            ("the warps' sums at a flush", 1, 8 * 16 * 64 * 4),
            ("a window of zeros (a repeat past reps)", 1, 16 * 384 * 2),
            ("alignment slack", 1, 1024)),
    reg_blocks=1, planes=1, max_steps=64)
# kernel J, dense4: one warpgroup, 4 wgmma m64n64k16 a K step (A fragments
# split in registers); four stages of a B chunk (64 x 64 bf16, 1024-byte
# aligned) and the chunk's 16 work rows (72 words a row)
DENSE4_GEMM = FormGeometry(
    "dense4[gemm]", threads=128, rows=16, rep_step=8, cols=32, k=896, kc=64,
    tiles_y=12, tiles_z=10,
    stages=(("B chunk", 4, 64 * 64 * 2), ("work rows", 4, 16 * 72 * 4),
            ("alignment slack", 1, 1024)), reg_blocks=2)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of a form: ``slices`` x ``steps_per_slice`` covers the
    ``steps`` steps of ``reps`` repeats; the grid is (slices, tiles_y,
    tiles_z)."""
    form: FormGeometry
    reps: int
    steps: int
    steps_per_slice: int
    slices: int

    @property
    def grid(self) -> tuple[int, int, int]:
        return self.slices, self.form.tiles_y, self.form.tiles_z

    @property
    def blocks(self) -> int:
        return self.slices * self.form.tiles

    def slice_steps(self, s: int) -> range:
        return range(s * self.steps_per_slice, min((s + 1) * self.steps_per_slice, self.steps))


def geometry(form: FormGeometry, reps: int, sms: int = H100_SMS) -> Launch:
    """The repeat slices of one launch: the fewest waves of blocks times the
    steps each block walks (plus the form's set-up, ``form.overhead`` steps),
    among the slicings whose grid holds at least ``form.fill`` blocks per SM
    where the steps allow."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    steps = -(-reps // form.rep_step)
    slots = sms * form.blocks_per_sm
    options = []
    for sps in range(1, min(steps, form.max_steps or steps) + 1):
        slices = -(-steps // sps)
        waves = -(-slices * form.tiles // slots)
        options.append((waves * (sps + form.overhead), sps, slices))
    floor = min(form.fill * sms, steps * form.tiles)
    _, sps, slices = min(o for o in options if o[2] * form.tiles >= floor)
    return Launch(form, reps, steps, sps, slices)


@dataclasses.dataclass(frozen=True)
class S8Launch:
    """One launch of the s8 variants' gemm form: ``blocks`` blocks, block
    ``b`` a contiguous run of the (tile, step) units ``tile * steps + step``
    (tile ``t``: output columns ``64 (t // 10)``, work rows ``16 (t % 10)``).
    The walk gives each of ``min(sms, units)`` persistent blocks an equal
    run, ``[b U / B, (b + 1) U / B)``."""
    reps: int
    steps: int
    blocks: int
    sms: int

    @property
    def units(self) -> int:
        return S8_GEMM.tiles * self.steps

    def run(self, b: int) -> tuple[int, int]:
        """Block ``b``'s units ``[u0, u1)``, as the kernel computes them."""
        return self.units * b // self.blocks, self.units * (b + 1) // self.blocks

    def segments(self, b: int) -> list[tuple[int, int, int]]:
        """Block ``b``'s runs between two flushes, ``(tile, first step, end
        step)``: its run cut where it enters a new tile and after at most
        ``S8_GEMM.max_steps`` steps of one tile."""
        u, u1 = self.run(b)
        out = []
        while u < u1:
            tile, s0 = divmod(u, self.steps)
            s1 = min(self.steps, s0 + S8_GEMM.max_steps, s0 + u1 - u)
            out.append((tile, s0, s1))
            u += s1 - s0
        return out

    @property
    def wave_efficiency(self) -> float:
        """The units over the SMs' time, ``sms x waves x`` the longest run
        (one block an SM)."""
        longest = max(u1 - u0 for u0, u1 in map(self.run, range(self.blocks)))
        return self.units / (self.sms * -(-self.blocks // self.sms) * longest)


def s8_launch(reps: int, sms: int = H100_SMS) -> S8Launch:
    """The s8 variants' launch: the walk's ``min(sms, units)`` blocks."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    steps = -(-reps // S8_GEMM.rep_step)
    return S8Launch(reps, steps, min(sms, S8_GEMM.tiles * steps), sms)


def s8_unit_cover(launch: S8Launch) -> np.ndarray:
    """How many times a launch's flush segments take each (tile, step) unit,
    (60, steps) int64: 1 everywhere where the walk is right."""
    counts = np.zeros((S8_GEMM.tiles, launch.steps), np.int64)
    for b in range(launch.blocks):
        for tile, s0, s1 in launch.segments(b):
            counts[tile, s0:s1] += 1
    return counts


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def lib(device: torch.device):
    """The probes' library with the forms' shared memory raised on
    ``device``, after :func:`check_shape`."""
    from . import _harness
    lib_ = _harness.lib_with_setup("iqo_exp_xpass_gemm_setup", device)
    check_shape(lib_)
    return lib_


@functools.cache
def s8_lib(device: torch.device):
    """The probes' library with the s8 form's shared memory raised on
    ``device``, after :func:`check_s8_shape`."""
    from . import _harness
    lib_ = _harness.lib_with_setup("iqo_exp_xpass_s8_setup", device)
    check_s8_shape(lib_)
    return lib_


def check_s8_shape(lib_) -> None:
    """``exp_xpass_s8.cu``'s compiled geometry (``iqo_exp_xpass_s8_shape``)
    must be :data:`S8_GEMM`."""
    import ctypes
    got = (ctypes.c_int * 9)()
    lib_.iqo_exp_xpass_s8_shape(got)
    f = S8_GEMM
    want = [f.threads, f.rows, f.rep_step, f.cols, f.kc, f.chunks, f.tiles, f.smem, f.max_steps]
    if list(got) != want:
        raise RuntimeError(f"exp_xpass_s8.cu's geometry {list(got)} != the host's {want}")


def check_shape(lib_) -> None:
    """The kernels' compiled geometry (``iqo_exp_xpass_gemm_shape``) must be
    :data:`F32_GEMM`, :data:`DENSE4_GEMM`, :data:`BF16_GEMM` and
    :data:`S16_GEMM`."""
    import ctypes
    got = (ctypes.c_int * 27)()
    lib_.iqo_exp_xpass_gemm_shape(got)
    want = [F32_GEMM.threads, F32_GEMM.rows, F32_GEMM.rep_step, F32_GEMM.kc, F32_GEMM.chunks,
            F32_GEMM.smem, DENSE4_GEMM.threads, DENSE4_GEMM.rows, DENSE4_GEMM.rep_step,
            DENSE4_GEMM.cols, DENSE4_GEMM.kc, DENSE4_GEMM.chunks, DENSE4_GEMM.smem,
            BF16_GEMM.threads, BF16_GEMM.rows, BF16_GEMM.rep_step, BF16_GEMM.kc,
            BF16_GEMM.chunks, BF16_GEMM.smem, S16_GEMM.threads, S16_GEMM.rows,
            S16_GEMM.rep_step, S16_GEMM.cols, S16_GEMM.kc, S16_GEMM.chunks, S16_GEMM.smem,
            S16_GEMM.max_steps]
    if list(got) != want:
        raise RuntimeError(f"exp_xpass_gemm.cu's geometry {list(got)} != the host's {want}")


def wrap_add(acc: np.ndarray, v: np.ndarray) -> np.ndarray:
    """uint32 addition, as ``atomicAdd`` on uint32 and ``add.u32``."""
    return (acc.astype(np.uint64) + v.astype(np.int64).astype(np.uint64)) \
        .astype(np.uint32)


def split_f32(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(x >> 8, x & 255)`` of int32 work values, as the kernels split them."""
    x = x.astype(np.int32)
    return (x >> 8).astype(np.int64), (x & 255).astype(np.int64)


def _chunked(a: np.ndarray, b: np.ndarray, kc: int) -> np.ndarray:
    """a @ b on integers, summed K chunk by K chunk in float64, with every
    output's sum of |terms| asserted below 2^24: then the kernels' f32 sums
    equal it in any order.  int64."""
    d = np.zeros((a.shape[0], b.shape[1]))
    mag = np.zeros_like(d)
    for k0 in range(0, a.shape[1], kc):
        ak, bk = a[:, k0:k0 + kc].astype(np.float64), b[k0:k0 + kc].astype(np.float64)
        d += ak @ bk
        mag += np.abs(ak) @ np.abs(bk)
    if mag.max(initial=0.0) >= _F32_EXACT:
        raise ValueError(f"a sum of |terms| reaches {mag.max()}, not below 2^24")
    return d.astype(np.int64)


def _work(w: np.ndarray, r: int) -> np.ndarray:
    """``w + r`` wrapped to int32, as the kernels add in uint32."""
    return ((w.astype(np.int64) + r + 2**31) % 2**32 - 2**31).astype(np.int32)


def f32_gemm_model(w: np.ndarray, c: np.ndarray, reps: int, sms: int = H100_SMS) -> np.ndarray:
    """Kernel I's ``f32_2dot`` in its gemm form, block by block, step by step
    and K chunk by K chunk as :func:`geometry` lays them out: ``w`` (160, 896)
    int32, ``c`` (3, 384, 128) integer taps -> (160, 384) int32."""
    f = F32_GEMM
    launch = geometry(f, reps, sms)
    out = np.zeros((160, 384), np.uint32)
    for s, grp, rt in np.ndindex(*launch.grid):
        cg = c[grp].astype(np.int64)
        rows = slice(f.rows * rt, f.rows * (rt + 1))
        wt = w[rows, 256 * grp:256 * grp + f.k]
        total = np.zeros((f.rows, f.cols), np.uint32)
        for step in launch.slice_steps(s):
            # A: m = 8 row + 2 j + plane, repeat 4 step + j
            a = np.empty((f.rows, f.rep_step, 2, f.k), np.int64)
            for j in range(f.rep_step):
                a[:, j, 0], a[:, j, 1] = split_f32(_work(wt, f.rep_step * step + j))
            d = _chunked(a.reshape(f.m, f.k), cg, f.kc).reshape(f.rows, f.rep_step, 2, f.cols)
            for j in range(f.rep_step):
                if f.rep_step * step + j < reps:
                    total = wrap_add(total, d[:, j, 0] * 256 + d[:, j, 1])
        out[rows, f.cols * grp:f.cols * (grp + 1)] = wrap_add(
            out[rows, f.cols * grp:f.cols * (grp + 1)], total)
    return out.view(np.int32)


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest even bf16, as float32 (finite
    values), as ``__floats2bfloat162_rn`` and ``torch``'s conversion."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def bf16_dot_f32(wt: np.ndarray, cb: np.ndarray, r: int, ks: int = 16) -> np.ndarray:
    """One repeat of ``bf16_1dot``'s dot as the gemm form forms it: the work
    values ``w + r`` (int32) rounded once to f32 and then to bf16, against
    the bf16 taps ``cb`` (K, N), each K step of ``ks`` summed exactly and
    rounded to f32, the steps summed in f32 in order (one order the tensor
    cores could take), truncated to int64."""
    a = bf16_round(_work(wt, r).astype(np.float32)).astype(np.float64)
    cb = cb.astype(np.float64)
    d = np.zeros((a.shape[0], cb.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], ks):
        d = (d + (a[:, k0:k0 + ks] @ cb[k0:k0 + ks]).astype(np.float32)).astype(np.float32)
    return np.trunc(d).astype(np.int64)


def bf16_gemm_model(w: np.ndarray, cbf: np.ndarray, reps: int,
                    sms: int = H100_SMS) -> np.ndarray:
    """Kernel I's ``bf16_1dot`` in its gemm form, block by block and step by
    step as :func:`geometry` lays them out: ``w`` (160, 896) int32, ``cbf``
    (3, 384, 128) the bf16 taps as float32 -> (160, 384) int32.  Each
    repeat's dot is :func:`bf16_dot_f32`, truncated whole, then summed over
    the block's slice in uint32; the slices meet in uint32."""
    f = BF16_GEMM
    launch = geometry(f, reps, sms)
    out = np.zeros((160, 384), np.uint32)
    for s, grp, rt in np.ndindex(*launch.grid):
        rows = slice(f.rows * rt, f.rows * (rt + 1))
        cols = slice(f.cols * grp, f.cols * (grp + 1))
        wt = w[rows, 256 * grp:256 * grp + f.k]
        total = np.zeros((f.rows, f.cols), np.uint32)
        for step in launch.slice_steps(s):
            for j in range(f.rep_step):         # warp j: repeat 8 step + j
                r = f.rep_step * step + j
                if r < reps:
                    total = wrap_add(total, bf16_dot_f32(wt, cbf[grp], r))
        out[rows, cols] = wrap_add(out[rows, cols], total)
    return out.view(np.int32)


def byte_planes(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(x >> 8, x & 255)`` of int16 values, int64: the high byte as s8
    and the low byte as u8, so that ``x == 256 hi + lo``; the kernel takes
    the work values' planes by byte permutes of their int16 and the taps'
    from ``build_cvals``' ``c16_k``."""
    x = x.astype(np.int64)
    if x.size and (x.min() < -2**15 or x.max() >= 2**15):
        raise ValueError("byte_planes takes int16 values")
    return x >> 8, x & 255


def s16_recombine(hh: np.ndarray, mid: np.ndarray, ll: np.ndarray) -> np.ndarray:
    """``65536 hh + 256 mid + ll`` in uint32, as the kernel's ``mad.lo.u32``
    forms it from the s32 sums: the dot wrapped to 32 bits."""
    u = [np.asarray(v).astype(np.int64).astype(np.uint64) for v in (hh, mid, ll)]
    return ((u[0] * 65536 + u[1] * 256 + u[2]) & 0xFFFFFFFF).astype(np.uint32)


def window_offset(row: int, k: int) -> int:
    """Byte offset of the int16 work value (row, k) in ``xscheme_s16_gemm``'s
    resident window: lane ``4 (row % 8) + k % 16 // 4`` reads its K step
    ``k // 32``'s values of rows g and g + 8 as the 16-byte words ``2 kk``
    and ``2 kk + 1`` of 32 lanes."""
    kk, lane = k // 32, 4 * (row % 8) + k % 16 // 4
    return ((kk * 2 + row // 8) * 32 + lane) * 16 + 8 * (k % 32 // 16) + 2 * (k % 4)


def s16_gemm_model(w: np.ndarray, c: np.ndarray, reps: int, sms: int = H100_SMS) -> np.ndarray:
    """Kernel I's ``s16_1dot`` in its gemm form, block by block, warp by warp
    and step by step as :func:`geometry` lays them out: ``w`` (160, 896)
    int32, ``c`` (3, 384, 128) int16 taps -> (160, 384) int32.  Each warp
    sums its repeats' byte-plane products in three accumulators over the
    slice (asserted to stay in int32, as the kernel's s32 sums must), forms
    :func:`s16_recombine` at the end; the warps and the slices meet in
    uint32."""
    f = S16_GEMM
    launch = geometry(f, reps, sms)
    out = np.zeros((160, 384), np.uint32)
    for s, half, rt in np.ndindex(*launch.grid):
        grp = half // 2
        rows = slice(f.rows * rt, f.rows * (rt + 1))
        cols = slice(f.cols * half, f.cols * (half + 1))
        ch, cl = byte_planes(c[grp][:, f.cols * (half % 2):f.cols * (half % 2 + 1)])
        wt = w[rows, 256 * grp:256 * grp + f.k].astype(np.int64)
        total = np.zeros((f.rows, f.cols), np.uint32)
        for warp in range(f.rep_step):
            hh, mid, ll = (np.zeros((f.rows, f.cols), np.int64) for _ in range(3))
            for step in launch.slice_steps(s):
                r = f.rep_step * step + warp
                if r >= reps:
                    continue                    # zero A rows
                xh, xl = byte_planes((wt + r + 2**15) % 2**16 - 2**15)
                hh += xh @ ch
                mid += xh @ cl + xl @ ch
                ll += xl @ cl
            if max(np.abs(a).max(initial=0) for a in (hh, mid, ll)) >= 2**31:
                raise ValueError("an s32 sum of the slice leaves int32")
            total = wrap_add(total, s16_recombine(hh, mid, ll))
        out[rows, cols] = wrap_add(out[rows, cols], total)
    return out.view(np.int32)


def _s8(v) -> np.ndarray:
    """The low byte of integers as s8, int64."""
    return ((np.asarray(v, np.int64) + 128) & 255) - 128


def s8_split(x) -> tuple[np.ndarray, np.ndarray]:
    """``(a, b)`` of the s8 variants from work values, as the kernel takes
    them from the window's ``int16(w)`` plus ``r`` in 16 bits: ``a`` the high
    byte as s8, ``b`` the low byte XOR 0x80 as s8, both int64; equal to
    ``int8((w + r) >> 8)`` and ``int8(((w + r) & 255) - 128)``, which read
    only the low 16 bits of ``w + r``."""
    x = np.asarray(x, np.int64) & 0xFFFF
    return _s8(x >> 8), _s8((x & 255) ^ 0x80)


def s8_gemm_model(w: np.ndarray, c: np.ndarray, corr: np.ndarray, reps: int, cat: bool,
                  sms: int = H100_SMS) -> np.ndarray:
    """Kernel I's ``s8_4dot`` (``cat`` False) or ``s8_2dot_cat`` in its gemm
    form, block by block, flush by flush and warp by warp as
    :func:`s8_launch` lays them out: ``w`` (160, 896) int32, ``c`` (3, 384,
    128) integer taps (``e = int8(c >> 8)``, ``f = int8(c & 255)``), ``corr``
    (3, 128) integers -> (160, 384) int32.  Each warp sums its live repeats'
    products between two flushes in s32 accumulators (``s8_4dot``: ``a e``,
    ``a f + b e``, ``b f``; ``s8_2dot_cat``: ``a [e | f]``, ``b [e | f]``),
    asserted to stay in int32; at the flush it forms ``65536 hh + 256 mid +
    ll + corr x`` its live repeats in uint32; the warps and the flushes meet
    in uint32."""
    f = S8_GEMM
    launch = s8_launch(reps, sms)
    c = np.asarray(c, np.int64)
    planes = np.concatenate([_s8(c >> 8), _s8(c & 255)], axis=2)    # (3, 384, 256): [e | f]
    corr = np.asarray(corr, np.int64)
    window = np.asarray(w, np.int64) & 0xFFFF                        # the int16 window
    out = np.zeros((160, 384), np.uint32)
    for b in range(launch.blocks):
        for tile, s0, s1 in launch.segments(b):
            half, rt = divmod(tile, f.tiles_z)
            grp, lo = half // 2, f.cols * (half % 2)
            ef = np.concatenate([planes[grp][:, lo:lo + f.cols],
                                 planes[grp][:, 128 + lo:128 + lo + f.cols]], axis=1)
            wt = window[f.rows * rt:f.rows * (rt + 1), 256 * grp:256 * grp + f.k]
            total = np.zeros((f.rows, f.cols), np.uint32)
            for warp in range(f.rep_step):
                rs = [r for r in range(f.rep_step * s0 + warp, f.rep_step * s1, f.rep_step)
                      if r < reps]
                if not rs:
                    continue                    # zero A rows, corr x 0
                a, bb = s8_split(wt[None] + np.array(rs)[:, None, None])
                # the s32 sums over K and the warp's repeats: the repeats' planes
                # summed first (the products are linear), exact in float64
                da = (a.sum(0).astype(np.float64) @ ef).astype(np.int64)    # a [e | f]
                db = (bb.sum(0).astype(np.float64) @ ef).astype(np.int64)   # b [e | f]
                hh, mid, ll = da[:, :f.cols], da[:, f.cols:] + db[:, :f.cols], db[:, f.cols:]
                accs = (da, db) if cat else (hh, mid, ll)
                if max(np.abs(x).max(initial=0) for x in accs) >= 2**31:
                    raise ValueError("an s32 sum between two flushes leaves int32")
                rec = wrap_add(s16_recombine(hh, mid, ll), corr[grp, lo:lo + f.cols] * len(rs))
                total = wrap_add(total, rec)
            rows = slice(f.rows * rt, f.rows * (rt + 1))
            cols = slice(f.cols * half, f.cols * (half + 1))
            out[rows, cols] = wrap_add(out[rows, cols], total)
    return out.view(np.int32)


def dense4_gemm_model(wd: np.ndarray, cxh: np.ndarray, cxl: np.ndarray, reps: int,
                      sms: int = H100_SMS) -> np.ndarray:
    """Kernel J's ``dense4`` in its gemm form, block by block, step by step
    and K chunk by K chunk: ``wd`` (160, 896) int32, ``cxh``, ``cxl`` (896,
    384) integer coefficients -> (160, 384) int32."""
    f = DENSE4_GEMM
    launch = geometry(f, reps, sms)
    out = np.zeros((160, 384), np.uint32)
    for s, ct, rt in np.ndindex(*launch.grid):
        cols = slice(f.cols * ct, f.cols * (ct + 1))
        rows = slice(f.rows * rt, f.rows * (rt + 1))
        b = np.concatenate([cxh[:, cols], cxl[:, cols]], axis=1).astype(np.int64)   # (896, 128)
        total = np.zeros((f.rows, f.cols), np.uint32)
        for step in launch.slice_steps(s):
            # A: m = 16 rl + 8 plane + row, repeat 8 step + rl
            a = np.empty((f.rep_step, 2, f.rows, f.k), np.int64)
            for rl in range(f.rep_step):
                a[rl, 0], a[rl, 1] = split_f32(_work(wd[rows], f.rep_step * step + rl))
            d = _chunked(a.reshape(f.m, f.k), b, f.kc).reshape(f.rep_step, 2, f.rows, 2, f.cols)
            for rl in range(f.rep_step):    # [rl, plane, row, cxh/cxl, col]
                if f.rep_step * step + rl >= reps:
                    continue
                hi = d[rl, 0, :, 0] + d[rl, 0, :, 1]
                lo = d[rl, 1, :, 0] + d[rl, 1, :, 1]
                total = wrap_add(total, hi * 256 + lo)
        out[rows, cols] = wrap_add(out[rows, cols], total)
    return out.view(np.int32)


def cover(form: FormGeometry, reps: int, sms: int = H100_SMS) -> np.ndarray:
    """How many times each (repeat, row, column) is computed and kept by the
    threads of a launch, (reps + the last step's padding, 160, 384) int64,
    from each kernel's thread mapping: 1 where ``repeat < reps``, else 0."""
    launch = geometry(form, reps, sms)
    counts = np.zeros((launch.steps * form.rep_step, 160, 384), np.int64)
    tid = np.arange(form.threads)
    for s, ty, tz in np.ndindex(*launch.grid):
        for step in launch.slice_steps(s):
            if form is BF16_GEMM or form is S16_GEMM:
                # warp w: repeat 8 step + w; lane (g, q): rows g, g + 8,
                # columns 8 j + 2 q + c of the block's 128 (s16: 64)
                warp, lane = tid // 32, tid % 32
                g, q = lane // 4, lane % 4
                j, h, c = np.meshgrid(np.arange(form.cols // 8), np.arange(2), np.arange(2),
                                      indexing="ij")
                cols = form.cols * ty + 8 * j.ravel() + 2 * q[:, None] + c.ravel()
                rows = form.rows * tz + g[:, None] + 8 * h.ravel()
                r = form.rep_step * step + warp
                live = r < reps
                np.add.at(counts, (r[live, None], rows[live], cols[live]), 1)
            elif form is F32_GEMM:
                # thread (tm, tn): row tm, repeats j, columns 4 tn + {0..3, 64..67}
                tm, tn = tid // 16, tid % 16
                cols = (form.cols * ty + 4 * tn[:, None] + np.array([0, 1, 2, 3, 64, 65, 66, 67]))
                for j in range(form.rep_step):
                    r = form.rep_step * step + j
                    if r < reps:
                        np.add.at(counts[r], (form.rows * tz + tm[:, None], cols), 1)
            else:
                # warp (wr, wp), lane (g, q): repeats 4 wp + tt, row 8 wr + g,
                # columns 8 j + 2 q + c2
                warp, lane = tid // 32, tid % 32
                wr, wp, g, q = warp % 2, warp // 2, lane // 4, lane % 4
                j, c2 = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
                cols = form.cols * ty + 8 * j.ravel() + 2 * q[:, None] + c2.ravel()
                rows = form.rows * tz + 8 * wr + g
                for tt in range(4):
                    r = form.rep_step * step + 4 * wp + tt
                    live = r < reps
                    np.add.at(counts, (r[live, None], rows[live, None], cols[live]), 1)
    return counts
