"""The thread map of kernel J's float32 variants in their ``wide`` form
(``libiqo_tpu_torch/csrc/exp/exp_vpu_f32.cu``, ``vpu_f32_wide_kernel``), its
int -> float conversions, and a NumPy model of the kernel that walks both.

**The map.**  A thread takes :data:`OUTS` = 4 adjacent outputs of one row,
``c0 .. c0 + 3``; ``corr_f32`` reads work columns ``c0 .. c0 + 8`` of ``we``
and ``wo`` (9 + 9 values for 4 outputs, as the serial form), ``muls_f32``
columns ``c0 .. c0 + 3``.  A warp's 32 lanes cover 128 adjacent outputs, a
third of a row; the :data:`SLICES` = 3 warps of a block take the same 128
outputs over contiguous thirds of the repeats, ``[reps s / 3, reps (s + 1) /
3)``, and meet in shared memory at the end (uint32 sums, the intended int32
wraps).  480 blocks of 96 threads: 1440 warps, 10.9 an SM on 132 SMs, where
the serial form ran 480 warps on 120 SMs, one a scheduler.  Three slices
because the probe's two repeat counts, R = 24 and R / 8 = 3, both split
evenly: every warp does the same share of the work at both, so the slope
between them stays a fair per-application time.  (``muls_f32``, whose
outputs share no values, ran slower on 2 outputs a thread and twice the
warps: ``tools/vpu_f32_ablate.py``, ``two_outputs``.)

**Why registers, not lanes, share corr_f32's window.**  Per output and repeat on
the H100 (instructions issue at 128 a clock an SM; shuffles and 4-byte
shared-memory words at 32 a clock; 465 outputs an SM), on paper:

* this form: 46 float operations, 9 conversion FADDs and 13.5 integer ops
  (the ``+ r``, the shift and exponent, the byte permute), 2 ``F2I``,
  2 integer adds: 72.5 instructions, 263 clocks an application an SM;
* two outputs a thread, the rest of the window by shuffle from the next
  three lanes: 46 + 10 conversion instructions + 10 shuffles + 4 = 70
  instructions (254 clocks) with 145 clocks on the shuffle unit, and lanes
  at a warp's edge converting columns twice;
* two outputs a thread, the converted planes of a row strip staged in
  shared memory once a repeat: about 64 instructions (233 clocks) but 64
  bytes an output read back (233 clocks of shared-memory bandwidth) and a
  barrier a repeat.

They come within 12 % of each other, so the form keeps the simplest: no
barrier in the loop, no halo lanes, no shuffles.

**The conversions** (:func:`exact_f32`, :func:`byte_f32`): for an integer
``|v| < 2^22``, ``__int_as_float(0x4B400000 + v) - 1.5 * 2^23`` is
``(float)v`` exactly (the work values of ``muls_f32``, the high plane ``x >>
8`` of ``corr_f32``); for a byte ``b`` (the low plane ``x & 255``),
``__int_as_float(0x4B000000 | b) - 2^23``, the byte placed by one byte
permute (``__byte_perm(x, 0x4B000000, 0x7440)``).  Each is one integer op
and one FADD on the FP32 pipe, where the serial form issues
``I2FP.F32.S32`` at 16 a clock an SM.  A warp takes them only if every work value of its lanes
has ``|v| + reps < 2^22`` (:func:`warp_fits`, ``__all_sync`` before the
repeat loop); other warps convert with ``I2F``.

:func:`model` runs the kernel's schedule in NumPy float32 (IEEE products and
sums, no contraction, as ``__fmul_rn``/``__fadd_rn``), warp by warp, and
:func:`cover` counts the writes of every output; the CPU tests hold both
against the plain version.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BLOCKS", "FIT", "LANES", "OUTS", "SLICES", "THREADS", "byte_f32", "cover",
           "exact_f32", "model", "n_values", "repeat_range", "thread_map", "window",
           "warp_fits"]

TH, TW, HALF = 160, 384, 6
OUTS = 4                    # adjacent outputs a thread
SLICES = 3                  # warps of a block, each a third of the repeats
LANES = 32
THREADS = LANES * SLICES
BLOCK_COLS = OUTS * LANES   # outputs of one row a block
BLOCKS = TH * TW // BLOCK_COLS
FIT = 1 << 22               # |v| + reps below this: the exponent trick
_BIAS22 = np.float32(1.5 * 2**23)
_BIAS23 = np.float32(2**23)


def n_values(variant: str) -> int:
    """Work values of ``we`` (and of ``wo``) a thread reads."""
    return OUTS + HALF - 1 if variant == "corr_f32" else OUTS


def thread_map() -> tuple[np.ndarray, np.ndarray]:
    """(row, c0) of every thread, each (BLOCKS, SLICES, LANES): its outputs
    are ``out[row, c0 .. c0 + OUTS - 1]``."""
    b = np.arange(BLOCKS)[:, None, None]
    lane = np.arange(LANES)[None, None, :]
    row = np.broadcast_to(b // (TW // BLOCK_COLS), (BLOCKS, SLICES, LANES))
    c0 = np.broadcast_to(BLOCK_COLS * (b % (TW // BLOCK_COLS)) + OUTS * lane,
                         (BLOCKS, SLICES, LANES))
    return row, c0


def repeat_range(reps: int, s: int) -> tuple[int, int]:
    """The repeats ``[r0, r1)`` slice ``s`` of a block takes."""
    return reps * s // SLICES, reps * (s + 1) // SLICES


def cover() -> np.ndarray:
    """How often the kernel writes each output (160, 384): slice 0 of each
    block stores its lanes' sums, the others hand theirs over."""
    row, c0 = thread_map()
    count = np.zeros((TH, TW), np.int64)
    for c in range(OUTS):
        np.add.at(count, (row[:, 0], c0[:, 0] + c), 1)
    return count


def window(plane: np.ndarray, variant: str) -> np.ndarray:
    """Each thread's work values of ``plane`` (160, 512): (BLOCKS, LANES, n),
    columns ``c0 .. c0 + n - 1``."""
    row, c0 = thread_map()
    cols = c0[:, 0, :, None] + np.arange(n_values(variant))
    return plane[row[:, 0, :, None], cols]


def exact_f32(v: np.ndarray) -> np.ndarray:
    """``(float)v`` for int32 ``|v| < 2^22``, as the kernel makes it:
    ``0x4B400000 + v`` read as a float, minus 1.5 * 2^23."""
    bits = (np.asarray(v, np.int64) + 0x4B400000).astype(np.uint32)
    return bits.view(np.float32) - _BIAS22


def byte_f32(b: np.ndarray) -> np.ndarray:
    """``(float)b`` for a byte ``b``: ``0x4B000000 | b`` read as a float,
    minus 2^23."""
    bits = (np.asarray(b, np.int64) | 0x4B000000).astype(np.uint32)
    return bits.view(np.float32) - _BIAS23


def warp_fits(values: np.ndarray, reps: int) -> np.ndarray:
    """The warp-uniform path test: per warp (leading axes), True where every
    work value of its lanes (the last two axes) has ``|v| + reps < 2^22``."""
    v = np.abs(np.asarray(values, np.int64)) + reps
    return (v < FIT).all(axis=(-2, -1))


def _f2i(x: np.ndarray) -> np.ndarray:
    """``__float2int_rz``: truncate, saturate at the int32 range; as uint32."""
    t = np.clip(np.trunc(x.astype(np.float64)), -2.0**31, 2.0**31 - 1)
    return t.astype(np.int64).astype(np.uint32)


def _tap_sum(ce, co, a, b) -> np.ndarray:
    """t_k = ce_k a_k + co_k b_k summed in order, every operation in float32."""
    s = None
    for k in range(HALF):
        t = ce[k] * a[..., k] + co[k] * b[..., k]
        s = t if s is None else s + t
    return s


def model(variant: str, we: np.ndarray, wo: np.ndarray, taps,
          reps: int) -> tuple[np.ndarray, np.ndarray]:
    """The wide kernel's output (160, 384) int32 on ``we``, ``wo`` (160, 512)
    int32, and each warp's path (BLOCKS, SLICES) bool, True for the
    exponent trick, walking the thread map slice by slice."""
    if variant not in ("corr_f32", "muls_f32"):
        raise ValueError(f"the wide form takes corr_f32 or muls_f32, got {variant!r}")
    ve = window(np.asarray(we, np.int32), variant).astype(np.int64)
    vo = window(np.asarray(wo, np.int32), variant).astype(np.int64)
    both = np.concatenate([ve, vo], axis=-1)
    fast = np.repeat(warp_fits(both, reps)[:, None], SLICES, axis=1)
    ce = np.array([taps[2 * k] for k in range(HALF)], np.float32)
    co = np.array([taps[2 * k + 1] for k in range(HALF)], np.float32)
    wrap = lambda x: ((x + 2**31) % 2**32 - 2**31)           # noqa: E731  int32 + r

    def conv(x, f):
        return np.where(f[:, None, None], exact_f32(np.where(f[:, None, None], x, 0)),
                        x.astype(np.float32))

    def low(x, f):
        return np.where(f[:, None, None], byte_f32(x & 255), (x & 255).astype(np.float32))

    acc = np.zeros((BLOCKS, SLICES, LANES, OUTS), np.uint32)
    for s in range(SLICES):
        f = fast[:, s]
        for r in range(*repeat_range(reps, s)):
            xe, xo = wrap(ve + r), wrap(vo + r)
            with np.errstate(over="ignore"):
                if variant == "corr_f32":
                    eh, el, oh, ol = conv(xe >> 8, f), low(xe, f), conv(xo >> 8, f), low(xo, f)
                    for c in range(OUTS):
                        h = _tap_sum(ce, co, eh[..., c:c + HALF], oh[..., c:c + HALF])
                        lo = _tap_sum(ce, co, el[..., c:c + HALF], ol[..., c:c + HALF])
                        acc[:, s, :, c] += _f2i(h) * np.uint32(256) + _f2i(lo)
                else:
                    a, b = conv(xe, f), conv(xo, f)
                    rep = lambda x: np.repeat(x[..., None], HALF, axis=-1)  # noqa: E731
                    for c in range(OUTS):
                        acc[:, s, :, c] += _f2i(_tap_sum(ce, co, rep(a[..., c]), rep(b[..., c])))
    total = acc.sum(axis=1, dtype=np.uint64).astype(np.uint32)     # the slices meet
    row, c0 = thread_map()
    out = np.zeros((TH, TW), np.uint32)
    for c in range(OUTS):
        out[row[:, 0], c0[:, 0] + c] = total[..., c]
    return out.view(np.int32), fast
