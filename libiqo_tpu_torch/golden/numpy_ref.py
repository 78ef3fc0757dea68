"""Golden oracle: exact NumPy implementation of the reference Generic paths.

The port's copy of ``libiqo_tpu/golden/numpy_ref.py``; the code is the same.
This is the executable specification of the fixed-point output contract
(ref: src/IQO{Lanczos,Area,Linear}ResizerImpl_Generic.cpp, SURVEY.md §3.3).
The port's plain path and CUDA kernel are tested byte-equal against it.

Pipeline per output row (vectorized here over all rows):

1. Y pass: integer weighted sum of source rows -> "work" rows scaled by the
   Y bias.  Lanczos accumulates in int16 and wraps (ref: Generic.cpp:513);
   wrap(total) == total mod 2**16 because wraparound is associative.
   Lanczos border rows renormalize by the in-range tap sum with a C-style
   truncating division (ref: Generic.cpp:487-489).
2. X pass: integer dot with the X tables, then the rounding epilogue:
   main outputs shift-round ((sum + half) >> shift, an arithmetic/floor
   shift, ref: Generic.cpp:222-227), border outputs divide by the in-range
   tap sum with truncation (roundedDiv, ref: Generic.cpp:216-220,572).
"""

from __future__ import annotations

import numpy as np

from ..coeffs.engine import trunc_div
from ..core.plan import ResizePlan

__all__ = ["resize_u8", "wrap_i16", "wrap_i32"]


def wrap_i16(x: np.ndarray) -> np.ndarray:
    """Reduce to int16 two's-complement range (C++ int16_t cast)."""
    return ((x + 32768) & 65535) - 32768


def wrap_i32(x: np.ndarray) -> np.ndarray:
    """Reduce to int32 two's-complement range.

    The reference accumulates the Lanczos X pass in a C ``int32_t``
    (ref: Generic.cpp:555,598) which wraps for pathological px_scale
    geometries whose near-zero-sum phases quantize to |coef| > 2**15; the
    wrap is part of observed output.
    """
    return ((x + 2**31) & (2**32 - 1)) - 2**31


def _y_pass(plan: ResizePlan, src_i: np.ndarray) -> np.ndarray:
    """(src_h, W) int64 -> (dst_h, W) int64 work rows, Y-bias scaled."""
    y = plan.y
    cy = y.dense(np.int64)                       # (dst_h, src_h)
    nume = cy @ src_i                            # exact integer
    if plan.wrap16:
        nume = wrap_i16(nume)
        if y.is_border.any():
            deno = np.where(y.deno == 0, 1, y.deno.astype(np.int64))[:, None]
            border = wrap_i16(trunc_div(nume * y.bias, deno))
            nume = np.where(y.is_border[:, None], border, nume)
    return nume


def _x_pass(plan: ResizePlan, work: np.ndarray) -> np.ndarray:
    """(dst_h, src_w) int64 work -> (dst_h, dst_w) u8 output."""
    x = plan.x
    cx = x.dense(np.int64)                       # (dst_w, src_w)
    sums = work @ cx.T                           # (dst_h, dst_w)
    if plan.wrap16:
        # lanczos: C int32 accumulator semantics, incl. the +half add
        sums = wrap_i32(sums)
        half = 1 << (plan.out_shift - 1)
        main = wrap_i32(sums + half) >> plan.out_shift
    else:
        half = 1 << (plan.out_shift - 1)
        main = (sums + half) >> plan.out_shift
    if x.is_border.any():
        deno = np.where(x.deno == 0, 1, x.deno.astype(np.int64)) * plan.y.bias
        border = trunc_div(wrap_i32(sums + half) if plan.wrap16 else sums + half,
                           deno[None, :])
        v = np.where(x.is_border[None, :], border, main)
    else:
        v = main
    v = wrap_i16(v)  # convertToInt/roundedDiv return int16 before clamping
    return np.clip(v, 0, 255).astype(np.uint8)


def resize_u8(plan: ResizePlan, src: np.ndarray) -> np.ndarray:
    """Resize one (src_h, src_w) uint8 image to (dst_h, dst_w) uint8."""
    if src.shape != (plan.y.n_src, plan.x.n_src):
        raise ValueError(
            f"source shape {src.shape} != plan geometry "
            f"({plan.y.n_src}, {plan.x.n_src})"
        )
    if src.dtype != np.uint8:
        raise TypeError(f"source must be uint8, got {src.dtype}")
    work = _y_pass(plan, src.astype(np.int64))
    return _x_pass(plan, work)
