"""Coefficient engine: exact host-side transcription of libiqo's table math.

The port's copy of ``libiqo_tpu/coeffs/engine.py``; the code is the same.

This module reproduces, bit-for-bit, the coefficient tables the reference
computes at resizer-construction time:

* Lanczos window tables   (ref: src/IQOLanczosResizerImpl_Generic.cpp:10-191)
* Area coverage tables    (ref: src/IQOAreaResizerImpl_Generic.cpp:11-97)
* Linear 2-tap tables     (ref: src/IQOLinearResizerImpl_Generic.cpp:13-69)
* exact-sum quantization  (ref: src/IQOLanczosResizerImpl_Generic.cpp:341-367,
                                src/IQOAreaResizerImpl_Generic.cpp:222-248)
* integer index iterators (ref: src/math.hpp:70-155 `LinearIterator`)

Everything here is pure NumPy / Python integers: it runs once per geometry at
plan-build time (the port's analog of the reference's construct-once contract,
ref: include/libiqo/LanczosResizer.hpp:17-25).

Numerical notes
---------------
The reference computes window values in ``double``, stores taps as ``float``
and accumulates the tap sum in ``float`` *sequentially*; quantization then
does float32 multiply/divide and a floor(x+0.5) round.  We replicate those
exact dtypes and the sequential summation order so the quantized integer
tables are identical to the reference's.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "gcd",
    "lcm",
    "div_floor",
    "trunc_div",
    "lanczos_window",
    "calc_num_coefs_lanczos",
    "set_lanczos_table",
    "calc_num_coefs_area",
    "set_area_table",
    "set_linear_table",
    "adjust_coefs",
    "adjust_coefs_linear",
    "src_origin_floor",
    "src_origin_centered",
]


def gcd(a: int, b: int) -> int:
    """Greatest common divisor (ref: src/math.hpp:38-49)."""
    return math.gcd(int(a), int(b))


def lcm(a: int, b: int) -> int:
    """Least common multiple, a/gcd*b ordering (ref: src/math.hpp:52-55)."""
    return int(a) // gcd(a, b) * int(b)


def div_floor(a, b):
    """floor(a / b) on integers (ref: src/math.hpp:58-65).

    Python's // already floors for negative operands, unlike C's /.
    Works on ints and numpy integer arrays.
    """
    return a // b


def trunc_div(a, b):
    """C-style integer division truncating toward zero.

    The reference relies on C++ ``/`` semantics in its border paths
    (ref: src/IQOLanczosResizerImpl_Generic.cpp:216-220,488).
    Works on ints and numpy integer arrays; b may be an array.
    """
    q = a // b
    r = a - q * b
    # floor and trunc differ exactly when the remainder is nonzero and the
    # operands' signs differ; trunc is then one closer to zero.
    return q + ((r != 0) & ((a < 0) != (b < 0)))


# ---------------------------------------------------------------------------
# Lanczos (ref: src/IQOLanczosResizerImpl_Generic.cpp)
# ---------------------------------------------------------------------------


def _sinc(x: float) -> float:
    """sin(pi*x)/(pi*x) in double (ref: :10-16)."""
    pi_x = 3.14159265358979 * x
    return math.sin(pi_x) / pi_x


def lanczos_window(degree: int, x: float) -> float:
    """Lanczos window in double, with the reference's 1e-5 integer snapping
    (ref: :18-29).  Note the snap triggers only when frac(|x|) < 1e-5 —
    values just *below* an integer are not snapped; we keep that asymmetry.
    """
    abs_x = abs(x)
    if math.fmod(abs_x, 1.0) < 1e-5:
        return 1.0 if abs_x < 1e-5 else 0.0
    if degree <= abs_x:
        return 0.0
    return _sinc(x) * _sinc(x / degree)


def calc_num_coefs_lanczos(degree: int, src_len: int, dst_len: int, px_scale: int) -> int:
    """Taps per output pixel (ref: :32-96).

    Up-sampling: 2*degree.  Down-sampling: 2*ceil(degree2*src/dst) where
    degree2 = max(1, degree // px_scale) — the pxScale trick that shrinks
    chroma kernel support so it matches luma units.
    """
    if src_len <= dst_len:
        return 2 * degree
    degree2 = max(1, degree // px_scale)
    return 2 * math.ceil((degree2 * src_len) / float(dst_len))


def set_lanczos_table(
    degree: int,
    src_len: int,
    dst_len: int,
    dst_offset: int,
    px_scale: int,
    num_coefs: int,
) -> tuple[np.ndarray, np.float32]:
    """One phase's float32 taps plus their sequential float32 sum
    (ref: :111-191).  All intermediate coordinates are doubles computed with
    the reference's exact integer-arithmetic derivation of beginX.
    """
    if src_len > dst_len:
        # down-sampling (ref: :145-171)
        deg_factor = max(1, int(px_scale) // degree)
        begin_x = (
            -degree * deg_factor
            - 0.5 * px_scale
            + 0.5 * dst_len * px_scale / src_len
            + ((dst_len - dst_offset * src_len % dst_len) * px_scale % src_len)
            / float(src_len)
        )
        step_src_len = src_len
        step_px_scale = px_scale
    else:
        # up-sampling (ref: :172-178): stepping switches to scale=1
        src_offset = math.fmod(dst_offset * src_len / float(dst_len), 1.0)
        begin_x = -degree + 1.0 - src_offset
        step_src_len = dst_len
        step_px_scale = 1

    table = np.empty(num_coefs, dtype=np.float32)
    f_sum = np.float32(0)
    for i in range(num_coefs):
        x = begin_x + (i * dst_len * step_px_scale) / float(step_src_len)
        v = np.float32(lanczos_window(degree, x))
        table[i] = v
        f_sum = np.float32(f_sum + v)
    return table, f_sum


# ---------------------------------------------------------------------------
# Area (ref: src/IQOAreaResizerImpl_Generic.cpp)
# ---------------------------------------------------------------------------


def calc_num_coefs_area(src_len: int, dst_len: int) -> int:
    """ceil(src/dst), +1 when the phase pattern straddles an extra pixel
    (ref: :11-65, the lcm edge case)."""
    if src_len < dst_len:
        return 1
    i_scale = (src_len // dst_len) * dst_len
    num_coefs = -(-src_len // dst_len)  # ceil
    if lcm(src_len, i_scale) > src_len:
        num_coefs += 1
    return num_coefs


def set_area_table(
    src_len: int, dst_len: int, dst_offset: int, num_coefs: int
) -> tuple[np.ndarray, np.float32]:
    """Box-filter coverage weights for one phase (ref: :74-97)."""
    src_begin_x = (dst_offset * src_len) / float(dst_len)
    src_end_x = ((dst_offset + 1) * src_len) / float(dst_len)
    src_x = src_begin_x
    table = np.empty(num_coefs, dtype=np.float32)
    f_sum = np.float32(0)
    for i in range(num_coefs):
        next_src_x = min(src_end_x, math.floor(src_x) + 1.0)
        v = np.float32(next_src_x - src_x)
        table[i] = v
        f_sum = np.float32(f_sum + v)
        src_x = next_src_x
    return table, f_sum


# ---------------------------------------------------------------------------
# Linear (ref: src/IQOLinearResizerImpl_Generic.cpp)
# ---------------------------------------------------------------------------


def set_linear_table(src_len: int, dst_len: int) -> np.ndarray:
    """Center-aligned 2-tap float weights, shape (dst_len, 2) (ref: :29-69)."""
    table = np.empty((dst_len, 2), dtype=np.float32)
    for i in range(dst_len):
        # +0.5 shifts modf's operand positive; fractional part is coef1
        coef1 = np.float32(math.modf((i + 0.5) * src_len / dst_len + 0.5)[0])
        table[i, 0] = np.float32(1.0) - coef1
        table[i, 1] = coef1
    return table


def adjust_coefs_linear(table_f: np.ndarray, bias: int) -> np.ndarray:
    """Linear quantization: coef0=round(c0*bias), coef1=bias-coef0
    (ref: :193-208).  Returns int32 (dst_len, 2)."""
    out = np.empty_like(table_f, dtype=np.int32)
    for i in range(table_f.shape[0]):
        c0 = int(np.floor(np.float32(table_f[i, 0] * np.float32(bias)) + np.float32(0.5)))
        out[i, 0] = c0
        out[i, 1] = bias - c0
    return out


# ---------------------------------------------------------------------------
# Exact-sum quantization (shared by Lanczos and Area)
# ---------------------------------------------------------------------------


def adjust_coefs(
    table_f: np.ndarray, f_sum: np.float32, bias: int, signed: bool = True
) -> np.ndarray:
    """Quantize float taps to integers summing to exactly ``bias``
    (ref: src/IQOLanczosResizerImpl_Generic.cpp:341-367 signed int16,
    src/IQOAreaResizerImpl_Generic.cpp:222-248 unsigned uint16).

    round(tap*bias/sum) in float32, then repair the quantized sum to exactly
    ``bias`` by bumping the largest remaining float tap (first-index tie
    break, tap zeroed after use) — this exact-sum property is what makes
    flat images invariant under resize.

    The reference stores taps in int16_t/uint16_t: pathological px_scale
    phases with near-zero float sums quantize past 2**15 and *wrap* (gcc
    semantics: truncate float->int32, then modular narrowing), and the
    repair loop then runs on the wrapped sum, spinning on index 0 once all
    float taps are consumed.  All of that is observable output and is
    reproduced here.
    """
    work = table_f.astype(np.float32).copy()
    n = work.shape[0]
    out = np.empty(n, dtype=np.int64)
    dst_sum = 0
    for i in range(n):
        # float32 multiply then divide then floor(x+0.5), then C cast:
        # truncate toward zero to int, wrap to the 16-bit storage type
        v = np.float32(np.float32(work[i] * np.float32(bias)) / np.float32(f_sum))
        q = int(np.float32(np.floor(v + np.float32(0.5))))  # trunc (integral)
        if signed:
            q = ((q + 32768) & 65535) - 32768
        else:
            q &= 65535
        out[i] = q
        dst_sum += q
    while dst_sum < bias:
        i = int(np.argmax(work))  # first max, as std::max_element
        out[i] += 1
        work[i] = 0
        dst_sum += 1
    while dst_sum > bias:
        i = int(np.argmax(work))
        out[i] -= 1
        work[i] = 0
        dst_sum -= 1
    # the ++/-- in the reference also wrap in 16-bit storage
    if signed:
        out = ((out + 32768) & 65535) - 32768
    else:
        out &= 65535
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Integer index sequences (LinearIterator transcriptions)
# ---------------------------------------------------------------------------


def src_origin_floor(n_dst: int, src_len: int, dst_len: int) -> np.ndarray:
    """floor(dstX * srcLen / dstLen) for each output coordinate — the plain
    LinearIterator(dstLen, srcLen) walk (ref: src/math.hpp:70-155)."""
    i = np.arange(n_dst, dtype=np.int64)
    return (i * src_len) // dst_len


def src_origin_centered(n_dst: int, src_len: int, dst_len: int) -> np.ndarray:
    """Center-aligned origin used by Linear: LinearIterator(dstLen, srcLen)
    seeded with setX(srcLen-dstLen, 2*dstLen)
    (ref: src/IQOLinearResizerImpl_Generic.cpp:253-255,385-386).

    setX's rational seeding (ref: src/math.hpp:96-112) does NOT preserve the
    iterator's y = x*dy/dx invariant: it sets the fractional state to
    (nume*dx/g) mod (dx*deno/g) instead of the remainder of the y division,
    so the resulting index sequence differs from the mathematically
    center-aligned floor((dstX+0.5)*src/dst - 0.5) whenever the seed
    fraction doesn't fully reduce (verified against the reference with
    impulse probes, e.g. linear 97->31 samples dst 1 from src 6,7).  That
    quirky sequence is the observable contract; reproduce it exactly:

        y0   = div_floor(nume*dy, deno*dx)
        g    = gcd(nume*dx, gcd(dy*deno, dx*deno))
        x0   = (nume*dx/g) mod (dx*deno/g), made non-negative
        y(k) = y0 + (x0 + k*(dy*deno/g)) // (dx*deno/g)
    """
    dx, dy = int(dst_len), int(src_len)
    nume, deno = dy - dx, 2 * dx
    y0 = div_floor(nume * dy, deno * dx)
    new_nume, new_dy, new_dx = nume * dx, dy * deno, dx * deno
    g = math.gcd(new_nume, math.gcd(new_dy, new_dx))  # |C gcd| == math.gcd
    # g divides all three exactly, so C's truncating division is exact here
    new_nume //= g
    new_dy //= g
    new_dx //= g
    x0 = new_nume % new_dx  # python % is already non-negative for new_dx > 0
    k = np.arange(n_dst, dtype=np.int64)
    return y0 + (x0 + k * new_dy) // new_dx
