"""Coefficient tables of libiqo's Generic path, worked out from the geometry.

A frozen copy of the arithmetic of ``libiqo_tpu_torch/coeffs/engine.py`` and
of the axis plans of ``libiqo_tpu_torch/core/plan.py`` (Lanczos and Area),
in pure Python and NumPy, so that the benchmark's reference shares no code
with the program it judges (ref: src/IQOLanczosResizerImpl_Generic.cpp,
src/IQOAreaResizerImpl_Generic.cpp).  The reference computes window values
in double, stores taps as float and sums them in float sequentially, then
quantizes in float32 to integers that sum to exactly the bias; every dtype
and order below is the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a separable resize: output d reads source rows
    ``start[d] .. start[d] + taps - 1`` (taps outside the source have weight
    0) and takes the border epilogue where ``is_border[d]``."""
    n_src: int
    n_dst: int
    coef: np.ndarray        # int64 (n_dst, taps)
    start: np.ndarray       # int64 (n_dst,)
    deno: np.ndarray        # int64 (n_dst,): in-range tap sum
    is_border: np.ndarray   # bool (n_dst,)
    bias_bit: int

    @property
    def bias(self) -> int:
        return 1 << self.bias_bit

    @property
    def taps(self) -> int:
        return self.coef.shape[1]


def trunc_div(a, b):
    """C's integer division, truncating toward zero."""
    q = a // b
    r = a - q * b
    return q + ((r != 0) & ((a < 0) != (b < 0)))


def _lanczos_window(degree: int, x: float) -> float:
    abs_x = abs(x)
    if math.fmod(abs_x, 1.0) < 1e-5:
        return 1.0 if abs_x < 1e-5 else 0.0
    if degree <= abs_x:
        return 0.0
    pi_x = 3.14159265358979 * x
    pi_xd = 3.14159265358979 * (x / degree)
    return (math.sin(pi_x) / pi_x) * (math.sin(pi_xd) / pi_xd)


def _lanczos_phase(degree: int, src_len: int, dst_len: int, dst_offset: int,
                   px_scale: int, num_coefs: int):
    if src_len > dst_len:
        deg_factor = max(1, int(px_scale) // degree)
        begin_x = (-degree * deg_factor - 0.5 * px_scale
                   + 0.5 * dst_len * px_scale / src_len
                   + ((dst_len - dst_offset * src_len % dst_len) * px_scale % src_len)
                   / float(src_len))
        step_src, step_scale = src_len, px_scale
    else:
        src_offset = math.fmod(dst_offset * src_len / float(dst_len), 1.0)
        begin_x = -degree + 1.0 - src_offset
        step_src, step_scale = dst_len, 1
    table = np.empty(num_coefs, dtype=np.float32)
    f_sum = np.float32(0)
    for i in range(num_coefs):
        v = np.float32(_lanczos_window(
            degree, begin_x + (i * dst_len * step_scale) / float(step_src)))
        table[i] = v
        f_sum = np.float32(f_sum + v)
    return table, f_sum


def _area_phase(src_len: int, dst_len: int, dst_offset: int, num_coefs: int):
    x = (dst_offset * src_len) / float(dst_len)
    end = ((dst_offset + 1) * src_len) / float(dst_len)
    table = np.empty(num_coefs, dtype=np.float32)
    f_sum = np.float32(0)
    for i in range(num_coefs):
        nxt = min(end, math.floor(x) + 1.0)
        v = np.float32(nxt - x)
        table[i] = v
        f_sum = np.float32(f_sum + v)
        x = nxt
    return table, f_sum


def _quantize(table: np.ndarray, f_sum, bias: int, signed: bool) -> np.ndarray:
    """Round each tap to ``tap * bias / sum`` in float32, wrap it to the
    16-bit storage type, then repair the sum to exactly ``bias`` by bumping
    the largest float tap left (first index on ties), zeroing it after use."""
    work = table.astype(np.float32).copy()
    out = np.empty(len(work), dtype=np.int64)

    def narrow(q):
        return ((q + 32768) & 65535) - 32768 if signed else q & 65535

    total = 0
    for i in range(len(work)):
        v = np.float32(np.float32(work[i] * np.float32(bias)) / np.float32(f_sum))
        out[i] = narrow(int(np.float32(np.floor(v + np.float32(0.5)))))
        total += int(out[i])
    while total != bias:
        step = 1 if total < bias else -1
        i = int(np.argmax(work))
        out[i] += step
        work[i] = 0
        total += step
    return narrow(out)


def _identity(n: int, bias_bit: int) -> Axis:
    bias = 1 << bias_bit
    return Axis(n, n, np.full((n, 1), bias, np.int64), np.arange(n, dtype=np.int64),
                np.full(n, bias, np.int64), np.zeros(n, bool), bias_bit)


def _clip(coef: np.ndarray, start: np.ndarray, n_src: int):
    src = start[:, None] + np.arange(coef.shape[1], dtype=np.int64)[None, :]
    kept = np.where((src >= 0) & (src < n_src), coef, 0)
    return kept, kept.sum(axis=1)


def lanczos_axis(degree: int, src_len: int, dst_len: int, px_scale: int,
                 bias_bit: int, vertical: bool) -> Axis:
    if src_len == dst_len:
        return _identity(src_len, bias_bit)
    g = math.gcd(src_len, dst_len)
    r_src, r_dst = src_len // g, dst_len // g
    if r_src <= r_dst:
        num_coefs = 2 * degree
    else:
        num_coefs = 2 * math.ceil((max(1, degree // px_scale) * r_src) / float(r_dst))
    tables = np.stack([_quantize(*_lanczos_phase(degree, r_src, r_dst, d, px_scale,
                                                  num_coefs), 1 << bias_bit, True)
                       for d in range(r_dst)])
    half = num_coefs // 2
    main_begin = ((half - 1) * dst_len + src_len - 1) // src_len
    main_end = max(0, (src_len - half) * dst_len // src_len)
    d = np.arange(dst_len, dtype=np.int64)
    # the vertical pass's second border loop continues a stale table cursor
    # where main_end < main_begin (ref: Generic.cpp:396-453)
    shift = max(0, main_begin - main_end) if vertical else 0
    it = d + np.where(d >= main_end, shift, 0)
    start = (it * src_len) // dst_len + 1 - half
    coef, deno = _clip(tables[it % r_dst], start, src_len)
    if vertical:   # the Y border denominator sums in int16 (ref: :482-483)
        deno = ((deno + 32768) & 65535) - 32768
    return Axis(src_len, dst_len, coef, start, deno,
                (d < main_begin) | (d >= main_end), bias_bit)


def area_axis(src_len: int, dst_len: int, bias_bit: int) -> Axis:
    if src_len == dst_len:
        return _identity(src_len, bias_bit)
    g = math.gcd(src_len, dst_len)
    r_src, r_dst = src_len // g, dst_len // g
    if r_src < r_dst:
        num_coefs = 1
    else:
        i_scale = (r_src // r_dst) * r_dst
        num_coefs = -(-r_src // r_dst)
        if r_src // math.gcd(r_src, i_scale) * i_scale > r_src:
            num_coefs += 1
    tables = np.stack([_quantize(*_area_phase(r_src, r_dst, d, num_coefs),
                                 1 << bias_bit, False) for d in range(r_dst)])
    d = np.arange(dst_len, dtype=np.int64)
    start = (d * src_len) // dst_len
    coef, deno = _clip(tables[d % r_dst], start, src_len)
    return Axis(src_len, dst_len, coef, start, deno, np.zeros(dst_len, bool), bias_bit)
