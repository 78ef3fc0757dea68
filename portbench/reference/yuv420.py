"""Plain NumPy reference of a YUV420 frame resize, byte-exact to libiqo's
Generic path.

The passes of ``libiqo_tpu_torch/golden/numpy_ref.py`` in banded form (each
output row or column sums its own taps, in int64, so a 4K frame takes a
fraction of a second where the dense product takes minutes), over the
tables of :mod:`.coeffs`, and the YUV420 rules of the reference sample
(ref: sample/resize_yuv420p.cpp:66-69, 125-163): strides evened, luma
resized at its true size into the evened layout (padding left zero),
chroma at half the evened size, Lanczos chroma at px_scale 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .coeffs import Axis, area_axis, lanczos_axis, trunc_div


def wrap_i16(x: np.ndarray) -> np.ndarray:
    return ((x + 32768) & 65535) - 32768


def wrap_i32(x: np.ndarray) -> np.ndarray:
    return ((x + 2**31) & (2**32 - 1)) - 2**31


@dataclasses.dataclass(frozen=True)
class Plane:
    """One plane's resize: its two axes and the method's fixed-point rules."""
    y: Axis
    x: Axis
    wrap16: bool    # Lanczos: int16 work rows, int32 X sums, signed epilogue

    @property
    def out_shift(self) -> int:
        return self.y.bias_bit + self.x.bias_bit

    def macs(self) -> int:
        """Multiply-adds of the two passes over one plane, at the taps each
        output reads."""
        return (self.y.n_dst * self.x.n_src * self.y.taps
                + self.y.n_dst * self.x.n_dst * self.x.taps)


def plane(method: str, src_w: int, src_h: int, dst_w: int, dst_h: int,
          px_scale: int = 1) -> Plane:
    """The plane resize of ``method`` ("area" or "lanczosN")."""
    if method.startswith("lanczos"):
        degree = int(method[len("lanczos"):] or 3)
        return Plane(lanczos_axis(degree, src_h, dst_h, px_scale, 6, True),
                     lanczos_axis(degree, src_w, dst_w, px_scale, 14, False), True)
    if method == "area":
        return Plane(area_axis(src_h, dst_h, 8), area_axis(src_w, dst_w, 15), False)
    raise ValueError(f"the reference has no method {method!r} (area | lanczosN)")


def _taps(axis: Axis, rows: np.ndarray, bound: int) -> np.ndarray:
    """Sum over taps of coef * rows[start + i], (n_dst, ...) int64; summed in
    int32 where no sum can reach 2**31 (``bound`` is the largest magnitude
    of a row value), else in int64."""
    idx = np.clip(axis.start[:, None] + np.arange(axis.taps), 0, axis.n_src - 1)
    coef = axis.coef
    exact32 = int(np.abs(coef).sum(axis=1).max()) * bound < 2**31
    if exact32:
        coef = coef.astype(np.int32)
        rows = rows.astype(np.int32, copy=False)
    total = np.zeros((axis.n_dst,) + rows.shape[1:], coef.dtype)
    shape = (axis.n_dst,) + (1,) * (rows.ndim - 1)
    for i in range(axis.taps):
        total += coef[:, i].reshape(shape) * rows[idx[:, i]]
    return total.astype(np.int64)


def resize_plane(p: Plane, src: np.ndarray) -> np.ndarray:
    """(src_h, src_w) uint8 -> (dst_h, dst_w) uint8."""
    if src.shape != (p.y.n_src, p.x.n_src) or src.dtype != np.uint8:
        raise ValueError(f"source {src.shape} {src.dtype}, plane wants "
                         f"({p.y.n_src}, {p.x.n_src}) uint8")
    work = _taps(p.y, src, 255)                             # (dst_h, src_w)
    if p.wrap16:
        work = wrap_i16(work)
        rows = np.nonzero(p.y.is_border)[0]
        deno = np.where(p.y.deno[rows] == 0, 1, p.y.deno[rows])[:, None]
        work[rows] = wrap_i16(trunc_div(work[rows] * p.y.bias, deno))
    bound = int(np.abs(work).max(initial=0))
    sums = _taps(p.x, np.ascontiguousarray(work.T), bound).T   # (dst_h, dst_w)
    half = 1 << (p.out_shift - 1)
    if p.wrap16:
        sums = wrap_i32(sums)
        rounded = wrap_i32(sums + half)
    else:
        rounded = sums + half
    v = rounded >> p.out_shift
    cols = np.nonzero(p.x.is_border)[0]
    deno = np.where(p.x.deno[cols] == 0, 1, p.x.deno[cols]) * p.y.bias
    v[:, cols] = trunc_div(rounded[:, cols], deno[None, :])
    return np.clip(wrap_i16(v), 0, 255).astype(np.uint8)


def _even(v: int) -> int:
    return (v + 1) & ~1


class Frame:
    """A YUV420 frame resize of one geometry: ``Frame(method, sw, sh, dw,
    dh)(y, u, v)`` gives the reference's (Y', U', V')."""

    def __init__(self, method: str, src_w: int, src_h: int, dst_w: int, dst_h: int):
        sw, sh, dw, dh = _even(src_w), _even(src_h), _even(dst_w), _even(dst_h)
        self.true_src, self.true_dst = (src_w, src_h), (dst_w, dst_h)
        self.src_size, self.dst_size = (sw, sh), (dw, dh)
        chroma_scale = 2 if method.startswith("lanczos") else 1
        self.luma = plane(method, src_w, src_h, dst_w, dst_h)
        self.chroma = plane(method, sw // 2, sh // 2, dw // 2, dh // 2, chroma_scale)

    def macs(self) -> int:
        return self.luma.macs() + 2 * self.chroma.macs()

    def __call__(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        (w, h), (tw, th), (dw, dh) = self.true_src, self.true_dst, self.dst_size
        oy = np.zeros((dh, dw), np.uint8)
        oy[:th, :tw] = resize_plane(self.luma, np.ascontiguousarray(y[:h, :w]))
        return oy, resize_plane(self.chroma, u), resize_plane(self.chroma, v)
