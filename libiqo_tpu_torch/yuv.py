"""YUV420 planar frame resizing — the reference's flagship workload.

The port of ``libiqo_tpu/yuv.py`` (ref: sample/resize_yuv420p.cpp): the Y
plane resizes at its true size and the U/V planes at half the evened size;
Lanczos chroma uses px_scale=2 so the window support matches luma units
(ref: sample/resize_yuv420p.cpp:150-163).  Planes may be NumPy arrays or
tensors; each comes back as it went in.  On the kernel routes a frame, or a
batch of frames, is one host call into the kernel library
(``ops/executable.launch_frame``, the counterpart of the JAX package's
jitted three-plane step): luma one launch, U and V one launch for a lone
frame and two for a batch, each where it lies, with no copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import tracing
from .api import AreaResizer, LanczosResizer, LinearResizer, Resizer, as_tensor
from .ops.cuda_resize import carry_requested
from .ops.executable import launch_frame

__all__ = ["YUV420Frame", "YUV420Resizer", "iter_yuv420", "read_yuv420",
           "write_yuv420"]


@dataclasses.dataclass
class YUV420Frame:
    """One planar YUV420 frame: Y (h, w), U and V (h/2, w/2), all uint8,
    as NumPy arrays or tensors."""
    y: np.ndarray | torch.Tensor
    u: np.ndarray | torch.Tensor
    v: np.ndarray | torch.Tensor

    @property
    def width(self) -> int:
        return self.y.shape[-1]

    @property
    def height(self) -> int:
        return self.y.shape[-2]


def _even(v: int) -> int:
    """Strides rounded up to even, as the sample does
    (ref: sample/resize_yuv420p.cpp:66-69)."""
    return (v + 1) & ~1


def iter_yuv420(path, width: int, height: int, frames: int | None = None):
    """Stream raw planar YUV420 frames one at a time, as NumPy planes
    (ref: sample/resize_yuv420p.cpp:94-112 reads frame by frame too)."""
    w, h = _even(width), _even(height)
    cw, ch = w // 2, h // 2
    frame_bytes = w * h + 2 * cw * ch
    n = 0
    with open(path, "rb") as fp:
        while frames is None or n < frames:
            buf = fp.read(frame_bytes)
            if len(buf) < frame_bytes:
                return
            f = np.frombuffer(buf, dtype=np.uint8)
            yield YUV420Frame(
                y=f[: w * h].reshape(h, w),
                u=f[w * h: w * h + cw * ch].reshape(ch, cw),
                v=f[w * h + cw * ch:].reshape(ch, cw))
            n += 1


def read_yuv420(path, width: int, height: int, frames: int | None = None):
    """All frames of a raw planar YUV420 file, as a list."""
    return list(iter_yuv420(path, width, height, frames))


def _host_bytes(plane) -> bytes:
    if isinstance(plane, torch.Tensor):
        plane = plane.cpu().numpy()
    return np.ascontiguousarray(plane).tobytes()


def write_yuv420(path, frames) -> None:
    with open(path, "wb") as fp:
        for f in frames:
            for plane in (f.y, f.u, f.v):
                fp.write(_host_bytes(plane))


class YUV420Resizer:
    """Three-plane resizer bound to one geometry.

    :param method: "linear" | "area" | "lanczosN" (N = degree 1..9)
    :param device: where NumPy planes are computed (tensors stay on theirs);
        the card by default
    """

    def __init__(self, method: str, src_w: int, src_h: int,
                 dst_w: int, dst_h: int, backend: str = "auto",
                 precision: str = "exact", device="cuda"):
        # The reference sample resizes the Y plane at its TRUE (possibly
        # odd) dimensions and evens only the buffer strides; chroma
        # resizers are built from the evened strides, so the padding
        # column/row is chroma data (ref: sample/resize_yuv420p.cpp:66-69,
        # 125-131,153-159).
        sw, sh = _even(src_w), _even(src_h)
        dw, dh = _even(dst_w), _even(dst_h)
        self.src_size = (sw, sh)        # strides (file layout)
        self.dst_size = (dw, dh)
        self._true_src = (src_w, src_h)
        self._true_dst = (dst_w, dst_h)
        self.method = method
        common = dict(backend=backend, precision=precision, device=device)
        if method.startswith("lanczos"):
            degree = int(method[len("lanczos"):] or 3)
            self._luma: Resizer = LanczosResizer(
                degree, src_w, src_h, dst_w, dst_h, **common)
            self._chroma: Resizer = LanczosResizer(
                degree, sw // 2, sh // 2, dw // 2, dh // 2, px_scale=2,
                **common)
        elif method == "area":
            self._luma = AreaResizer(src_w, src_h, dst_w, dst_h, **common)
            self._chroma = AreaResizer(sw // 2, sh // 2, dw // 2, dh // 2,
                                       **common)
        elif method == "linear":
            self._luma = LinearResizer(src_w, src_h, dst_w, dst_h, **common)
            self._chroma = LinearResizer(sw // 2, sh // 2, dw // 2, dh // 2,
                                         **common)
        else:
            raise ValueError(f"unknown method {method!r} "
                             "(linear | area | lanczos[1-9])")
        self._odd = (sw, sh, dw, dh) != (src_w, src_h, dst_w, dst_h)
        self._frame_calls: dict = {}   # (device index, carry) -> (luma, chroma) or False

    def resolved_backend(self) -> str:
        return self._luma.resolved_backend()

    def _slice_y(self, y):
        w, h = self._true_src
        return y[..., :h, :w]

    def _pad_y(self, oy):
        """Place the true-size luma result into the evened-stride layout;
        the padding column/row stays zero, as the reference's zero-filled
        output buffer (ref: sample/resize_yuv420p.cpp:88)."""
        w, h = self._true_dst
        dw, dh = self.dst_size
        if (w, h) == (dw, dh):
            return oy
        shape = tuple(oy.shape[:-2]) + (dh, dw)
        if isinstance(oy, np.ndarray):
            out = np.zeros(shape, np.uint8)
        else:
            out = torch.zeros(shape, dtype=torch.uint8, device=oy.device)
        out[..., :h, :w] = oy
        return out

    def _executables(self, index: int):
        """Luma's and chroma's executables for planes on CUDA device
        ``index`` (the carry choice read now), or None where either plane
        takes the plain path; remembered per (device, carry choice)."""
        key = (index, carry_requested())
        pair = self._frame_calls.get(key)
        if pair is None:
            dev = torch.device("cuda", index)
            (lk, lex), (ck, cex) = self._luma._bind(dev), self._chroma._bind(dev)
            pair = self._frame_calls[key] = (lex, cex) if lk and ck else False
        return pair

    def _planes(self, y, u, v):
        """(..., h, w) luma and (..., h/2, w/2) U and V -> the three planes
        resized, each as it went in: NumPy or a tensor on its device.
        Tensors of one frame or one batch on a card whose routes are both
        kernels take one frame call; NumPy planes go to the resizer's
        device and back; anything else runs plane by plane."""
        luma, chroma = self._luma, self._chroma
        if type(y) is type(u) is type(v) is torch.Tensor:
            if y.is_cuda and y.dim() == u.dim() == v.dim() and y.dim() in (2, 3):
                pair = self._executables(y.get_device())
                if pair:
                    oy, ou, ov = launch_frame(*pair, self._slice_y(y) if self._odd else y,
                                              u, v)
                    return (self._pad_y(oy) if self._odd else oy), ou, ov
        elif luma._backend != "numpy":
            host = [isinstance(p, np.ndarray) for p in (y, u, v)]
            if any(host):
                outs = self._planes(*(as_tensor(p, luma.device) if h else p
                                      for p, h in zip((y, u, v), host)))
                return tuple(o.cpu().numpy() if h else o for o, h in zip(outs, host))
        return (self._pad_y(luma.resize(self._slice_y(y))), chroma.resize(u),
                chroma.resize(v))

    def _call(self, y, u, v):
        """:meth:`_planes` as one user call: a ``port.frame_call`` span
        while the port records (:mod:`.tracing`)."""
        rec = tracing.RECORDING
        if rec is None:
            return self._planes(y, u, v)
        t = rec.begin()
        try:
            return self._planes(y, u, v)
        finally:
            rec.end("port.frame_call", t)

    def resize(self, frame: YUV420Frame) -> YUV420Frame:
        return YUV420Frame(*self._call(frame.y, frame.u, frame.v))

    def resize_batch(self, y, u, v):
        """Batched planes (B, h, w) / (B, h/2, w/2) -> (y, u, v) resized,
        as one frame call."""
        return self._call(y, u, v)
