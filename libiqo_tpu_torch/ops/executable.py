"""Compiled executables: a plan's kernel launch packed once, issued many
times.

The counterpart of the JAX package's executable layer: ``api.py``
``_ensure_compiled`` builds one ``jax.jit`` per plan, and the YUV420 step
is one jitted function over the three planes
(``parallel/sharding.py:make_yuv_step_fn``).  Here an :class:`Executable`
holds a plan's :class:`~.cuda_resize.KernelOperands` on one device and, on
a CUDA device, a C handle (``csrc/exec.cuh``) built from them once by
``iqo_resize_{tiled,wide,wide_s8,fused}_exec_create``: the kernel
instantiation, its argument record, the grid of one frame, the block and
the shared memory.  A call is then one ctypes call, ``iqo_exec_launch``, with the
source, the output, the frame count and the strides; :func:`launch_frame`
issues a whole YUV420 frame, luma and U and V, in one host call
(``iqo_exec_launch_frame``), with no copy of U and V: three launches, or
two for a lone frame, whose U and V one launch takes where they lie.

The handle takes the same packing as the one-shot entry
``cuda_resize.resize_fused`` (:func:`~.cuda_resize.entry_args`), so the two
cannot drift.  It is built on first use, holds no device memory (its tables
belong to the operands, which it keeps alive) and is freed with the
executable.  Every launch is counted in ``cuda_resize.LAUNCHES`` and
``LAUNCHES_BY_VARIANT``; while the port records (:mod:`..tracing`), each
ctypes launch is also a ``port.launch`` span with its launches by plane,
each tiled or wide-window launch a count of its form (``tiled.x_window``,
``tiled.x_taps``, ``wide.y_s8``, ``wide.y_whole`` or ``wide.y_sliced``,
:func:`~.cuda_resize.launch_form`), and each handle made a
``port.exec_create`` span.  A failed create or
launch raises: nothing falls back to another path.  On the CPU an
executable runs the kernel's plain version, ``cuda_resize.resize_plain``.
"""

from __future__ import annotations

import ctypes
import threading
import weakref

import torch

from .. import tracing
from . import cuda_resize

__all__ = ["Executable", "launch_frame"]

_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    """The current CUDA stream of device ``index``, as an address."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def _error(lib, rc: int) -> str:
    return f"{lib.iqo_error_string(rc).decode()} ({rc})"


def _geometry(x: torch.Tensor) -> tuple[int, int, int]:
    """(frames, frame stride, row stride) of a (h, w) or (B, h, w) plane."""
    if x.dim() == 2:
        return 1, 0, x.stride(0)
    fs, rs, _ = x.stride()
    return x.shape[0], fs, rs


class Executable:
    """One plan's kernel launch on one device, built once: the operands
    ``ops`` and, on a CUDA device, the C handle that launches the kernel
    its tables were built for (:attr:`variant`).  ``ex(src)`` resizes a
    (src_h, src_w) or (B, src_h, src_w) uint8 tensor; rows may be strided,
    the last stride must be 1."""

    def __init__(self, ops: cuda_resize.KernelOperands):
        self.ops = ops
        self.device = ops.device
        self.index = ops.device.index if ops.device.type == "cuda" else -1
        self.variant = None if ops.tables is None else cuda_resize.variant(ops.tables)
        self.form = cuda_resize.launch_form(ops.tables)
        self.src_shape = tuple(ops.plain.src_shape)
        self.dst_shape = tuple(ops.plain.dst_shape)
        self._handle = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def handle(self) -> int:
        """The C executable, created on first use; raises on a device
        other than a CUDA one, for a plan outside the kernel's scope, or
        if the library refuses it."""
        if self._handle is None:
            with self._lock:
                if self._handle is None:
                    self._create()
        return self._handle

    def _create(self) -> None:
        if self.device.type != "cuda":
            raise ValueError(f"an executable launches on a CUDA device, not {self.device}")
        if self.ops.tables is None:
            raise ValueError("plan is outside the kernel's scope (supports_plan)")
        with tracing.span("port.exec_create"):
            lib = cuda_resize._lib_for(self.device)
            kind, head, tail = cuda_resize.entry_args(self.ops)
            h = ctypes.c_void_p()
            rc = getattr(lib, f"iqo_resize_{kind}_exec_create")(*head, *tail, ctypes.byref(h))
        if rc != 0:
            raise RuntimeError(f"resize_{kind} executable refused: {_error(lib, rc)}")
        tracing.count("exec.create")
        weakref.finalize(self, lib.iqo_exec_destroy, h.value)
        self._lib = lib
        self._handle = h.value

    def check(self, src: torch.Tensor) -> None:
        """Raise unless ``src`` is a (src_h, src_w) or (B, src_h, src_w)
        uint8 tensor on this executable's device whose last stride is 1,
        B <= 65535."""
        if (src.dtype is torch.uint8 and src.get_device() == self.index
                and src.shape[-2:] == self.src_shape and src.stride(-1) == 1
                and (src.dim() == 2 or (src.dim() == 3
                                        and src.shape[0] <= cuda_resize._MAX_GRID_YZ))):
            return
        if src.device != self.device:
            raise ValueError(f"source on {src.device}, executable on {self.device}")
        if src.dtype != torch.uint8:
            raise TypeError(f"source must be uint8, got {src.dtype}")
        if src.dim() == 3 and src.shape[0] > cuda_resize._MAX_GRID_YZ:
            raise ValueError(f"{src.shape[0]} frames in one call; at most "
                             f"{cuda_resize._MAX_GRID_YZ}")
        if src.stride(-1) != 1:
            raise ValueError("source rows must be contiguous (last stride 1)")
        raise ValueError(f"source shape {tuple(src.shape)} != ([B,] "
                         f"{self.src_shape[0]}, {self.src_shape[1]})")

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        if not src.is_cuda:
            if src.dim() == 2:
                return cuda_resize.resize_plain(self.ops, src[None])[0]
            return cuda_resize.resize_plain(self.ops, src)
        h = self._handle or self.handle
        self.check(src)
        n, fs, rs = _geometry(src)
        out = torch.empty(self.dst_shape if src.dim() == 2 else (n, *self.dst_shape),
                          dtype=torch.uint8, device=self.device)
        if n == 0:
            return out
        rec = tracing.RECORDING
        t = rec.begin() if rec is not None else 0
        rc = -1
        try:
            rc = self._lib.iqo_exec_launch(h, src.data_ptr(), out.data_ptr(), n, fs, rs,
                                           _stream(self.index))
        finally:
            if rec is not None:     # one launch, of a plane the executable cannot know
                rec.launched(t, *(tracing.UNKNOWN_PLANE if rc == 0 else (0, 0)))
        if rc != 0:
            raise RuntimeError(f"{self.variant} launch failed: {_error(self._lib, rc)}")
        cuda_resize.count_launches(self.variant)
        if rec is not None and self.form:
            rec.count(self.form)
        return out


def launch_frame(luma: Executable, chroma: Executable, y: torch.Tensor,
                 u: torch.Tensor, v: torch.Tensor):
    """One YUV420 step: luma through ``luma``, U and V through ``chroma``,
    in one host call on a CUDA device; the planes are (h, w), (h/2, w/2) or
    (B, h, w), (B, h/2, w/2).  Returns (Y', U', V') of the same leading
    shape; U' and V' are the two halves of one output.  Luma is one
    launch; U and V of a lone frame with one row stride are one launch of
    two frames, the second at the distance from U to V, and otherwise two
    launches.  On the CPU each plane runs the plain version."""
    if not y.is_cuda:
        return luma(y), chroma(u), chroma(v)
    hl = luma._handle or luma.handle
    hc = chroma._handle or chroma.handle
    if chroma.index != luma.index:
        raise ValueError(f"luma executable on {luma.device}, chroma on {chroma.device}")
    luma.check(y)
    chroma.check(u)
    chroma.check(v)
    lone = y.dim() == 2
    if lone and u.dim() == 2 == v.dim():     # the lone frame, its strides direct
        n, yfs, yrs, ufs, urs, vfs, vrs = 1, 0, y.stride(0), 0, u.stride(0), 0, v.stride(0)
    else:
        (n, yfs, yrs), (nu, ufs, urs), (nv, vfs, vrs) = map(_geometry, (y, u, v))
        if not (y.dim() == u.dim() == v.dim() and n == nu == nv):
            raise ValueError(f"planes {tuple(y.shape)}, {tuple(u.shape)}, "
                             f"{tuple(v.shape)}: not one frame or one batch")
    oy = torch.empty(luma.dst_shape if lone else (n, *luma.dst_shape),
                     dtype=torch.uint8, device=luma.device)
    ouv = torch.empty((2 * n, *chroma.dst_shape), dtype=torch.uint8, device=luma.device)
    if n == 0:
        return oy, ouv, ouv
    lib = luma._lib
    rec = tracing.RECORDING
    t = rec.begin() if rec is not None else 0
    rc = -1
    try:
        rc = lib.iqo_exec_launch_frame(hl, hc, n, y.data_ptr(), yfs, yrs, oy.data_ptr(),
                                       u.data_ptr(), ufs, urs, v.data_ptr(), vfs, vrs,
                                       ouv.data_ptr(), _stream(luma.index))
    finally:
        if rec is not None:
            rec.launched(t, int(rc > 0), max(rc - 1, 0))
    if rc < 0:
        raise RuntimeError(f"YUV420 frame ({luma.variant}, {chroma.variant}) launch "
                           f"failed: {_error(lib, -rc)}")
    cuda_resize.count_launches(luma.variant)
    cuda_resize.count_launches(chroma.variant, rc - 1)
    if rec is not None:
        if luma.form:
            rec.count(luma.form)
        if chroma.form:
            rec.count(chroma.form, rc - 1)
    return (oy, *ouv.unbind(0)) if lone else (oy, ouv[:n], ouv[n:])
