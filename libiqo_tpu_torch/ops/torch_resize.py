"""The plain exact resize in PyTorch: banded taps, integer arithmetic.

This is the port of ``libiqo_tpu/ops/xla_resize.py`` and the executable form
of ``golden/numpy_ref.py`` on tensors.  It serves three roles:

* the ``torch`` backend, on CPU and CUDA alike;
* the plain version that the hand-written CUDA kernel
  (``ops/cuda_resize.py``) is compared with;
* the route for plans the kernel does not take.

:func:`resize_relaxed` is the plain version of the kernel's relaxed form
(``precision="relaxed"``), which shares the Y pass and the epilogue.

Each pass is a banded tap form over the plan's ``(coef, start)`` tables: for
every tap, an ``index_select`` of clamped source indices, a multiply and an
accumulate.  Out-of-range taps are zero in the plan, so the clamped indices
are inert (as ``xla_resize._pack_banded``).  Everything runs in int64, where
the sums are exact, and the reference's intended wraps are then applied
explicitly: int16 on the work rows and the final narrowing, int32 on the X
accumulator (``numpy_ref.py:32-45``).  No matmul is used: CUDA has no general
integer matmul, and the tap form needs none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.plan import AxisPlan, ResizePlan

__all__ = ["AxisOperands", "Operands", "pack_operands", "resize",
           "resize_relaxed"]


@dataclasses.dataclass(frozen=True)
class AxisOperands:
    """One axis of a plan as device tensors, tap-major."""
    coef: torch.Tensor      # int64 (taps, n_dst)
    idx: torch.Tensor       # int64 (taps, n_dst), clamped to [0, n_src)
    deno: torch.Tensor      # int64 (n_dst,), border divisor (0 -> 1)
    border: torch.Tensor    # bool (n_dst,)
    has_border: bool


@dataclasses.dataclass(frozen=True)
class Operands:
    """A whole plan on one device.  Read-only once built."""
    y: AxisOperands
    x: AxisOperands
    wrap16: bool
    y_bias: int
    out_shift: int
    src_shape: tuple[int, int]
    dst_shape: tuple[int, int]
    device: torch.device


def clamped_taps(ax: AxisPlan) -> np.ndarray:
    """(n_dst, taps) source index of every tap, clipped into [0, n_src)."""
    taps = ax.start[:, None] + np.arange(ax.num_coefs, dtype=np.int64)
    return np.clip(taps, 0, ax.n_src - 1)


def _axis(ax: AxisPlan, deno_scale: int, device) -> AxisOperands:
    deno = np.where(ax.deno == 0, 1, ax.deno).astype(np.int64) * deno_scale

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return AxisOperands(
        coef=t(ax.coef.T), idx=t(clamped_taps(ax).T), deno=t(deno),
        border=t(ax.is_border, torch.bool), has_border=bool(ax.is_border.any()))


def pack_operands(plan: ResizePlan, device="cpu") -> Operands:
    """Turn a :class:`ResizePlan` into tensors on ``device``.

    The X divisor carries the Y bias (``deno_x * bias_y``), as in
    ``numpy_ref._x_pass``."""
    y = _axis(plan.y, 1, device)
    return Operands(
        y=y, x=_axis(plan.x, plan.y.bias, device),
        wrap16=plan.wrap16, y_bias=plan.y.bias, out_shift=plan.out_shift,
        src_shape=(plan.y.n_src, plan.x.n_src),
        dst_shape=(plan.y.n_dst, plan.x.n_dst), device=y.coef.device)


def _wrap16(v: torch.Tensor) -> torch.Tensor:
    return ((v + 32768) & 65535) - 32768


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    return ((v + 2**31) & (2**32 - 1)) - 2**31


def _taps(s: torch.Tensor, ax: AxisOperands, dim: int) -> torch.Tensor:
    """sum_t coef[t] * s[..., idx[t], ...] along ``dim`` (-2 or -1), exact."""
    acc = None
    for c, i in zip(ax.coef, ax.idx):
        term = s.index_select(dim, i) * (c[:, None] if dim == -2 else c)
        acc = term if acc is None else acc.add_(term)
    return acc


def _check(ops: Operands, src: torch.Tensor) -> None:
    if tuple(src.shape[-2:]) != ops.src_shape:
        raise ValueError(f"source spatial shape {tuple(src.shape[-2:])} != "
                         f"plan geometry {ops.src_shape}")
    if src.dtype != torch.uint8:
        raise TypeError(f"source must be uint8, got {src.dtype}")


def _y_pass(ops: Operands, src: torch.Tensor) -> torch.Tensor:
    """The work rows, int64: the Y tap sums, with int16 narrowing and
    border-row renormalisation in wrap16 plans."""
    nume = _taps(src.to(torch.int64), ops.y, -2)
    if ops.wrap16:
        nume = _wrap16(nume)
        if ops.y.has_border:
            border = _wrap16(torch.div(nume * ops.y_bias, ops.y.deno[:, None],
                                       rounding_mode="trunc"))
            nume = torch.where(ops.y.border[:, None], border, nume)
    return nume


def _epilogue(ops: Operands, sums: torch.Tensor, wrap32: bool) -> torch.Tensor:
    """(sums + half) >> out_shift, the truncating border-column divide,
    int16 narrowing and the clip to uint8; ``wrap32`` wraps sums + half as
    the reference's C int32 accumulator."""
    rounded = sums + (1 << (ops.out_shift - 1))
    if wrap32:
        rounded = _wrap32(rounded)
    v = rounded >> ops.out_shift
    if ops.x.has_border:
        v = torch.where(ops.x.border,
                        torch.div(rounded, ops.x.deno, rounding_mode="trunc"), v)
    return _wrap16(v).clamp_(0, 255).to(torch.uint8)


def resize(ops: Operands, src: torch.Tensor) -> torch.Tensor:
    """(..., src_h, src_w) uint8 -> (..., dst_h, dst_w) uint8 on src's device,
    byte-identical to ``numpy_ref.resize_u8`` on every frame."""
    _check(ops, src)
    return _epilogue(ops, _taps(_y_pass(ops, src), ops.x, -1), ops.wrap16)


def _float_taps(w: torch.Tensor, plane: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """sum_t plane[t] * w[..., idx[t]] in float32, tap by tap in order,
    truncated toward zero to int32 (returned as int64)."""
    acc = torch.zeros(w.shape[:-1] + idx.shape[1:], dtype=torch.float32,
                      device=w.device)
    for c, i in zip(plane, idx):
        acc = acc + w.index_select(-1, i) * c
    return acc.to(torch.int32).to(torch.int64)


def resize_relaxed(ops: Operands, cxr: torch.Tensor, cxd: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """The relaxed resize (``precision="relaxed"``), the plain version of
    the kernel's relaxed instantiations: the exact Y pass; the work rows
    rounded to bf16; the X pass against the bf16 coefficient plane ``cxr``
    (taps, dst_w), a float32 sum taken tap by tap in order and truncated to
    int32, plus the same over the residual plane ``cxd`` where it is not
    empty; then the exact epilogue on the int32-wrapping sums.  Within
    2 LSB of ``resize``; flat fields exact.

    The port of the TPU's relaxed X scheme
    (``libiqo_tpu/ops/pallas_resize.py:1486-1505``), which rounds ``w``
    to bf16 on the chip too; its planes come from
    ``cuda_resize.relaxed_plane``."""
    _check(ops, src)
    w = _y_pass(ops, src).to(torch.float32).to(torch.bfloat16).to(torch.float32)
    sums = _float_taps(w, cxr, ops.x.idx)
    if cxd.numel():
        sums = sums + _float_taps(w, cxd, ops.x.idx)
    return _epilogue(ops, sums, wrap32=True)
