"""What the card's tensor cores give a hand-written kernel in f32 (TF32),
bf16, s8 -> s32 and s8 -> f32, at one shape.

Port of ``scripts/exp_int8_mxu.py`` to one NVIDIA H100.  Kernel C,
``mma_steps(a, bt, acc)`` (``libiqo_tpu_torch/csrc/exp/exp_mma.cu``):
``out[t] = a[t] @ b`` for every step t, with ``b`` held K-major as
``bt = k_major(b)`` (laid out once, as the TPU kernel kept ``b`` resident);
replaces ``make`` (``pl.pallas_call`` at ``:29``).  Rows, as the script's
``__main__`` (``:68-82``): ``f32xf32->f32`` (the script's ``"bf16 -> f32"``
row at ``:71``, whose inputs are float32: TF32 here, exact on its integer
inputs), ``bf16xbf16->f32``, ``s8xs8->i32`` and ``s8xs8->f32`` (int32 sums
converted at the store: Hopper has no s8 -> f32 product).  Each row times
back-to-back launches on inputs that each differ in ``a[0, 0, 0]``, as the
script's loop does, holds one output to the plain version, and prints the
effective multiply-adds per second (``:64-65``) beside the row's bound.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_int8_mxu``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _harness
from ._harness import (BF16_OPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S,
                       TF32_OPS_PER_S, Launches, wrap)

__all__ = ["LAUNCHES", "ROWS", "k_major", "main", "mma_steps", "mma_steps_plain"]

M, K, N = 256, 1024, 512
STEPS = 64
ITERS = 8                  # launches per timed run, as the script's fori_loop
# row: (input dtype, accumulator dtype)
ROWS = {"f32xf32->f32": (torch.float32, torch.float32),
        "bf16xbf16->f32": (torch.bfloat16, torch.float32),
        "s8xs8->i32": (torch.int8, torch.int32),
        "s8xs8->f32": (torch.int8, torch.float32)}
_KIND = {dt: i for i, dt in enumerate(ROWS.values())}
PEAK = {torch.float32: TF32_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S,
        torch.int8: INT8_OPS_PER_S}
_F32_EXACT = 2**24         # f32 sums of integers are exact below this
_TF32_EXACT = 2**11        # integers TF32 holds exactly
LAUNCHES = Launches(ROWS)


def reset_launches() -> None:
    LAUNCHES.reset()


def _row(in_dtype, acc_dtype) -> str:
    try:
        return list(ROWS)[_KIND[(in_dtype, acc_dtype)]]
    except KeyError:
        raise ValueError(f"no mma_steps row for {in_dtype} -> {acc_dtype}; "
                         f"rows: {list(ROWS)}") from None


def k_major(b: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (N, K) contiguous: the layout kernel C reads ``b`` in."""
    return b.t().contiguous()


def mma_steps_plain(a: torch.Tensor, bt: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """Kernel C's function in plain PyTorch: float64 products of integers,
    exact below 2^53, then the int32 wrap or the f32 conversion.  The float
    rows hold integers: their f32 sums are exact only while every output's
    sum of |terms| stays below 2^24 (TF32 also needs |x| <= 2^11), which is
    asserted here, so kernel and plain agree bit for bit."""
    row = _row(a.dtype, acc)
    ad, bd = a.to(torch.float64), bt.to(torch.float64)
    if a.dtype != torch.int8:
        for v in (ad, bd):
            if not torch.equal(v, v.round()):
                raise ValueError(f"{row}: the plain version takes integer values")
        if a.dtype == torch.float32 and max(ad.abs().max(), bd.abs().max()) > _TF32_EXACT:
            raise ValueError(f"{row}: |x| > 2^11 is not exact in TF32")
        worst = torch.matmul(ad.abs(), bd.abs().t()).max()
        if worst >= _F32_EXACT:
            raise ValueError(f"{row}: a sum of |terms| reaches {worst}, not "
                             "below 2^24: f32 sums would depend on their order")
    out = torch.matmul(ad, bd.t())
    if a.dtype == torch.int8:
        out = wrap(out.to(torch.int64), 32).to(torch.int32)
    return out.to(acc)


def mma_steps(a: torch.Tensor, bt: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """Kernel C: (steps, M, K) @ bt (N, K) -> (steps, M, N) of ``acc``.  A
    CPU tensor takes :func:`mma_steps_plain`; a CUDA tensor launches the
    kernel (M and N multiples of 64, K of 128 bytes) or raises."""
    row = _row(a.dtype, acc)
    if bt.dtype != a.dtype or a.ndim != 3 or bt.ndim != 2 or bt.shape[1] != a.shape[2]:
        raise ValueError(f"a (steps, M, K) and bt (N, K) of one dtype, got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(bt.shape)} {bt.dtype}")
    if not _harness.on_card(a, bt):
        return mma_steps_plain(a, bt, acc)
    steps, m, k = a.shape
    n = bt.shape[0]
    if m % 64 or n % 64 or (k * a.element_size()) % 128:
        raise ValueError(f"the kernel takes M, N multiples of 64 and K of 128 "
                         f"bytes, got M={m} N={n} K={k}")
    if not (a.is_contiguous() and bt.is_contiguous()):
        raise ValueError("mma_steps takes contiguous tensors")
    out = torch.empty((steps, m, n), dtype=acc, device=a.device)
    _harness.check_rc(_harness.lib().iqo_exp_mma_steps(
        _KIND[(a.dtype, acc)], a.data_ptr(), bt.data_ptr(), out.data_ptr(),
        steps, m, n, k, _harness.stream(a)), "mma_steps")
    LAUNCHES.add(row)
    return out


def inputs(in_dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's inputs (``bench``, ``:41-44``): integers in [-100, 100)
    from seed 0, as ``in_dtype``."""
    rng = np.random.default_rng(0)
    a = rng.integers(-100, 100, (STEPS, M, K))
    b = rng.integers(-100, 100, (K, N))
    to = lambda v: torch.from_numpy(v.astype(np.float32)).to(device).to(in_dtype)  # noqa: E731
    return to(a), to(b)


def bound(in_dtype, acc_dtype) -> tuple[float, str, int, float]:
    """(ms, 'bytes' or 'operations', bytes, operations) of the least time
    the card could take for one launch at the module's shapes."""
    isz = torch.empty(0, dtype=in_dtype).element_size()
    osz = torch.empty(0, dtype=acc_dtype).element_size()
    nbytes = STEPS * M * K * isz + K * N * isz + STEPS * M * N * osz
    ops = 2.0 * STEPS * M * K * N
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK[in_dtype] * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, ops


def main() -> dict:
    """Every row on card 0; returns {row: {ms, tmacs, bound_ms, ...}}."""
    _harness.require_card()
    card = _harness.card()
    dev = torch.device("cuda", 0)
    rows = {}
    for name, (in_dt, acc) in ROWS.items():
        a, b = inputs(in_dt, dev)
        bt = k_major(b)
        xs = _harness.perturbed(a, ITERS)
        if not torch.equal(mma_steps(xs[-1], bt, acc), mma_steps_plain(xs[-1], bt, acc)):
            raise AssertionError(f"{name}: kernel differs from its plain version")
        ms = _harness.launches_ms(lambda x: mma_steps(x, bt, acc), xs)
        tmacs = STEPS * M * K * N / (ms * 1e-3) / 1e12
        b_ms, by, nbytes, ops = bound(in_dt, acc)
        print(f"{name:18s}: {ms!r} ms  {tmacs!r} Tmac/s; bound {b_ms!r} ms "
              f"({by}: {nbytes} B, {ops!r} operations), kernel/bound "
              f"{ms / b_ms!r} ({card})", flush=True)
        rows[name] = {"ms": ms, "tmacs": tmacs, "bound_ms": b_ms, "bound_by": by,
                      "bytes": nbytes, "ops": ops}
    return rows


if __name__ == "__main__":
    main()
