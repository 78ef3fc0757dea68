"""What the resize kernel's elementwise op mixes cost per element on the
card: P repeats of a mix over a 4K-wide i32 tile stack, the slope over P.

Port of ``scripts/exp_vpu_rate.py`` to one NVIDIA H100.  Kernel K,
``op_mix(src, mix, p)`` (``libiqo_tpu_torch/csrc/exp/exp_vpu.cu``,
``op_mix<Mix, P>``), replaces ``build`` (``pl.pallas_call`` at ``:50``).  On
``src`` (1152, 1920) int32 (12 steps of 96 rows, drawn in +-2^20), with
``acc = 0`` and P repeats, int32 wraps, out (1152, 1920) int32:

* ``mad``: ``v = v * 3 + 7``, ``acc ^= v``;
* ``epi``: ``m = (v + 32) >> 6``, ``m = ((m + 32768) & 65535) - 32768`` (the
  int16 wrap), ``acc ^= clip(m, 0, 255)``, ``v += 1``;
* ``split``: ``a = int8((v * 65536) >> 24)``, ``b = int8((v & 255) - 128)``,
  ``acc ^= int32(a ^ b)``, ``v += 1``.

Rates are in Gop/s with the script's counts of 2, 8 and 6 operations per
element and repeat (:data:`OPS`), which are the TPU's counts, not this
card's instructions; beside them :func:`sass_per_rep` gives the SASS
instructions per element and repeat of the built kernel (``cuobjdump``),
and those instructions, not the TPU's count, set the bound's operation
term.  The slope is the repeats' cost only where P = 1 is already bound
by its operations; where it is bound by its bytes, repeats hide under the
byte time and the slope is only what shows above it, so the Gop/s are
None, as they are where ``t(8) - t(1)`` is not larger than the spread of
two timed runs at each P (:func:`slope`).

**On Hopper.**  The script's 12 ``"arbitrary"`` grid steps are independent
(no state carries between them), so they become one block per (step,
chunk of 1024 elements): 2160 blocks of 256 threads, one thread per 4
elements (16-byte loads and stores), the P repeats unrolled in registers
with the wraps in uint32.  (The in-block loop form of a sequential grid
cost 8.8x one block per step in ``exp_band_shape``'s ``arb``.)  A fused
elementwise pass like this is what Triton serves well; it stays CUDA here,
in the one library that serves all the probes.

Times: per launch by back-to-back launches on 8 sources that each differ
in ``src[0, 0]`` (71 MB together, more than the L2); per repeat is
``(t(8) - t(1)) / 7``, the script's slope.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_vpu_rate``.
"""

from __future__ import annotations

import re
import subprocess

import numpy as np
import torch

from . import _harness
from ._harness import HBM_BYTES_PER_S, INT32_OPS_PER_S, Launches, wrap

__all__ = ["LAUNCHES", "MIXES", "OPS", "PS", "bound", "inputs", "main", "op_mix",
           "op_mix_plain", "sass_per_rep", "slope"]

TH, TW = 96, 1920
STEPS = 12
MIXES = ("mad", "epi", "split")
PS = (1, 4, 8)
OPS = {"mad": 2, "epi": 8, "split": 6}
ITERS = 8
LAUNCHES = Launches(f"{m},P={p}" for m in MIXES for p in PS)


def reset_launches() -> None:
    LAUNCHES.reset()


def inputs(device) -> torch.Tensor:
    """The script's source (``main``, ``:98-100``), from seed 0:
    (STEPS * 96, 1920) int32 in [-2^20, 2^20)."""
    rng = np.random.default_rng(0)
    src = rng.integers(-2**20, 2**20, (STEPS * TH, TW)).astype(np.int32)
    return torch.from_numpy(src).to(device)


def _check(src: torch.Tensor, mix: str, p: int) -> None:
    if mix not in MIXES:
        raise ValueError(f"mixes are {MIXES}, got {mix!r}")
    if p not in PS:
        raise ValueError(f"P is one of {PS}, got {p}")
    if src.dtype != torch.int32 or src.ndim != 2 or src.shape[1] != TW:
        raise ValueError(f"src must be (rows, {TW}) int32, got {tuple(src.shape)} {src.dtype}")


def op_mix_plain(src: torch.Tensor, mix: str, p: int) -> torch.Tensor:
    """Kernel K's function in plain PyTorch: int64 with explicit int32 and
    int8 wraps."""
    _check(src, mix, p)
    v = src.to(torch.int64)
    acc = torch.zeros_like(v)
    for _ in range(p):
        if mix == "mad":
            v = wrap(v * 3 + 7, 32)
            acc ^= v
        elif mix == "epi":
            m = (v + 32) >> 6
            m = ((m + 32768) & 65535) - 32768
            acc ^= m.clamp(0, 255)
            v = wrap(v + 1, 32)
        else:
            a = wrap(wrap(v * 65536, 32) >> 24, 8)
            b = wrap((v & 255) - 128, 8)
            acc ^= a ^ b
            v = wrap(v + 1, 32)
    return acc.to(torch.int32)


def op_mix(src: torch.Tensor, mix: str, p: int) -> torch.Tensor:
    """Kernel K: src (rows, 1920) int32 -> the same shape.  A CPU tensor takes
    :func:`op_mix_plain`; a CUDA tensor launches the kernel or raises."""
    _check(src, mix, p)
    if not _harness.on_card(src):
        return op_mix_plain(src, mix, p)
    if not src.is_contiguous():
        raise ValueError("op_mix takes a contiguous source")
    out = torch.empty_like(src)
    _harness.check_rc(_harness.lib().iqo_exp_op_mix(
        MIXES.index(mix), p, src.data_ptr(), out.data_ptr(), src.numel(),
        _harness.stream(src)), f"op_mix[{mix}, P={p}]")
    LAUNCHES.add(f"{mix},P={p}")
    return out


def bound(mix: str, p: int, rows: int = STEPS * TH,
          per_rep: float | None = None) -> tuple[float, str, int, float]:
    """(ms, 'bytes' or 'operations', bytes, operations) of one launch: the
    source read and the output written once at 3.35 TB/s, against
    ``per_rep`` operations per element and repeat (the card's SASS count;
    the script's TPU count :data:`OPS` where none is given) at the int32
    rate :data:`INT32_OPS_PER_S`."""
    n = rows * TW
    nbytes, ops = 2 * 4 * n, (OPS[mix] if per_rep is None else per_rep) * p * n
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, ops


def slope(first: dict[int, float], second: dict[int, float],
          bound_by: str) -> tuple[float, str | None]:
    """The script's per-repeat time ``(t(8) - t(1)) / 7`` from the faster of
    two timed runs at each P, and why it is not the repeats' cost (None
    where it is): P = 1 bound (``bound_by``) by its bytes, so that repeats
    hide under the byte time and the slope is only what shows above it; or
    ``t(8) - t(1)`` not larger than the two runs' spread at P = 1 and 8."""
    t = {p: min(first[p], second[p]) for p in (1, 8)}
    spread = sum(abs(first[p] - second[p]) for p in (1, 8))
    why = ("P=1 bound by bytes: the slope is the cost above the byte time" if bound_by == "bytes"
           else None if t[8] - t[1] > spread else "t(8) - t(1) within the runs' spread")
    return (t[8] - t[1]) / 7, why


def sass_per_rep() -> dict[str, float] | None:
    """SASS instructions per element and repeat of each mix,
    ``(insns(P=8) - insns(P=1)) / 7 / 4``, from the built library's
    ``cuobjdump -sass``; None where the toolkit has no ``cuobjdump``."""
    from ..tools import sass_loads
    try:
        counts = sass_loads.instruction_counts(["op_mix_kernel"])
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return None
    out = {}
    for i, mix in enumerate(MIXES):
        per_p = {int(m.group(1)): n for sym, n in counts.items()
                 if (m := re.search(rf"op_mix_kernelILi{i}ELi(\d+)E", sym))}
        if set(per_p) != set(PS):
            return None
        out[mix] = (per_p[8] - per_p[1]) / 7 / 4
    return out


def main() -> dict:
    """Every mix and P on card 0, each P timed twice; returns {"<mix>
    P=<p>": {ms, ...}, "<mix>": {per_rep_us, gops (None where the slope is
    not the repeats' cost), ...}}."""
    _harness.require_card()
    card = _harness.card()
    xs = _harness.perturbed(inputs(torch.device("cuda", 0)), ITERS)
    sass = sass_per_rep()
    rows = {}
    for mix in MIXES:
        runs = ({}, {})
        for p in PS:
            if not torch.equal(op_mix(xs[-1], mix, p), op_mix_plain(xs[-1], mix, p)):
                raise AssertionError(f"{mix} P={p}: kernel differs from its plain version")
            for run in runs:
                run[p] = _harness.launches_ms(lambda x: op_mix(x, mix, p), xs)
            b_ms, by, nbytes, ops = bound(mix, p, per_rep=None if sass is None else sass[mix])
            rows[f"{mix} P={p}"] = {"ms": min(r[p] for r in runs), "bound_ms": b_ms,
                                    "bound_by": by, "bytes": nbytes, "ops": ops}
        p8 = rows[f"{mix} P=8"]
        per_rep, why = slope(*runs, rows[f"{mix} P=1"]["bound_by"])
        elems = STEPS * TH * TW
        gops = None if why else OPS[mix] * elems / (per_rep * 1e-3) / 1e9
        ts = {p: rows[f"{mix} P={p}"]["ms"] for p in PS}
        print(f"{mix:6s}: t(P=1)={ts[1] * 1e3!r}us t(4)={ts[4] * 1e3!r} t(8)={ts[8] * 1e3!r} "
              f"(runs {[r[1] * 1e3 for r in runs]!r} at P=1, {[r[8] * 1e3 for r in runs]!r} at "
              f"P=8) -> {per_rep * 1e3!r} us/rep = {gops!r} Gop/s ({OPS[mix]} ops/elem, the "
              f"TPU's count{'; None: ' + why if why else ''}); SASS "
              f"{None if sass is None else sass[mix]!r} instructions/elem/rep; bound at P=8 "
              f"{p8['bound_ms'] * 1e3!r} us ({p8['bound_by']}, "
              f"{'the TPU count' if sass is None else 'the SASS count'}) ({card})", flush=True)
        rows[mix] = {"per_rep_us": per_rep * 1e3, "gops": gops,
                     "sass_per_elem_rep": None if sass is None else sass[mix]}
    return rows


if __name__ == "__main__":
    main()
