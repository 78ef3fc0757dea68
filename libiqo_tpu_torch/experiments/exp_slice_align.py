"""What the alignment of the X pass's K window costs on the card: 15 grouped
Karatsuba bf16 dot triples per 32-row tile of a 4K -> 1080p luma row, with
the group starts aligned to 128 (width 512), 64 or 32 (width 384).

Port of ``scripts/exp_slice_align.py`` to one NVIDIA H100.  Kernel L,
``slice_groups(w, ops, align, kl)`` (``libiqo_tpu_torch/csrc/exp/
exp_slice.cu``, ``slice_groups<Check>``), replaces ``make``
(``pl.pallas_call`` at ``:56``) at (align, kl) = (128, 512), (64, 384) and
(32, 384).  Per step ``t < 34`` of ``w`` (34, 32, 3840) int16:
``b = ((w + 128) & 255) - 128``, ``a = (w - b) >> 8``; for group ``g < 15``
(outputs ``[128 g, 128 g + 128)``, ``k0 = min(max(0, 256 g - 5) // align *
align, 3840 - kl)``): ``d_i = int(p_i[:, k0:k0+kl] @ c_i[k0:k0+kl, 128 g:128
g + 128])`` for ``p = (a, b, a + b)`` in bf16 with f32 sums; ``s = 65280 d1 -
255 d2 + 256 d3`` with int32 wraps; ``out = clip((s + 2^19) >> 20, 0, 255)``
as u8, (34, 32, 1920).  Every sum is exact: |a + b| <= 246, |c| <= 100 and
kl <= 512 keep each |partial| below 2^24.

The u8 output is 94 % saturated (only ~6 % of pixels land in 1..254), so a
wrong kernel could hide behind the clip: ``check=True`` returns the int32
``s`` instead, which the card compares too.

**On Hopper.**  The TPU keeps the whole (3840, 1920) x 3 coefficient planes
in VMEM; here a group's window is 3 x kl x 128 bf16 (393 KB at kl = 512).
The coefficients are laid out K-major once (:func:`pack`, as the TPU
kernel's planes sit in VMEM), and the kernel streams K in chunks of 64
through shared memory with a ``cp.async`` double buffer.  The script's 34
``"arbitrary"`` steps are independent (no state carries), so the launch
form is one block per (group, half of its 128 columns, 4 steps): 15 x 2 x 9
= 270 blocks, one in flight per SM (172 registers a thread, so three
waves on 132 SMs); one block per (step, group) would re-read each window
34 times from L2 (~200 MB a launch), this form 9 times (:func:`issued_bytes`,
the bytes its ``cp.async`` copies issue, computed from the launch form; the
L2 traffic itself is not measured).  (The in-block loop over all steps of a
sequential grid cost 8.8x one block per step in ``exp_band_shape``'s
``arb``.)  The dots
run on ``mma.sync`` m16n8k16 bf16 -> f32, the split done in registers from
the int16 rows.  ``cp.async`` and the fragment loads need only 16-byte
alignment (8 bf16), so align 32 and 64 should cost nothing here and ``kl``
should.

Times: per launch by back-to-back launches on 8 tile stacks that each
differ in ``w[0, 0, 0]`` (67 MB together), as the script's loop perturbs,
and the script's speed-up line.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_slice_align``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _harness
from ._harness import BF16_OPS_PER_S, HBM_BYTES_PER_S, Launches, wrap

__all__ = ["CONFIGS", "LAUNCHES", "SliceOperands", "bound", "groups", "inputs", "issued_bytes",
           "main", "pack", "slice_groups", "slice_groups_plain", "split"]

TH, BW, TWF = 32, 3840, 1920
GRID = 34
N_GROUPS, GN = 15, 128
CONFIGS = ((128, 512), (64, 384), (32, 384))
STEPS_PER_BLOCK = 4        # kernel L's launch form
ITERS = 8
LAUNCHES = Launches(f"{a},{kl}" for a, kl in CONFIGS)
_F32_EXACT = 2**24


def reset_launches() -> None:
    LAUNCHES.reset()


@dataclasses.dataclass(frozen=True)
class SliceOperands:
    """The three coefficient planes (3840, 1920) bf16 and ``ct`` (3, 1920,
    3840), the same K-major for kernel L."""
    c: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    ct: torch.Tensor


def pack(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor) -> SliceOperands:
    for i, t in enumerate((c0, c1, c2)):
        if tuple(t.shape) != (BW, TWF) or t.dtype != torch.bfloat16:
            raise ValueError(f"c{i} must be ({BW}, {TWF}) bfloat16, got {tuple(t.shape)} {t.dtype}")
    _harness.on_card(c0, c1, c2)
    return SliceOperands((c0, c1, c2), torch.stack([c0.t(), c1.t(), c2.t()]).contiguous())


def inputs(device, grid: int | None = None) -> tuple[torch.Tensor, SliceOperands]:
    """The script's draws (``bench``, ``:88-91``), from seed 0: ``w`` (GRID,
    32, 3840) int16 in [-30000, 30000), then c0, c1, c2 in [-100, 100) as
    bf16, packed."""
    rng = np.random.default_rng(0)
    grid = GRID if grid is None else grid
    w = rng.integers(-30000, 30000, (grid, TH, BW)).astype(np.int16)
    cs = [torch.from_numpy(rng.integers(-100, 100, (BW, TWF)).astype(np.float32))
          .to(torch.bfloat16).to(device) for _ in range(3)]
    return torch.from_numpy(w).to(device), pack(*cs)


def groups(align: int, kl: int) -> list[tuple[int, int]]:
    """(output start, k0) of the 15 groups (``make``, ``:57-61``)."""
    return [(g * GN, min(max(0, 2 * GN * g - 5) // align * align, BW - kl))
            for g in range(N_GROUPS)]


def _check(w: torch.Tensor, align: int, kl: int) -> None:
    if (align, kl) not in CONFIGS:
        raise ValueError(f"(align, kl) is one of {CONFIGS}, got {(align, kl)}")
    if w.dtype != torch.int16 or w.ndim != 3 or tuple(w.shape[1:]) != (TH, BW):
        raise ValueError(f"w must be (steps, {TH}, {BW}) int16, got {tuple(w.shape)} {w.dtype}")


def split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Karatsuba split of int16 work values: ``(a, b, a + b)`` int64 with
    ``b = ((w + 128) & 255) - 128`` and ``a = (w - b) >> 8``."""
    w = w.to(torch.int64)
    b = ((w + 128) & 255) - 128
    a = (w - b) >> 8
    return a, b, a + b


def slice_groups_plain(w: torch.Tensor, ops: SliceOperands, align: int, kl: int,
                       check: bool = False) -> torch.Tensor:
    """Kernel L's function in plain PyTorch: the dots as float64 products of
    integers (every sum of |products| asserted below 2^24, so f32 sums in any
    order equal them), int32 wraps in int64.  ``check``: the int32 ``s``."""
    _check(w, align, kl)
    planes = [p.to(torch.float64) for p in split(w)]
    parts = []
    for o0, k0 in groups(align, kl):
        d = []
        for p, c in zip(planes, ops.c):
            pw, cw = p[..., k0:k0 + kl], c[k0:k0 + kl, o0:o0 + GN].to(torch.float64)
            worst = float(torch.matmul(pw.abs(), cw.abs()).max())
            if worst >= _F32_EXACT:
                raise ValueError(f"a sum of |products| reaches {worst}, not below 2^24")
            d.append(torch.matmul(pw, cw).to(torch.int64))
        parts.append(wrap(d[0] * 65280 - d[1] * 255 + d[2] * 256, 32))
    s = torch.cat(parts, dim=-1)
    if check:
        return s.to(torch.int32)
    return (wrap(s + (1 << 19), 32) >> 20).clamp(0, 255).to(torch.uint8)


def slice_groups(w: torch.Tensor, ops: SliceOperands, align: int, kl: int,
                 check: bool = False) -> torch.Tensor:
    """Kernel L: w (steps, 32, 3840) int16 -> (steps, 32, 1920) u8 (int32 ``s``
    with ``check``).  CPU tensors take :func:`slice_groups_plain`; CUDA
    tensors launch the kernel or raise."""
    _check(w, align, kl)
    if not _harness.on_card(w, ops.ct, *ops.c):
        return slice_groups_plain(w, ops, align, kl, check)
    if not (w.is_contiguous() and ops.ct.is_contiguous()):
        raise ValueError("slice_groups takes contiguous tensors")
    lib = _harness.lib_with_setup("iqo_exp_slice_setup", w.device)
    out = torch.empty((w.shape[0], TH, TWF), dtype=torch.int32 if check else torch.uint8,
                      device=w.device)
    _harness.check_rc(lib.iqo_exp_slice_groups(
        align, kl, int(check), w.data_ptr(), ops.ct.data_ptr(), out.data_ptr(), w.shape[0],
        _harness.stream(w)), f"slice_groups[{align}, {kl}]")
    LAUNCHES.add(f"{align},{kl}")
    return out


def bound(kl: int, steps: int = GRID) -> tuple[float, str, int, int]:
    """(ms, 'bytes' or 'operations', bytes, multiply-adds) of one launch:
    ``w``, the 15 windows and the output once each at 3.35 TB/s, against the
    bf16 multiply-adds at 989 TFLOP/s."""
    macs = steps * TH * N_GROUPS * GN * kl * 3
    nbytes = steps * TH * BW * 2 + 3 * N_GROUPS * kl * GN * 2 + steps * TH * TWF
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / BF16_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, macs


def issued_bytes(kl: int, steps: int = GRID) -> int:
    """Bytes kernel L's ``cp.async`` copies issue in one launch, from L2 or
    memory, computed from the launch form (not measured): each (group,
    column half) reads its ``w`` rows and its window once per block of 4
    steps."""
    sets = -(-steps // STEPS_PER_BLOCK)
    w_bytes = N_GROUPS * 2 * steps * TH * kl * 2
    c_bytes = N_GROUPS * 2 * sets * 3 * (GN // 2) * kl * 2
    return w_bytes + c_bytes


def main() -> dict:
    """Every (align, kl) on card 0; returns {"k0%<align>, kl=<kl>": {ms, ...}}."""
    _harness.require_card()
    card = _harness.card()
    w, ops = inputs(torch.device("cuda", 0))
    ws = _harness.perturbed(w, ITERS)
    rows = {}
    for align, kl in CONFIGS:
        for check in (False, True):
            if not torch.equal(slice_groups(ws[-1], ops, align, kl, check),
                               slice_groups_plain(ws[-1], ops, align, kl, check)):
                raise AssertionError(f"align {align} kl {kl} check={check}: kernel differs "
                                     "from its plain version")
        ms = _harness.launches_ms(lambda x: slice_groups(x, ops, align, kl), ws)
        b_ms, by, nbytes, macs = bound(kl)
        name = f"k0%{align}, kl={kl}"
        print(f"{name:14s}: {ms!r} ms/frame-equivalent; bound {b_ms!r} ms ({by}), "
              f"kernel/bound {ms / b_ms!r}; {issued_bytes(kl) / 1e6!r} MB issued by cp.async, "
              f"computed from the launch form ({card})",
              flush=True)
        rows[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": by, "bytes": nbytes,
                      "macs": macs, "issued_bytes": issued_bytes(kl)}
    a, b, c = (rows[f"k0%{al}, kl={kl}"]["ms"] for al, kl in CONFIGS)
    print(f"64-align speedup: {a / b!r}x   32-align: {a / c!r}x ({card})", flush=True)
    return rows


if __name__ == "__main__":
    main()
