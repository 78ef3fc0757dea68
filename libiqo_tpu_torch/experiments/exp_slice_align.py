"""What the alignment of the X pass's K window costs on the card: 15 grouped
Karatsuba bf16 dot triples per 32-row tile of a 4K -> 1080p luma row, with
the group starts aligned to 128 (width 512), 64 or 32 (width 384).

Port of ``scripts/exp_slice_align.py`` to one NVIDIA H100.  Kernel L,
``slice_groups(w, ops, align, kl, check=False, form=None)``, replaces
``make`` (``pl.pallas_call`` at ``:56``) at (align, kl) = (128, 512),
(64, 384) and (32, 384), in two forms (:data:`FORMS`):

* ``"wgmma"``, the default (``libiqo_tpu_torch/csrc/exp/exp_slice_wgmma.cu``,
  ``slice_wgmma<Check>``): a persistent grid of one block an SM; a block
  holds a window (3 planes x 64 columns x kl, half a group) resident in
  shared memory and streams 64-row M tiles (two steps) of the int16 rows
  past it by TMA, each warp splitting its 16 rows into the three bf16 A
  fragments in registers for one ``wgmma`` m64n64k16 a plane; two consumer
  warpgroups take alternate tiles of a block's run (:data:`WGMMA`
  states the geometry, :func:`wgmma_walk` the tiles of each block,
  :func:`wgmma_model` the schedule in NumPy, :func:`split_bf16` the split's
  bit operations);
* ``"mma_sync"``, the first form (``csrc/exp/exp_slice.cu``,
  ``slice_groups<Check>``), described below.

:data:`LAUNCHES` counts the ``mma_sync`` form under ``"<align>,<kl>"`` and the
``wgmma`` form under ``"<align>,<kl>[wgmma]"`` (:func:`launch_key`).

Per step ``t < 34`` of ``w`` (34, 32, 3840) int16:
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

**On Hopper, the first form.**  The TPU keeps the whole (3840, 1920) x 3
coefficient planes in VMEM; here a group's window is 3 x kl x 128 bf16
(393 KB at kl = 512).
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
both forms and the library calls in turns (:func:`library`: the three
planes' dots as one bf16 ``torch.bmm`` with float32 output over the 45
windows stacked on the batch axis, and as three, one a plane, each over
operands laid out beforehand and held equal to the plain sums), and the
script's speed-up line.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_slice_align``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _harness
from ._harness import BF16_OPS_PER_S, HBM_BYTES_PER_S, Launches, wrap

__all__ = ["CONFIGS", "FORMS", "LAUNCHES", "SliceOperands", "WGMMA", "WgmmaGeometry", "bound",
           "groups", "inputs", "issued_bytes", "launch_key", "library", "library_lhs",
           "library_rhs", "library_sums", "main", "pack", "slice_groups", "slice_groups_plain",
           "split", "split_bf16", "wave_efficiency", "wgmma_ctas", "wgmma_model", "wgmma_tiles",
           "wgmma_walk"]

TH, BW, TWF = 32, 3840, 1920
GRID = 34
N_GROUPS, GN = 15, 128
CONFIGS = ((128, 512), (64, 384), (32, 384))
STEPS_PER_BLOCK = 4        # the mma_sync form's launch form
ITERS = 8
FORMS = ("wgmma", "mma_sync")   # the first is the default
H100_SMS = 132
_F32_EXACT = 2**24


def launch_key(align: int, kl: int, form: str) -> str:
    """The :data:`LAUNCHES` key of a config's form: ``"<align>,<kl>"`` for
    the first, ``mma_sync`` form, ``"<align>,<kl>[form]"`` otherwise."""
    return f"{align},{kl}" if form == "mma_sync" else f"{align},{kl}[{form}]"


LAUNCHES = Launches(launch_key(a, kl, f) for f in reversed(FORMS) for a, kl in CONFIGS)


@dataclasses.dataclass(frozen=True)
class WgmmaGeometry:
    """The wgmma form's geometry, as ``exp_slice_wgmma.cu`` states it."""
    bm: int = 64            # rows of an M tile: two steps
    bn: int = 64            # columns of a block's window: half a group
    kc: int = 64            # K of a chunk: 128 bytes, the swizzle's width
    max_chunks: int = 8     # kl <= 512
    stages: int = 2         # each consumer's ring of M-tile rows
    consumers: int = 2      # warpgroups: tile i of a block's run goes to consumer i % 2

    @property
    def windows(self) -> int:
        return N_GROUPS * (GN // self.bn)

    @property
    def threads(self) -> int:
        return 160 * self.consumers                # + a producer warp each

    @property
    def tile_bytes(self) -> int:
        """One plane's K chunk of the window."""
        return self.bn * self.kc * 2

    @property
    def window_bytes(self) -> int:
        return 3 * self.max_chunks * self.tile_bytes

    @property
    def stage_bytes(self) -> int:
        return self.bm * self.kc * 2

    @property
    def barriers(self) -> int:
        return 2 * self.consumers * self.stages + 2 * self.max_chunks

    @property
    def smem(self) -> int:
        return (self.window_bytes + self.consumers * self.stages * self.stage_bytes
                + 8 * self.barriers + 1024)         # + the alignment slack


WGMMA = WgmmaGeometry()


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


def wgmma_tiles(steps: int) -> int:
    """The wgmma form's tiles: 30 windows x ceil(steps * 32 / 64) M tiles."""
    return WGMMA.windows * -(-steps * TH // WGMMA.bm)


def wgmma_ctas(steps: int, sms: int) -> int:
    """Blocks of the wgmma form's persistent grid: one an SM, at most one a
    tile."""
    return min(sms, wgmma_tiles(steps))


def wgmma_walk(steps: int, ctas: int) -> list[list[tuple[int, int]]]:
    """The wgmma form's tiles for each of ``ctas`` blocks, in order: block b
    takes the contiguous run [b T / ctas, (b + 1) T / ctas) of the
    window-major order, tile t being (window t // mt, M tile t % mt) with
    mt = ceil(steps / 2); window i is group i // 2, columns 64 (i % 2) ..
    of it."""
    mt = -(-steps * TH // WGMMA.bm)
    tiles = WGMMA.windows * mt
    return [[(t // mt, t % mt) for t in range(b * tiles // ctas, (b + 1) * tiles // ctas)]
            for b in range(ctas)]


def wave_efficiency(steps: int, sms: int) -> float:
    """The mean run over the longest: the share of the card's time its
    blocks have tiles to compute, if every tile takes the same time."""
    runs = [len(r) for r in wgmma_walk(steps, wgmma_ctas(steps, sms))]
    return sum(runs) / len(runs) / max(runs)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _bf16_exact(v: np.ndarray) -> np.ndarray:
    """The bf16 bits of ``v`` (float64), which bf16 must hold exactly, as
    the kernel's exact bf16x2 arithmetic gives them."""
    bits = (v.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    if not np.array_equal(_bf16_value(bits), v):
        raise AssertionError("a split value is not exact in bf16")
    return bits


def split_bf16(w: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The wgmma form's split (``exp_slice_wgmma.cu``'s ``split_pair``) in
    NumPy, bit for bit, on int16 ``w``: the integer masks on each 16-bit lane
    of a pair, then the exact bf16 subtractions, the fused multiply-add by
    2^126 and the addition; returns the bf16 bits of a, b and a + b (uint16,
    the shape of ``w``)."""
    v = w.astype(np.int16).view(np.uint16).astype(np.uint32)
    h = v >> 8
    b = _bf16_value((v & 0x7F) | 0x4300) - _bf16_value((v & 0x80) | 0x4300)
    hs = _bf16_value((h & 0x7F) | 0x4300) - _bf16_value((h & 0x80) | 0x4300)
    bit = _bf16_value(v & 0x80) * _bf16_value(np.uint32(0x7E80))
    a = _bf16_exact(hs + bit)
    b = _bf16_exact(b)
    return a, b, _bf16_exact(_bf16_value(a) + _bf16_value(b))


def wgmma_model(w: np.ndarray, c: np.ndarray, align: int, kl: int, check: bool = False,
                sms: int = H100_SMS) -> np.ndarray:
    """The wgmma form's schedule in NumPy: block by block along
    :func:`wgmma_walk`, each (window, M tile) from the split's bf16 values
    (:func:`split_bf16`) and the window's coefficients ``c`` (3, 3840,
    1920), each plane summed K chunk by K chunk (exact: integers, every
    sum of |products| asserted below 2^24) and truncated, the three met in uint32, then rounded
    and clipped (or ``s`` with ``check``); rows past the last step are
    computed as zeros and not stored.  w (steps, 32, 3840) int16 ->
    (steps, 32, 1920) u8 or int32."""
    g = WGMMA
    steps = w.shape[0]
    rows = w.reshape(-1, BW)
    mt = -(-steps * TH // g.bm)
    padded = np.zeros((mt * g.bm, BW), np.int16)
    padded[:rows.shape[0]] = rows
    planes = [_bf16_value(p) for p in split_bf16(padded)]
    k0s = dict(groups(align, kl))
    s = np.full((steps * TH, TWF), -1, np.int64)
    seen = np.zeros((g.windows, mt), np.int64)
    for run in wgmma_walk(steps, wgmma_ctas(steps, sms)):
        for window, m in run:
            col0 = GN * (window // 2) + g.bn * (window % 2)
            k0 = k0s[GN * (window // 2)]
            r = slice(g.bm * m, g.bm * (m + 1))
            d = []
            for p, cp in zip(planes, c):
                acc = np.zeros((g.bm, g.bn), np.float64)
                worst = np.zeros((g.bm, g.bn), np.float64)
                for k in range(k0, k0 + kl, g.kc):
                    pk, ck = p[r, k:k + g.kc], cp[k:k + g.kc, col0:col0 + g.bn]
                    acc += pk @ ck
                    worst += np.abs(pk) @ np.abs(ck)
                if worst.max() >= _F32_EXACT:
                    raise AssertionError("a sum of |products| reaches 2^24: f32 sums would "
                                         "depend on their order")
                d.append(acc.astype(np.int64))
            sw = (d[0] * 65280 - d[1] * 255 + d[2] * 256) % 2**32
            n = min(g.bm, steps * TH - g.bm * m)
            s[g.bm * m:g.bm * m + n, col0:col0 + g.bn] = sw[:n]
            seen[window, m] += 1
    if not (seen == 1).all() or (s < 0).any():
        raise AssertionError("the walk did not cover every (window, M tile) once")
    s = (s + 2**31) % 2**32 - 2**31                         # as int32
    if check:
        return s.astype(np.int32).reshape(steps, TH, TWF)
    u = np.clip(((s + 2**19 + 2**31) % 2**32 - 2**31) >> 20, 0, 255)
    return u.astype(np.uint8).reshape(steps, TH, TWF)


def _form(form: str | None) -> str:
    if form is None:
        return FORMS[0]
    if form not in FORMS:
        raise ValueError(f"slice_groups takes form {FORMS}, got {form!r}")
    return form


@functools.cache
def _wgmma_lib(device: torch.device):
    """The probes' library with the wgmma form's shared memory raised on
    ``device``, its compiled geometry checked against :data:`WGMMA`."""
    import ctypes
    lib_ = _harness.lib_with_setup("iqo_exp_slice_wgmma_setup", device)
    got = (ctypes.c_int * 7)()
    lib_.iqo_exp_slice_wgmma_shape(got)
    g = WGMMA
    want = [g.bm, g.bn, g.kc, g.max_chunks, g.stages, g.threads, g.smem]
    if list(got) != want:
        raise RuntimeError(f"exp_slice_wgmma.cu's geometry {list(got)} != the host's {want}")
    return lib_


def slice_groups(w: torch.Tensor, ops: SliceOperands, align: int, kl: int,
                 check: bool = False, form: str | None = None) -> torch.Tensor:
    """Kernel L: w (steps, 32, 3840) int16 -> (steps, 32, 1920) u8 (int32 ``s``
    with ``check``), in ``form`` (:data:`FORMS`, ``"wgmma"`` by default).
    CPU tensors take :func:`slice_groups_plain`; CUDA tensors launch the
    form's kernel or raise."""
    form = _form(form)
    _check(w, align, kl)
    if not _harness.on_card(w, ops.ct, *ops.c):
        return slice_groups_plain(w, ops, align, kl, check)
    if not (w.is_contiguous() and ops.ct.is_contiguous()):
        raise ValueError("slice_groups takes contiguous tensors")
    if w.data_ptr() % 16 or ops.ct.data_ptr() % 16:
        raise ValueError("slice_groups takes 16-byte aligned tensors")
    steps = w.shape[0]
    out = torch.empty((steps, TH, TWF), dtype=torch.int32 if check else torch.uint8,
                      device=w.device)
    if form == "wgmma":
        sms = torch.cuda.get_device_properties(w.device).multi_processor_count
        rc = _wgmma_lib(w.device).iqo_exp_slice_wgmma(
            align, kl, int(check), w.data_ptr(), ops.ct.data_ptr(), out.data_ptr(), steps,
            wgmma_ctas(steps, sms), _harness.stream(w))
    else:
        rc = _harness.lib_with_setup("iqo_exp_slice_setup", w.device).iqo_exp_slice_groups(
            align, kl, int(check), w.data_ptr(), ops.ct.data_ptr(), out.data_ptr(), steps,
            _harness.stream(w))
    _harness.check_rc(rc, f"slice_groups[{align}, {kl}, {form}]")
    LAUNCHES.add(launch_key(align, kl, form))
    return out


def library_lhs(w: torch.Tensor, align: int, kl: int) -> torch.Tensor:
    """The library call's left operand: the three planes' windows stacked on
    the batch axis, plane-major, (45, steps 32, kl) bf16 (entry 15 p + g is
    plane p of group g's window over every step's rows)."""
    k0s = [k0 for _, k0 in groups(align, kl)]
    return torch.stack([p.reshape(-1, BW)[:, k0:k0 + kl] for p in split(w) for k0 in k0s]) \
        .to(torch.bfloat16).contiguous()


def library_rhs(ops: SliceOperands, align: int, kl: int) -> torch.Tensor:
    """The library call's right operand, laid out once: (45, kl, 128) bf16,
    entry 15 p + g being ``c_p[k0:k0 + kl, 128 g:128 g + 128]``."""
    return torch.stack([c[k0:k0 + kl, o0:o0 + GN] for c in ops.c
                        for o0, k0 in groups(align, kl)]).contiguous()


def library(lhs: torch.Tensor, rhs: torch.Tensor, calls: int = 1) -> list[torch.Tensor]:
    """Kernel L's dots as PyTorch calls (CUDA: bf16 ``torch.bmm`` with
    ``out_dtype=float32``; elsewhere the float32 ``bmm`` of the same bf16
    values, exact): ``calls`` 1 is one ``bmm`` over all 45 windows, 3 one a
    plane over its 15."""
    per = lhs.shape[0] // calls
    if lhs.is_cuda:
        return [torch.bmm(lhs[i:i + per], rhs[i:i + per], out_dtype=torch.float32)
                for i in range(0, lhs.shape[0], per)]
    return [torch.bmm(lhs[i:i + per].float(), rhs[i:i + per].float())
            for i in range(0, lhs.shape[0], per)]


def library_sums(d: list[torch.Tensor], steps: int, check: bool = False) -> torch.Tensor:
    """The library's f32 dots (from :func:`library`) met as the kernel meets
    them: int64, ``s = 65280 d1 - 255 d2 + 256 d3`` with int32 wraps, then
    the epilogue (or ``s`` with ``check``); (steps, 32, 1920)."""
    d = torch.cat(d).to(torch.int64).view(3, N_GROUPS, steps * TH, GN)
    s = wrap(d[0] * 65280 - d[1] * 255 + d[2] * 256, 32)
    s = s.permute(1, 0, 2).reshape(steps, TH, TWF)
    if check:
        return s.to(torch.int32)
    return (wrap(s + (1 << 19), 32) >> 20).clamp(0, 255).to(torch.uint8)


def bound(kl: int, steps: int = GRID) -> tuple[float, str, int, int]:
    """(ms, 'bytes' or 'operations', bytes, multiply-adds) of one launch:
    ``w``, the 15 windows and the output once each at 3.35 TB/s, against the
    bf16 multiply-adds at 989 TFLOP/s."""
    macs = steps * TH * N_GROUPS * GN * kl * 3
    nbytes = steps * TH * BW * 2 + 3 * N_GROUPS * kl * GN * 2 + steps * TH * TWF
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / BF16_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, macs


def issued_bytes(kl: int, steps: int = GRID, form: str = "mma_sync",
                 sms: int = H100_SMS) -> int:
    """Bytes kernel L's copies issue in one launch, from L2 or memory,
    computed from the launch form (not measured).  ``mma_sync``: each (group,
    column half) reads its ``w`` rows and its window once per block of 4
    steps (``cp.async``).  ``wgmma``: each block reads each window its run
    touches once and each of its M tiles' rows once per window (TMA, rows
    past the last step not read)."""
    if form == "mma_sync":
        sets = -(-steps // STEPS_PER_BLOCK)
        w_bytes = N_GROUPS * 2 * steps * TH * kl * 2
        c_bytes = N_GROUPS * 2 * sets * 3 * (GN // 2) * kl * 2
        return w_bytes + c_bytes
    g = WGMMA
    total = 0
    for run in wgmma_walk(steps, wgmma_ctas(steps, sms)):
        total += len({win for win, _ in run}) * 3 * g.bn * kl * 2
        total += sum(min(g.bm, steps * TH - g.bm * m) for _, m in run) * kl * 2
    return total


def main() -> dict:
    """Every (align, kl) on card 0: both forms, the one-call library and the
    three-call library in turns (that order, then reversed; min of two
    each), each first held to the plain version (the library's sums met as
    the kernel meets them, u8 and ``check``); returns {"k0%<align>, kl=<kl>":
    {ms (the wgmma form), ms_mma_sync, library_ms, library3_ms, ...}}."""
    _harness.require_card()
    card = _harness.card()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w, ops = inputs(dev)
    ws = _harness.perturbed(w, ITERS)
    rows = {}
    for align, kl in CONFIGS:
        rhs = library_rhs(ops, align, kl)
        lhs = [library_lhs(x, align, kl) for x in ws]
        for check in (False, True):
            want = slice_groups_plain(ws[-1], ops, align, kl, check)
            got = {f: slice_groups(ws[-1], ops, align, kl, check, f) for f in FORMS}
            got["library"] = library_sums(library(lhs[-1], rhs), GRID, check)
            got["library3"] = library_sums(library(lhs[-1], rhs, 3), GRID, check)
            for what, out in got.items():
                if not torch.equal(out, want):
                    raise AssertionError(f"align {align} kl {kl} check={check}: {what} differs "
                                         "from the plain version")
        calls = {f: functools.partial(lambda i, f: slice_groups(ws[i], ops, align, kl, form=f),
                                      f=f) for f in FORMS}
        calls["library"] = lambda i: library(lhs[i], rhs)
        calls["library3"] = lambda i: library(lhs[i], rhs, 3)
        times = {what: [] for what in calls}
        for what in list(calls) + list(calls)[::-1]:
            times[what].append(_harness.launches_ms(calls[what], list(range(ITERS))))
        t = {what: min(v) for what, v in times.items()}
        del lhs
        ms = t["wgmma"]
        b_ms, by, nbytes, macs = bound(kl)
        name = f"k0%{align}, kl={kl}"
        print(f"{name:14s}: wgmma {ms!r} ms/frame-equivalent, mma_sync {t['mma_sync']!r}; "
              f"library one bf16 torch.bmm(out_dtype=float32) over 45 windows "
              f"{t['library']!r}, three (one a plane) {t['library3']!r}; wgmma/library "
              f"{ms / t['library']!r}; bound {b_ms!r} ms ({by}), wgmma/bound {ms / b_ms!r}, "
              f"mma_sync/bound {t['mma_sync'] / b_ms!r}; MB issued by the copies, computed "
              f"from the launch forms: wgmma {issued_bytes(kl, form='wgmma', sms=sms) / 1e6!r}, "
              f"mma_sync {issued_bytes(kl) / 1e6!r}; wave efficiency "
              f"{wave_efficiency(GRID, sms)!r} ({card})", flush=True)
        rows[name] = {"ms": ms, "ms_mma_sync": t["mma_sync"], "library_ms": t["library"],
                      "library3_ms": t["library3"], "bound_ms": b_ms, "bound_by": by,
                      "bytes": nbytes, "macs": macs,
                      "issued_bytes": issued_bytes(kl, form="wgmma", sms=sms),
                      "issued_bytes_mma_sync": issued_bytes(kl)}
    for form, key in (("wgmma", "ms"), ("mma_sync", "ms_mma_sync")):
        a, b, c = (rows[f"k0%{al}, kl={kl}"][key] for al, kl in CONFIGS)
        print(f"{form}: 64-align speedup: {a / b!r}x   32-align: {a / c!r}x ({card})",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
