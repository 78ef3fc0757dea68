"""Does the band fetch overlap the dots on the card: time(P) of a windowed
Y pass with P s8 dots per tile, in four launch forms.

Port of ``scripts/exp_overlap.py`` to one NVIDIA H100.  Kernel G,
``overlap_dots(src, coef, variant, p)`` (``libiqo_tpu_torch/csrc/exp/
exp_band.cu``), replaces ``build`` (``pl.pallas_call`` at ``:82``).  Per row
tile ``t < N_TY = 12`` of a (2160, 3840) u8 plane, a window of 208 rows at
``max(0, min(1952, 192 t))`` (the script's ``CLAMP_HI``, ``(H - 208) // 32 *
32``), of which the dots read the first ``ND = 1920`` columns:

* P = 0: ``out[96 t : 96 t + 96] = window[:96, :1920]``;
* P >= 1: ``out = (sum_{i < P} C (96, 128) @ int8(window[8 i : 8 i + 128,
  :1920])) & 255``, the u8 -> int8 cast wrapping (the script applies no
  ``^ 0x80``); (1152, 1920) u8.

``time(P) ~ fetch + P * dot`` means fetch and dots run in turn;
``~ max(fetch, P * dot)`` means they overlap.  The variants and their
Hopper launch forms (column chunks of 128 columns, 15 per row):

* ``elem``: the script's Element window on its sequential grid: one block
  per column chunk (15 blocks) looping over the 12 tiles, each window
  fetched by synchronous 16-byte loads into shared memory, then a barrier;
* ``elem-b2``: the same loop with ``Buffered(2)``: a ``cp.async`` double
  buffer that fetches tile t + 1's window while tile t computes;
* ``blocked``: the loop on disjoint 192-row blocks at ``192 t`` (no halo,
  no clamp; a control, not a resize), fetched as ``elem``.  Its last block
  runs past the plane (rows 2112-2303 of 2160): the TPU leaves those rows
  undefined, the script's interpret mode reads them as zeros, and this
  probe defines them as zeros, which the kernel writes itself;
* ``parallel``: one block per (tile, chunk), 180 blocks, synchronous loads.

Two implementations (:data:`IMPLS`, ``impl=`` of :func:`overlap_dots`):

* ``"ring"`` (the default, ``csrc/exp/exp_band_ring.cu``): on this card the
  sequential grid and the parallel one are one schedule, so ``elem``,
  ``elem-b2`` and ``parallel`` launch one kernel (they compute one function)
  and ``blocked`` its 192-row form.  A persistent grid of one block an SM
  walks runs of (chunk, tile, 64-column side) items in order
  (:mod:`.band_ring`: 360 items, runs of 2 or 3 on 132 SMs, wave efficiency
  0.909, where whole chunks would give 1 or 2); a producer warp keeps the
  windows in flight by TMA (one box a window into a ring of 4 stages, both
  sides of a tile reading one; rows past the plane arrive as zeros), while
  four groups of two consumer warps run the P ``mma.sync`` s8 dots of the
  items in turn on the windows that have landed, each warp all 96 output
  rows of its 32 columns.
* ``"sync"`` (``csrc/exp/exp_band.cu``, the first port): the four launch
  forms above, one to one.

Every form fetches the whole window (208 or 192 rows) whatever P reads, so
the fetch stays fixed as P grows, and the P products stay P products (P is
the probe's knob).  Each row times back-to-back launches on 8 sources that
each differ in ``src[0, 0]`` (66 MB), both implementations and, for P >= 1,
the library call (``torch._int_mm`` of [C] x P over the slices stacked
beforehand, :func:`library`) in turns, and prints the script's "+x vs P=0"
column.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_overlap``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _harness, band_ring
from ._harness import HBM_BYTES_PER_S, INT8_OPS_PER_S, Launches
from .band_ring import IMPLS
from .exp_band_shape import band_dims, ring_lib

__all__ = ["IMPLS", "LAUNCHES", "PS", "VARIANTS", "bound", "inputs", "issued_bytes",
           "launch_key", "library", "library_operand", "library_rows", "main",
           "overlap_dots", "overlap_dots_plain", "ring_work"]

H, W = 2160, 3840
TH = 96                    # output rows per tile
STEP = 192                 # 2:1 vertical
BAND_H = 208               # window rows
KD, ND = 128, 1920         # per dot: (TH, KD) @ (KD, ND)
N_TY = (1080 + TH - 1) // TH
CHUNK = 128
VARIANTS = ("elem", "elem-b2", "blocked", "parallel")
PS = (0, 1, 2, 4, 8)
ITERS = 8


def launch_key(variant: str, p: int, impl: str) -> str:
    """The :data:`LAUNCHES` key: ``"<variant>,P=<p>"`` for the sync
    implementation, ``"<variant>,P=<p>[ring]"`` for the ring."""
    return f"{variant},P={p}" if impl == "sync" else f"{variant},P={p}[{impl}]"


LAUNCHES = Launches(launch_key(v, p, i) for i in reversed(IMPLS) for v in VARIANTS for p in PS)


def reset_launches() -> None:
    LAUNCHES.reset()


def _geometry(src, coef, variant, p, nd, n_ty) -> tuple[int, int]:
    if variant not in VARIANTS:
        raise ValueError(f"variants are {VARIANTS}, got {variant!r}")
    if src.dtype != torch.uint8 or src.ndim != 2:
        raise ValueError(f"src must be (H, W) uint8, got {tuple(src.shape)} {src.dtype}")
    if tuple(coef.shape) != (TH, KD) or coef.dtype != torch.int8:
        raise ValueError(f"coef must be ({TH}, {KD}) int8, got "
                         f"{tuple(coef.shape)} {coef.dtype}")
    rows = STEP if variant == "blocked" else BAND_H
    if p < 0 or 8 * (p - 1) + KD > rows:
        raise ValueError(f"P={p}: the dots would read past a {rows}-row window")
    if nd > src.shape[1] or n_ty < 1:
        raise ValueError(f"nd={nd} > W={src.shape[1]} or n_ty={n_ty} < 1")
    if variant != "blocked" and src.shape[0] < BAND_H:
        raise ValueError(f"{variant} needs >= {BAND_H} rows, got {src.shape[0]}")
    return rows, (src.shape[0] - BAND_H) // 32 * 32


def _offset(variant: str, t: int, clamp_hi: int) -> int:
    return STEP * t if variant == "blocked" else max(0, min(clamp_hi, STEP * t))


def overlap_dots_plain(src: torch.Tensor, coef: torch.Tensor, variant: str, p: int,
                       nd: int | None = None, n_ty: int | None = None) -> torch.Tensor:
    """Kernel G's function in plain PyTorch: float64 products of integers,
    exact (|sum| < 2^24), then ``& 255``.  Rows past the plane are zeros."""
    nd, n_ty = ND if nd is None else nd, N_TY if n_ty is None else n_ty
    rows, clamp_hi = _geometry(src, coef, variant, p, nd, n_ty)
    wins = []
    for t in range(n_ty):
        win = src[_offset(variant, t, clamp_hi):][:rows, :nd]
        if win.shape[0] < rows:
            win = torch.cat([win, win.new_zeros((rows - win.shape[0], nd))])
        wins.append(win)
    wins = torch.stack(wins)                                  # (n_ty, rows, nd)
    if p == 0:
        return wins[:, :TH].reshape(n_ty * TH, nd).clone()
    c = coef.to(torch.float64)
    acc = sum(torch.matmul(c, wins[:, 8 * i:8 * i + KD].view(torch.int8).to(torch.float64))
              for i in range(p))
    return (acc.to(torch.int64) & 255).to(torch.uint8).reshape(n_ty * TH, nd)


@functools.cache
def _lib_for(device: torch.device):
    """The probes' library with kernel G's shared-memory limit raised on
    ``device``, its tile checked against this module's."""
    dims = band_dims()
    if (dims["G_TH"], dims["G_STEP"], dims["G_BAND"], dims["G_KD"], dims["CHUNK"]) != \
            (TH, STEP, BAND_H, KD, CHUNK):
        raise RuntimeError(f"kernel G's tile {dims} != {(TH, STEP, BAND_H, KD, CHUNK)}")
    return _harness.lib_with_setup("iqo_exp_overlap_setup", device)


def ring_work(variant: str, h: int = H, nd: int = ND,
              n_ty: int = N_TY) -> band_ring.RingWork:
    """The ring form's items and windows (:mod:`.band_ring`)."""
    return band_ring.overlap_work(variant, h, nd, n_ty)


def overlap_dots(src: torch.Tensor, coef: torch.Tensor, variant: str, p: int,
                 nd: int | None = None, n_ty: int | None = None,
                 impl: str | None = None) -> torch.Tensor:
    """Kernel G: src (H, W) u8, coef (96, 128) int8 -> (96 n_ty, nd) u8
    (``nd`` ND and ``n_ty`` N_TY if None), in ``impl`` (:data:`IMPLS`,
    ``"ring"`` by default).  A CPU tensor takes :func:`overlap_dots_plain`;
    a CUDA tensor launches the kernel (nd a multiple of 128, W of 16) or
    raises."""
    nd, n_ty = ND if nd is None else nd, N_TY if n_ty is None else n_ty
    impl = band_ring.impl_of(impl)
    _geometry(src, coef, variant, p, nd, n_ty)
    if not _harness.on_card(src, coef):
        return overlap_dots_plain(src, coef, variant, p, nd, n_ty)
    if nd % CHUNK or src.shape[1] % 16:
        raise ValueError(f"the kernel takes nd a multiple of {CHUNK} and W of 16, "
                         f"got nd={nd} W={src.shape[1]}")
    if not (src.is_contiguous() and coef.is_contiguous()):
        raise ValueError("overlap_dots takes contiguous tensors")
    out = torch.empty((n_ty * TH, nd), dtype=torch.uint8, device=src.device)
    if impl == "ring":
        sms = torch.cuda.get_device_properties(src.device).multi_processor_count
        rc = ring_lib(src.device).iqo_exp_overlap_ring(
            int(variant == "blocked"), p, src.data_ptr(), src.shape[0], src.shape[1],
            coef.data_ptr(), out.data_ptr(), nd, n_ty,
            band_ring.ring_ctas(ring_work(variant, src.shape[0], nd, n_ty), sms),
            _harness.stream(src))
    else:
        rc = _lib_for(src.device).iqo_exp_overlap(
            VARIANTS.index(variant), p, src.data_ptr(), src.shape[0], src.shape[1],
            coef.data_ptr(), out.data_ptr(), nd, n_ty, _harness.stream(src))
    _harness.check_rc(rc, f"overlap_dots[{variant}, P={p}, {impl}]")
    LAUNCHES.add(launch_key(variant, p, impl))
    return out


def inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's draws (``main``, ``:126-129``), from seed 0, in its
    order: src (H, W) uint8, then coef (96, 128) int8 in [-64, 64)."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (H, W), np.uint8)
    coef = rng.integers(-64, 64, (TH, KD)).astype(np.int8)
    return torch.from_numpy(src).to(device), torch.from_numpy(coef).to(device)


def _union(ranges) -> int:
    n, end = 0, -1
    for a, b in sorted(ranges):
        if b > end:
            n += b - max(a, end)
            end = b
    return n


def bound(variant: str, p: int, h: int = H, nd: int = ND,
          n_ty: int = N_TY) -> tuple[float, str, int, int, int]:
    """(ms, 'bytes' or 'operations', bytes, multiply-adds, bytes fetched) of
    one launch: the source rows the function reads (P = 0: 96 per window,
    else 8 (P - 1) + 128; rows past the plane are not read) at nd columns,
    coef and the output once each at 3.35 TB/s, against two operations per
    multiply-add at the int8 peak; and the bytes the kernel fetches (whole
    windows at nd columns)."""
    rows = STEP if variant == "blocked" else BAND_H
    clamp_hi = (h - BAND_H) // 32 * 32
    used = TH if p == 0 else 8 * (p - 1) + KD
    offs = [_offset(variant, t, clamp_hi) for t in range(n_ty)]
    nbytes = _union((o, min(o + used, h)) for o in offs if o < h) * nd
    nbytes += (TH * KD if p else 0) + n_ty * TH * nd
    macs = n_ty * p * TH * KD * nd
    fetched = sum(max(0, min(o + rows, h) - o) for o in offs) * nd
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / INT8_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, macs, fetched


def issued_bytes(variant: str, impl: str = "ring", h: int = H, nd: int = ND,
                 n_ty: int = N_TY, sms: int = band_ring.H100_SMS) -> int:
    """Bytes the window fetches issue in one launch, from L2 or memory,
    computed from the launch form (not measured): ``sync`` every window whole
    at nd columns (rows past the plane not fetched), ``ring`` every window
    of each block's run, whole, rows past the plane included
    (:func:`.band_ring.issued_bytes`)."""
    if band_ring.impl_of(impl) == "sync":
        return bound(variant, 0, h, nd, n_ty)[4]
    work = ring_work(variant, h, nd, n_ty)
    return band_ring.issued_bytes(work, band_ring.ring_ctas(work, sms))


def library_operand(src: torch.Tensor, variant: str, p: int, nd: int | None = None,
                    n_ty: int | None = None) -> torch.Tensor:
    """The library call's right operand at P >= 1: slice i of every window,
    ``int8(window_t[8 i : 8 i + 128, :nd])``, the P slices stacked along K
    and the windows side by side along N, held column-major: (n_ty nd,
    128 P) contiguous (its transpose is ``torch._int_mm``'s B).  Rows past
    the plane are zeros."""
    nd, n_ty = ND if nd is None else nd, N_TY if n_ty is None else n_ty
    rows, clamp_hi = _geometry(src, torch.zeros((TH, KD), dtype=torch.int8), variant, p,
                               nd, n_ty)
    h = src.shape[0]
    pad = torch.cat([src[:, :nd], src.new_zeros((max(0, STEP * (n_ty - 1) + rows - h), nd))])
    win = torch.stack([pad[_offset(variant, t, clamp_hi):][:rows] for t in range(n_ty)])
    sl = torch.cat([win[:, 8 * i:8 * i + KD] for i in range(p)], dim=1)   # (n_ty, 128 P, nd)
    return sl.view(torch.int8).permute(0, 2, 1).reshape(n_ty * nd, KD * p).contiguous()


def library(coef: torch.Tensor, st: torch.Tensor) -> torch.Tensor:
    """Kernel G's P dots as one PyTorch call: ``torch._int_mm([C] x P,
    st.t())``, (96, n_ty nd) int32, the sum before the ``& 255``."""
    p = st.shape[1] // KD
    return torch._int_mm(coef.repeat(1, p), st.t())


def library_rows(r: torch.Tensor, nd: int | None = None) -> torch.Tensor:
    """:func:`library`'s sums as kernel G's output: ``& 255`` as u8,
    (96 n_ty, nd)."""
    nd = ND if nd is None else nd
    return (r & 255).to(torch.uint8).view(TH, -1, nd).transpose(0, 1).reshape(-1, nd)


def main() -> dict:
    """Every variant and P on card 0, both implementations and (P >= 1) the
    library call in turns; returns {"<variant> P=<p>": {"ring_ms",
    "sync_ms", "library_ms", ...}}."""
    _harness.require_card()
    card = _harness.card()
    src, coef = inputs(torch.device("cuda", 0))
    xs = _harness.perturbed(src, ITERS)
    found = {}
    for variant in VARIANTS:
        base = None
        for p in PS:
            want = overlap_dots_plain(xs[-1], coef, variant, p)
            calls = {}
            for impl in IMPLS:
                if not torch.equal(overlap_dots(xs[-1], coef, variant, p, impl=impl), want):
                    raise AssertionError(f"{variant} P={p} {impl}: kernel differs from its "
                                         f"plain version")
                calls[impl] = (functools.partial(
                    lambda x, i: overlap_dots(x, coef, variant, p, impl=i), i=impl), xs)
            if p:
                st = library_operand(xs[-1], variant, p)
                if not torch.equal(library_rows(library(coef, st)), want):
                    raise AssertionError(f"{variant} P={p}: torch._int_mm over the stacked "
                                         f"slices differs from the plain version")
                calls["library"] = (lambda t: library(coef, t), _harness.perturbed(st, ITERS))
            ms = _harness.turns_ms(calls)
            lib_ms = ms.get("library")
            base = ms if base is None else base
            b_ms, by, nbytes, macs, fetched = bound(variant, p)
            lib = (f"library torch._int_mm of [C]*{p} {lib_ms * 1e3!r} us, ring/library "
                   f"{ms['ring'] / lib_ms!r}" if p else "no library call at P=0")
            over = {i: (ms[i] - base[i]) * 1e3 for i in IMPLS}
            print(f"{variant:9s} P={p}: ring {ms['ring'] * 1e3!r} us (+{over['ring']!r} vs P=0), "
                  f"sync {ms['sync'] * 1e3!r} us (+{over['sync']!r}); "
                  f"{lib}; bound {b_ms * 1e3!r} us ({by}), ring/bound {ms['ring'] / b_ms!r} "
                  f"({card})", flush=True)
            found[f"{variant} P={p}"] = {
                "ring_ms": ms["ring"], "sync_ms": ms["sync"], "library_ms": lib_ms,
                "ring_over_p0_ms": ms["ring"] - base["ring"],
                "sync_over_p0_ms": ms["sync"] - base["sync"], "bound_ms": b_ms,
                "bound_by": by, "bytes": nbytes, "macs": macs, "fetched": fetched,
                "issued": issued_bytes(variant)}
    work = ring_work("elem")
    runs = band_ring.run_lengths(work)
    print(f"ring: {len(runs)} blocks, runs of {min(runs)}-{max(runs)} items, wave efficiency "
          f"{band_ring.wave_efficiency(work)!r}; issued MB ring {issued_bytes('elem') / 1e6!r} "
          f"(blocked {issued_bytes('blocked') / 1e6!r}), sync "
          f"{issued_bytes('elem', 'sync') / 1e6!r} ({card})", flush=True)
    return found


if __name__ == "__main__":
    main()
