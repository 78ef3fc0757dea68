"""Which ingredient of the resize kernel's launch form costs its band fetch:
the Y pass of a 2:1 tile over a 4K plane in seven forms, each adding one.

Port of ``scripts/exp_band_shape.py`` to one NVIDIA H100.  Kernel E,
``band_ydot(coef, src, form)`` (``libiqo_tpu_torch/csrc/exp/exp_band.cu``),
replaces ``build`` (``pl.pallas_call`` at ``:65`` for base/arb, ``:124``
for streams/vmem, ``:147`` for grid3/clamp/u8out).  Per row tile
``t < N_T`` of a (2160, 3840) u8 plane: ``r = C (32, 96) @ int8(src[64 t :
64 t + 96] ^ 0x80)``, exact in int32, and per form:

* ``base``: 2-D plane, r as (32 N_T, W) i32;
* ``arb``: the same function;
* ``grid3``: a (1, H, W) source, r as (1, 32 N_T, W) i32;
* ``clamp``: grid3 with the window start clamped to ``[0, H - 96]``;
* ``u8out``: ``r & 255`` as u8;
* ``streams``: ``(r + r0 + r1 + r2 + c0 + c1 + c2) & 255`` as u8, with
  ``r_k`` (32 N_T, 1) i32 per row and ``c_k`` (1, 1920) i32, column j
  reading ``c_k[j % 1920]`` (the script's ``concatenate([c_k] * 2)[:, :W]``);
* ``vmem``: streams plus ``int8(slab[0, j % 128])``, the 4.5 MB slab also
  copied into ``scratch`` once per launch; ``& 255`` stored in **i32**.

The script's ``vmem`` stores ``r & 255`` into an int32 output
(``odt`` is int32 unless the variant is u8out or streams, ``:86-87``) and
compares it with the unmasked base (``:223``), so it reports MISMATCHES on
any device; its output equals ``base & 255`` exactly with its zero
operands.  This probe holds vmem to what its kernel computes.  The script
feeds zeros to the streamed operands; the probe draws them nonzero from a
second seed (:func:`operands`), so that a mis-indexed operand shows on the
card; the times do not depend on their values.

Two implementations (:data:`IMPLS`, ``impl=`` of :func:`band_ydot`):

* ``"ring"`` (the default, ``csrc/exp/exp_band_ring.cu``): on this card the
  TPU's sequential grid ("arbitrary") and its parallel one are one schedule.
  A persistent grid of one block an SM walks runs of consecutive row tiles
  of a column chunk (and frame) in order (:mod:`.band_ring`: 990 items in
  runs of 7 or 8 on 132 SMs, wave efficiency 0.9375); a producer warp keeps
  the windows in flight by TMA, one 96-row box a window into a ring of 8
  stages (a block's whole run); two consumer warpgroups run the
  ``mma.sync`` s8 dots on alternate tiles.  So
  ``arb`` and ``base`` are the same kernel, and the seven forms differ only
  in their ingredients (3-D source, clamp, u8 store, streamed operands, slab
  copy), each a template flag.
* ``"sync"`` (``csrc/exp/exp_band.cu``, the first port): the launch forms
  carried over one to one.  base's grid of independent steps is one block
  per (row tile, column chunk of 128 columns): 33 x 30 = 990 blocks;
  ``arb``'s steps in order on one core are one block per column chunk (30
  blocks), looping over the 33 tiles; grid3 and after are one block per
  (tile, chunk) with ``blockIdx.z`` the tile.  Every Element window is
  synchronous loads into shared memory, one byte per thread per load as the
  resize kernel's ``load_rows``, then a barrier.

Each row times back-to-back launches on 8 sources that each differ in
``src[0, 0]`` (66 MB, more than the L2), as the script's loop perturbs
``x[0, 0]``, both implementations and the library call (``torch._int_mm``
over the windows laid out beforehand, :func:`library`) in turns, and holds
one output to the plain version.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_band_shape``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _harness, band_ring
from ._harness import HBM_BYTES_PER_S, INT8_OPS_PER_S, Launches

__all__ = ["FORMS", "IMPLS", "LAUNCHES", "StreamOperands", "band_dims", "band_ydot",
           "band_ydot_plain", "bound", "inputs", "issued_bytes", "launch_key", "library",
           "library_operand", "main", "operands", "ring_work"]

H, W = 2160, 3840
TH = 32                    # output rows per tile
STEP = 64                  # source rows per tile at 2:1
BAND = 96                  # window rows
N_T = (H - BAND) // STEP + 1
TW = 1920                  # width of the streamed column operands (:90)
SLAB_BYTES = 4718592       # vmem's resident slab, (36864, 128) int8 (:91)
SLAB_COLS = 128
CHUNK = 128                # source columns per block of kernel E
FORMS = ("base", "arb", "grid3", "clamp", "u8out", "streams", "vmem")
WORDS = "i32"              # the word-load form (exp_i32_band's build_i32)
ITERS = 8                  # sources per timed run (66 MB > L2)
IMPLS = band_ring.IMPLS


def launch_key(form: str, impl: str) -> str:
    """The :data:`LAUNCHES` key of a form: ``"<form>"`` for the sync
    implementation, ``"<form>[ring]"`` for the ring."""
    return form if impl == "sync" else f"{form}[{impl}]"


LAUNCHES = Launches(launch_key(f, i) for i in reversed(IMPLS) for f in FORMS + (WORDS,))
_FORM_ID = {f: i for i, f in enumerate(FORMS)}
_THREE_D = ("grid3", "clamp", "u8out", "streams", "vmem")
_STREAMED = ("streams", "vmem")
_CLAMPED = ("clamp", "u8out", "streams", "vmem")


def reset_launches() -> None:
    LAUNCHES.reset()


@dataclasses.dataclass(frozen=True)
class StreamOperands:
    """The streams/vmem forms' small operands: ``rows`` three (32 N_T, 1)
    int32, ``cols`` three (1, 1920) int32, ``slab`` (36864, 128) int8 (read
    by vmem only)."""
    rows: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    cols: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    slab: torch.Tensor


def operands(device, n_t: int | None = None, seed: int | None = None) -> StreamOperands:
    """The streamed operands for ``n_t`` tiles (N_T if None): zeros, as the
    script's ``main`` (``:199-202``), when ``seed`` is None; else drawn from
    ``seed``: rows and columns in [-2^20, 2^20), the slab over all of int8."""
    n_t = N_T if n_t is None else n_t
    if seed is None:
        rows = [np.zeros((n_t * TH, 1), np.int32) for _ in range(3)]
        cols = [np.zeros((1, TW), np.int32) for _ in range(3)]
        slab = np.zeros((SLAB_BYTES // SLAB_COLS, SLAB_COLS), np.int8)
    else:
        rng = np.random.default_rng(seed)
        rows = [rng.integers(-2**20, 2**20, (n_t * TH, 1), np.int32) for _ in range(3)]
        cols = [rng.integers(-2**20, 2**20, (1, TW), np.int32) for _ in range(3)]
        slab = rng.integers(-128, 128, (SLAB_BYTES // SLAB_COLS, SLAB_COLS), np.int8)
    to = lambda v: torch.from_numpy(v).to(device)  # noqa: E731
    return StreamOperands(tuple(map(to, rows)), tuple(map(to, cols)), to(slab))


def _check(coef: torch.Tensor, src: torch.Tensor, form: str,
           ops: StreamOperands | None) -> tuple[int, int, int]:
    """(frames, h, w) of a valid call; raises on anything else."""
    if form not in FORMS + (WORDS,):
        raise ValueError(f"forms are {FORMS + (WORDS,)}, got {form!r}")
    if tuple(coef.shape) != (TH, BAND) or coef.dtype != torch.int8:
        raise ValueError(f"coef must be ({TH}, {BAND}) int8, got "
                         f"{tuple(coef.shape)} {coef.dtype}")
    want = ((torch.int32, 2) if form == WORDS else
            (torch.uint8, 3) if form in _THREE_D else (torch.uint8, 2))
    if (src.dtype, src.ndim) != want:
        raise ValueError(f"{form} takes a {want[1]}-D {want[0]} source, got "
                         f"{tuple(src.shape)} {src.dtype}")
    frames = src.shape[0] if src.ndim == 3 else 1
    h, w = src.shape[-2], src.shape[-1] * (4 if form == WORDS else 1)
    if h < BAND:
        raise ValueError(f"the source needs >= {BAND} rows, got {h}")
    if form in _STREAMED:
        if ops is None:
            raise ValueError(f"{form} takes StreamOperands")
        n_t = (h - BAND) // STEP + 1
        for r in ops.rows:
            if tuple(r.shape) != (n_t * TH, 1) or r.dtype != torch.int32:
                raise ValueError(f"row operands must be ({n_t * TH}, 1) int32")
        for c in ops.cols:
            if tuple(c.shape) != (1, TW) or c.dtype != torch.int32:
                raise ValueError(f"column operands must be (1, {TW}) int32")
        if tuple(ops.slab.shape) != (SLAB_BYTES // SLAB_COLS, SLAB_COLS) or \
                ops.slab.dtype != torch.int8:
            raise ValueError("the slab must be (36864, 128) int8")
        if w > 2 * TW:
            raise ValueError(f"{form} reads its column operands twice over: "
                             f"W <= {2 * TW}, got {w}")
    return frames, h, w


def _offsets(h: int, clamp: bool) -> list[int]:
    n_t = (h - BAND) // STEP + 1
    hi = h - BAND
    return [max(0, min(hi, STEP * t)) if clamp else STEP * t for t in range(n_t)]


def _ydot(coef: torch.Tensor, plane: torch.Tensor, offs: list[int]) -> torch.Tensor:
    """C @ int8(window ^ 0x80) for every window, (len(offs) * 32, W) int64;
    float64 products of integers, exact (|sum| < 2^21)."""
    win = torch.stack([plane[o:o + BAND] for o in offs]).to(torch.float64) - 128.0
    r = torch.matmul(coef.to(torch.float64), win)
    return r.reshape(-1, plane.shape[-1]).to(torch.int64)


def band_ydot_plain(coef: torch.Tensor, src: torch.Tensor, form: str,
                    ops: StreamOperands | None = None,
                    scratch: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel E's function in plain PyTorch, exact in int64.  ``vmem`` also
    copies the slab into ``scratch`` where one is given, as the kernel does."""
    frames, h, w = _check(coef, src, form, ops)
    if form == WORDS:
        r = _ydot(coef, src.contiguous().view(torch.uint8), _offsets(h, False))
        perm = torch.cat([torch.arange(p, w, 4, device=src.device) for p in range(4)])
        return r[:, perm].to(torch.int32)
    planes = src if src.ndim == 3 else src[None]
    offs = _offsets(h, form in _CLAMPED)
    r = torch.stack([_ydot(coef, p, offs) for p in planes])
    if form in _STREAMED:
        r = r + sum(x.to(torch.int64) for x in ops.rows)
        r = r + torch.cat([sum(c.to(torch.int64) for c in ops.cols)] * 2, 1)[:, :w]
        if form == "vmem":
            r = r + ops.slab[0].to(torch.int64).repeat(w // SLAB_COLS + 1)[:w]
            if scratch is not None:
                scratch.copy_(ops.slab)
    if form in ("u8out", "streams", "vmem"):
        r = r & 255
    r = r.to(torch.uint8 if form in ("u8out", "streams") else torch.int32)
    return r if src.ndim == 3 else r[0]


@functools.cache
def band_dims() -> dict:
    """The tile constants compiled into kernels E and G, by name."""
    dims = (ctypes.c_int * 8)()
    _harness.check_rc(_harness.lib().iqo_exp_band_shape(dims), "band shape")
    return dict(zip(("TH", "STEP", "BAND", "G_TH", "G_STEP", "G_BAND", "G_KD", "CHUNK"),
                    dims))


@functools.cache
def ring_lib(device: torch.device):
    """The probes' library with the ring kernels' shared memory raised on
    ``device``, their compiled geometry checked against
    :data:`.band_ring.RING`."""
    lib_ = _harness.lib_with_setup("iqo_exp_band_ring_setup", device)
    got = (ctypes.c_int * 8)()
    lib_.iqo_exp_band_ring_shape(got)
    g = band_ring.RING
    want = [g.chunk, g.threads, g.groups_e, g.groups_g, g.stages_e, g.stages_g, g.smem_e,
            g.smem_g]
    if list(got) != want:
        raise RuntimeError(f"exp_band_ring.cu's geometry {list(got)} != the host's {want}")
    return lib_


def ring_work(form: str, h: int = H, w: int = W, frames: int = 1) -> band_ring.RingWork:
    """The ring form's items and windows (:mod:`.band_ring`)."""
    return band_ring.ydot_work(h, w, frames, form in _CLAMPED)


def band_ydot(coef: torch.Tensor, src: torch.Tensor, form: str,
              ops: StreamOperands | None = None,
              scratch: torch.Tensor | None = None, impl: str | None = None) -> torch.Tensor:
    """Kernel E: (frames, H, W) or (H, W) u8, or (H, W / 4) int32 for the
    ``"i32"`` form -> the Y pass of every full window (module docstring), in
    ``impl`` (:data:`IMPLS`, ``"ring"`` by default).  A CPU tensor takes
    :func:`band_ydot_plain`; a CUDA tensor launches the kernel (W a
    multiple of 128) or raises."""
    impl = band_ring.impl_of(impl)
    frames, h, w = _check(coef, src, form, ops)
    tensors = [coef, src]
    if form in _STREAMED:
        tensors += [*ops.rows, *ops.cols, ops.slab]
    if scratch is not None:
        tensors.append(scratch)
    if not _harness.on_card(*tensors):
        return band_ydot_plain(coef, src, form, ops, scratch)
    if w % CHUNK:
        raise ValueError(f"the kernel takes W a multiple of {CHUNK}, got {w}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("band_ydot takes contiguous tensors")
    dims = band_dims()
    if (dims["TH"], dims["STEP"], dims["BAND"], dims["CHUNK"]) != (TH, STEP, BAND, CHUNK):
        raise RuntimeError(f"kernel E's tile {dims} != {(TH, STEP, BAND, CHUNK)}")
    n_t = (h - BAND) // STEP + 1
    shape = (n_t * TH, w) if src.ndim == 2 else (frames, n_t * TH, w)
    out = torch.empty(shape, device=src.device,
                      dtype=torch.uint8 if form in ("u8out", "streams") else torch.int32)
    null = [None] * 3
    rows, cols = (ops.rows, ops.cols) if form in _STREAMED else (null, null)
    if form == "vmem" and scratch is None:
        scratch = torch.empty_like(ops.slab)
    if form == "vmem" and tuple(scratch.shape) != tuple(ops.slab.shape):
        raise ValueError("scratch must have the slab's shape")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    slab = (ptr(ops.slab), ptr(scratch), SLAB_BYTES) if form == "vmem" else (None, None, 0)
    if impl == "ring":
        sms = torch.cuda.get_device_properties(src.device).multi_processor_count
        rc = ring_lib(src.device).iqo_exp_band_ydot_ring(
            _FORM_ID.get(form, 0), int(form == WORDS), src.data_ptr(), frames, h, w,
            coef.data_ptr(), out.data_ptr(), *map(ptr, rows), *map(ptr, cols), *slab,
            band_ring.ring_ctas(ring_work(form, h, w, frames), sms), _harness.stream(src))
    else:
        rc = _harness.lib().iqo_exp_band_ydot(
            _FORM_ID.get(form, 0), int(form == WORDS), src.data_ptr(),
            h * w if src.ndim == 3 else 0, frames, h, w, coef.data_ptr(),
            out.data_ptr(), *map(ptr, rows), *map(ptr, cols), *slab, _harness.stream(src))
    _harness.check_rc(rc, f"band_ydot[{form}, {impl}]")
    LAUNCHES.add(launch_key(form, impl))
    return out


def inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's draws (``main``, ``:190-192``), from seed 0, in its
    order: coef (32, 96) int8 in [-64, 64), then src (H, W) uint8."""
    rng = np.random.default_rng(0)
    coef = rng.integers(-64, 64, (TH, BAND), np.int8)
    src = rng.integers(0, 256, (H, W), np.uint8)
    return torch.from_numpy(coef).to(device), torch.from_numpy(src).to(device)


def _rows_read(h: int) -> int:
    """Source rows some window reads: the union of the windows."""
    return (((h - BAND) // STEP) * STEP) + BAND


def bound(form: str, h: int = H, w: int = W) -> tuple[float, str, int, int, int]:
    """(ms, 'bytes' or 'operations', bytes, multiply-adds, bytes fetched):
    the least time of one launch, each input the form reads once (source
    rows in a window, coef, operands; vmem's slab) and each output written
    once (vmem's scratch too) at 3.35 TB/s, against two operations per
    multiply-add at the int8 peak; and the bytes the windows fetch, re-read
    rows counted again (the script's "MB band")."""
    n_t = (h - BAND) // STEP + 1
    nbytes = _rows_read(h) * w + TH * BAND
    nbytes += n_t * TH * w * (1 if form in ("u8out", "streams") else 4)
    if form in _STREAMED:
        nbytes += 3 * n_t * TH * 4 + 3 * min(w, TW) * 4
    if form == "vmem":
        nbytes += 2 * SLAB_BYTES
    macs = n_t * TH * BAND * w
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / INT8_OPS_PER_S * 1e3
    return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, macs,
            n_t * BAND * w)


def issued_bytes(form: str, impl: str = "ring", h: int = H, w: int = W, frames: int = 1,
                 sms: int = band_ring.H100_SMS) -> int:
    """Bytes the form's window fetches issue in one launch, from L2 or
    memory, computed from the launch form (not measured): both fetch every
    window whole (rows shared by two windows twice), ``sync`` by loads,
    ``ring`` by TMA (:func:`.band_ring.issued_bytes`)."""
    if band_ring.impl_of(impl) == "sync":
        return frames * ((h - BAND) // STEP + 1) * BAND * w
    work = ring_work(form, h, w, frames)
    return band_ring.issued_bytes(work, band_ring.ring_ctas(work, sms))


def library_operand(src: torch.Tensor) -> torch.Tensor:
    """The library call's right operand: the windows ``int8(src[64 t :
    64 t + 96] ^ 0x80)`` side by side, held column-major, (N_T W, 96)
    contiguous (its transpose is ``torch._int_mm``'s B)."""
    h, w = src.shape
    win = torch.stack([src[o:o + BAND] for o in _offsets(h, False)])
    return (win ^ 0x80).view(torch.int8).permute(0, 2, 1).reshape(-1, BAND).contiguous()


def library(coef: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Kernel E's dots as one PyTorch call: ``torch._int_mm(coef, wt.t())``,
    (32, N_T W) int32; :func:`library_rows` lays it out as ``base``'s."""
    return torch._int_mm(coef, wt.t())


def library_rows(r: torch.Tensor, w: int) -> torch.Tensor:
    """:func:`library`'s (32, n_t w) as ``base``'s output, (32 n_t, w)."""
    return r.view(TH, -1, w).transpose(0, 1).reshape(-1, w)


def main() -> dict:
    """Every form on card 0, both implementations and the library call in
    turns; returns {form: {"ring_ms", "sync_ms", "library_ms", "bound_ms",
    "bound_by", ...}}."""
    _harness.require_card()
    card = _harness.card()
    dev = torch.device("cuda", 0)
    coef, src = inputs(dev)
    ops = operands(dev, seed=1)
    wt = library_operand(src)
    if not torch.equal(library_rows(library(coef, wt), W), band_ydot_plain(coef, src, "base")):
        raise AssertionError("torch._int_mm over the windows differs from the plain version")
    wts = _harness.perturbed(wt, ITERS)
    rows = {}
    for form in FORMS:
        xs = _harness.perturbed(src[None] if form in _THREE_D else src, ITERS)
        o = ops if form in _STREAMED else None
        scratch = torch.empty_like(ops.slab) if form == "vmem" else None
        want = band_ydot_plain(coef, xs[-1], form, o)
        calls = {}
        for impl in IMPLS:
            if not torch.equal(band_ydot(coef, xs[-1], form, o, scratch, impl), want):
                raise AssertionError(f"{form} {impl}: kernel differs from its plain version")
            calls[impl] = (functools.partial(
                lambda x, i: band_ydot(coef, x, form, o, scratch, i), i=impl), xs)
        calls["library"] = (lambda t: library(coef, t), wts)
        ms = _harness.turns_ms(calls)
        b_ms, by, nbytes, macs, fetched = bound(form)
        lib_ms = ms["library"]
        print(f"{form:7s}: ring {ms['ring'] * 1e3!r} us, sync {ms['sync'] * 1e3!r} us, "
              f"library torch._int_mm {lib_ms * 1e3!r} us (values ok); bound "
              f"{b_ms * 1e3!r} us ({by}: {nbytes} B read once and written once); "
              f"ring/bound {ms['ring'] / b_ms!r}, ring/library {ms['ring'] / lib_ms!r}, "
              f"sync/library {ms['sync'] / lib_ms!r}; issued MB ring "
              f"{issued_bytes(form) / 1e6!r}, sync {fetched / 1e6!r} ({card})", flush=True)
        rows[form] = {"ring_ms": ms["ring"], "sync_ms": ms["sync"], "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": by, "bytes": nbytes, "macs": macs,
                      "fetched": fetched, "issued": issued_bytes(form)}
    for impl in IMPLS:
        k = f"{impl}_ms"
        print(f"{impl}: arb/base {rows['arb'][k] / rows['base'][k]!r}, "
              f"streams/u8out {rows['streams'][k] / rows['u8out'][k]!r}, "
              f"vmem/streams {rows['vmem'][k] / rows['streams'][k]!r} ({card})", flush=True)
    runs = band_ring.run_lengths(ring_work("base"))
    print(f"ring: {len(runs)} blocks, runs of {min(runs)}-{max(runs)} items, wave "
          f"efficiency {band_ring.wave_efficiency(ring_work('base'))!r} ({card})", flush=True)
    return rows


if __name__ == "__main__":
    main()
