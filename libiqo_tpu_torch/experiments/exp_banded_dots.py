"""What the Y dot and the X dots of a 4K Lanczos3 tile cost on the card's
tensor cores: monolithic against block-banded, and each pass skipped.

Port of ``scripts/exp_banded_dots.py`` to one NVIDIA H100.  Kernel D,
``banded_tile(ops, band, ymode, xmode, form)``, replaces ``make``
(``pl.pallas_call`` at ``:92``) in all nine (Y, X) modes of ``:150-155``, in
two forms (:data:`FORMS`): ``"wgmma"``, the default
(``libiqo_tpu_torch/csrc/exp/exp_banded_wgmma.cu``: a transposed Y GEMM on
wgmma into int16 work rows, then a persistent X GEMM on wgmma fed by a TMA
ring, its walk and model in :mod:`.banded_wgmma`), and ``"sync"``, PR 5's
(``exp_banded.cu``: a block of 16 output rows a tile on ``mma.sync``).  Per
tile of ``band`` (GRID, 336, 896) u8:

* Y: ``w = int32(cy @ band)`` (``mono``), or each group of 40 rows over its
  96 band rows only (``grouped``, ``:39``), or ``band[:160] * 37``
  (``skip``); then ``w = wrap16(w)``, ``b = ((w + 128) & 255) - 128``,
  ``a = (w - b) >> 8``;
* X: ``65280 * D0 - 255 * D1 + 256 * D2`` with int32 wraps, ``Dp = int32``
  of ``(a, b, a + b) @ cxp`` in bf16 with f32 sums (``mono``), or each group
  of 128 columns over its 384 work columns (``grouped``, ``:40``), or
  ``a * 65280 + b * 256`` on the first 384 columns (``skip``);
* ``out = clip(wrap16((sums + 2^19) >> 20), 0, 255)``, (GRID, 160, 384) u8.

The coefficients are packed once (:func:`pack`: ``cy`` as it is, each
``cxp`` K-major), as the TPU kernel copies them into VMEM once per call.
The nine modes compute different functions on these dense random
coefficients, so each is held to its own plain version, never to another
mode.  Each row times both forms in turns (back-to-back launches on band
stacks that each differ in ``band[0, 0, 0]``, ``bench``, ``:116-145``) and
reports ms per 35-tile frame beside its bound.  :data:`LAUNCHES` counts the
``sync`` form under ``"y,x"`` and the ``wgmma`` form, one count a call of its
two kernels, under ``"y,x[wgmma]"``.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_banded_dots``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _harness, banded_wgmma
from ._harness import BF16_OPS_PER_S, HBM_BYTES_PER_S, Launches, wrap

__all__ = ["FORMS", "LAUNCHES", "MODES", "PAIRS", "BandedOperands", "banded_tile",
           "banded_tile_plain", "launch_key", "main", "pack"]

TH, BH, BW, TW = 160, 336, 896, 384
GRID = 35                  # 7 x 5 tiles per 4K -> 1080p frame
MODES = ("mono", "grouped", "skip")
PAIRS = (("mono", "mono"), ("grouped", "mono"), ("mono", "grouped"),
         ("grouped", "grouped"), ("skip", "mono"), ("skip", "grouped"),
         ("mono", "skip"), ("grouped", "skip"), ("skip", "skip"))
# the script's groups, (out0, out_len, k0, k_len) (exp_banded_dots.py:39-40)
YGRP = tuple((g * 40, 40, min(g * 80, BH - 96), 96) for g in range(4))
XGRP = tuple((g * 128, 128, max(0, 256 * g - 128), 384) for g in range(3))
XWEIGHTS = (65280, -255, 256)
ITERS = 8                  # band stacks per timed run (84 MB > L2)
_F32_EXACT = 2**24
FORMS = ("wgmma", "sync")  # the first is the default


def launch_key(ymode: str, xmode: str, form: str) -> str:
    """The :data:`LAUNCHES` key of a mode pair's form: ``"y,x"`` for the
    ``sync`` form, ``"y,x[wgmma]"`` for the ``wgmma`` form."""
    return f"{ymode},{xmode}" + ("" if form == "sync" else f"[{form}]")


LAUNCHES = Launches(launch_key(y, x, f) for f in reversed(FORMS) for y, x in PAIRS)


def reset_launches() -> None:
    LAUNCHES.reset()


@dataclasses.dataclass(frozen=True)
class BandedOperands:
    """The coefficients as kernel D reads them: ``cy`` (160, 336) bf16 and
    ``cxt`` three (384, 896) bf16 planes, each ``cxp`` K-major."""
    cy: torch.Tensor
    cxt: tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def pack(cy: torch.Tensor, cx0: torch.Tensor, cx1: torch.Tensor,
         cx2: torch.Tensor) -> BandedOperands:
    """Lay the script's coefficients (``cy`` (160, 336), ``cxp`` (896, 384),
    bf16, on one device) out for kernel D, once."""
    for name, t, shape in (("cy", cy, (TH, BH)), ("cx0", cx0, (BW, TW)),
                           ("cx1", cx1, (BW, TW)), ("cx2", cx2, (BW, TW))):
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be {shape} bfloat16, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _harness.on_card(cy, cx0, cx1, cx2)
    return BandedOperands(cy.contiguous(),
                          tuple(c.t().contiguous() for c in (cx0, cx1, cx2)))


def _exact_dot(a: torch.Tensor, b: torch.Tensor, what: str) -> torch.Tensor:
    """a @ b in float64 on integer values, as int64, with every output's sum
    of |terms| asserted below 2^24: the f32 sums of the kernel and of JAX
    are then exact whatever their order."""
    worst = float(torch.matmul(a.abs(), b.abs()).max()) if a.numel() else 0.0
    if worst >= _F32_EXACT:
        raise ValueError(f"{what}: a sum of |terms| reaches {worst}, not below "
                         "2^24: f32 sums would depend on their order")
    return torch.matmul(a, b).to(torch.int64)


def banded_tile_plain(ops: BandedOperands, band: torch.Tensor, ymode: str,
                      xmode: str) -> torch.Tensor:
    """Kernel D's function in plain PyTorch, exact in int64 (products in
    float64 on integers) with explicit wraps."""
    _check_modes(ymode, xmode)
    bandf = band.to(torch.float64)
    cy = ops.cy.to(torch.float64)
    if ymode == "mono":
        w = _exact_dot(cy, bandf, "Y")
    elif ymode == "grouped":
        w = torch.cat([_exact_dot(cy[o0:o0 + ol, k0:k0 + kl],
                                  bandf[:, k0:k0 + kl, :], "Y")
                       for o0, ol, k0, kl in YGRP], dim=1)
    else:
        w = band[:, :TH, :].to(torch.int64) * 37
    w = wrap(w, 16)
    b = ((w + 128) & 255) - 128
    a = (w - b) >> 8
    if xmode == "skip":
        sums = a[..., :TW] * 65280 + b[..., :TW] * 256
    else:
        planes = [p.to(torch.float64) for p in (a, b, a + b)]
        cxs = [c.to(torch.float64).t() for c in ops.cxt]
        sums = 0
        for plane, cx, weight in zip(planes, cxs, XWEIGHTS):
            if xmode == "mono":
                d = _exact_dot(plane, cx, "X")
            else:
                d = torch.cat([_exact_dot(plane[..., k0:k0 + kl],
                                          cx[k0:k0 + kl, o0:o0 + ol], "X")
                               for o0, ol, k0, kl in XGRP], dim=-1)
            sums = sums + wrap(d, 32) * weight
    sums = wrap(sums, 32)
    v = wrap(sums + (1 << 19), 32) >> 20
    return wrap(v, 16).clamp(0, 255).to(torch.uint8)


def _check_modes(ymode: str, xmode: str) -> None:
    if ymode not in MODES or xmode not in MODES:
        raise ValueError(f"modes are {MODES}, got {ymode!r}, {xmode!r}")


@functools.cache
def _lib_for(device: torch.device):
    """The probes' library with kernel D's shared-memory limit raised on
    ``device``, its tile shape checked against this module's."""
    lib = _harness.lib()
    dims = [ctypes.c_int() for _ in range(4)]
    lib.iqo_exp_banded_shape(*map(ctypes.byref, dims))
    if tuple(d.value for d in dims) != (TH, BH, BW, TW):
        raise RuntimeError(f"kernel D's tile {[d.value for d in dims]} != "
                           f"{(TH, BH, BW, TW)}")
    return _harness.lib_with_setup("iqo_exp_banded_setup", device)


def _form(form: str | None) -> str:
    if form is None:
        return FORMS[0]
    if form not in FORMS:
        raise ValueError(f"banded_tile's forms are {FORMS}, got {form!r}")
    return form


@functools.cache
def _wgmma_lib(device: torch.device):
    """The probes' library with the wgmma form's shared memory raised on
    ``device``, its geometry checked against :mod:`.banded_wgmma`'s."""
    lib = _harness.lib_with_setup("iqo_exp_banded_wgmma_setup", device)
    banded_wgmma.check_shape(lib)
    return lib


def banded_tile(ops: BandedOperands, band: torch.Tensor, ymode: str,
                xmode: str, form: str | None = None) -> torch.Tensor:
    """Kernel D: band (tiles, 336, 896) u8 -> (tiles, 160, 384) u8, in
    ``form`` (:data:`FORMS`, ``"wgmma"`` if None).  A CPU tensor takes
    :func:`banded_tile_plain`; a CUDA tensor launches the kernel or raises."""
    _check_modes(ymode, xmode)
    form = _form(form)
    if band.dtype != torch.uint8 or band.ndim != 3 or tuple(band.shape[1:]) != (BH, BW):
        raise ValueError(f"band must be (tiles, {BH}, {BW}) uint8, got "
                         f"{tuple(band.shape)} {band.dtype}")
    if not _harness.on_card(band, ops.cy):
        return banded_tile_plain(ops, band, ymode, xmode)
    if not band.is_contiguous():
        raise ValueError("banded_tile takes a contiguous band")
    if form == "wgmma":
        return _banded_wgmma(ops, band, ymode, xmode)
    lib = _lib_for(band.device)
    out = torch.empty((band.shape[0], TH, TW), dtype=torch.uint8, device=band.device)
    _harness.check_rc(lib.iqo_exp_banded(
        MODES.index(ymode), MODES.index(xmode), band.data_ptr(),
        ops.cy.data_ptr(), *(c.data_ptr() for c in ops.cxt), out.data_ptr(),
        band.shape[0], _harness.stream(band)), "banded_tile")
    LAUNCHES.add(launch_key(ymode, xmode, "sync"))
    return out


def _banded_wgmma(ops: BandedOperands, band: torch.Tensor, ymode: str,
                  xmode: str) -> torch.Tensor:
    """The wgmma form's two launches: Y into int16 work rows (or, with X
    skip, into the output), then X; grids from :mod:`.banded_wgmma`."""
    tiles, dev = band.shape[0], band.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    xskip = xmode == "skip"
    work = None if xskip else torch.empty((tiles * TH, BW), dtype=torch.int16, device=dev)
    out = torch.empty((tiles, TH, TW), dtype=torch.uint8, device=dev)
    _harness.check_rc(_wgmma_lib(dev).iqo_exp_banded_wgmma(
        MODES.index(ymode), MODES.index(xmode), band.data_ptr(), ops.cy.data_ptr(),
        *(c.data_ptr() for c in ops.cxt), None if work is None else work.data_ptr(),
        out.data_ptr(), tiles, banded_wgmma.y_ctas(tiles, xskip, sms),
        0 if xskip else banded_wgmma.x_ctas(tiles, sms), _harness.stream(band)),
        "banded_tile[wgmma]")
    LAUNCHES.add(launch_key(ymode, xmode, "wgmma"))
    return out


def inputs(device, tiles: int | None = None):
    """The script's inputs (``bench``, ``:116-122``), from seed 0: band
    (tiles, 336, 896) u8, cy in [-64, 64) and cx0..2 in [-128, 128) as
    bf16."""
    rng = np.random.default_rng(0)
    tiles = GRID if tiles is None else tiles
    band = torch.from_numpy(rng.integers(0, 256, (tiles, BH, BW), np.uint8))
    bf = lambda v: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    cy = bf(rng.integers(-64, 64, (TH, BH)))
    cxs = [bf(rng.integers(-128, 128, (BW, TW))) for _ in range(3)]
    return band.to(device), cy.to(device), [c.to(device) for c in cxs]


def macs(ymode: str, xmode: str, tiles: int | None = None) -> int:
    """Multiply-adds of one launch on ``tiles`` tiles (GRID if None)."""
    tiles = GRID if tiles is None else tiles
    y = {"mono": TH * BH * BW, "grouped": sum(ol * kl for _, ol, _, kl in YGRP) * BW,
         "skip": 0}[ymode]
    x = {"mono": 3 * TH * BW * TW,
         "grouped": 3 * TH * sum(ol * kl for _, ol, _, kl in XGRP), "skip": 0}[xmode]
    return tiles * (y + x)


def bound(ymode: str, xmode: str, tiles: int | None = None) -> tuple[float, str, int, int]:
    """(ms, 'bytes' or 'operations', bytes, multiply-adds): the least time
    of one launch, each input the mode reads once and the output once at
    3.35 TB/s, two operations per multiply-add at the bf16 peak."""
    tiles = GRID if tiles is None else tiles
    nbytes = tiles * (BH * BW + TH * TW)
    nbytes += (TH * BH * 2 if ymode != "skip" else 0) + (3 * BW * TW * 2 if xmode != "skip" else 0)
    m = macs(ymode, xmode, tiles)
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * m / BF16_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, m


def main() -> dict:
    """Every mode in both forms on card 0, timed in turns; returns {"y=..
    x=..": {ms (wgmma), ms_sync, bound_ms, ...}}."""
    _harness.require_card()
    card = _harness.card()
    band, cy, cxs = inputs(torch.device("cuda", 0))
    ops = pack(cy, *cxs)
    bands = _harness.perturbed(band, ITERS)
    rows = {}
    for ym, xm in PAIRS:
        name = f"y={ym} x={xm}"
        want = banded_tile_plain(ops, bands[-1], ym, xm)
        for form in FORMS:
            if not torch.equal(banded_tile(ops, bands[-1], ym, xm, form), want):
                raise AssertionError(f"{name} [{form}]: kernel differs from its plain version")
        ms = _harness.turns_ms({
            form: (lambda b, f=form: banded_tile(ops, b, ym, xm, f), bands) for form in FORMS})
        b_ms, by, nbytes, m = bound(ym, xm)
        print(f"{name:22s}: wgmma {ms['wgmma']!r} ms/frame, sync {ms['sync']!r} ms/frame, in "
              f"turns ({GRID} tiles), {m} MAC, bound {b_ms!r} ms ({by}), wgmma/bound "
              f"{ms['wgmma'] / b_ms!r}, wgmma/sync {ms['wgmma'] / ms['sync']!r} ({card})",
              flush=True)
        rows[name] = {"ms": ms["wgmma"], "ms_sync": ms["sync"], "bound_ms": b_ms,
                      "bound_by": by, "bytes": nbytes, "macs": m,
                      "issued": banded_wgmma.issued_bytes(GRID, xm)}
    for key in ("ms", "ms_sync"):
        y = rows["y=mono x=skip"][key] - rows["y=skip x=skip"][key]
        x = rows["y=skip x=mono"][key] - rows["y=skip x=skip"][key]
        print(f"per pass, over skip/skip, {'wgmma' if key == 'ms' else 'sync'}: Y mono {y!r} "
              f"ms, X mono {x!r} ms ({card})", flush=True)
    return rows


if __name__ == "__main__":
    main()
