"""One overlapping band window against a disjoint step plus a halo: what
each costs a column-sum Y pass on the card.

Port of ``scripts/exp_blocked_halo.py`` to one NVIDIA H100.  Kernel H,
``band_colsum(x, variant, n_t, step, halo)`` (``libiqo_tpu_torch/csrc/exp/
exp_band.cu``), replaces ``build`` (``pl.pallas_call`` at ``:82``).  Per
tile ``t < n_t`` of a (n_t step + halo, w) u8 plane, the i32 column sums,
written to 8 rows, (8 n_t, w) i32:

* ``element``: rows ``[t step, t step + step + halo)``, one loop;
* ``blocked2``: rows ``[t step, (t + 1) step)`` of plane A, then
  ``[(t + 1) step, (t + 1) step + halo)`` of plane B, two loops; the probe
  passes the plane twice, as the script's ``call(x, x)`` (``:88``);
* ``blocked1``: the step rows alone: the no-overlap floor.

Configs (name, n_t, step, halo, w), as ``main`` (``:126-130``):
luma-like (64, 64, 64, 3840), luma-halo32 (64, 64, 32, 3840) and narrow
(256, 64, 64, 512).  The script runs them on its sequential grid; the three
variants differ only in their row ranges, and each tile writes its own
rows, so the probe launches one block per (tile, column chunk of 128
columns) for all three (1,920 blocks on the luma configs, 1,024 on the
narrow one), each thread summing one 4-byte word (4 columns) over every
fourth row straight from device memory; the four row groups meet in shared
memory.

The probe draws a new source for every (config, variant) from one seed-0
generator, in the script's order (``:122-141``).  Each row times
back-to-back launches on 8 sources that each differ in ``x[0, 0]``
(8 x 16 MB on the luma configs), and prints the bytes the windows fetch
(the script's "MB", halo rows re-read) and their rate.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_blocked_halo``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _harness
from ._harness import HBM_BYTES_PER_S, Launches

__all__ = ["CONFIGS", "LAUNCHES", "VARIANTS", "band_colsum", "band_colsum_plain",
           "bound", "main", "sources"]

CONFIGS = (("luma-like", 64, 64, 64, 3840),
           ("luma-halo32", 64, 64, 32, 3840),
           ("narrow", 256, 64, 64, 512))
VARIANTS = ("element", "blocked2", "blocked1")
ITERS = 8
LAUNCHES = Launches(VARIANTS)


def reset_launches() -> None:
    LAUNCHES.reset()


def _check(x, y, variant, n_t, step, halo) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variants are {VARIANTS}, got {variant!r}")
    if n_t < 1 or step < 1 or halo < 0:
        raise ValueError(f"n_t={n_t}, step={step}, halo={halo}")
    need = n_t * step + (0 if variant == "blocked1" else halo)
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.uint8 or t.ndim != 2 or t.shape[0] < need:
            raise ValueError(f"{name} must be (>= {need}, w) uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if y.shape[1] != x.shape[1]:
        raise ValueError(f"x and y differ in width: {x.shape[1]} != {y.shape[1]}")


def band_colsum_plain(x: torch.Tensor, variant: str, n_t: int, step: int, halo: int,
                      y: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel H's function in plain PyTorch: each tile's row range summed
    from running column sums in int64 (exact), as int32, 8 rows a tile."""
    y = x if y is None else y
    _check(x, y, variant, n_t, step, halo)
    zero = x.new_zeros((1, x.shape[1]), dtype=torch.int64)
    cx = torch.cat([zero, x.to(torch.int64).cumsum(0)])
    t = torch.arange(n_t, device=x.device) * step
    s = cx[t + step] - cx[t]
    if variant == "element":
        s = cx[t + step + halo] - cx[t]
    elif variant == "blocked2":
        cy = torch.cat([zero, y.to(torch.int64).cumsum(0)])
        s = s + cy[t + step + halo] - cy[t + step]
    return s.to(torch.int32).repeat_interleave(8, dim=0)


def band_colsum(x: torch.Tensor, variant: str, n_t: int, step: int, halo: int,
                y: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel H: x (rows, w) u8 (and blocked2's halo plane ``y``, x if None)
    -> (8 n_t, w) int32.  A CPU tensor takes :func:`band_colsum_plain`; a
    CUDA tensor launches the kernel (w a multiple of 4) or raises."""
    y = x if y is None else y
    _check(x, y, variant, n_t, step, halo)
    if not _harness.on_card(x, y):
        return band_colsum_plain(x, variant, n_t, step, halo, y)
    if x.shape[1] % 4:
        raise ValueError(f"the kernel takes w a multiple of 4, got {x.shape[1]}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("band_colsum takes contiguous tensors")
    out = torch.empty((8 * n_t, x.shape[1]), dtype=torch.int32, device=x.device)
    _harness.check_rc(_harness.lib().iqo_exp_band_colsum(
        VARIANTS.index(variant), x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[1],
        n_t, step, halo, _harness.stream(x)), f"band_colsum[{variant}]")
    LAUNCHES.add(variant)
    return out


def sources(device, configs=CONFIGS):
    """(name, n_t, step, halo, w, variant, x) for every config and variant,
    each x (n_t step + halo, w) uint8 drawn anew from one seed-0 generator
    in the script's order (``main``, ``:123-136``)."""
    rng = np.random.default_rng(0)
    for name, n_t, step, halo, w in configs:
        for variant in VARIANTS:
            x = rng.integers(0, 256, (n_t * step + halo, w), np.uint8)
            yield name, n_t, step, halo, w, variant, torch.from_numpy(x).to(device)


def bound(variant: str, n_t: int, step: int, halo: int,
          w: int) -> tuple[float, str, int, int]:
    """(ms, 'bytes', bytes, bytes fetched): the rows the variant reads
    (their union) once and the output once at 3.35 TB/s; and the bytes its
    windows fetch, halo rows re-read (the script's "MB")."""
    extra = 0 if variant == "blocked1" else halo
    nbytes = (n_t * step + extra) * w + 8 * n_t * w * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes, n_t * (step + extra) * w


def main() -> dict:
    """Every config and variant on card 0; returns {"<config> <variant>": {ms, ...}}."""
    _harness.require_card()
    card = _harness.card()
    found = {}
    for name, n_t, step, halo, w, variant, x in sources(torch.device("cuda", 0)):
        xs = _harness.perturbed(x, ITERS)
        if not torch.equal(band_colsum(xs[-1], variant, n_t, step, halo),
                           band_colsum_plain(xs[-1], variant, n_t, step, halo)):
            raise AssertionError(f"{name} {variant}: kernel differs from its plain version")
        ms = _harness.launches_ms(lambda v: band_colsum(v, variant, n_t, step, halo), xs)
        b_ms, by, nbytes, fetched = bound(variant, n_t, step, halo, w)
        print(f"{name:11s} {variant}={ms * 1e3!r}us ({fetched / 1e6!r}MB "
              f"{fetched / 1e9 / (ms * 1e-3)!r}GB/s); bound {b_ms * 1e3!r} us ({by}), "
              f"kernel/bound {ms / b_ms!r} ({card})", flush=True)
        found[f"{name} {variant}"] = {"ms": ms, "bound_ms": b_ms, "bound_by": by,
                                      "bytes": nbytes, "fetched": fetched}
    for name, *_ in CONFIGS:
        e, b2 = found[f"{name} element"]["ms"], found[f"{name} blocked2"]["ms"]
        print(f"{name:11s} blocked2/element {b2 / e!r}, blocked1/element "
              f"{found[f'{name} blocked1']['ms'] / e!r} ({card})", flush=True)
    return found


if __name__ == "__main__":
    main()
