"""Byte loads against word loads unpacked in registers: the Y pass of a 2:1
tile with its band fetched as u8 or as i32 words of four source columns.

Port of ``scripts/exp_i32_band.py`` to one NVIDIA H100, on kernel E
(``band_ydot`` of :mod:`.exp_band_shape`, ``libiqo_tpu_torch/csrc/exp/
exp_band.cu``), which replaces ``build_u8`` (``pl.pallas_call`` at ``:65``)
with its ``base`` form and ``build_i32`` (``:94``) with its ``"i32"`` form:

* u8: ``C (32, 96) @ int8(band ^ 0x80)`` over a (2160, 3840) u8 plane, the
  band fetched one byte per thread per load, (1056, 3840) i32;
* i32: the same plane as (2160, 960) i32 words (little-endian, four source
  columns each), fetched one word per thread per load; the kernel flips
  every byte's sign bit in one ``^ 0x80808080`` and splits each word into
  its four s8 planes with byte permutes in registers, and source column
  ``4 q + p`` lands at output column ``p * 960 + q``: the script's permuted
  order ``[c % 4 == 0 | c % 4 == 1 | ...]``.

Both stage the band in shared memory and run the same ``mma.sync`` s8 dots,
so in the ``sync`` implementation their difference is the fetch; the
``ring`` implementation (the default, ``csrc/exp/exp_band_ring.cu``) fetches
both by TMA, bytes being bytes, so there the forms differ only in the
output's column order.  As the script's ``main`` (``:179-186``), the i32
output must equal the u8 output with its columns permuted.  The u8 row
times 8 sources that each differ in ``src[0, 0]``; the i32 row 8 word planes
whose word 0 differs in its low byte (``x[0, 0] ^ i``, as the script's
``measure_i32``); both implementations and the library call
(``exp_band_shape.library``) in turns.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_i32_band``.
"""

from __future__ import annotations

import numpy as np
import torch

import functools

from . import _harness
from .exp_band_shape import (BAND, IMPLS, TH, WORDS, band_ydot, band_ydot_plain, bound,
                             issued_bytes, library, library_operand, library_rows)

__all__ = ["main", "permutation", "rows", "to_words", "inputs"]

H, W = 2160, 3840
ITERS = 8


def inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's draws (``main``, ``:164-166``), from seed 0, in its
    order: coef (32, 96) int8 in [-64, 64) (``_mk_coef``), then src (H, W)
    uint8."""
    rng = np.random.default_rng(0)
    coef = rng.integers(-64, 64, (TH, BAND), np.int8)
    src = rng.integers(0, 256, (H, W), np.uint8)
    return torch.from_numpy(coef).to(device), torch.from_numpy(src).to(device)


def to_words(src: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 -> (H, W / 4) int32, byte b of word q = column 4 q + b
    (the script's ``src32``, ``:167-170``)."""
    return src.contiguous().view(torch.int32)


def permutation(w: int, device=None) -> torch.Tensor:
    """Output column -> source column of the i32 form."""
    return torch.cat([torch.arange(p, w, 4, device=device) for p in range(4)])


def rows(coef: torch.Tensor, src: torch.Tensor,
         impl: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(u8 output, i32 output) of kernel E in ``impl``, or of its plain
    version on the CPU; raises unless the i32 output is the u8 output
    permuted."""
    o_u8 = band_ydot(coef, src, "base", impl=impl)
    o_i32 = band_ydot(coef, to_words(src), WORDS, impl=impl)
    if not torch.equal(o_i32, o_u8[:, permutation(src.shape[1], src.device)]):
        raise AssertionError("i32 output != u8 output permuted")
    return o_u8, o_i32


def _perturbed_words(base: torch.Tensor, n: int) -> list[torch.Tensor]:
    """n copies of base, copy i with the low byte of word 0 xor-ed with i."""
    out = []
    for i in range(n):
        x = base.clone()
        x.view(-1)[0] ^= i
        out.append(x)
    return out


def main() -> dict:
    """Both rows on card 0, both implementations and the library call in
    turns; returns {"u8": {"ring_ms", "sync_ms", "library_ms", ...}, "i32":
    {...}}."""
    _harness.require_card()
    card = _harness.card()
    coef, src = inputs(torch.device("cuda", 0))
    for impl in IMPLS:
        rows(coef, src, impl)
    print("value check (i32 permuted == u8), both implementations: True", flush=True)
    wts = _harness.perturbed(library_operand(src), ITERS)
    found = {}
    for name, form, xs in (("u8", "base", _harness.perturbed(src, ITERS)),
                           ("i32", WORDS, _perturbed_words(to_words(src), ITERS))):
        want = band_ydot_plain(coef, xs[-1], form)
        calls = {}
        for impl in IMPLS:
            if not torch.equal(band_ydot(coef, xs[-1], form, impl=impl), want):
                raise AssertionError(f"{name} {impl}: kernel differs from its plain version")
            calls[impl] = (functools.partial(
                lambda x, i: band_ydot(coef, x, form, impl=i), i=impl), xs)
        calls["library"] = (lambda t: library(coef, t), wts)
        ms = _harness.turns_ms(calls)
        b_ms, by, nbytes, macs, fetched = bound(form)
        print(f"{name:3s} band Y pass: ring {ms['ring'] * 1e3!r} us, sync {ms['sync'] * 1e3!r} "
              f"us, library torch._int_mm {ms['library'] * 1e3!r} us; bound {b_ms * 1e3!r} us "
              f"({by}), ring/bound {ms['ring'] / b_ms!r}, ring/library "
              f"{ms['ring'] / ms['library']!r}; issued MB ring {issued_bytes(form) / 1e6!r}, "
              f"sync {fetched / 1e6!r} ({card})", flush=True)
        found[name] = {"ring_ms": ms["ring"], "sync_ms": ms["sync"],
                       "library_ms": ms["library"], "bound_ms": b_ms, "bound_by": by,
                       "bytes": nbytes, "macs": macs, "fetched": fetched}
    for impl in IMPLS:
        ratio = found["u8"][f"{impl}_ms"] / found["i32"][f"{impl}_ms"]
        print(f"{impl}: ratio u8/i32 = {ratio!r} ({'i32 WINS' if ratio > 1 else 'u8 stays'}) "
              f"({card})", flush=True)
    return found


if __name__ == "__main__":
    main()
