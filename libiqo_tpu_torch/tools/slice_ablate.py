"""Where kernel L's wgmma form spends its time: ``csrc/exp/exp_slice_wgmma.cu``
and variants of it with one stage removed, built side by side and timed in
turns at the probe's configs, beside an empty launch (the launch floor of the
protocol).

Each variant is the source with text substitutions (:data:`VARIANTS`); none
touches a barrier, so every variant runs the kernel's whole schedule of
copies and waits:

* ``kernel``: the source as it is, held byte-equal to the plain version;
* ``no_split``: the A fragments are the int16 pairs' bits with a fixed bf16
  exponent (finite values) in place of the Karatsuba split;
* ``no_mma``: no ``wgmma``; the split's values are folded into the
  accumulators so that the split stays;
* ``no_epilogue``: the sums are neither converted nor stored;
* ``copies_only``: no split, no ``wgmma``, no epilogue: the launch, the TMA
  copies of the windows and the rows, the shared-memory reads and the
  barriers.

The stage variants compute garbage: they are measurements, never outputs.
Run on a card, from the repository root::

    python3 -m libiqo_tpu_torch.tools.slice_ablate [variant ...]

Builds go to ``build/libiqo_tpu_torch/slice-ablate-<hash>/<variant>/`` (one
``nvcc`` per variant, all started together).  Times
(:func:`._ablate.time_in_turns`): CUDA events, the card spinning while the
host queues, min over 5 repeats of back-to-back launches on 8 tile stacks
that each differ in one element, each variant timed twice in the order
kernel, variants, empty launch, then reversed (min of its two).  Prints one
line per config with the card's name and power limit.  Raises without a
card.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..experiments import _harness
from ..experiments import exp_slice_align as sa
from ..ops import _build
from . import _ablate

__all__ = ["VARIANTS", "main", "variant_source"]

SOURCE = _build.EXP_CSRC / "exp_slice_wgmma.cu"
_SPLIT = "split_pair(wv[kk][i], a[0][i], a[1][i], a[2][i]);"
_NO_SPLIT = [(_SPLIT, "a[0][i] = a[1][i] = a[2][i] = (wv[kk][i] & 0x807F807Fu) | 0x3F003F00u;")]
_MMA = """            wgmma_rs_m64n64(d[p], a[p], desc_sw128(wtile + p * kTileBytes + 32 * kk),
                            (c | kk) != 0);"""
_NO_MMA = [(_MMA, "            d[p][kk] += __uint_as_float(a[p][kk] & 0x3F7FFFFFu);")]
_EPILOGUE = """      const Tile tl = tile_of(tt, mt, align, kl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {"""
_NO_EPILOGUE = [(_EPILOGUE, """      const Tile tl = tile_of(tt, mt, align, kl);
      if (d[0][0] == 12345.f && d[1][0] == d[2][0]) static_cast<uint8_t*>(out)[tid] = 1;
#pragma unroll
      for (int h = 0; h < 2 && tl.m < 0; ++h) {""")]
# variant: [(text, replacement)], each text found once in the source
VARIANTS = {
    "kernel": [],
    "no_split": _NO_SPLIT,
    "no_mma": _NO_MMA,
    "no_epilogue": _NO_EPILOGUE,
    "copies_only": _NO_SPLIT + _NO_MMA + _NO_EPILOGUE,
}
CONFIGS = ((128, 512), (64, 384))


def variant_source(name: str, source: str | None = None) -> str:
    """The kernel source with variant ``name``'s substitutions; raises
    ValueError if one of its texts is not in the source exactly once."""
    return _ablate.variant_source(VARIANTS, SOURCE, name, source)


def _load(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.iqo_exp_slice_wgmma.argtypes = [i, i, i, p, p, p, i, i, p]
    lib.iqo_exp_slice_wgmma.restype = i
    lib.iqo_exp_slice_wgmma_setup.restype = i
    rc = lib.iqo_exp_slice_wgmma_setup()
    if rc != 0:
        raise RuntimeError(f"{name}: shared-memory limit refused (cudaError_t {rc})")
    return lib


def main(argv: list[str] | None = None) -> int:
    names = _ablate.names_of(sys.argv[1:] if argv is None else argv, VARIANTS)
    _ablate.require_card("slice_ablate")
    card = _harness.card()
    libs = _ablate.load_variants(_ablate.build_variants(
        "slice-ablate", names, SOURCE, variant_source, [_build.EXP_CSRC / "hopper.cuh"],
        [SOURCE.name]), _load)
    dev = torch.device("cuda", 0)
    w, ops = sa.inputs(dev)
    ws = _harness.perturbed(w, sa.ITERS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas = sa.wgmma_ctas(sa.GRID, sms)
    out_t = torch.empty((sa.GRID, sa.TH, sa.TWF), dtype=torch.uint8, device=dev)

    def launch(lib, x, align, kl):
        _harness.check_rc(lib.iqo_exp_slice_wgmma(
            align, kl, 0, x.data_ptr(), ops.ct.data_ptr(), out_t.data_ptr(), sa.GRID, ctas,
            _harness.stream(x)), "slice_ablate")

    for align, kl in CONFIGS:
        launch(libs["kernel"], ws[-1], align, kl)
        if not torch.equal(out_t, sa.slice_groups_plain(ws[-1], ops, align, kl)):
            raise RuntimeError(f"({align}, {kl}): kernel != plain")
        calls = {n: (lambda x, n=n: launch(libs[n], x, align, kl)) for n in names}
        calls["empty_launch"] = lambda x: torch.cuda._sleep(0)
        ms = _ablate.time_in_turns(calls, ws)
        print(f"({align}, {kl}), {sa.GRID} steps, {ctas} blocks: " + ", ".join(
            f"{n} {ms[n]!r} ms ({ms[n] / ms['kernel']!r})" for n in calls) + f" ({card})",
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
