"""Where kernel D's ``wgmma`` form spends its time:
``csrc/exp/exp_banded_wgmma.cu`` and variants of it with one stage removed,
built side by side and timed in turns on the probe's mono/mono and
grouped/grouped frames, beside an empty launch (the launch floor of the
protocol).

Each variant is the source with text substitutions (:data:`VARIANTS`); none
removes a barrier, a wait or a copy that a barrier waits for, so every
variant that launches the X kernel runs its whole schedule of TMA loads and
waits (``y_no_cy`` leaves cy^T's cp.async groups empty, and a wait on an
empty group returns at once):

* ``kernel``: the source as it is, held byte-equal to the plain version;
* ``y_only``: the Y launch alone (the work rows written, no X launch);
* ``y_prologue``: the Y launch with no item (cy^T's copy alone);
* ``y_no_cy``: the Y launch alone without cy^T's copy (zeros in its place);
* ``y_no_store``, ``y_no_stash``, ``y_only_no_mma``, ``y_no_load``: the Y
  launch alone without the work rows' stores, without widening the band
  into the stage (its loads kept), without the ``wgmma``, without the band's
  loads (zeros widened);
* ``y_first_item``: the Y launch alone, each warpgroup's first item only;
* ``y_no_mma``: no Y ``wgmma`` (mono): the band's loads, widening and
  ``ldmatrix`` stay, their fragments folded into the sums;
* ``x_no_mma``: no X ``wgmma``: the split fragments are folded into the
  sums, so the stage reads and the split stay;
* ``x_fetch_only``: no X ``wgmma`` and no split: the consumers read their
  stage words and hand the stages back, the TMA ring runs whole;
* ``x_stages5``: a ring of 5 stages in place of 4.

The stage variants compute garbage: they are measurements, never outputs.
Run on a card, from the repository root::

    python3 -m libiqo_tpu_torch.tools.banded_ablate [variant ...]

Builds go to ``build/libiqo_tpu_torch/banded-ablate-<hash>/<variant>/`` (one
``nvcc`` per variant, all started together).  Times
(:func:`._ablate.time_in_turns`): CUDA events, the card spinning while the
host queues, min over 5 repeats of back-to-back launches on 8 band stacks
that each differ in one element, each variant timed twice in the order
kernel, variants, empty launch, then reversed (min of its two).  Prints one
line per row with the card's name and power limit.  Raises without a card.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..experiments import _harness, banded_wgmma
from ..experiments import exp_banded_dots as bd
from ..ops import _build
from . import _ablate

__all__ = ["VARIANTS", "main", "variant_source"]

SOURCE = _build.EXP_CSRC / "exp_banded_wgmma.cu"
_X_MMA = ("          wgmma_m64n64(d[p], a[p], desc_sw128(btile + p * kBTile + 32 * kk), "
          "(c | kk) != 0);")
_X_FOLD = "          d[p][0] += __uint_as_float(a[p][0] ^ a[p][1] ^ a[p][2] ^ a[p][3]);"
_X_SPLIT = ("for (int e = 0; e < 4; ++e) split_pair(wv[kk][e], a[0][e], a[1][e], "
            "a[2][e]);")
_Y_MMA = "wgmma_n160(d, a, desc_sw128(cyb + (ks / 4) * kCyTile + 32 * (ks % 4)));"
_Y_ONLY = ("  if (rc || xskip) return rc;", "  if (rc || xskip || x_ctas > 0) return rc;")
_Y_NO_MMA = (_Y_MMA, "d[0][0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3]);")
# variant: [(text, replacement)], each text found once in the source
VARIANTS = {
    "kernel": [],
    "y_only": [_Y_ONLY],
    "y_prologue": [_Y_ONLY, ("  for (int i = 2 * blockIdx.x + wg; i < items; i += step, "
                             "first = false) {",
                             "  for (int i = items; i < items; i += step) {")],
    "y_no_store": [_Y_ONLY, ("    wg_sync();\n    store_item(t, c0);\n  }\n}",
                             "    wg_sync();\n  }\n}")],
    "y_no_stash": [_Y_ONLY, ("stash(c & 1, pre[c % kYAhead]);",
                             "d[0][c] += __uint_as_float(pre[c % kYAhead][0].x ^ "
                             "pre[c % kYAhead][1].w);")],
    "y_only_no_mma": [_Y_ONLY, _Y_NO_MMA],
    "y_no_cy": [_Y_ONLY, ("      if (k < kBH) cp_async16(dst, cy + static_cast<long long>(n)",
                          "      if (k < 0) cp_async16(dst, cy + static_cast<long long>(n)")],
    "y_no_load": [_Y_ONLY, ("    if (i < items && row < kBH) {",
                            "    if (i < 0 && row < kBH) {")],
    "y_first_item": [_Y_ONLY, ("i < items; i += step, first = false) {",
                               "i < items; i += items, first = false) {")],
    "y_no_mma": [_Y_NO_MMA],
    "x_no_mma": [(_X_MMA, _X_FOLD)],
    "x_stages5": [("constexpr int kXStages = 4;", "constexpr int kXStages = 5;")],
    "x_fetch_only": [(_X_MMA, _X_FOLD),
                     (_X_SPLIT, "for (int e = 0; e < 4; ++e) a[0][e] = a[1][e] = a[2][e] = "
                                "wv[kk][e];")],
}


def variant_source(name: str, source: str | None = None) -> str:
    """The kernel source with variant ``name``'s substitutions; raises
    ValueError if one of its texts is not in the source exactly once."""
    return _ablate.variant_source(VARIANTS, SOURCE, name, source)


def _load(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    _build.bind_experiments(lib, ("iqo_exp_banded_wgmma", "iqo_exp_banded_wgmma_setup"))
    rc = lib.iqo_exp_banded_wgmma_setup()
    if rc != 0:
        raise RuntimeError(f"{name}: shared-memory limit refused (cudaError_t {rc})")
    return lib


def main(argv: list[str] | None = None) -> int:
    names = _ablate.names_of(sys.argv[1:] if argv is None else argv, VARIANTS)
    _ablate.require_card("banded_ablate")
    card = _harness.card()
    libs = _ablate.load_variants(_ablate.build_variants(
        "banded-ablate", names, SOURCE, variant_source, [_build.EXP_CSRC / "hopper.cuh"],
        [SOURCE.name]), _load)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    band, cy, cxs = bd.inputs(dev)
    ops = bd.pack(cy, *cxs)
    tiles = band.shape[0]
    work = torch.empty((tiles * bd.TH, bd.BW), dtype=torch.int16, device=dev)
    out = torch.empty((tiles, bd.TH, bd.TW), dtype=torch.uint8, device=dev)
    xs = _harness.perturbed(band, bd.ITERS)
    for mode in ("mono", "grouped"):
        def launch(lib, x, m=bd.MODES.index(mode)):
            _harness.check_rc(lib.iqo_exp_banded_wgmma(
                m, m, x.data_ptr(), ops.cy.data_ptr(), *(c.data_ptr() for c in ops.cxt),
                work.data_ptr(), out.data_ptr(), tiles, banded_wgmma.y_ctas(tiles, False, sms),
                banded_wgmma.x_ctas(tiles, sms), _harness.stream(x)), "banded_ablate")
        launch(libs["kernel"], xs[-1])
        if not torch.equal(out, bd.banded_tile_plain(ops, xs[-1], mode, mode)):
            raise RuntimeError(f"{mode}/{mode}: kernel != plain")
        calls = {n: (lambda v, n=n, launch=launch: launch(libs[n], v)) for n in names}
        calls["empty_launch"] = lambda v: torch.cuda._sleep(0)
        ms = _ablate.time_in_turns(calls, xs)
        print(f"D wgmma {mode}/{mode}: " + ", ".join(
            f"{n} {ms[n]!r} ms ({ms[n] / ms['kernel']!r})" for n in calls) + f" ({card})",
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
