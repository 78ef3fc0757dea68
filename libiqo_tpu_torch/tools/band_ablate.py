"""Where the ring forms of kernels E and G spend their time:
``csrc/exp/exp_band_ring.cu`` and variants of it with one stage removed,
built side by side and timed in turns on the probes' main rows, beside an
empty launch (the launch floor of the protocol).

Each variant is the source with text substitutions (:data:`VARIANTS`); none
touches a barrier, a wait or a copy, so every variant runs the kernel's whole
schedule of TMA loads and waits:

* ``kernel``: the source as it is, held byte-equal to the plain version;
* ``fetch_only``: no item body: the launch, the coefficients' load, the TMA
  loads of every window and the barriers;
* ``no_store``: the item bodies without their output stores;
* ``no_mma``: no ``mma.sync``; the B fragments' words are folded into the
  accumulators so that their loads and byte transposes stay.

The stage variants compute garbage: they are measurements, never outputs.
Run on a card, from the repository root::

    python3 -m libiqo_tpu_torch.tools.band_ablate [variant ...]

Builds go to ``build/libiqo_tpu_torch/band-ablate-<hash>/<variant>/`` (one
``nvcc`` per variant, all started together).  Times
(:func:`._ablate.time_in_turns`): CUDA events, the card spinning while the
host queues, min over 5 repeats of back-to-back launches on 8 sources that
each differ in one element, each variant timed twice in the order kernel,
variants, empty launch, then reversed (min of its two).  Rows: E ``base``
(i32 out) and ``u8out`` at (2160, 3840), G ``elem`` at P = 0 and 8.  Prints
one line per row with the card's name and power limit.  Raises without a
card.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..experiments import _harness, band_ring
from ..experiments import exp_band_shape as bs
from ..experiments import exp_overlap as ov
from ..ops import _build
from . import _ablate

__all__ = ["VARIANTS", "main", "variant_source"]

SOURCE = _build.EXP_CSRC / "exp_band_ring.cu"
_BODY = "if ((i - i0) % groups == group) body(i, n % stages);"
_E_WIDE = """          *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<int4*>(o + 16) = make_int4(v[4], v[5], v[6], v[7]);"""
_E_U8 = """          uint8_t* o = static_cast<uint8_t*>(a.out) + orow + chunk0 + 32 * wl + 8 * q;
          *reinterpret_cast<uint2*>(o) ="""
_G_U8 = ("      *reinterpret_cast<uint2*>(out + static_cast<long long>(16 * mt + g + 8 * rh)"
         " * a.nd +\n                                32 * wl + 8 * q) =")
# a store's condition that every value feeds and that the compiler cannot
# decide (it reads the plane's height), so that it keeps every sum; the sums
# do not meet it (u8 below 2^20: never; i32: by chance alone)
_UNSTORED = ("if ((v[0] ^ v[1] ^ v[2] ^ v[3] ^ v[4] ^ v[5] ^ v[6] ^ v[7]) == "
             "static_cast<uint32_t>(a.h) << 20) ")
_E_MMA = "for (int p = 0; p < 4; ++p) mma_s8(acc[mt][p], af[mt][ks], b[0][p], b[1][p]);"
_G_MMA = "for (int p = 0; p < 4; ++p) mma_s8(acc[mt][p], af[mt], b[0][p], b[1][p]);"
# variant: [(text, replacement)], each text found once in the source
VARIANTS = {
    "kernel": [],
    "fetch_only": [(_BODY, "if (group < 0) body(i, n % stages);")],
    "no_store": [
        (_E_WIDE, "          " + _UNSTORED + "{\n  " + _E_WIDE.replace("\n", "\n  ")
         + "\n          }"),
        (_E_U8, _E_U8.replace("          *reinterpret_cast", "          " + _UNSTORED
                              + "*reinterpret_cast")),
        (_G_U8, "      " + _UNSTORED + _G_U8.lstrip()),
    ],
    "no_mma": [
        (_E_MMA, "for (int p = 0; p < 4; ++p) acc[mt][p][0] += af[mt][ks][p] ^ b[0][p] ^ "
                 "b[1][p];"),
        (_G_MMA, "for (int p = 0; p < 4; ++p) acc[mt][p][0] += af[mt][p] ^ b[0][p] ^ b[1][p];"),
    ],
}


def variant_source(name: str, source: str | None = None) -> str:
    """The kernel source with variant ``name``'s substitutions; raises
    ValueError if one of its texts is not in the source exactly once."""
    return _ablate.variant_source(VARIANTS, SOURCE, name, source)


def _load(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.iqo_exp_band_ydot_ring.argtypes = [i, i, p, i, i, i, p, p, p, p, p, p, p, p, p, p, ll,
                                           i, p]
    lib.iqo_exp_overlap_ring.argtypes = [i, i, p, i, i, p, p, i, i, i, p]
    for f in (lib.iqo_exp_band_ydot_ring, lib.iqo_exp_overlap_ring,
              lib.iqo_exp_band_ring_setup):
        f.restype = i
    rc = lib.iqo_exp_band_ring_setup()
    if rc != 0:
        raise RuntimeError(f"{name}: shared-memory limit refused (cudaError_t {rc})")
    return lib


def main(argv: list[str] | None = None) -> int:
    names = _ablate.names_of(sys.argv[1:] if argv is None else argv, VARIANTS)
    _ablate.require_card("band_ablate")
    card = _harness.card()
    libs = _ablate.load_variants(_ablate.build_variants(
        "band-ablate", names, SOURCE, variant_source, [_build.EXP_CSRC / "hopper.cuh"],
        [SOURCE.name]), _load)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    coef, src = bs.inputs(dev)
    osrc, ocoef = ov.inputs(dev)
    rows = []                      # (tag, launch(lib, x), source, output, plain(x))
    for form in ("base", "u8out"):
        out = torch.empty((bs.N_T * bs.TH, bs.W), device=dev,
                          dtype=torch.uint8 if form == "u8out" else torch.int32)
        ctas = band_ring.ring_ctas(bs.ring_work(form), sms)

        def launch(lib, x, form=form, out=out, ctas=ctas):
            _harness.check_rc(lib.iqo_exp_band_ydot_ring(
                bs.FORMS.index(form), 0, x.data_ptr(), 1, bs.H, bs.W, coef.data_ptr(),
                out.data_ptr(), *[None] * 8, 0, ctas, _harness.stream(x)), "band_ablate")
        rows.append((f"E {form}", launch, src, out,
                     lambda x, form=form: bs.band_ydot_plain(
                         coef, x if form == "base" else x[None], form).reshape(out.shape)))
    g_out = torch.empty((ov.N_TY * ov.TH, ov.ND), dtype=torch.uint8, device=dev)
    g_ctas = band_ring.ring_ctas(ov.ring_work("elem"), sms)
    for p in (0, 8):
        def launch(lib, x, p=p):
            _harness.check_rc(lib.iqo_exp_overlap_ring(
                0, p, x.data_ptr(), ov.H, ov.W, ocoef.data_ptr(), g_out.data_ptr(), ov.ND,
                ov.N_TY, g_ctas, _harness.stream(x)), "band_ablate")
        rows.append((f"G elem P={p}", launch, osrc, g_out,
                     lambda x, p=p: ov.overlap_dots_plain(x, ocoef, "elem", p)))
    for tag, launch, x, out, plain in rows:
        xs = _harness.perturbed(x, bs.ITERS)
        launch(libs["kernel"], xs[-1])
        if not torch.equal(out, plain(xs[-1])):
            raise RuntimeError(f"{tag}: kernel != plain")
        calls = {n: (lambda v, n=n, launch=launch: launch(libs[n], v)) for n in names}
        calls["empty_launch"] = lambda v: torch.cuda._sleep(0)
        ms = _ablate.time_in_turns(calls, xs)
        print(f"{tag}: " + ", ".join(f"{n} {ms[n]!r} ms ({ms[n] / ms['kernel']!r})"
                                     for n in calls) + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
