"""Where the tiled resize kernel's time goes: ``csrc/resize_tiled.cuh`` and
variants of it with one stage removed or its registers capped, built side by
side and timed in turns on the main path's planes, in each of the kernel's
forms (exact, relaxed, carry: :data:`PLANES`).

Each variant is the kernel source with text substitutions (:data:`VARIANTS`),
applied to every form:

* ``kernel``: the source as it is, held byte-equal to the plain path;
* ``no_x``, ``no_y``, ``no_xy``: the X pass's tap loop, the Y pass's (the s8
  dot's K loop and the IMAD taps), or both, run zero times;
* ``no_band``: the band is not staged, nor the carry form's fresh rows (the
  passes read whatever shared memory holds);
* ``no_store``: the outputs are computed and not written;
* ``band_only``: no X, no Y, no store: the launch, the records, the band and
  the barriers;
* ``regs40``, ``regs32``: ``__launch_bounds__`` of 6 and 8 blocks of 256
  threads per SM, so ptxas keeps to 40 or 32 registers.

The stage variants compute garbage: they are measurements, never outputs.
Run on a card, from the repository root::

    python3 -m libiqo_tpu_torch.tools.tiled_ablate [variant ...]

Builds go to ``build/libiqo_tpu_torch/ablate-<hash>/<variant>/`` (the
variant's header beside copies of the four ``resize_tiled*.cu`` sources; one
``nvcc -c`` per source and variant, all started together).  Times
(:func:`._ablate.time_in_turns`): CUDA events, the card spinning while the
host queues, min over 5 repeats of back-to-back calls on > 64 MB of distinct
inputs, and each variant timed twice in the order kernel, variants, variants
reversed, kernel (min of its two).  Prints one line per plane with the
card's name and power limit.  Raises without a card.
"""

from __future__ import annotations

import ctypes
import math
import sys

import numpy as np
import torch

from ..core.plan import build_plan
from ..experiments import _harness
from ..ops import _build, cuda_resize
from . import _ablate

__all__ = ["PLANES", "VARIANTS", "main", "variant_source"]

SOURCE = _build.CSRC / "resize_tiled.cuh"
# the translation units that include it: the exact form and the C entry
# points, then the relaxed, carry and relaxed carry forms
UNITS = ("resize_tiled.cu", "resize_tiled_relaxed.cu", "resize_tiled_carry.cu",
         "resize_tiled_relaxed_carry.cu")
_X_LOOP = "for (int t = 0; t < a.taps_x; ++t)"
# the X tap loop's one-phase and per-output forms, integer and float32
_COUNTS = {_X_LOOP: 4}
_NO_X = [(_X_LOOP, "for (int t = 0; t < 0; ++t)")]
_NO_Y = [("for (int kb = 0; kb < a.k_rows; kb += 32)", "for (int kb = 0; kb < 0; kb += 32)"),
         ("for (int t = 0; t < a.taps_y; ++t)", "for (int t = 0; t < 0; ++t)")]
_NO_STORE = [("out[j] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));",
              "if (v == 0x7FFFFFFF) out[j] = 0;")]
_BOUNDS = "__global__ void __launch_bounds__(kThreads) resize_tiled_kernel"
# variant: [(text, replacement)], each text found in the source
VARIANTS = {
    "kernel": [],
    "no_x": _NO_X,
    "no_y": _NO_Y,
    "no_xy": _NO_X + _NO_Y,
    "no_band": [("for (int e = threadIdx.x; e < n * nchunk; e += kThreads)",
                 "for (int e = threadIdx.x; e < 0; e += kThreads)")],
    "no_store": _NO_STORE,
    "band_only": _NO_X + _NO_Y + _NO_STORE,
    "regs40": [(_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 6)"))],
    "regs32": [(_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 8)"))],
}
# (name, algorithm, kwargs, src_w, src_h, dst_w, dst_h, batch, form): the
# main paths' planes (U and V as one batch-of-2 call), the IMAD Y pass's,
# and the relaxed and carry forms on the planes that take them
PLANES = (
    ("lanczos3 4K->1080p luma", "lanczos", dict(degree=3), 3840, 2160, 1920, 1080, 1,
     "exact"),
    ("lanczos3 4K->1080p px2 chroma", "lanczos", dict(degree=3, px_scale=2),
     1920, 1080, 960, 540, 2, "exact"),
    ("area 1080p->360p luma", "area", {}, 1920, 1080, 640, 360, 1, "exact"),
    ("area 1080p->360p chroma", "area", {}, 960, 540, 320, 180, 2, "exact"),
    ("area 4K->1080p luma", "area", {}, 3840, 2160, 1920, 1080, 1, "exact"),
    ("linear 1080p->4K luma", "linear", {}, 1920, 1080, 3840, 2160, 1, "exact"),
    ("lanczos3 4K->1080p luma", "lanczos", dict(degree=3), 3840, 2160, 1920, 1080, 1,
     "relaxed"),
    ("area 1080p->360p luma", "area", {}, 1920, 1080, 640, 360, 1, "relaxed"),
    ("lanczos3 4K->1080p luma", "lanczos", dict(degree=3), 3840, 2160, 1920, 1080, 1,
     "carry"),
    ("linear 1080p->4K luma", "linear", {}, 1920, 1080, 3840, 2160, 1, "carry"),
)


def variant_source(name: str, source: str | None = None) -> str:
    """The kernel source with variant ``name``'s substitutions; raises
    ValueError if one of its texts is not in the source as often as
    expected (once; the X tap loop four times, in its one-phase and
    per-output forms, integer and relaxed)."""
    return _ablate.variant_source(VARIANTS, SOURCE, name, source, _COUNTS)


def _load(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Bind a variant's library and raise its kernels' shared-memory limit."""
    lib = _build.bind_tiled(lib)
    rc = lib.iqo_tiled_set_max_smem(cuda_resize.SMEM_BUDGET)
    if rc != 0:
        raise RuntimeError(f"{name}: shared-memory limit refused (cudaError_t {rc})")
    return lib


def _launch(lib, ops, src: torch.Tensor) -> torch.Tensor:
    k, lay = ops.tables, ops.tables.layout
    (_, w), (dh, dw) = ops.plain.src_shape, ops.plain.dst_shape
    out = torch.empty((src.shape[0], dh, dw), dtype=torch.uint8, device=src.device)
    rc = lib.iqo_resize_tiled(
        int(k.wrap16), int(lay.s8y), lay.tw, int(lay.relaxed), int(lay.carry),
        src.data_ptr(), out.data_ptr(), src.shape[0], src.stride(0), src.stride(1),
        w, dh, dw, k.rrec.data_ptr(), k.rrec.shape[1], k.crec.data_ptr(),
        k.crec.shape[1], k.taps_y, k.taps_x, lay.k_rows, lay.pitch, lay.margin,
        lay.work_pitch, lay.max_phases, ops.plain.y_bias, ops.plain.out_shift,
        lay.planes, lay.run, lay.slots,
        torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed ({rc})")
    return out


def main(argv: list[str] | None = None) -> int:
    names = _ablate.names_of(sys.argv[1:] if argv is None else argv, VARIANTS)
    _ablate.require_card("tiled_ablate")
    card = _harness.card()
    libs = _ablate.load_variants(_ablate.build_variants(
        "ablate", names, SOURCE, variant_source, [_build.CSRC / u for u in UNITS], UNITS),
        _load)
    rng = np.random.default_rng(8)
    for tag, algo, kw, sw, sh, dw, dh, batch, form in PLANES:
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        ops = cuda_resize.pack_operands(plan, "cuda", relaxed=form == "relaxed",
                                        carry=form == "carry")
        if not ops.tables.tiled or ops.tables.carry != (form == "carry"):
            raise RuntimeError(f"{tag}: the tiled kernel's {form} form refuses")
        tag = f"{tag} [{cuda_resize.variant(ops.tables)}]"
        x = torch.from_numpy(rng.integers(0, 256, (batch, sh, sw), np.uint8)).cuda()
        if not torch.equal(_launch(libs["kernel"], ops, x),
                           cuda_resize.resize_plain(ops, x)):
            raise RuntimeError(f"{tag}: kernel != plain")
        xs = [x.clone() for _ in range(max(8, math.ceil(64e6 / x.numel())))]
        for i, t in enumerate(xs):
            t.view(-1)[i] += i
        ms = _ablate.time_in_turns(
            {n: (lambda t, n=n: _launch(libs[n], ops, t)) for n in names}, xs)
        print(f"{tag} ({batch}, {sh}, {sw}): " + ", ".join(
            f"{n} {ms[n]!r} ms ({ms[n] / ms['kernel']!r})" for n in names) + f" ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
