"""Where kernel J's float32 forms spend their time: the conversions, the
warps a scheduler and the range test.  ``csrc/exp/exp_vpu_f32.cu`` (the
``wide`` form) and five variants of it, built side by side and timed in
turns with the serial form (``vpu_xpass_kernel``, from the probe library)
for ``corr_f32`` and ``muls_f32`` at R and R / 8; then the SASS of both
forms' loops.

The variants (:data:`VARIANTS`) are the source with text substitutions:

* ``kernel``: the source as it is: the exponent trick, three warps a block
  over thirds of the repeats (480 blocks of 96 threads, 1440 warps);
* ``i2f``: every warp converts with ``I2F`` (the trick's path never taken):
  the conversion unit's share of the wide form;
* ``one_slice``: one warp a block over all the repeats (480 warps, about
  one a scheduler, as the serial form ran), with the trick;
* ``one_slice_i2f``: both: the serial form's occupancy and conversions on
  the wide form's thread map;
* ``two_outputs``: 2 outputs a thread, twice the blocks and warps (960,
  2880), ``corr_f32``'s window shared by 2 outputs instead of 4;
* ``no_check``: every warp takes the trick without the warp-uniform range
  test (exact only on inputs below 2^22, as the probe's are): the test's
  share of the launch's fixed cost.

Each variant is held bit for bit equal to the plain version at R and R / 8
before it is timed.  Run on a card, from the repository root::

    python3 -m libiqo_tpu_torch.tools.vpu_f32_ablate

Builds go to ``build/libiqo_tpu_torch/vpu-f32-ablate-<hash>/<variant>/``
(one ``nvcc`` per variant, all started together).  Times
(:func:`._ablate.time_in_turns`): CUDA events, min over 5 repeats of
back-to-back launches on 8 operand sets that each differ in ``we[0, 0]``
and ``wo[0, 0]``, each call timed twice in order and then reversed (min of
its two); per application as the slope between R and R / 8 and as t(R)/R.
The SASS counts (``tools/sass_loads.loop_counts``, needs ``cuobjdump``):
``I2F``, ``I2FP``, ``F2I``, ``FADD``, ``FMUL``, ``FFMA`` and all
instructions in each loop of the serial and the wide kernels of the probe
library.  Prints one line per variant and kernel with the card's name and
power limit.  Raises without a card.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..experiments import _harness
from ..experiments import exp_vpu_xpass as vx
from ..ops import _build
from . import _ablate, sass_loads

__all__ = ["OPCODES", "VARIANTS", "main", "variant_source"]

SOURCE = _build.EXP_CSRC / "exp_vpu_f32.cu"
_FAST = "const bool fast = __all_sync(0xffffffffu, fits);"
_SLICES = "constexpr int kSlices = 3;"
# variant: [(text, replacement)], each text found once in the source
VARIANTS = {
    "kernel": [],
    "i2f": [(_FAST, "const bool fast = __all_sync(0xffffffffu, fits) && false;")],
    "one_slice": [(_SLICES, "constexpr int kSlices = 1;")],
    "one_slice_i2f": [(_SLICES, "constexpr int kSlices = 1;"),
                      (_FAST, "const bool fast = __all_sync(0xffffffffu, fits) && false;")],
    "two_outputs": [("constexpr int kOuts = 4;", "constexpr int kOuts = 2;")],
    "no_check": [(_FAST, "const bool fast = true;")],
}
OPCODES = ("I2F", "I2FP", "F2I", "FADD", "FMUL", "FFMA")
# mangled-name pieces of each form's kernel, by variant (the template argument)
KERNELS = {("corr_f32", "serial"): "vpu_xpass_kernelILi3E",
           ("muls_f32", "serial"): "vpu_xpass_kernelILi5E",
           ("corr_f32", "wide"): "vpu_f32_wide_kernelILi0E",
           ("muls_f32", "wide"): "vpu_f32_wide_kernelILi1E"}


def variant_source(name: str, source: str | None = None) -> str:
    """The kernel source with variant ``name``'s substitutions; raises
    ValueError if one of its texts is not in the source exactly once."""
    return _ablate.variant_source(VARIANTS, SOURCE, name, source)


def _load(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    return _build.bind_experiments(lib, ("iqo_exp_vpu_f32_wide", "iqo_exp_vpu_f32_shape"))


def launch(lib: ctypes.CDLL, variant: str, ops: vx.XpassOperands, reps: int) -> torch.Tensor:
    """One launch of a variant library's wide kernel."""
    out = torch.empty((vx.TH, vx.TW), dtype=torch.int32, device=ops.we.device)
    taps = (ctypes.c_int * vx.TAPS)(*ops.taps)
    _harness.check_rc(lib.iqo_exp_vpu_f32_wide(
        vx.WIDE_VARIANTS.index(variant), ops.we.data_ptr(), ops.wo.data_ptr(), taps,
        out.data_ptr(), reps, _harness.stream(ops.we)), f"vpu_f32_ablate {variant}")
    return out


def sass_lines() -> list[str]:
    """One line a loop of each form's kernel: its opcode counts."""
    lines = []
    for (variant, form), piece in KERNELS.items():
        for sym, found in sass_loads.loop_counts([piece], OPCODES).items():
            for i, counts in enumerate(found):
                lines.append(f"SASS {variant}[{form}] loop {i} of {len(found)} ({sym[:48]}...): "
                             + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return lines


def main(argv: list[str] | None = None) -> int:
    names = _ablate.names_of(sys.argv[1:] if argv is None else argv, VARIANTS)
    _ablate.require_card("vpu_f32_ablate")
    card = _harness.card()
    libs = _ablate.load_variants(_ablate.build_variants(
        "vpu-f32-ablate", names, SOURCE, variant_source, [_build.EXP_CSRC / "hopper.cuh"],
        [SOURCE.name]), _load)
    ops = vx.operands(torch.device("cuda", 0))
    xs = [ops.perturbed(i) for i in range(vx.ITERS)]
    reps_pair = (vx.R, vx.R // 8)
    for variant in vx.WIDE_VARIANTS:
        for name in names:
            for reps in reps_pair:
                if not torch.equal(launch(libs[name], variant, ops, reps),
                                   vx.vpu_xpass_plain(variant, ops, reps)):
                    raise RuntimeError(f"{variant} {name} R={reps}: kernel != plain")
        calls = {f"{n} {r}": (lambda o, n=n, r=r, v=variant: launch(libs[n], v, o, r))
                 for n in names for r in reps_pair}
        calls.update({f"serial {r}": (lambda o, r=r, v=variant: vx.vpu_xpass(v, o, r, "serial"))
                      for r in reps_pair})
        ms = _ablate.time_in_turns(calls, xs)
        app_b = vx.bound(variant)[2]
        for n in [*names, "serial"]:
            hi, lo = ms[f"{n} {vx.R}"], ms[f"{n} {vx.R // 8}"]
            slope = (hi - lo) / (vx.R - vx.R // 8) * 1e3
            print(f"{variant} {n}: {hi!r} ms at R={vx.R}, {lo!r} at R={vx.R // 8}; "
                  f"{slope!r} us/application (slope), t(R)/R {hi / vx.R * 1e3!r}; bound "
                  f"{app_b!r} ({card})", flush=True)
    for line in sass_lines():
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
