"""Kernel I's s8 gemm form on its persistent walk against the same kernel on
``s16_1dot``'s slicing: ``csrc/exp/exp_xpass_s8.cu`` and a variant of it
that takes its blocks' runs from the slicing, built side by side and timed
in turns for ``s8_4dot`` and ``s8_2dot_cat`` at R and R / 8.

The variants (:data:`VARIANTS`) are the source with text substitutions:

* ``kernel``: the source as it is, the walk of ``min(SMs, units)`` blocks
  in equal contiguous runs;
* ``slices``: block ``tile x slices + s`` takes steps ``[s sps, (s + 1)
  sps)`` of its tile, ``sps = ceil(steps / slices)``, launched on ``60 x
  slices`` blocks as :func:`..experiments.xpass_gemm.geometry` picks the
  slices for ``S16_GEMM`` (at R = 512: 120 blocks of 32 steps).

Both compute the kernel's function and are held bit for bit equal to the
plain version before they are timed.  Run on a card, from the repository
root::

    python3 -m libiqo_tpu_torch.tools.s8_ablate

Builds go to ``build/libiqo_tpu_torch/s8-ablate-<hash>/<variant>/`` (one
``nvcc`` per variant, all started together).  Times
(:func:`._ablate.time_in_turns`): CUDA events, min over 5 repeats of
back-to-back launches on 8 work tiles that each differ in ``w[0, 0]``, each
call timed twice in order and then reversed (min of its two).  Prints one
line per variant with the card's name and power limit.  Raises without a
card.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..experiments import _harness, xpass_gemm
from ..experiments import exp_x_schemes as xs
from ..ops import _build
from . import _ablate

__all__ = ["VARIANTS", "main", "variant_source"]

SOURCE = _build.EXP_CSRC / "exp_xpass_s8.cu"
_WALK = """  const long long units = static_cast<long long>(kTiles) * steps;
  long long u = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;"""
_SLICES = """  const int slices = gridDim.x / kTiles, sps = (steps + slices - 1) / slices;
  const int tile0 = blockIdx.x / slices, s = blockIdx.x % slices;
  long long u = static_cast<long long>(tile0) * steps + s * sps;
  const long long u1 = static_cast<long long>(tile0) * steps + min((s + 1) * sps, steps);"""
# variant: [(text, replacement)], each text found once in the source
VARIANTS = {"kernel": [], "slices": [(_WALK, _SLICES)]}


def variant_source(name: str, source: str | None = None) -> str:
    """The kernel source with variant ``name``'s substitutions; raises
    ValueError if one of its texts is not in the source exactly once."""
    return _ablate.variant_source(VARIANTS, SOURCE, name, source)


def blocks(name: str, reps: int, sms: int) -> int:
    """The blocks variant ``name`` is launched on at ``reps`` repeats."""
    if name == "slices":
        return xpass_gemm.geometry(xpass_gemm.S16_GEMM, reps, sms).blocks
    return xpass_gemm.s8_launch(reps, sms).blocks


def _load(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    _build.bind_experiments(lib, ("iqo_exp_xscheme_s8_gemm", "iqo_exp_xpass_s8_setup"))
    rc = lib.iqo_exp_xpass_s8_setup()
    if rc != 0:
        raise RuntimeError(f"{name}: shared-memory limit refused (cudaError_t {rc})")
    return lib


def main(argv: list[str] | None = None) -> int:
    names = _ablate.names_of(sys.argv[1:] if argv is None else argv, VARIANTS)
    _ablate.require_card("s8_ablate")
    card = _harness.card()
    libs = _ablate.load_variants(_ablate.build_variants(
        "s8-ablate", names, SOURCE, variant_source, [_build.EXP_CSRC / "hopper.cuh"],
        [SOURCE.name]), _load)
    dev = torch.device("cuda", 0)
    sms = xpass_gemm.sm_count(dev)
    w, c = xs.inputs(dev)
    corr = torch.from_numpy(np.random.default_rng(15).integers(
        -2**31, 2**31, (xs.N_G, xs.GN)).astype(np.int32)).to(dev)
    ws = _harness.perturbed(w, xs.ITERS)
    for variant in ("s8_4dot", "s8_2dot_cat"):
        cv = {**xs.build_cvals(variant, c), "corr": corr}

        def launch(name, x, reps, cv=cv, cat=int(variant == "s8_2dot_cat")):
            out = torch.zeros((xs.TH, xs.TW), dtype=torch.int32, device=dev)
            _harness.check_rc(libs[name].iqo_exp_xscheme_s8_gemm(
                x.data_ptr(), cv["ef_k"].data_ptr(), cv["corr"].data_ptr(), out.data_ptr(),
                reps, cat, blocks(name, reps, sms), _harness.stream(x)), f"s8_ablate {name}")
            return out

        for name in names:
            for reps in (xs.R, xs.R // 8):
                if not torch.equal(launch(name, w, reps), xs.x_scheme_plain(variant, w, cv, reps)):
                    raise RuntimeError(f"{variant} {name} R={reps}: kernel != plain")
        calls = {f"{n} {r}": (lambda x, n=n, r=r: launch(n, x, r))
                 for n in names for r in (xs.R, xs.R // 8)}
        ms = _ablate.time_in_turns(calls, ws)
        per = {n: (ms[f"{n} {xs.R}"] / xs.R * 1e3,
                   (ms[f"{n} {xs.R}"] - ms[f"{n} {xs.R // 8}"]) / (xs.R - xs.R // 8) * 1e3)
               for n in names}
        print(f"{variant}[gemm]: " + ", ".join(
            f"{n} ({blocks(n, xs.R, sms)} blocks at R={xs.R}) {ms[f'{n} {xs.R}']!r} ms, "
            f"t(R)/R {per[n][0]!r} us/application, slope {per[n][1]!r}" for n in names)
            + "".join(f"; {n} / kernel t(R)/R {per[n][0] / per['kernel'][0]!r}"
                      for n in names if n != "kernel") + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
