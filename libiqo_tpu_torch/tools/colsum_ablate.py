"""Where kernel H's walk (``band_colsum(..., form="walk")``,
``csrc/exp/exp_colsum_walk.cu`` ``band_colsum_walk_kernel``) spends its time
and where it stands against the grid form: the walk's launch changed one
choice at a time, and the kernel with one stage removed, timed in turns on
the narrow and luma-like ``element`` rows, beside the grid form and an empty
launch (the launch floor of the protocol).

Launch variants, launches of the one kernel (no rebuild), each held equal to
the plain version first:

* ``walk``: the launch :func:`exp_blocked_halo.colsum_walk` picks (16-byte
  loads, runs of 3 tiles, each source row of a run read once, one piece a
  thread);
* ``load4``: the same chunk and run with 4-byte loads (four times the load
  instructions, the same bytes in flight a thread);
* ``halo_twice``: runs of one tile, so every halo row is read again by the
  next tile's block (the grid form's reads, on the walk's code);
* ``run_double``: the walk's chunk with twice its run;
* ``two_phases``: the walk's blocks with two pieces a thread on half the
  threads (the second piece loaded after the first is summed, its stores
  after the first phase's);
* ``grid``: the first form's kernel (``form="grid"``).

Stage variants (:data:`STAGES`), the kernel source with text substitutions
built side by side (``tools/_ablate.py``) and launched as the walk; each
keeps every barrier and the work that feeds what it keeps (a removed store
sits behind a condition that reads its value and never holds), and computes
garbage:

* ``no_store``: no output stores;
* ``no_sum``: the stores add up no slot (each tile stores zeros);
* ``fetch_only``: both removed: the loads, the pieces' sums into their
  slots and the barriers;
* ``no_loads``: the loads predicated off, everything else kept.

Run on a card, from the repository root::

    python3 -m libiqo_tpu_torch.tools.colsum_ablate [variant ...]

Times (:func:`._ablate.time_in_turns`): CUDA events, the card spinning while
the host queues, min over 5 repeats of back-to-back launches on 8 sources
that each differ in one element (past the L2), each variant timed twice in
the order given, empty launch last, then reversed (min of its two); then the
walk and the grid form again on one source 8 times (L2-warm).  Prints one
line a row with each variant's launch, its time, its share of the bound's
pace and its time over the walk's, with the card's name and power limit.
Raises without a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys

import torch

from ..experiments import _harness
from ..experiments import exp_blocked_halo as bh
from ..ops import _build
from . import _ablate

__all__ = ["ROWS", "STAGES", "VARIANTS", "main", "variant_source", "walks"]

ROWS = ("narrow", "luma-like")          # element rows of bh.CONFIGS
VARIANTS = ("walk", "load4", "halo_twice", "run_double", "two_phases", "grid")
SOURCE = _build.EXP_CSRC / "exp_colsum_walk.cu"
_STORE = "      for (int r = 0; r < 8; ++r) o[(long long)r * (a.w / 4)] = make_uint4(s0, s1, s2, s3);"
# a condition that reads the value it guards and that the compiler cannot
# decide (it reads the call's n_t); no sum meets it in these rows
_NEVER = "static_cast<uint32_t>(a.n_t) << 30"
_NO_STORE = (_STORE, f"      if ((s0 ^ s1 ^ s2 ^ s3) == {_NEVER})\n  " + _STORE)
_NO_SUM = ("        if (p < P) {\n          const WalkPass& ps = a.pass[p];",
           "        if (p < P && a.n_t < 0) {\n          const WalkPass& ps = a.pass[p];")
_NO_LOADS = ("      v[r] = r < pc.rows ? __ldg(", "      v[r] = r < pc.rows && a.n_t < 0 ? __ldg(")
# variant: [(text, replacement)], each text found once in the source
STAGES = {
    "kernel": [],
    "no_store": [_NO_STORE],
    "no_sum": [_NO_SUM],
    "fetch_only": [_NO_STORE, _NO_SUM],
    "no_loads": [_NO_LOADS],
}


def walks(n_t: int, step: int, halo: int, w: int, sms: int = bh.H100_SMS) -> dict:
    """{variant: the walk's launch} for the ``element`` row (None: the grid
    form); a variant that does not fit a block is left out."""
    walk = bh.colsum_walk("element", n_t, step, halo, w, 16, sms)
    out = {"walk": walk,
           "load4": bh.colsum_walk("element", n_t, step, halo, w, 4, sms, cw=walk.cw,
                                   run=walk.run),
           "halo_twice": bh.colsum_walk("element", n_t, step, halo, w, 16, sms, cw=walk.cw,
                                        run=1),
           "run_double": bh.colsum_walk("element", n_t, step, halo, w, 16, sms, cw=walk.cw,
                                        run=min(n_t, 2 * walk.run))}
    out["two_phases"] = dataclasses.replace(walk, tps=-(-walk.pieces() // 2))
    return {**out, "grid": None}


def variant_source(name: str, source: str | None = None) -> str:
    """The kernel source with stage variant ``name``'s substitutions; raises
    ValueError if one of its texts is not in the source exactly once."""
    return _ablate.variant_source(STAGES, SOURCE, name, source)


def _load(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    _build.bind_experiments(lib, ("iqo_exp_band_colsum_walk",
                                  "iqo_exp_band_colsum_walk_setup"))
    rc = lib.iqo_exp_band_colsum_walk_setup()
    if rc != 0:
        raise RuntimeError(f"{name}: shared-memory limit refused (cudaError_t {rc})")
    return lib


def _stage_call(lib, walk: bh.ColsumWalk, out: torch.Tensor):
    def call(t):
        rc = lib.iqo_exp_band_colsum_walk(
            bh.VARIANTS.index("element"), t.data_ptr(), t.data_ptr(), out.data_ptr(), walk.w,
            walk.n_t, walk.step, walk.halo, walk.vec, walk.cw, walk.run, walk.tps,
            _harness.stream(t))
        if rc != 0:
            raise RuntimeError(f"colsum_ablate: launch failed ({rc})")
    return call


def main(argv: list[str] | None = None) -> int:
    asked = sys.argv[1:] if argv is None else argv
    unknown = sorted(set(asked) - set(VARIANTS) - set(STAGES))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; choose from "
                         f"{list(VARIANTS) + [s for s in STAGES if s != 'kernel']}")
    names = ["walk", *(v for v in (asked or VARIANTS) if v in VARIANTS and v != "walk")]
    stages = [v for v in (asked or STAGES) if v in STAGES and v != "kernel"]
    _ablate.require_card("colsum_ablate")
    card = _harness.card()
    libs = _ablate.load_variants(_ablate.build_variants(
        "colsum-ablate", ["kernel", *stages], SOURCE, variant_source, [], [SOURCE.name]),
        _load) if stages else {}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, n_t, step, halo, w in (c for c in bh.CONFIGS if c[0] in ROWS):
        x = next(s[-1] for s in bh.sources(dev, [(name, n_t, step, halo, w)])
                 if s[5] == "element")
        xs = _harness.perturbed(x, bh.ITERS)
        want = bh.band_colsum_plain(xs[-1], "element", n_t, step, halo)
        launches = walks(n_t, step, halo, w, sms)
        calls = {}
        for v in (n for n in names if n in launches):
            form, walk = ("grid", None) if launches[v] is None else ("walk", launches[v])
            fn = (lambda t, form=form, walk=walk:
                  bh.band_colsum(t, "element", n_t, step, halo, form=form, walk=walk))
            if not torch.equal(fn(xs[-1]), want):
                raise RuntimeError(f"{name} {v}: the kernel differs from its plain version")
            calls[v] = fn
        if stages:
            out = torch.empty((8 * n_t, w), dtype=torch.int32, device=dev)
            _stage_call(libs["kernel"], launches["walk"], out)(xs[-1])
            if not torch.equal(out, want):
                raise RuntimeError(f"{name}: the rebuilt kernel differs from its plain version")
            for v in stages:
                calls[v] = _stage_call(libs[v], launches["walk"], out)
        calls["empty_launch"] = lambda t: torch.cuda._sleep(0)
        ms = _ablate.time_in_turns(calls, xs)
        warm = _ablate.time_in_turns({v: calls[v] for v in ("walk", "grid") if v in calls},
                                     [xs[-1]] * len(xs))
        b_ms = bh.bound("element", n_t, step, halo, w)[0]
        parts = []
        for v in calls:
            walk = launches.get(v)
            how = (f" [vec {walk.vec}, chunk {walk.cw} B, run {walk.run}, {walk.threads} "
                   f"threads, {walk.phases()} phases, {walk.blocks} blocks, re-read "
                   f"{walk.reread!r}]" if walk else "")
            parts.append(f"{v}{how} {ms[v]!r} ms ({b_ms / ms[v]!r} of the bound's pace, "
                         f"{ms[v] / ms['walk']!r} of the walk's)")
        print(f"{name} element (bound {b_ms!r} ms): " + "; ".join(parts) + f"; one source "
              f"8 times (L2-warm): {warm} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
