"""Where the host's time to issue a YUV420 frame goes: each step of the
executables' frame call (``ops/executable.launch_frame``) timed alone.

    python -m libiqo_tpu_torch.tools.host_split [--quick]

Lanczos3 4K -> 1080p, a lone frame of tensors on the card, as
``tools/bench_decomp.py``'s ``frame`` mode issues it.  Per step, by the
host clock, the µs a call: the min over rounds of ``CALLS`` calls back to
back, the card synchronised between rounds so that its queue never fills.
The steps:

* ``resize``: ``YUV420Resizer.resize`` as a user calls it;
* ``launch_frame``: the frame call without the facade;
* ``checks``: its three planes' checks;
* ``outputs``: its two output allocations;
* ``frame_ctypes``: the one C call, ``iqo_exec_launch_frame``, and its two
  launches (luma, and U and V as one);
* ``launch_ctypes``: ``iqo_exec_launch`` of luma alone, one launch;
* ``ctypes_only``: ``iqo_exec_launch`` with no frame, which returns before
  any launch: the ctypes call's own cost;
* ``views``: U's and V's views of their output (``unbind``);
* ``count``: one launch count;
* ``carry_flag``: reading ``LIBIQO_TPU_CARRY``;
* ``per_plane``: the per-plane path for contrast, ``cuda_resize.resize_fused``
  on luma and on U and V stacked.

The frame call is held to the per-plane path byte for byte first.  Prints
the card's name and power limit and one JSON line per step.  The steps are
timed in turns, in order and then reversed, round after round: the host's
pace drifts within a run.  Exits 1 if the check fails, 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import _bench
from .bench import DST_H, DST_W, SRC_H, SRC_W

CALLS, QUICK_CALLS = 200, 50
ROUNDS, QUICK_ROUNDS = 6, 2


def host_us(fns: dict, calls: int, rounds: int) -> dict:
    """Host µs a call of each of ``fns``: ``calls`` calls back to back,
    synchronised before and after, in turns (in order, then reversed) over
    ``rounds`` rounds; the min of each."""
    names = list(fns)
    best = dict.fromkeys(names, float("inf"))
    for rnd in range(rounds):
        for name in names if rnd % 2 == 0 else names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[name]()
            best[name] = min(best[name], (time.perf_counter() - t0) * 1e6 / calls)
            torch.cuda.synchronize()
    return best


def steps(r) -> dict:
    """Each step's call, over one lone frame on card 0."""
    from ..ops import cuda_resize, executable
    from ..yuv import YUV420Frame

    dev = torch.device("cuda", 0)
    y, u, v = (torch.from_numpy(p[0]).to(dev)
               for p in _bench.seeded_planes((1, SRC_H, SRC_W)))
    frame = YUV420Frame(y, u, v)
    luma, chroma = r._executables(0)
    hl, hc = luma.handle, chroma.handle
    lib = luma._lib
    oy = torch.empty(luma.dst_shape, dtype=torch.uint8, device=dev)
    ouv = torch.empty((2, *chroma.dst_shape), dtype=torch.uint8, device=dev)
    stream = executable._stream(0)
    got = r.resize(frame)
    want = (cuda_resize.resize_fused(luma.ops, y[None])[0],
            cuda_resize.resize_fused(chroma.ops, torch.stack([u, v])))
    for name, g, w in zip("yuv", (got.y, got.u, got.v), (want[0], *want[1])):
        _bench.check_equal(f"host_split {name}", g, w)

    def checks():
        luma.check(y)
        chroma.check(u)
        chroma.check(v)

    def outputs():
        torch.empty(luma.dst_shape, dtype=torch.uint8, device=dev)
        torch.empty((2, *chroma.dst_shape), dtype=torch.uint8, device=dev)

    return {
        "resize": lambda: r.resize(frame),
        "launch_frame": lambda: executable.launch_frame(luma, chroma, y, u, v),
        "checks": checks,
        "outputs": outputs,
        "frame_ctypes": lambda: lib.iqo_exec_launch_frame(
            hl, hc, 1, y.data_ptr(), 0, y.stride(0), oy.data_ptr(), u.data_ptr(), 0,
            u.stride(0), v.data_ptr(), 0, v.stride(0), ouv.data_ptr(), stream),
        "launch_ctypes": lambda: lib.iqo_exec_launch(hl, y.data_ptr(), oy.data_ptr(), 1, 0,
                                                     y.stride(0), stream),
        "ctypes_only": lambda: lib.iqo_exec_launch(hl, y.data_ptr(), oy.data_ptr(), 0, 0,
                                                   y.stride(0), stream),
        "views": lambda: ouv.unbind(0),
        "count": lambda: cuda_resize.count_launches(luma.variant, 0),
        "carry_flag": cuda_resize.carry_requested,
        "per_plane": lambda: (cuda_resize.resize_fused(luma.ops, y[None]),
                              cuda_resize.resize_fused(chroma.ops, torch.stack([u, v]))),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="fewer calls and rounds")
    args = ap.parse_args(argv)
    _bench.require_card("host_split")
    from ..yuv import YUV420Resizer

    name, limit = _bench.card()
    print(f"{name}, {limit}", flush=True)
    r = YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H, device="cuda")
    calls, rounds = (QUICK_CALLS, QUICK_ROUNDS) if args.quick else (CALLS, ROUNDS)
    for step, us in host_us(steps(r), calls, rounds).items():
        row = {"step": step, "us_per_call": us, "calls": calls, "rounds": rounds,
               "card": name, "power_limit": limit}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
