"""Where a YUV420 frame's time goes on one CUDA card: the headline loop of
``tools/bench.py`` split into its terms.  The port of
``scripts/bench_decomp.py`` and ``scripts/perf_probe.py`` as one module.

    python -m libiqo_tpu_torch.tools.bench_decomp [--quick]

Lanczos3 4K -> 1080p through ``YUV420Resizer(..., device="cuda")``'s two
kernels, at a batch of 16 frames (the scripts' ``BATCH``) and of one (the
lone frame of PERF.md section 5, item 2).  Per mode, by CUDA events, the
slope per frame between two counts of calls over copies one byte apart
(``tools/_bench.py``):

* ``frame``: ``YUV420Resizer.resize`` (a lone frame) or ``resize_batch``
  on Y, U and V as tensors of their own, as a user calls them: the
  executables' one frame call (``ops/executable.launch_frame``);
* ``full``: luma and chroma (U and V as one batch), ``tools/bench.py``'s call;
* ``luma``: the luma call alone;
* ``chroma``: the chroma call alone;
* ``floor``: the perturbation and nothing else: one byte written into the
  luma and the chroma batch, as the JAX loop's ``dynamic_update_slice`` of
  the loop index.  The other modes take copies perturbed beforehand, so
  this floor is not inside them: it is what a per-call perturbation would
  add.

Per call, by the host clock: the time the host takes to issue each mode's
calls (the calls' enqueue alone, the card left to catch up afterwards),
beside the card's time for the same call, so that a host-bound pace shows.
The scripts' ``dus`` and ``pad`` terms have no counterpart here: a PyTorch
call has no loop-carried update to alias, and the kernels read the frame
in place with no padded copy.  Frame 0 of each batch is held byte for byte
to the plain path first, and the ``frame`` mode's whole call too; its rows
carry ``tools/_bench.guards``' failures (``guards_failed``, empty when every
guard passes).  Prints the card's name and power limit, one line and one
JSON line per batch and mode.  Exits 1 if a check fails, 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import _bench
from .bench import DST_H, DST_W, SRC_H, SRC_W

BATCHES = (16, 1)
COUNTS = {16: (8, 32), 1: (64, 256)}
QUICK_COUNTS = {16: (2, 6), 1: (16, 64)}
REPEATS, QUICK_REPEATS = 3, 2
MODES = ("frame", "full", "luma", "chroma", "floor")


def frame_call(r, batch: int):
    """The ``frame`` mode's call of ``(y, u, v)``: ``r.resize`` of one frame
    (planes without a batch dimension) or ``r.resize_batch``."""
    from ..yuv import YUV420Frame

    if batch == 1:
        return lambda x: r.resize(YUV420Frame(*x))
    return lambda x: r.resize_batch(*x)


def calls(r) -> dict:
    """Each mode's call of ``(y, uv)`` but ``frame``'s (:func:`frame_call`)."""
    luma, chroma = r._luma, r._chroma

    def floor(x):      # fill_ with a Python number: one launch, no copy from the host
        x[0].view(-1)[:1].fill_(1)
        x[1].view(-1)[:1].fill_(1)
    return {"full": _bench.yuv_call(r), "luma": lambda x: luma.resize(x[0]),
            "chroma": lambda x: chroma.resize(x[1]), "floor": floor}


def issue_ms(call, inputs, n: int, repeats: int) -> float:
    """Host ms to issue one call: ``n`` calls queued back to back on the
    host clock, min over ``repeats``; the card catches up after each."""
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            call(inputs[i % len(inputs)])
        best = min(best, (time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer counts and repeats; the same shapes and checks")
    args = ap.parse_args(argv)
    _bench.require_card("bench_decomp")
    from ..yuv import YUV420Resizer

    name, limit = _bench.card()
    print(f"{name}, {limit}", flush=True)
    r = YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H, device="cuda")
    plain = YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H, backend="torch",
                          device="cuda")
    repeats = QUICK_REPEATS if args.quick else REPEATS
    planes = [torch.from_numpy(p).cuda()
              for p in _bench.seeded_planes((max(BATCHES), SRC_H, SRC_W))]
    for batch in BATCHES:
        y, u, v = (p[:batch] for p in planes)
        uv = torch.cat([u, v])
        _bench.yuv_check(r, plain, y, uv, 0, f"bench_decomp batch {batch}")
        yuv = (y, u, v) if batch > 1 else (y[0], u[0], v[0])
        frame = frame_call(r, batch)
        got, want = frame(yuv), frame_call(plain, batch)(yuv)
        for i, plane in enumerate("yuv"):
            _bench.check_equal(f"bench_decomp batch {batch} frame {plane}",
                               getattr(got, plane) if batch == 1 else got[i],
                               getattr(want, plane) if batch == 1 else want[i])
        xs, frame_xs = _bench.copies((y, uv)), _bench.copies(yuv)
        counts = (QUICK_COUNTS if args.quick else COUNTS)[batch]
        for mode, call in {"frame": frame, **calls(r)}.items():
            inputs = frame_xs if mode == "frame" else xs
            t = _bench.slope(call, inputs, counts, repeats)
            row = {"batch": batch, "mode": mode, "ms_per_frame": t["ms"] / batch,
                   "device_ms_per_call": t["ms"],
                   "issue_ms_per_call": issue_ms(call, inputs, counts[1], repeats),
                   "ms_per_call_with_sync": t["ms_with_sync"], "counts": t["counts"],
                   "card": name, "power_limit": limit}
            if mode == "frame":
                row["guards_failed"] = _bench.guards(t["ms"], t["ms_with_sync"],
                                                     _bench.yuv_bytes(r, batch))
            print(f"batch {batch:2d} {mode:7s}: {row['ms_per_frame']!r} ms/frame on "
                  f"the card; a call {row['device_ms_per_call']!r} ms on the card, "
                  f"{row['issue_ms_per_call']!r} ms issued ({name}, {limit})")
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
