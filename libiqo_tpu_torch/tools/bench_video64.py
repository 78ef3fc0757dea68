"""Graded config 5 on one CUDA card: a batched 64-frame 4K -> 1080p Lanczos3
YUV420 video, device-resident.  The port of ``scripts/bench_video64.py``.

    python -m libiqo_tpu_torch.tools.bench_video64 [--batch N] [--quick]

All 64 frames (796 MB in, 199 MB out) are generated on the card from a
seeded ``torch.Generator(device="cuda")``, as the script generates them on
the TPU (``:47-55``), so no host staging is timed.  Each call resizes the
full YUV triple of every frame through ``YUV420Resizer(..., device="cuda")``'s
two kernels (luma, and U+V as one batch stacked beforehand), timed by the
protocol of ``tools/bench.py`` (``tools/_bench.py``): the slope per frame
between two counts of calls by CUDA events, the host clock per frame with a
synchronize, both guards.  Frames 0 and 63 through ``resize`` are held byte
for byte to the plain path first.  Prints the card's name and power limit,
the script's line and one JSON line.  Exits 1 if a check or guard fails, 2
without a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import _bench
from .bench import BASELINE_LUMA_MPIX_S, DST_H, DST_W, SRC_H, SRC_W

FRAMES = 64
SEED = 0
COUNTS, QUICK_COUNTS = (2, 6), (1, 3)
REPEATS, QUICK_REPEATS = 3, 2


def generate(batch: int, seed: int = SEED) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, uv) on the card: ``batch`` luma planes and their U and V planes
    stacked as one batch of 2 * ``batch``, uniform bytes from a seeded
    generator on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(h, w):
        return torch.randint(0, 256, (batch, h, w), generator=g, device="cuda",
                             dtype=torch.uint8)
    y = mk(SRC_H, SRC_W)
    uv = torch.cat([mk(SRC_H // 2, SRC_W // 2), mk(SRC_H // 2, SRC_W // 2)])
    return y, uv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=FRAMES)
    ap.add_argument("--quick", action="store_true",
                    help="fewer counts and repeats; the same shapes and checks")
    args = ap.parse_args(argv)
    _bench.require_card("bench_video64")
    from ..yuv import YUV420Resizer

    name, limit = _bench.card()
    print(f"{name}, {limit}", flush=True)
    r = YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H, device="cuda")
    plain = YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H, backend="torch",
                          device="cuda")
    y, uv = generate(args.batch)
    for i in sorted({0, args.batch - 1}):
        _bench.yuv_check(r, plain, y, uv, i, "bench_video64")
    t = _bench.timed(_bench.yuv_call(r), _bench.copies((y, uv)),
                     QUICK_COUNTS if args.quick else COUNTS,
                     QUICK_REPEATS if args.quick else REPEATS, args.batch,
                     _bench.yuv_bytes(r, args.batch))
    mpix = SRC_W * SRC_H / t["ms_per_frame"] / 1e3
    print(f"batched x{args.batch} 4K->1080p lanczos3 YUV (device-resident): "
          f"{t['ms_per_frame']!r} ms/frame  {mpix:,.0f} Mpix/s-in  "
          f"{mpix / BASELINE_LUMA_MPIX_S:.1f}x vs ref ({name}, {limit})")
    print(json.dumps({"batch": args.batch, "backend": r.resolved_backend(),
                      "mpix_per_s": mpix, "vs_baseline": mpix / BASELINE_LUMA_MPIX_S,
                      **t, "card": name, "power_limit": limit}), flush=True)
    return 1 if t["guards_failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
