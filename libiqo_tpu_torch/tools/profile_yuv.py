"""Where the time goes on the YUV420 main path, on one CUDA device.

    python -m libiqo_tpu_torch.tools.profile_yuv [-m METHOD -iw W -ih H
        -ow W -oh H] [--precision exact|relaxed] [--out FILE]

One YUV420 frame, by default 3840x2160 -> 1920x1080, Lanczos3 (the
Lanczos main path; ``-m area -iw 1920 -ih 1080 -ow 640 -oh 360`` is the
benchmark CLI's default), through ``YUV420Resizer(..., device="cuda")``.
For the kernel (``backend="cuda"``; with ``--precision relaxed`` its
relaxed route, ``cuda-relaxed``) and the plain path (``backend="torch"``,
always exact), with frames already on the card (tensor in / tensor out)
and as NumPy frames (the CLI's form), it measures:

* latency: host clock around one ``resize`` ended by
  ``torch.cuda.synchronize()``, median and p90 over 120 frames;
* streamed time per frame: host clock over 64 back-to-back frames and one
  synchronize;
* with ``torch.profiler`` over 32 streamed frames: the device's
  busy time as the union of its kernel, copy and memset intervals (each
  instant counted once, however many of them overlap), its share of the
  profiled window, and device time per frame by kind (kernel, H2D, D2H,
  other).  The profiler slows the host, so the window's busy share is a
  lower bound; ``busy_share_of_streamed`` divides the profiled busy time
  per frame by the unprofiled streamed time per frame instead.

Prints the card's name and power limit, then one JSON line per form, and
writes all of them to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import yuv

N_SYNC, N_STREAM, N_PROFILED = 120, 64, 32
N_FRAMES = 16          # distinct seeded frames, cycled through
SEED = 1
WINDOW = "libiqo_profile_window"


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals; overlaps count once."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _kind(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith(("Memcpy", "Memset")):
        return "other"
    return "kernel"


def _device_profile(resize, frames, n: int) -> dict:
    """Busy union, busy share and per-kind device ms per frame over n
    streamed frames, from the profiler's device intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(n):
                resize(frames[i % len(frames)])
            torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events
              if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"found {len(window)} profile windows, expected 1")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    spans = [(max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
             for e in events
             if e.device_type == DeviceType.CUDA and e.name != WINDOW
             and not getattr(e, "is_user_annotation", False)]
    spans = [s for s in spans if s[1] > s[0]]
    if not spans:
        return {"device_busy_ms_per_frame": None,
                "note": "the profiler recorded no device activity"}
    busy_us = union_length((a, b) for a, b, _ in spans)
    by_kind: dict[str, float] = {}
    for a, b, name in spans:
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + (b - a)
    return {
        "profiled_frames": n,
        "window_ms": (w1 - w0) / 1e3,
        "device_busy_ms_per_frame": busy_us / 1e3 / n,
        "device_busy_share": busy_us / (w1 - w0),
        "device_ms_per_frame_by_kind": {k: v / 1e3 / n
                                        for k, v in sorted(by_kind.items())},
    }


def measure(resizer, frames, luma_pixels: int) -> dict:
    for f in frames[:3]:
        resizer.resize(f)
    torch.cuda.synchronize()
    lat = []
    for i in range(N_SYNC):
        t0 = time.perf_counter()
        resizer.resize(frames[i % len(frames)])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    t0 = time.perf_counter()
    for i in range(N_STREAM):
        resizer.resize(frames[i % len(frames)])
    torch.cuda.synchronize()
    stream_ms = (time.perf_counter() - t0) * 1e3 / N_STREAM
    prof = _device_profile(resizer.resize, frames, N_PROFILED)
    busy = prof["device_busy_ms_per_frame"]
    return {"sync_median_ms": float(np.median(lat)),
            "sync_p90_ms": lat[int(0.9 * len(lat))], "sync_n": N_SYNC,
            "stream_ms_per_frame": stream_ms, "stream_n": N_STREAM,
            "luma_mpix_per_s_streamed": luma_pixels / stream_ms / 1e3,
            **prof,
            "busy_share_of_streamed": None if busy is None else busy / stream_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", default="lanczos3", help="linear | area | lanczos[1-9]")
    ap.add_argument("-iw", type=int, default=3840)
    ap.add_argument("-ih", type=int, default=2160)
    ap.add_argument("-ow", type=int, default=1920)
    ap.add_argument("-oh", type=int, default=1080)
    ap.add_argument("--precision", default="exact", choices=["exact", "relaxed"])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sw, sh = args.iw, args.ih
    if not torch.cuda.is_available():
        ap.error("needs a CUDA device")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rng = np.random.default_rng(SEED)
    host = [yuv.YUV420Frame(
        rng.integers(0, 256, (sh, sw), np.uint8),
        rng.integers(0, 256, (sh // 2, sw // 2), np.uint8),
        rng.integers(0, 256, (sh // 2, sw // 2), np.uint8))
        for _ in range(N_FRAMES)]
    dev = [yuv.YUV420Frame(*(torch.from_numpy(p).cuda()
                             for p in (f.y, f.u, f.v))) for f in host]
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "frame": f"{args.m} {sw}x{sh}->{args.ow}x{args.oh}",
              "precision": args.precision, "forms": {}}
    for backend in ("cuda", "torch"):
        r = yuv.YUV420Resizer(args.m, sw, sh, args.ow, args.oh, backend=backend,
                              precision=args.precision, device="cuda")
        for form, frames in (("device", dev), ("numpy", host)):
            key = f"{r.resolved_backend()}/{form}"
            result["forms"][key] = m = measure(r, frames, sw * sh)
            print(key, json.dumps(m), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
