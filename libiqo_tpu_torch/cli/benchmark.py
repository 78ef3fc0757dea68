"""Benchmark CLI, protocol-compatible with the reference harness
(ref: benchmark/benchmark.cpp:882-1036); the port of
``libiqo_tpu/cli/benchmark.py``, with the same flags, defaults and printed
lines, plus ``--device`` (default ``cuda``):

* ``-m method -iw W -ih H -ow W -oh H`` flags
* seeded-random YUV420 planes (ref: :51-59,1013-1015)
* N cycles (default 256, ref: :895), reporting the **min** ms/cycle
* like the reference, the default protocol constructs the resizer every
  cycle (ref: :1019-1031 constructs fresh iqo resizers per cycle); pass
  ``--amortized`` for the construct-once number (the realistic serving mode).
  Both take NumPy frames in and out and time with the host clock.

Optional side-by-side oracles (the reference's OpenCV/IPP comparison slots,
ref: benchmark.cpp:23-29): ``--oracle cv`` uses cv2 if installed, and
``--oracle pil`` uses PIL; both are skipped when unavailable.

Device modes:

* ``--batch B`` measures batched device-resident throughput: the planes
  stay on the device, many calls are in flight, and one synchronize ends
  the timed region;
* ``--stream N --batch B`` (CUDA only) measures the serving pipeline: N
  host frames in pinned memory move to the card in B-frame chunks on a
  second CUDA stream, ordered against compute by events, so the next
  chunk's upload overlaps the current chunk's resize; each result is copied
  back into pinned host buffers on a third stream (``non_blocking``), and
  the clock stops only when every frame's bytes have landed on the host.

``--profile DIR`` writes a ``torch.profiler`` trace of the timed region to
``DIR/trace.json``.

Usage::

    python -m libiqo_tpu_torch.cli.benchmark -m area -iw 1920 -ih 1080 \\
        -ow 640 -oh 360 [--amortized | --batch 16 | --stream 256 --batch 16]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _rand_planes(w, h, batch=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (h, w) if batch is None else (batch, h, w)
    cshape = (h // 2, w // 2) if batch is None else (batch, h // 2, w // 2)
    return (rng.integers(0, 256, shape, np.uint8),
            rng.integers(0, 256, cshape, np.uint8),
            rng.integers(0, 256, cshape, np.uint8))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _profiled(out_dir):
    """A torch.profiler trace of the block, written to out_dir/trace.json;
    nothing when out_dir is None."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(out_dir) / "trace.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark")
    ap.add_argument("-m", default="area", help="linear | area | lanczos[1-9]")
    ap.add_argument("-iw", type=int, default=1920)
    ap.add_argument("-ih", type=int, default=1080)
    ap.add_argument("-ow", type=int, default=640)
    ap.add_argument("-oh", type=int, default=360)
    ap.add_argument("--cycles", type=int, default=256)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "torch", "numpy"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to compute on (default cuda)")
    ap.add_argument("--amortized", action="store_true",
                    help="construct once instead of per cycle")
    ap.add_argument("--batch", type=int, default=0,
                    help="batched throughput mode (frames per call)")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="streaming pipeline mode (CUDA): N pinned host "
                         "frames through the device in --batch chunks, "
                         "transfers overlapped with compute")
    ap.add_argument("--precision", default="exact",
                    choices=["exact", "relaxed"],
                    help="relaxed: ≤ 2 LSB, flat fields exact")
    ap.add_argument("--oracle", choices=["cv", "pil"], default=None)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the timed region")
    args = ap.parse_args(argv)

    from ..utils.device import describe, resolve_device
    from ..yuv import YUV420Frame, YUV420Resizer

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.stream and device.type != "cuda":
        print("error: --stream measures host<->device transfers and needs a "
              "CUDA device", file=sys.stderr)
        return 2

    print(f"    size: {args.ow}x{args.oh}")
    print(f"  method: {args.m}  backend: {args.backend}")
    print(f"  device: {describe(device)}")

    def resizer():
        return YUV420Resizer(args.m, args.iw, args.ih, args.ow, args.oh,
                             backend=args.backend, precision=args.precision,
                             device=device)

    if args.stream:
        return _stream(args, resizer(), device)

    if args.batch:
        r = resizer()
        planes = [torch.from_numpy(a).to(device)
                  for a in _rand_planes(args.iw, args.ih, args.batch)]
        r.resize_batch(*planes)
        _sync(device)
        reps = max(1, args.cycles // args.batch)
        with _profiled(args.profile):
            # keep calls in flight, synchronize once: one host round trip
            # amortized over all frames instead of one per call
            t0 = time.perf_counter()
            for _ in range(reps):
                r.resize_batch(*planes)
            _sync(device)
            dt = (time.perf_counter() - t0) / (reps * args.batch)
        print(f"benchmark (batched x{args.batch}, {reps} calls in flight)")
        print(f"  backend: {r.resolved_backend()}")
        print(f"  elapsed time: {dt*1e3:8.3f} ms/cycle")
        print(f"  luma input:   {args.iw*args.ih/dt/1e6:10,.1f} Mpix/s")
        if args.profile:
            print(f"  profile: {args.profile}")
        return 0

    y, u, v = _rand_planes(args.iw, args.ih)
    frame = YUV420Frame(y, u, v)
    r = None
    if args.amortized:
        r = resizer()
        r.resize(frame)  # build the operands and the kernel outside the clock
    best, rr = float("inf"), r
    with _profiled(args.profile):
        for _ in range(args.cycles):
            t0 = time.perf_counter()
            rr = r or resizer()
            rr.resize(frame)    # NumPy out: returns once the bytes are on the host
            best = min(best, time.perf_counter() - t0)
    mode = "amortized" if args.amortized else "per-cycle construction"
    print(f"benchmark ({mode})")
    print(f"  backend: {(rr or resizer()).resolved_backend()}")
    print(f"  cycles: {args.cycles}")
    print(f"  elapsed time: {best*1e3:8.3f} ms/cycle")
    if args.profile:
        print(f"  profile: {args.profile}")

    if args.oracle:
        _run_oracle(args, frame)
    return 0


def _stream(args, r, device: torch.device) -> int:
    """The serving pipeline on a CUDA device: pinned uploads on one stream,
    resizes on the current stream, pinned downloads on a third, ordered by
    events."""
    chunk = args.batch or 16
    n_chunks = max(2, -(-args.stream // chunk))
    # distinct frame contents per chunk (nothing cacheable), made and pinned
    # outside the timed region: the timed pipeline is upload + resize +
    # download for every frame
    host = [tuple(torch.from_numpy(a).pin_memory()
                  for a in _rand_planes(args.iw, args.ih, chunk, seed=s))
            for s in range(min(n_chunks, 4))]
    warm = r.resize_batch(*(a.to(device) for a in host[0]))
    # a ring of pinned output buffers; downloads into one buffer run in
    # stream order, so each frame's bytes land before the next overwrite
    outs = [tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                  for o in warm) for _ in range(len(host))]
    torch.cuda.synchronize(device)

    compute = torch.cuda.current_stream(device)
    up = torch.cuda.Stream(device)
    down = torch.cuda.Stream(device)

    def upload(i):
        with torch.cuda.stream(up):
            dev = [a.to(device, non_blocking=True) for a in host[i % len(host)]]
            ready = torch.cuda.Event()
            ready.record(up)
        return dev, ready

    with _profiled(args.profile):
        t0 = time.perf_counter()
        nxt = upload(0)                  # the pipeline fill
        for i in range(n_chunks):
            dev, ready = nxt
            if i + 1 < n_chunks:
                nxt = upload(i + 1)      # overlaps this chunk's resize
            compute.wait_event(ready)
            for a in dev:                # allocated on `up`, used here
                a.record_stream(compute)
            res = r.resize_batch(*dev)
            done = torch.cuda.Event()
            done.record(compute)
            with torch.cuda.stream(down):
                down.wait_event(done)
                for dst, src in zip(outs[i % len(outs)], res):
                    dst.copy_(src, non_blocking=True)
                    src.record_stream(down)
        # every frame's download must really land on the host
        torch.cuda.synchronize(device)
        dt = (time.perf_counter() - t0) / (n_chunks * chunk)
    print(f"benchmark (streaming {n_chunks * chunk} frames, "
          f"chunks of {chunk}, transfers overlapped)")
    print(f"  backend: {r.resolved_backend()}")
    print(f"  elapsed time: {dt*1e3:8.3f} ms/frame")
    print(f"  luma input:   {args.iw*args.ih/dt/1e6:10,.1f} Mpix/s")
    if args.profile:
        print(f"  profile: {args.profile}")
    return 0


def _run_oracle(args, frame) -> None:
    """Side-by-side third-party timing, like the reference's OpenCV/IPP
    slots.  Comparison only — these do not share the fixed-point contract."""
    if args.oracle == "cv":
        try:
            import cv2
        except ImportError:
            print("  oracle: cv2 not installed, skipping")
            return
        inter = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR}.get(
            args.m, cv2.INTER_LANCZOS4)
        best = float("inf")
        for _ in range(min(64, args.cycles)):
            t0 = time.perf_counter()
            cv2.resize(frame.y, (args.ow, args.oh), interpolation=inter)
            cv2.resize(frame.u, (args.ow // 2, args.oh // 2), interpolation=inter)
            cv2.resize(frame.v, (args.ow // 2, args.oh // 2), interpolation=inter)
            best = min(best, time.perf_counter() - t0)
        print(f"  oracle cv2: {best*1e3:8.3f} ms/cycle")
    elif args.oracle == "pil":
        try:
            from PIL import Image
        except ImportError:
            print("  oracle: PIL not installed, skipping")
            return
        modes = {"area": Image.BOX, "linear": Image.BILINEAR}
        m = modes.get(args.m, Image.LANCZOS)
        best = float("inf")
        for _ in range(min(64, args.cycles)):
            t0 = time.perf_counter()
            Image.fromarray(frame.y).resize((args.ow, args.oh), m)
            Image.fromarray(frame.u).resize((args.ow // 2, args.oh // 2), m)
            Image.fromarray(frame.v).resize((args.ow // 2, args.oh // 2), m)
            best = min(best, time.perf_counter() - t0)
        print(f"  oracle PIL: {best*1e3:8.3f} ms/cycle")


if __name__ == "__main__":
    sys.exit(main())
