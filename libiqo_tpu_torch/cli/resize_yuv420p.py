"""CLI parity with the reference sample (ref: sample/resize_yuv420p.cpp).

Usage (the reference's flags, plus ``--backend`` and ``--device``):

    python -m libiqo_tpu_torch.cli.resize_yuv420p \
        -m lanczos3 -i in.yuv -iw 3840 -ih 2160 -o out.yuv -ow 1920 -oh 1080

Reads a raw planar YUV420 file, resizes Y at full size and U/V at half size
(Lanczos chroma with px_scale=2), writes a raw file.  Runs on the CUDA card
by default; ``--device cuda`` with no card is an error, never a silent CPU
run.
"""

from __future__ import annotations

import argparse
import itertools
import sys

from ..yuv import YUV420Resizer, iter_yuv420, write_yuv420


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="resize_yuv420p",
        description="Resize raw planar YUV420 images (libiqo_tpu_torch)")
    ap.add_argument("-m", default="area",
                    help="method: linear | area | lanczos[1-9] (default area)")
    ap.add_argument("-i", required=True, help="input .yuv path")
    ap.add_argument("-iw", type=int, required=True, help="input width")
    ap.add_argument("-ih", type=int, required=True, help="input height")
    ap.add_argument("-o", required=True, help="output .yuv path")
    ap.add_argument("-ow", type=int, required=True, help="output width")
    ap.add_argument("-oh", type=int, required=True, help="output height")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "torch", "numpy"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to compute on (default cuda)")
    ap.add_argument("--precision", default="exact",
                    choices=["exact", "relaxed"],
                    help="relaxed: ≤ 2 LSB, flat fields exact")
    ap.add_argument("--frames", type=int, default=None,
                    help="max frames to process (default: all)")
    args = ap.parse_args(argv)

    try:
        r = YUV420Resizer(args.m, args.iw, args.ih, args.ow, args.oh,
                          backend=args.backend, precision=args.precision,
                          device=args.device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # stream frame by frame: constant memory for any file length.  Validate
    # the input before touching the output path, so a bad -i never
    # truncates an existing -o.
    try:
        frames_in = iter_yuv420(args.i, args.iw, args.ih, args.frames)
        first = next(frames_in, None)
    except OSError as e:
        print(f"error: could not read {args.i}: {e}", file=sys.stderr)
        return 1
    if first is None:
        print("error: no complete frames in input", file=sys.stderr)
        return 1

    count = 0

    def resized():
        nonlocal count
        for f in itertools.chain([first], frames_in):
            yield r.resize(f)
            count += 1

    try:
        write_yuv420(args.o, resized())
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"{count} frame(s): {args.iw}x{args.ih} -> {args.ow}x{args.oh} "
          f"({args.m}, backend={r.resolved_backend()}, device={args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
