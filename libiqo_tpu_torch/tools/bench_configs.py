"""Every graded config on one CUDA card, ms per frame.  The port of
``scripts/bench_configs.py``.

    python -m libiqo_tpu_torch.tools.bench_configs [--relaxed] [--quick] [config ...]

Per config of :data:`CONFIGS` (the script's five, with its reference
baselines :data:`BASELINES`): a batch of 8 seeded frames through the
config's resizer on the card (``Resizer.from_plan(..., device="cuda")``,
its route printed), held byte for byte first: frame 0 to ``numpy_ref``
where the source is 1280x720 or smaller (``_bench.oracle_ok``) and to the
plain path elsewhere.
``--relaxed`` measures the relaxed route instead and holds it to its own
plain version, reporting its largest error against the exact output, which
must be 2 LSB or less, with flat fields 0, 128 and 255 exact.

Then the protocol of ``tools/bench.py`` (``tools/_bench.py``): the slope
per frame between two counts of calls by CUDA events, the host clock per
frame with a synchronize, both guards.  Prints the card's name and power
limit, then one line and one JSON line per config.  Exits 1 if a check or
guard fails, 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import _bench

# scripts/bench_configs.py:20-29, the same values
CONFIGS = {
    "linear": ("linear", 640, 480, 320, 240, {}),
    "area": ("area", 1920, 1080, 480, 270, {}),
    "upsample": ("lanczos", 1280, 720, 1920, 1080, dict(degree=2)),
    "luma4k": ("lanczos", 3840, 2160, 1920, 1080, dict(degree=3)),
    "chroma": ("lanczos", 1920, 1080, 960, 540, dict(degree=3, px_scale=2)),
}
BASELINES = {  # reference AVX512 1-core Mpix/s-in (BASELINE.md)
    "linear": 1689.0, "area": 6562.0, "upsample": 400.0, "luma4k": 1222.0,
}
BATCH = 8
COUNTS, QUICK_COUNTS = (8, 32), (4, 12)
REPEATS, QUICK_REPEATS = 3, 2
RELAXED_LSB = 2
FLAT_VALUES = (0, 128, 255)


def measure(name: str, relaxed: bool, quick: bool, card: tuple[str, str]) -> dict:
    """One config: its checks, then its timing; the result's row."""
    from ..core.plan import build_plan
    from ..golden import numpy_ref
    from ..ops import cuda_resize
    from ..api import Resizer

    alg, sw, sh, dw, dh, kw = CONFIGS[name]
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    precision = "relaxed" if relaxed else "exact"
    r = Resizer.from_plan(plan, precision=precision, device="cuda")
    src_np = np.random.default_rng(0).integers(0, 256, (BATCH, sh, sw), np.uint8)
    src = torch.from_numpy(src_np).cuda()
    out = r.resize(src)
    dev = src.device
    exact_plain = cuda_resize.resize_plain(r._operands(dev), src[:1])
    row = {"config": name, "plan": f"{alg}{kw.get('degree', '')} {sw}x{sh}->{dw}x{dh}"
           + (f" px{kw['px_scale']}" if kw.get("px_scale") else ""),
           "route": r.resolved_backend(), "precision": precision}
    if relaxed:
        _bench.check_equal(f"{name} relaxed vs its plain version", out[:1],
                           cuda_resize.resize_plain(r._operands(dev, relaxed=True), src[:1]))
        row["max_lsb_vs_exact"] = int((out[:1].int() - exact_plain.int()).abs().max())
        for v in FLAT_VALUES:
            flat = torch.full_like(src[:1], v)
            _bench.check_equal(f"{name} relaxed flat {v}", r.resize(flat),
                               cuda_resize.resize_plain(r._operands(dev), flat))
        if row["max_lsb_vs_exact"] > RELAXED_LSB:
            raise AssertionError(f"{name}: relaxed {row['max_lsb_vs_exact']} LSB "
                                 f"from exact (> {RELAXED_LSB})")
    elif _bench.oracle_ok(plan):
        _bench.check_equal(f"{name} vs numpy_ref", out[0],
                           torch.from_numpy(numpy_ref.resize_u8(plan, src_np[0])))
        row["held_to"] = "numpy_ref"
    else:
        _bench.check_equal(f"{name} vs plain", out[:1], exact_plain)
        row["held_to"] = "plain"
    t = _bench.timed(r.resize, [x for (x,) in _bench.copies((src,))],
                     QUICK_COUNTS if quick else COUNTS,
                     QUICK_REPEATS if quick else REPEATS, BATCH,
                     _bench.plan_bytes(plan, BATCH))
    mpix = sw * sh / t["ms_per_frame"] / 1e3
    base = BASELINES.get(name)
    return {**row, **t, "mpix_per_s": mpix, "baseline_mpix_per_s": base,
            "vs_baseline": mpix / base if base else None,
            "card": card[0], "power_limit": card[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", help=f"any of {', '.join(CONFIGS)} (default all)")
    ap.add_argument("--relaxed", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="fewer counts and repeats; the same shapes and checks")
    args = ap.parse_args(argv)
    if set(args.configs) - set(CONFIGS):
        ap.error(f"unknown configs {sorted(set(args.configs) - set(CONFIGS))}")
    _bench.require_card("bench_configs")
    card = _bench.card()
    print(", ".join(card), flush=True)
    failed = False
    for name in args.configs or list(CONFIGS):
        row = measure(name, args.relaxed, args.quick, card)
        vs = f"  {row['vs_baseline']:6.1f}x vs ref" if row["vs_baseline"] else ""
        check = (f"max {row['max_lsb_vs_exact']} LSB" if args.relaxed
                 else f"exact vs {row['held_to']}")
        print(f"{name:9s} {row['plan']}: {row['ms_per_frame']!r} ms/frame  "
              f"{row['mpix_per_s']:.0f} Mpix/s-in{vs}  {check}  route {row['route']}  "
              f"({card[0]}, {card[1]})")
        print(json.dumps(row), flush=True)
        failed |= bool(row["guards_failed"])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
