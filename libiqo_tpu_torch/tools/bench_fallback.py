"""The plain path's cost on one CUDA card: the plans that fall off the
kernels, and the cliff a user meets by asking for the plain path.  The port
of ``scripts/bench_fallback.py``.

    python -m libiqo_tpu_torch.tools.bench_fallback [--quick]

Per case of :data:`CASES` (the script's four, ``:27-41``): the resizer a
user builds on the card (``Resizer.from_plan(..., device="cuda")``) with
the route it resolves to (only Area 65536x16 -> 16x16 resolves to
``torch``: its window is too wide for 4 rows of the windowed kernel's
shared memory) and the kernel instantiation that ran; then the same plan
forced through ``backend="torch"``.  Then :data:`WIDE` (the wide-window
plans, ``card_check.WIDE_WINDOW``), which the JAX package's kernel takes
and the port's kernels now take too, on both routes.  Every output is held
byte for byte first: the route's to the plain path's, and the plain path's
to ``numpy_ref`` where the source is 1280x720 or smaller or the dense
products are small (``_bench.oracle_ok``).
The two routes of a case are timed in turns (route, torch, torch, route;
the min of each pair) at the host's pace, as a user meets them, by CUDA
events over back-to-back calls on distinct inputs past the L2
(``_harness.launches_ms``); a kernel route also on the card alone, the
card spinning while the host queues (the plain path's many launches
overfill the queue that such a spin holds).  Prints the card's name and
power limit and one line and one JSON line per case.  Exits 1 if a check
fails, 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..experiments import _harness
from . import _bench
from .card_check import WIDE_WINDOW

# scripts/bench_fallback.py:27-41, the same values
CASES = [
    # name, algorithm, sw, sh, dw, dh, kwargs
    ("area 64K wide, 4096 taps (real fallback)", "area",
     65536, 16, 16, 16, {}),
    ("area 512-tap X (in envelope now)", "area", 8192, 256, 16, 256, {}),
    ("lanczos3 16K wide (in envelope now)", "lanczos", 16384, 512,
     4096, 512, dict(degree=3)),
    ("lanczos3 4K->1080p (the headline config)", "lanczos", 3840, 2160,
     1920, 1080, dict(degree=3)),
]
WIDE = [(f"wide window {alg} {sw}x{sh}->{dw}x{dh}", alg, sw, sh, dw, dh, kw)
        for alg, sw, sh, dw, dh, kw in WIDE_WINDOW]
REPEATS, QUICK_REPEATS = 3, 1
QUICK_MIN_BYTES = 0       # the short form times two copies a case


def measure(case, src: np.ndarray, repeats: int, card: tuple[str, str],
            min_bytes: float = _bench.L2_COLD_BYTES) -> dict:
    """One case: both routes checked, then timed in turns."""
    from ..api import Resizer
    from ..core.plan import build_plan
    from ..golden import numpy_ref
    from ..ops import cuda_resize as cr

    name, alg, sw, sh, dw, dh, kw = case
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    routes = {"auto": Resizer.from_plan(plan, device="cuda"),
              "torch": Resizer.from_plan(plan, backend="torch", device="cuda")}
    x = torch.from_numpy(src).cuda()[None]
    cr.reset_launches()
    got = routes["auto"].resize(x)
    torch.cuda.synchronize()
    kernel = "/".join(v for v, n in cr.LAUNCHES_BY_VARIANT.items() if n) or None
    plain = routes["torch"].resize(x)
    _bench.check_equal(f"{name}: route vs plain", got, plain)
    held = "plain"
    if _bench.oracle_ok(plan):
        _bench.check_equal(f"{name}: plain vs numpy_ref", plain[0],
                           torch.from_numpy(numpy_ref.resize_u8(plan, src)))
        held = "numpy_ref"
    route = routes["auto"].resolved_backend()
    xs = [t for (t,) in _bench.copies((x,), min_bytes)]
    names = ["auto", "torch"] if route != "torch" else ["torch"]
    ms = {n: {"host_paced": []} | ({"device": []} if n == "auto" else {}) for n in names}
    for n in names + names[::-1]:
        ms[n]["host_paced"].append(_harness.launches_ms(routes[n].resize, xs, repeats,
                                                        primed=False))
        if n == "auto":     # the plain path's launches overfill the spin's queue
            ms[n]["device"].append(_harness.launches_ms(routes[n].resize, xs, repeats))
    times = {n: {k: min(v) for k, v in m.items()} for n, m in ms.items()}
    return {"case": name, "route": route, "kernel": kernel,
            "kernel_envelope": cr.supports_plan(plan),
            "work_rows": cr.work_rows(plan), "tiled": cr.tiled_ok(plan),
            "exact": True, "held_to": held, "ms": times,
            "mpix_per_s": {n: sw * sh / t["host_paced"] / 1e3 for n, t in times.items()},
            "bound_ms": _bench.plan_bytes(plan) / _harness.HBM_BYTES_PER_S * 1e3,
            "card": card[0], "power_limit": card[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer repeats and inputs; the same cases and checks")
    args = ap.parse_args(argv)
    _bench.require_card("bench_fallback")
    card = _bench.card()
    print(", ".join(card), flush=True)
    rng = np.random.default_rng(0)
    for case in CASES + WIDE:
        src = rng.integers(0, 256, (case[3], case[2]), np.uint8)
        t0 = time.perf_counter()
        row = measure(case, src, QUICK_REPEATS if args.quick else REPEATS, card,
                      QUICK_MIN_BYTES if args.quick else _bench.L2_COLD_BYTES)
        row["seconds"] = time.perf_counter() - t0
        t = row["ms"]
        print(f"{row['case']}: route {row['route']} ({row['kernel']}) "
              + "  ".join(f"{n} {v['host_paced']!r} ms host-paced"
                          + (f" ({v['device']!r} on the card)" if "device" in v else "")
                          for n, v in t.items())
              + f"  exact vs {row['held_to']}, {row['seconds']:.1f} s  ({card[0]}, {card[1]})")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
