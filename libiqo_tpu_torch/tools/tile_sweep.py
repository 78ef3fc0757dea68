"""The tiled kernel's output-tile width on one CUDA card.  The port of
``scripts/tile_sweep.py``.

    python -m libiqo_tpu_torch.tools.tile_sweep [--quick] [geometry ...]

The script sweeps the Pallas kernel's (th, tw) tiles; the port's tiled
kernel (``csrc/resize_tiled.cuh``) has 16-row tiles and three compiled
widths, ``cuda_resize.TILED_WIDTHS`` (128, 64, 32 output columns a block).
Per geometry of :data:`GEOMS` (the script's four, a batch of 8 seeded
frames), ``resize_tiled`` at every width whose layout fits shared memory
(``tiled_layout(plan, tw=...)``, its tables by ``tiled_tables``), each held
byte for byte to the plain path on the card first, then timed in turns
(the widths in order, then reversed; the min of each pair): device ms a
call by CUDA events with the card spinning while the host queues
(``_harness.turns_ms``), over distinct inputs past the L2.  The width that
``tiled_width`` picks for the plan is marked.  Prints the card's name and
power limit and one line and one JSON line per geometry.  Exits 1 if a
check fails, 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..experiments import _harness
from . import _bench

# scripts/tile_sweep.py:16-22, the same values
GEOMS = {
    "luma": ("lanczos", 3840, 2160, 1920, 1080, dict(degree=3)),
    "chroma": ("lanczos", 1920, 1080, 960, 540, dict(degree=3, px_scale=2)),
    "upsample": ("lanczos", 1280, 720, 1920, 1080, dict(degree=2)),
    "area": ("area", 1920, 1080, 480, 270, {}),
}
BATCH = 8
REPEATS, QUICK_REPEATS = 5, 2


def sweep(which: str, card: tuple[str, str], repeats: int = REPEATS) -> dict:
    """One geometry: each fitting width checked, then all timed in turns."""
    from ..core.plan import build_plan
    from ..ops import cuda_resize as cr
    from ..ops import torch_resize

    alg, sw, sh, dw, dh, kw = GEOMS[which]
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(0, 256, (BATCH, sh, sw), np.uint8)).cuda()
    plain_ops = torch_resize.pack_operands(plan, "cuda")
    want = torch_resize.resize(plain_ops, src)
    xs = [x for (x,) in _bench.copies((src,))]
    calls, fits = {}, {}
    for tw in cr.TILED_WIDTHS:
        layout = cr.tiled_layout(plan, tw=tw)
        fits[tw] = layout.smem <= cr.SMEM_BUDGET
        if not fits[tw]:
            continue
        ops = cr.KernelOperands(plain=plain_ops,
                                tables=cr.tiled_tables(plan, "cuda", layout))
        _bench.check_equal(f"{which} tw {tw} vs plain", cr.resize_fused(ops, src), want)
        calls[f"tw{tw}"] = (lambda x, o=ops: cr.resize_fused(o, x), xs, repeats)
    ms = _harness.turns_ms(calls)
    return {"geometry": which, "plan": f"{alg}{kw.get('degree', '')} {sw}x{sh}->{dw}x{dh}",
            "batch": BATCH, "chosen_tw": cr.tiled_width(plan),
            "fits": {f"tw{tw}": f for tw, f in fits.items()},
            "ms_per_frame": {k: v / BATCH for k, v in ms.items()},
            "bound_ms_per_frame": _bench.plan_bytes(plan) / _harness.HBM_BYTES_PER_S * 1e3,
            "exact": True, "card": card[0], "power_limit": card[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("geometries", nargs="*", help=f"any of {', '.join(GEOMS)} (default all)")
    ap.add_argument("--quick", action="store_true",
                    help="fewer repeats; the same shapes and checks")
    args = ap.parse_args(argv)
    if set(args.geometries) - set(GEOMS):
        ap.error(f"unknown geometries {sorted(set(args.geometries) - set(GEOMS))}")
    _bench.require_card("tile_sweep")
    card = _bench.card()
    print(", ".join(card), flush=True)
    for which in args.geometries or list(GEOMS):
        row = sweep(which, card, QUICK_REPEATS if args.quick else REPEATS)
        print(f"{which}: " + "  ".join(
            f"{k} {v!r} ms/frame" + (" (chosen)" if k == f"tw{row['chosen_tw']}" else "")
            for k, v in row["ms_per_frame"].items())
            + f"  exact  ({card[0]}, {card[1]})")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
