"""The wide-window kernel's layout against its neighbours, and against the
kernels it replaced, on one CUDA card.

    python -m libiqo_tpu_torch.tools.wide_ablate [--thumbnails]

For each plan of ``card_check.WIDE_TIMED`` (the five plans the facade sends
to the wide-window kernel, ``csrc/resize_wide.cu``, and the two that
``tiled_ok`` takes, here with ``tiled=False``), or with ``--thumbnails`` of
:func:`thumbnails` (the plans of ``card_check.THUMBNAILS`` that the kernel
takes at 16 rows, whose walk is the windowed kernel's 16-row tile): the
kernel at its own layout
(``cuda_resize.wide_layout``) and at each of :func:`variants` (the tile's
columns or rows doubled or halved, another block target, one Y slice or
four, a whole warp or one lane an output), each held == the plain path first, then
timed in turns with the windowed kernel's wide-window walk
(``pack_operands(..., wide=False)``), the facade's route and the plain path
(host-paced): CUDA events, the card spinning while the host queues, over
perturbed copies past the 50 MB L2 (at most 64: the small sources' copies
stay in it).  Prints the card's name and power limit,
and one line and one JSON line a plan.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import torch

from ..experiments import _harness
from . import _bench, card_check

INT32_MADS_PER_S = 64 * 132 * 1.98e9     # IMAD: 64 a clock an SM, 132 SMs
MAX_INPUTS = 64          # distinct sources timed at most: small ones stay in the L2


def variants(plan, lay) -> dict:
    """name: layout, the neighbours of ``lay`` that fit shared memory."""
    from ..ops import cuda_resize as cr

    out = {}
    for name, tc, tr in (("cols x2", lay.tc * 2, lay.tr), ("cols /2", lay.tc // 2, lay.tr),
                         ("rows x2", lay.tc, lay.tr * 2), ("rows /2", lay.tc, lay.tr // 2)):
        if 1 <= tc <= cr.TILE_COLS and tr >= 1:
            v = cr.wide_layout(plan, tc=tc, tr=tr)
            if v is not None and v.tr == tr:
                out[name] = v
    for blocks in (cr.WIDE_BLOCKS // 2, cr.WIDE_BLOCKS * 2):
        out[f"blocks {blocks}"] = cr.wide_layout(plan, blocks=blocks)
    if lay.ks > 1:
        out["ks 1"] = dataclasses.replace(lay, ks=1)
    elif lay.taps_y >= 8:            # below WIDE_SLICE_TAPS: what slices would do
        out["ks 4"] = dataclasses.replace(lay, ks=4)
    for group in (32, 1):
        if group != lay.group:
            out[f"group {group}"] = dataclasses.replace(lay, group=group)
    return {k: v for k, v in out.items() if v is not None and v.smem <= cr.SMEM_BUDGET}


def thumbnails() -> list:
    """``card_check.THUMBNAILS`` whose band fits no tiled width: the ones
    the facade sends to this kernel at 16 work rows."""
    from ..core.plan import build_plan
    from ..ops import cuda_resize as cr

    return [c for c in card_check.THUMBNAILS
            if not cr.tiled_ok(build_plan(*c[:5], **c[5]))]


def ptxas_report(log: str) -> list[str]:
    """ptxas -v's lines for each resize_wide_kernel instantiation."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = "resize_wide_kernel" in line and line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def measure(case, card: tuple[str, str]) -> dict:
    from ..api import Resizer
    from ..core.plan import build_plan
    from ..ops import cuda_resize as cr

    alg, sw, sh, dw, dh, kw = case
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    ops = cr.pack_operands(plan, "cuda", tiled=False)
    walk = cr.pack_operands(plan, "cuda", tiled=False, wide=False)
    route = Resizer.from_plan(plan, device="cuda")
    lay = ops.tables.layout
    x = torch.from_numpy(card_check.source(case, 0)).cuda()[None]
    want = cr.resize_plain(ops, x)
    cr.reset_launches()
    _bench.check_equal(f"{card_check.case_name(case)} kernel", cr.resize_fused(ops, x), want)
    torch.cuda.synchronize()
    launched = {v: n for v, n in cr.LAUNCHES_BY_VARIANT.items() if n}
    _bench.check_equal("walk", cr.resize_fused(walk, x), want)
    _bench.check_equal("route", route.resize(x), want)
    calls = {"kernel": lambda t: cr.resize_fused(ops, t),
             "walk": lambda t: cr.resize_fused(walk, t),
             "route": lambda t: route.resize(t)}
    shapes = {}
    for name, v in variants(plan, lay).items():
        vops = cr.KernelOperands(plain=ops.plain, tables=cr.wide_tables(plan, "cuda", v))
        _bench.check_equal(f"layout {name}", cr.resize_fused(vops, x), want)
        calls[name] = lambda t, o=vops: cr.resize_fused(o, t)
        shapes[name] = [v.tc, v.tr, v.ks, v.group, v.blocks]
    calls["plain"] = lambda t: cr.resize_plain(ops, t)
    n = min(MAX_INPUTS, max(8, math.ceil(_bench.L2_COLD_BYTES / x.numel())))
    xs = _harness.perturbed(x, n)
    times = {n: [] for n in calls}
    for n in list(calls) + list(calls)[::-1]:
        times[n].append(_harness.launches_ms(calls[n], xs, primed=n != "plain"))
    ms = {n: min(t) for n, t in times.items()}
    nbytes = _bench.plan_bytes(plan)
    mads = dh * sw * plan.y.num_coefs + dh * dw * plan.x.num_coefs
    return {"case": card_check.case_name(case), "launched": launched,
            "layout": [lay.tc, lay.tr, lay.ks, lay.group, lay.blocks],
            "smem": lay.smem, "walk_rows": walk.tables.rows, "route": cr.variant(
                route._operands(x.device).tables) if route.resolved_backend() == "cuda" else None,
            "ms": ms, "variants": shapes,
            "bound_ms": nbytes / _harness.HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "int32_mads": mads, "int32_mad_ms": mads / INT32_MADS_PER_S * 1e3,
            "card": card[0], "power_limit": card[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--thumbnails", action="store_true",
                    help="the 16-row thumbnails in place of WIDE_TIMED")
    args = ap.parse_args(argv)
    _bench.require_card("wide_ablate")
    card = _bench.card()
    print(", ".join(card), flush=True)
    from ..ops import _build

    _build.load()
    for line in ptxas_report(_build.build_log):
        print(f"ptxas {line}")
    for case in thumbnails() if args.thumbnails else card_check.WIDE_TIMED:
        row = measure(case, card)
        ms = row["ms"]
        print(f"{row['case']}: kernel {ms['kernel']!r} ms (tc, tr, ks, group, blocks "
              f"{row['layout']}), walk {ms['walk']!r} ({row['walk_rows']} rows), route "
              f"{row['route']} {ms['route']!r}, plain {ms['plain']!r}; bound "
              f"{row['bound_ms']!r} (bytes), int32 multiply-adds {row['int32_mad_ms']!r}; "
              + ", ".join(f"{n} {v!r}" for n, v in ms.items()
                          if n not in ("kernel", "walk", "route", "plain"))
              + f"  ({card[0]}, {card[1]})", flush=True)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
