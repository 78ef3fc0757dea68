"""The wide-window kernel's layout against its neighbours, and against the
kernels it replaced, on one CUDA card.

    python -m libiqo_tpu_torch.tools.wide_ablate [--thumbnails | --s8] [--batch N]

For each plan of ``card_check.WIDE_TIMED`` (the five plans the facade sends
to the wide-window kernel, ``csrc/resize_wide.cu``, and the two that
``tiled_ok`` takes, here with ``tiled=False``), with ``--thumbnails`` of
:func:`thumbnails` (the plans of ``card_check.THUMBNAILS`` that the kernel
takes at 16 rows, whose walk is the windowed kernel's 16-row tile), or
with ``--s8`` of :func:`s8_plans` (those of both lists that its s8 Y form
takes): the kernel in the form the route gives it (``cuda_resize.wide_s8``,
else the scalar Y form at ``cuda_resize.wide_layout``), the scalar Y form
at that layout (``y_imad``, where the route takes the s8 form) and at each
of :func:`variants` (the tile's columns or
rows doubled or halved, another block target, one Y slice or four, a whole
warp or one lane an output), and the s8 form's :func:`s8_variants` (the
other width, fewer or more ring stages), each held == the plain path
first, then timed in turns with the windowed kernel's wide-window walk
(``pack_operands(..., wide=False)``), the facade's route and the plain path
(host-paced): CUDA events, the card spinning while the host queues, over
perturbed copies past the 50 MB L2 (at most 64: the small sources' copies
stay in it), of one frame a call or ``--batch`` frames.  Prints the card's name and power limit,
and one line and one JSON line a plan.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch

from ..experiments import _harness
from . import _bench, card_check

INT32_MADS_PER_S = 64 * 132 * 1.98e9     # IMAD: 64 a clock an SM, 132 SMs
MAX_INPUTS = 64          # distinct sources timed at most: small ones stay in the L2


def variants(plan, lay) -> dict:
    """name: layout, the neighbours of the scalar Y form's layout ``lay``
    that fit shared memory."""
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
    out = {k: v for k, v in out.items() if v is not None}
    if lay.ks > 1:
        out["ks 1"] = dataclasses.replace(lay, ks=1)
    elif lay.taps_y >= 8:            # below WIDE_SLICE_TAPS: what slices would do
        out["ks 4"] = dataclasses.replace(lay, ks=4)
    for group in (32, 1):
        if group != lay.group:
            out[f"group {group}"] = dataclasses.replace(lay, group=group)
    return {k: v for k, v in out.items() if v is not None and v.smem <= cr.SMEM_BUDGET}


def s8_variants(plan, form) -> dict:
    """name: ``cuda_resize.WideS8``, the neighbours of the s8 Y form
    ``form``: the other width of ``WIDE_S8_WIDTHS`` and one ring stage
    fewer or more, where they fit (``cuda_resize.wide_s8_form``)."""
    from ..ops import cuda_resize as cr

    out = {}
    for tw in cr.WIDE_S8_WIDTHS:
        if tw != form.tw:
            out[f"s8 tw {tw}"] = cr.wide_s8_form(plan, tw)
    for n in (form.stages - 1, form.stages + 1):
        out[f"s8 stages {n}"] = cr.wide_s8_form(plan, form.tw, n)
    return {k: v for k, v in out.items() if v is not None}


def s8_plans() -> list:
    """The plans of ``card_check.WIDE_TIMED`` and :func:`thumbnails` that
    the route gives the s8 Y form (``cuda_resize.wide_s8``)."""
    from ..core.plan import build_plan
    from ..ops import cuda_resize as cr

    return [c for c in card_check.WIDE_TIMED + thumbnails()
            if cr.wide_s8(build_plan(*c[:5], **c[5])) is not None]


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


def measure(case, card: tuple[str, str], batch: int = 1) -> dict:
    from ..api import Resizer
    from ..core.plan import build_plan
    from ..ops import cuda_resize as cr

    alg, sw, sh, dw, dh, kw = case
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    ops = cr.pack_operands(plan, "cuda", tiled=False)
    walk = cr.pack_operands(plan, "cuda", tiled=False, wide=False)
    route = Resizer.from_plan(plan, device="cuda")
    lay = cr.wide_layout(plan)
    s8 = ops.tables.layout if ops.tables.y_s8 else None
    x = torch.from_numpy(np.stack([card_check.source(case, f) for f in range(batch)])).cuda()
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
    neighbours = variants(plan, lay)
    if s8 is not None:
        neighbours = {"y_imad": lay, **neighbours, **s8_variants(plan, s8)}
    for name, v in neighbours.items():
        scalar = isinstance(v, cr.WideLayout)
        tables = (cr.wide_tables(plan, "cuda", v) if scalar
                  else cr.wide_s8_tables(plan, "cuda", v))
        vops = cr.KernelOperands(plain=ops.plain, tables=tables)
        _bench.check_equal(f"layout {name}", cr.resize_fused(vops, x), want)
        calls[name] = lambda t, o=vops: cr.resize_fused(o, t)
        shapes[name] = ([v.tc, v.tr, v.ks, v.group, v.blocks] if scalar
                        else ["s8", v.tw, v.stages, v.blocks])
    calls["plain"] = lambda t: cr.resize_plain(ops, t)
    n = min(MAX_INPUTS, max(8, math.ceil(_bench.L2_COLD_BYTES / x.numel())))
    xs = _harness.perturbed(x, n)
    times = {n: [] for n in calls}
    for n in list(calls) + list(calls)[::-1]:
        times[n].append(_harness.launches_ms(calls[n], xs, primed=n != "plain"))
    ms = {n: min(t) for n, t in times.items()}
    scalar = [n for n, v in neighbours.items() if isinstance(v, cr.WideLayout)]
    if s8 is None:
        scalar.append("kernel")
    best = min(scalar, key=ms.get)
    nbytes = _bench.plan_bytes(plan)
    mads = dh * sw * plan.y.num_coefs + dh * dw * plan.x.num_coefs
    return {"case": card_check.case_name(case), "batch": batch, "launched": launched,
            "layout": [lay.tc, lay.tr, lay.ks, lay.group, lay.blocks],
            "smem": lay.smem, "form": cr.launch_form(ops.tables),
            "s8": None if s8 is None else [s8.tw, s8.stages, s8.blocks, s8.smem],
            "scalar_best": best, "kernel_vs_scalar_best": ms["kernel"] / ms[best], "walk_rows": walk.tables.rows, "route": cr.variant(
                route._operands(x.device).tables) if route.resolved_backend() == "cuda" else None,
            "ms": ms, "variants": shapes,
            "bound_ms": nbytes / _harness.HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "int32_mads": mads, "int32_mad_ms": mads / INT32_MADS_PER_S * 1e3,
            "card": card[0], "power_limit": card[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--thumbnails", action="store_true",
                       help="the 16-row thumbnails in place of WIDE_TIMED")
    which.add_argument("--s8", action="store_true",
                       help="the plans the s8 Y form takes, in place of WIDE_TIMED")
    ap.add_argument("--batch", type=int, default=1, help="frames a call")
    args = ap.parse_args(argv)
    _bench.require_card("wide_ablate")
    card = _bench.card()
    print(", ".join(card), flush=True)
    from ..ops import _build

    _build.load()
    for line in ptxas_report(_build.build_log):
        print(f"ptxas {line}")
    cases = (thumbnails() if args.thumbnails else s8_plans() if args.s8
             else card_check.WIDE_TIMED)
    for case in cases:
        row = measure(case, card, args.batch)
        ms = row["ms"]
        print(f"{row['case']}: kernel {ms['kernel']!r} ms ({row['form']}, s8 (tw, stages, "
              f"blocks, smem) {row['s8']}; scalar (tc, tr, ks, group, blocks) "
              f"{row['layout']}, best {row['scalar_best']}: kernel "
              f"{row['kernel_vs_scalar_best']!r}x), walk {ms['walk']!r} ({row['walk_rows']} rows), route "
              f"{row['route']} {ms['route']!r}, plain {ms['plain']!r}; bound "
              f"{row['bound_ms']!r} (bytes), int32 multiply-adds {row['int32_mad_ms']!r}; "
              + ", ".join(f"{n} {v!r}" for n, v in ms.items()
                          if n not in ("kernel", "walk", "route", "plain"))
              + f"  ({card[0]}, {card[1]})", flush=True)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
