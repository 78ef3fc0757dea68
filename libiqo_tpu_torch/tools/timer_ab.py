"""``chip_smoke.py``'s timer against the one it replaced, on its timed rows,
in turns.

    python -m libiqo_tpu_torch.tools.timer_ab OLD_CHIP_SMOKE [phase ...]

``chip_smoke.py`` once timed phases 7-12 with its own ``time_ms`` (a fixed
spin of 2,000,000 clock cycles a queued call) and built their inputs with
its own ``perturbed``; it now times them with the probes'
``experiments/_harness.launches_ms`` (a spin sized from the host's
measured enqueue time, a repeat redone when the host outran it) on
``_harness.perturbed`` copies.  This tool loads ``OLD_CHIP_SMOKE`` (the
``chip_smoke.py`` of a checkout from before that change, for its
``time_ms``), then runs this checkout's phases (``times`` = 7, ``relaxed``
= 10, ``px4`` = 10's plane, ``sharded`` = 11, ``carry`` = 12; all by
default) with every ``_harness.launches_ms`` call replaced by both timers
in turns on the same inputs (harness, old, old, harness; the min of each
pair).  The phases run their checks as in ``chip_smoke.py``.  Prints each
timed call's two figures and their ratio, with the card's name and power
limit, then a summary line, and writes every row to
``build/timer_ab.json`` in the checkout.  Raises without a card.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ..experiments import _harness

ROOT = Path(__file__).resolve().parents[2]
PHASES = ("times", "relaxed", "px4", "sharded", "carry")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or set(argv[1:]) - set(PHASES):
        print(__doc__, file=sys.stderr)
        return 2
    _harness.require_card()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    spec = importlib.util.spec_from_file_location("old_chip_smoke", argv[0])
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    from libiqo_tpu_torch import build_plan, yuv
    from libiqo_tpu_torch.golden import numpy_ref
    from libiqo_tpu_torch.ops import cuda_resize as cr
    from libiqo_tpu_torch.parallel import sharding

    card = _harness.card()
    print(card, flush=True)
    harness_ms, rows = _harness.launches_ms, []

    def both(fn, inputs, repeats=5, primed=True):
        new = [harness_ms(fn, inputs, repeats, primed)]
        was = [old.time_ms(fn, inputs, repeats, primed) for _ in range(2)]
        new.append(harness_ms(fn, inputs, repeats, primed))
        caller = inspect.stack()[1]
        rows.append({"phase": caller.function, "line": caller.lineno,
                     "inputs": len(inputs), "primed": primed,
                     "harness_ms": min(new), "old_ms": min(was),
                     "ratio": min(new) / min(was)})
        print(f"{caller.function}:{caller.lineno} ({len(inputs)} inputs, "
              f"{'primed' if primed else 'host-paced'}): harness {min(new)!r} ms, "
              f"old {min(was)!r} ms, ratio {rows[-1]['ratio']!r} ({card})", flush=True)
        return min(new)

    _harness.launches_ms = both
    try:
        for phase in argv[1:] or PHASES:
            rng = np.random.default_rng(smoke.SEED + 7)
            if phase == "times":
                for frame in [("lanczos3", smoke.SRC_W, smoke.SRC_H, smoke.DST_W,
                               smoke.DST_H), *smoke.U16_FRAMES.values()]:
                    smoke.phase_times(cr, yuv, build_plan, rng, card, frame)
            elif phase == "relaxed":
                for frame in [("lanczos3", smoke.SRC_W, smoke.SRC_H, smoke.DST_W,
                               smoke.DST_H), smoke.AREA_MAIN]:
                    smoke.phase_relaxed_times(cr, build_plan, rng, card, frame)
            elif phase == "px4":
                smoke.phase_px4_time(cr, build_plan, rng, card)
            elif phase == "sharded":
                smoke.phase_sharded(cr, sharding, build_plan, numpy_ref, rng, card)
            else:
                os.environ["LIBIQO_TPU_CARRY"] = "1"
                smoke.phase_carry(cr, yuv, build_plan, numpy_ref, rng, card)
                del os.environ["LIBIQO_TPU_CARRY"]
    finally:
        _harness.launches_ms = harness_ms
    ratios = sorted(r["ratio"] for r in rows)
    summary = {"card": card, "calls": len(rows), "ratio_min": ratios[0],
               "ratio_median": ratios[len(ratios) // 2], "ratio_max": ratios[-1],
               "rows": rows}
    out = ROOT / "build" / "timer_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
