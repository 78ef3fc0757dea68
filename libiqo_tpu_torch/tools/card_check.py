"""The port's on-card byte gate: every resize route on the card, byte for
byte against the NumPy oracle, with a committed result.

The port of ``scripts/tpu_check.py``, with ``scripts/stress_geometries.py``
(:data:`STRESS_GEOMETRIES`) and ``scripts/check_relaxed_tpu.py`` (the
relaxed rows' error against the oracle) folded in.  Run from the repository
root on a machine with a CUDA card::

    python -m libiqo_tpu_torch.tools.card_check [--fuzz N]

Sweeps, each a function that returns its rows:

* :func:`exact_sweep`: :data:`GRADED`, :data:`STRESS`,
  :data:`STRESS_GEOMETRIES`, the port's own :data:`WIDE_WINDOW` (windows
  too wide for 16 rows of the windowed kernel, on the wide-window kernel)
  and :data:`THUMBNAILS` (bands that fit no tiled width, on the wide-window
  kernel, and the 8K proxy the tiled width's walk moves), and
  ``fuzz_cases(20)`` through the facades on
  ``cuda`` (``LanczosResizer``/``AreaResizer``/``LinearResizer``), the
  kernel of ``pack_operands(..., tiled=False)`` on each (the windowed
  ``resize_fused`` where the tiled kernel takes the plan, else the
  wide-window kernel) and its twin (:func:`twin`: the other of those two),
  all == ``numpy_ref`` == the plain path on the card; batch 4 and 2 on
  ``GRADED[0]``, ``[2]`` and ``[4]``.  Each row names the instantiation
  that ran, read from ``cuda_resize.LAUNCHES_BY_VARIANT`` after
  ``reset_launches()``.  A GRADED, STRESS, STRESS_GEOMETRIES, WIDE_WINDOW or THUMBNAILS case that
  resolves to ``torch`` or launches no kernel is ``FAIL-unsupported``; only
  a fuzz case outside ``supports_plan`` is a skip, with its reason.
* :func:`relaxed_sweep`: ``precision="relaxed"`` == its plain version (0
  LSB), within 2 LSB of the exact kernel, flat fields 0/128/255 exact, with
  its error against the oracle, on the facade's route, ``tiled=False`` and
  its twin, so the wide-window kernel's relaxed form runs on every row
  (:data:`THUMBNAILS` take it on the facade); the forced residual plane
  (``tpu_check.py:334``) by the port's own ``relaxed_plane`` with the
  column-sum repair stubbed to plain rounding.
* :func:`carry_sweep`: ``LIBIQO_TPU_CARRY=1``, the tiled carry form and the
  windowed one where each applies, one frame and a batch of 4; a case that
  no carry layout takes is a recorded skip.
* :func:`sharded_sweep`: ``parallel.sharding`` on a mesh of one card and
  on ``cuda:0`` named 4 times; the Lanczos rows must run the kernel.
* :func:`border_div_sweep`: in place of ``tpu_check.py``'s ``div_sweep``
  (the TPU's float lowering of the divide, which the port has no
  counterpart of): geometries where most output rows and columns take the
  kernels' truncating C++ ``/`` (small destinations, odd Lanczos degrees,
  px_scale 2-4), gated as the exact sweep.

The oracle runs in a pool of worker processes while the card works:
``numpy_ref`` is a dense int64 product, minutes for an 8K frame.  Each
case's frames are drawn from a seed of its own, so sweeps that share a case
share its oracle outputs.  Writes
``libiqo_tpu_torch/tools/card_check_result.json`` (``--out``): the keys of
``scripts/tpu_check_result.json`` (``n_cases``, ``n_fail``, ``n_skip``,
``results``, ``relaxed``, ``carry``, ``sharded``), with ``border_div``, the
card's name and power limit (``card``) on the file and on every row that
holds a time, and the run's seconds.  Exits 1 on any failure and 2 without
a CUDA device; nothing runs on the CPU in its place.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

RESULT = Path(__file__).with_name("card_check_result.json")
SEED = 20261018
RELAXED_LSB = 2          # relaxed vs exact: the port's contract
FLAT_VALUES = (0, 128, 255)

# scripts/tpu_check.py:24-48, the same values
GRADED = [
    ("linear", 640, 480, 320, 240, {}),
    ("area", 1920, 1080, 480, 270, {}),
    ("lanczos", 1280, 720, 1920, 1080, dict(degree=2)),
    ("lanczos", 3840, 2160, 1920, 1080, dict(degree=3)),
    ("lanczos", 1920, 1080, 960, 540, dict(degree=3, px_scale=2)),  # chroma
]
STRESS = [
    ("lanczos", 1024, 768, 512, 384, dict(degree=7)),
    ("lanczos", 640, 480, 320, 240, dict(degree=9)),
    ("lanczos", 7680, 4320, 1920, 1080, dict(degree=3)),            # 8K
    ("lanczos", 1920, 1080, 960, 540, dict(degree=9, px_scale=2)),
    ("lanczos", 363, 614, 364, 18, dict(degree=4)),                 # 274 taps
    ("lanczos", 256, 70, 256, 5, dict(degree=3)),   # border-wrap w hi-range
    ("area", 4096, 2160, 1024, 540, {}),            # 4K-wide area 4:1
    ("linear", 97, 61, 291, 183, {}),
    ("area", 8192, 4, 16, 4, {}),        # 512 taps: the wide-window walk
    ("area", 16, 4096, 16, 31, {}),      # identity X
    ("linear", 640, 480, 321, 241, {}),  # odd linear up
]
# scripts/stress_geometries.py:14-23, the same values
STRESS_GEOMETRIES = [
    ("lanczos", 3839, 2161, 1919, 1081, dict(degree=3)),   # gcd=1 4K, odd dims
    ("lanczos", 7680, 4320, 3840, 2160, dict(degree=3)),   # 8K -> 4K
    ("area", 7680, 120, 640, 40, {}),                      # wide & flat
    ("lanczos", 120, 4320, 60, 2160, dict(degree=2)),      # tall & skinny
    ("linear", 8191, 33, 4093, 17, {}),                    # prime-ish wide
    ("lanczos", 257, 8191, 129, 4099, dict(degree=3)),     # prime tall
    ("area", 5120, 2880, 1280, 720, {}),                   # 5K 4:1
    ("lanczos", 640, 480, 1920, 1440, dict(degree=4)),     # 3x upsample deg4
]
# the port's own list: windows too wide for 16 rows of the windowed kernel's
# shared memory on several column tiles (4-15 rows fit: cuda_resize.work_rows),
# which the wide-window kernel takes (csrc/resize_wide.cu; the facade's route
# where tiled_ok refuses); the first two the JAX package's kernel takes too,
# the rest it refuses.  Rows: the windowed walk's (wide=False)
WIDE_WINDOW = [
    ("area", 8192, 2160, 256, 540, {}),              # 2 column tiles, 14 rows
    ("area", 4096, 2160, 128, 540, {}),              # 1 column tile, 14 rows
    ("area", 4096, 4096, 128, 128, {}),
    ("area", 3840, 2160, 128, 72, {}),               # 15 rows
    ("area", 7680, 4320, 240, 135, {}),
    ("lanczos", 7680, 4320, 240, 135, dict(degree=3)),   # wrap16, 13 rows
    ("area", 40960, 8, 1024, 8, {}),                 # 8 column tiles, 11 rows
]
# the plans whose facade takes the wide-window kernel (tiled_ok refuses them):
# STRESS's 512-tap plan and the WIDE_WINDOW thumbnails; WIDE_TIMED adds the two
# of WIDE_WINDOW that the JAX package's kernel takes (the facade's route: tiled)
WIDE_FACADE = [STRESS[8]] + WIDE_WINDOW[2:6]
# the port's own list: the plans whose band fits no tiled width while 16 rows
# of the windowed kernel's work tile fit (the wide-window kernel takes them,
# exact and relaxed), and the 8K proxy that fits only at TW 64 (the tiled
# width walks down to it)
THUMBNAILS = [
    ("lanczos", 3840, 2160, 256, 144, dict(degree=3)),
    ("lanczos", 1920, 1080, 128, 72, dict(degree=3)),
    ("lanczos", 3840, 2160, 1920, 16, dict(degree=3)),
    ("area", 3840, 2160, 1920, 16, {}),
    ("linear", 3840, 2160, 256, 144, {}),
    ("lanczos", 7680, 4320, 480, 270, dict(degree=3)),
    ("lanczos", 7680, 4320, 320, 180, dict(degree=3)),
    ("lanczos", 7680, 4320, 480, 270, dict(degree=2)),
    ("lanczos", 7680, 4320, 960, 540, dict(degree=3)),
]
# those inside the relaxed scope (the Lanczos3 strip's 810 Y taps are not)
RELAXED_THUMBNAILS = THUMBNAILS[:2] + THUMBNAILS[3:]
REQUIRED = GRADED + STRESS + STRESS_GEOMETRIES + WIDE_WINDOW + THUMBNAILS
WIDE_TIMED = WIDE_FACADE + WIDE_WINDOW[:2]
BATCHED = (GRADED[0], GRADED[2], GRADED[4])     # batch 4 and 2, tpu_check.py:494
BATCHES = (4, 2)
# tpu_check.py:carry_sweep's cases: GRADED, two more, fuzz_cases(6, seed=20260819)
CARRY_CASES = GRADED + [
    ("lanczos", 512, 520, 256, 130, dict(degree=4)),  # clamped tail
    ("lanczos", 7680, 4320, 1920, 1080, dict(degree=3)),
]
CARRY_FUZZ = (6, 20260819)
CARRY_BATCH = 4
# tpu_check.py:relaxed_sweep's cases: GRADED, the px2 chroma draws,
# fuzz_cases(8, seed=20260818), and GRADED[3] with a forced residual plane
RELAXED_PX2 = [
    ("lanczos", 482, 270, 240, 134, dict(degree=3, px_scale=2)),
    ("lanczos", 638, 360, 320, 178, dict(degree=2, px_scale=2)),
]
RELAXED_FUZZ = (8, 20260818)
RELAXED_RESIDUAL = GRADED[3]
# tpu_check.py:sharded_sweep's cases: (case, required, batched)
SHARDED_CASES = [
    (("lanczos", 1280, 720, 640, 360, dict(degree=3)), True, False),
    (("lanczos", 3840, 2160, 1920, 1080, dict(degree=3)), True, False),
    (("lanczos", 1280, 720, 640, 360, dict(degree=3)), True, True),
    (("area", 1920, 1080, 480, 270, {}), False, False),
    (("linear", 640, 480, 320, 240, {}), False, False),
]
SHARDS = (1, 4)              # a mesh of one card, and cuda:0 named 4 times
SHARDED_BATCH = 3
BORDER_DEGREES = (1, 3, 5, 7, 9)
BORDER_PX = (2, 3, 4)
BORDER_SHARE = 0.5           # border outputs on each axis, at least


def fuzz_cases(n, seed=20260816):
    """scripts/tpu_check.py:fuzz_cases, the same seeded draws."""
    rng = np.random.default_rng(seed)
    cases = []
    while len(cases) < n:
        alg = rng.choice(["lanczos", "area", "linear"])
        sw, sh = int(rng.integers(16, 1200)), int(rng.integers(16, 900))
        if alg == "area":
            dw = int(rng.integers(4, max(5, sw)))
            dh = int(rng.integers(4, max(5, sh)))
        elif alg == "linear":
            dw = int(rng.integers(max(4, sw // 3 + 1), sw * 3))
            dh = int(rng.integers(max(4, sh // 3 + 1), sh * 3))
        else:
            dw, dh = int(rng.integers(4, sw * 2)), int(rng.integers(4, sh * 2))
        kw = {}
        if alg == "lanczos":
            kw = dict(degree=int(rng.integers(1, 10)))
        cases.append((str(alg), sw, sh, dw, dh, kw))
    return cases


def border_cases(seed=SEED):
    """Lanczos plans, one per odd degree and px_scale 2-4, whose output rows
    and columns are at least BORDER_SHARE border outputs on each axis (the
    divide by the renormalising denominator): small destinations of a
    seeded source, down and up."""
    from ..core.plan import build_plan

    rng = np.random.default_rng(seed)
    cases = []
    for degree in BORDER_DEGREES:
        for px in BORDER_PX:
            while True:
                sw, sh = (int(v) for v in rng.integers(7, 160, 2))
                dw, dh = (int(v) for v in rng.integers(2, 24, 2))
                case = ("lanczos", sw, sh, dw, dh, dict(degree=degree, px_scale=px))
                plan = build_plan(*case[:5], **case[5])
                if min(plan.y.is_border.mean(), plan.x.is_border.mean()) >= BORDER_SHARE:
                    cases.append(case)
                    break
    return cases


def case_name(case, suffix: str = "") -> str:
    alg, sw, sh, dw, dh, kw = case
    px = kw.get("px_scale", 1)
    return (f"{alg}{kw.get('degree', '')} {sw}x{sh}->{dw}x{dh}"
            + (f" px{px}" if px != 1 else "") + suffix)


def source(case, frame: int) -> np.ndarray:
    """Frame ``frame`` of a case's source: uint8 noise from a seed of the
    case's own, so every sweep that runs the case reads the same frames."""
    alg, sw, sh, dw, dh, kw = case
    rng = np.random.default_rng([SEED, zlib.crc32(case_name(case).encode()), frame])
    return rng.integers(0, 256, (sh, sw), np.uint8)


def oracle(case, frame: int) -> np.ndarray:
    """``numpy_ref`` on frame ``frame`` of the case (run in a worker)."""
    from ..core.plan import build_plan
    from ..golden import numpy_ref

    alg, sw, sh, dw, dh, kw = case
    return numpy_ref.resize_u8(build_plan(alg, sw, sh, dw, dh, **kw),
                               source(case, frame))


class Oracle:
    """``numpy_ref`` outputs of (case, frame), computed once each in a pool
    of worker processes, or here with no pool."""

    def __init__(self, pool=None):
        self.pool, self.jobs = pool, {}
        # by the module's own name: run with -m, this module is __main__
        import importlib
        self.fn = importlib.import_module(__spec__.name).oracle if pool else oracle

    def submit(self, case, frames) -> None:
        for f in frames:
            key = (case_name(case), f)
            if key not in self.jobs:
                self.jobs[key] = self.pool.submit(self.fn, case, f) if self.pool else None

    def get(self, case, frame: int) -> np.ndarray:
        self.submit(case, (frame,))
        key = (case_name(case), frame)
        if self.jobs[key] is None:
            done = concurrent.futures.Future()
            done.set_result(oracle(case, frame))
            self.jobs[key] = done
        return self.jobs[key].result()


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return 999
    return int((a.int() - b.int()).abs().max().item()) if a.numel() else 0


def first_diff(a: torch.Tensor, b: torch.Tensor) -> list:
    """[index..., got, want] of the first differing element."""
    idx = torch.nonzero(a.cpu() != b.cpu())[0].tolist()
    return idx + [int(a[tuple(idx)]), int(b[tuple(idx)])]


def facade(case, precision: str = "exact"):
    """The case's resizer on ``cuda``, as a user builds it."""
    from .. import AreaResizer, LanczosResizer, LinearResizer

    alg, sw, sh, dw, dh, kw = case
    if alg == "lanczos":
        return LanczosResizer(kw["degree"], sw, sh, dw, dh,
                              kw.get("px_scale", 1), precision=precision,
                              device="cuda")
    cls = AreaResizer if alg == "area" else LinearResizer
    return cls(sw, sh, dw, dh, precision=precision, device="cuda")


def launched(cr, call):
    """``call()`` with every launch count set to 0 just before; returns its
    output and the counts it left, by instantiation."""
    cr.reset_launches()
    out = call()
    torch.cuda.synchronize()
    return out, {v: n for v, n in cr.LAUNCHES_BY_VARIANT.items() if n}


def _frames(case, frames) -> torch.Tensor:
    return torch.from_numpy(np.stack([source(case, f) for f in frames])).cuda()


def _status(ok: bool) -> str:
    return "ok" if ok else "FAIL"


def twin(plan, ops, relaxed: bool = False):
    """The other of the two kernels that ``tiled=False`` chooses between,
    on ``ops``' device: the windowed kernel (``wide=False``) where ``ops``
    holds the wide-window kernel's tables, else the wide-window kernel's at
    its own layout (None where ``wide_layout`` refuses the plan)."""
    from ..ops import cuda_resize as cr

    if ops.tables.wide:
        return cr.pack_operands(plan, ops.device, relaxed=relaxed, tiled=False, wide=False)
    lay = cr.wide_layout(plan, relaxed=relaxed)
    return None if lay is None else cr.KernelOperands(
        plain=ops.plain, tables=cr.wide_tables(plan, ops.device, lay))


def exact_case(case, orc: Oracle, card: str, required: bool,
               oracle_max_pixels: int | None = None, batches=()) -> list[dict]:
    """One case of the exact sweep: its rows (the case, then each batch).

    The facade on ``cuda``, the kernel of ``tiled=False`` (the windowed
    kernel, or the wide-window kernel) and its :func:`twin` == the plain
    path on the card, and == ``numpy_ref`` where the source has at most
    ``oracle_max_pixels`` pixels (every case by default)."""
    from ..core.plan import build_plan
    from ..ops import cuda_resize as cr

    alg, sw, sh, dw, dh, kw = case
    name = case_name(case)
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    if not cr.supports_plan(plan):
        return [{"case": name,
                 "status": "FAIL-unsupported" if required else "skip-unsupported",
                 "reason": "outside cuda_resize.supports_plan: the plain path serves it"}]
    use_oracle = oracle_max_pixels is None or sw * sh <= oracle_max_pixels
    r = facade(case)
    rows = []
    for b in (1, *batches):
        t0 = time.perf_counter()
        src = _frames(case, range(b))
        got, counts = launched(cr, lambda: r.resize(src if b > 1 else src[0]))
        run_s = time.perf_counter() - t0
        got = got.reshape(b, dh, dw)
        route = r.resolved_backend()
        row = {"case": name + (f" [batch{b}]" if b > 1 else ""),
               "route": route, "variant": "/".join(counts) or None,
               "launches": sum(counts.values()), "run_s": run_s, "card": card}
        if route != "cuda" or len(counts) != 1:
            rows.append({**row, "status": "FAIL-unsupported"})
            continue
        ops = cr.pack_operands(plan, "cuda")
        plain = cr.resize_plain(ops, src)
        errs = {"vs_plain": max_err(got, plain)}
        ok = True
        if b == 1:
            row["work_rows"] = cr.work_rows(plan)
            wops = cr.pack_operands(plan, "cuda", tiled=False)
            wgot, wcounts = launched(cr, lambda: cr.resize_fused(wops, src))
            row["windowed_variant"] = "/".join(wcounts) or None
            errs["windowed_vs_plain"] = max_err(wgot, plain)
            ok = len(wcounts) == 1
            tops = twin(plan, wops)
            if tops is not None:
                tgot, tcounts = launched(cr, lambda: cr.resize_fused(tops, src))
                row["twin_variant"] = "/".join(tcounts) or None
                errs["twin_vs_plain"] = max_err(tgot, plain)
                ok &= len(tcounts) == 1
        if use_oracle:
            want = torch.from_numpy(np.stack([orc.get(case, f) for f in range(b)]))
            errs["vs_oracle"] = max_err(got.cpu(), want)
            if b == 1:
                errs["windowed_vs_oracle"] = max_err(wgot.cpu(), want)
            if errs["vs_oracle"]:
                row["first_diff"] = first_diff(got, want)
        ok &= not any(errs.values())
        rows.append({**row, "status": _status(ok), "max_lsb_err": max(errs.values()),
                     **errs, "oracle": use_oracle})
    return rows


def exact_sweep(orc: Oracle, card: str, fuzz: int = 20, cases=None,
                oracle_max_pixels: int | None = None) -> tuple[list, int, int]:
    """The exact sweep over ``cases`` (GRADED, STRESS, STRESS_GEOMETRIES,
    WIDE_WINDOW, THUMBNAILS and ``fuzz_cases(fuzz)`` by default; every case
    but a fuzz case is required): (rows, failures, skips)."""
    required = {case_name(c) for c in REQUIRED}
    if cases is None:
        cases = REQUIRED + fuzz_cases(fuzz)
    rows = []
    for case in cases:
        for row in exact_case(case, orc, card, case_name(case) in required,
                              oracle_max_pixels,
                              BATCHES if case in BATCHED else ()):
            rows.append(row)
            _print("exact", row)
    return _tally(rows)


def _print(sweep: str, row: dict) -> None:
    keys = ("variant", "windowed_variant", "work_rows", "max_lsb_err",
            "max_lsb_vs_exact", "reason")
    extra = ", ".join(f"{k} {row[k]}" for k in keys if row.get(k) is not None)
    print(f"{row['status']:<16} {sweep} {row['case']}  ({extra})", flush=True)


def _tally(rows) -> tuple[list, int, int]:
    fails = sum(r["status"].startswith("FAIL") for r in rows)
    skips = sum(r["status"].startswith("skip") for r in rows)
    return rows, fails, skips


def relaxed_case(case, orc: Oracle, card: str, required: bool,
                 residual: bool = False) -> dict:
    """One case of the relaxed sweep: the relaxed kernels == the relaxed
    plain version, within RELAXED_LSB of the exact kernel, flat fields
    exact; the facade's route unless ``residual``, where the operands are
    packed with the column-sum repair stubbed to plain rounding, so the
    relaxed forms add the residual plane's sums."""
    from ..core.plan import build_plan
    from ..ops import cuda_resize as cr

    alg, sw, sh, dw, dh, kw = case
    name = case_name(case, " [resid]" if residual else "")
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    repair = cr._repaired_bf16
    if residual:
        cr._repaired_bf16 = cr._bf16
    try:
        if not cr.supports_plan(plan, relaxed=True):
            return {"case": name,
                    "status": "FAIL-infeasible" if required else "skip-infeasible",
                    "reason": "outside cuda_resize.supports_plan(relaxed=True)"}
        ops = cr.pack_operands(plan, "cuda", relaxed=True)
        wops = cr.pack_operands(plan, "cuda", relaxed=True, tiled=False)
        tops = twin(plan, wops, relaxed=True)
    finally:
        cr._repaired_bf16 = repair
    t0 = time.perf_counter()
    src = _frames(case, (0,))
    if residual:
        run = lambda x: cr.resize_fused(ops, x)                   # noqa: E731
    else:
        r = facade(case, "relaxed")
        run = lambda x: r.resize(x[0])[None]                      # noqa: E731
    got, counts = launched(cr, lambda: run(src))
    run_s = time.perf_counter() - t0
    wgot, wcounts = launched(cr, lambda: cr.resize_fused(wops, src))
    tgot, tcounts = launched(cr, lambda: cr.resize_fused(tops, src))
    exact_ops = cr.pack_operands(plan, "cuda")
    exact = cr.resize_fused(exact_ops, src)
    plain = cr.resize_plain(ops, src)
    want = torch.from_numpy(orc.get(case, 0))[None]
    diff = (got.cpu().int() - want.int()).abs()
    flat_ok = True
    for v in FLAT_VALUES:
        flat = torch.full_like(src, v)
        flat_ok &= all(torch.equal(f(flat), cr.resize_plain(exact_ops, flat)) for f in (
            run, lambda t: cr.resize_fused(wops, t), lambda t: cr.resize_fused(tops, t)))
    row = {"case": name, "variant": "/".join(counts) or None,
           "windowed_variant": "/".join(wcounts) or None,
           "twin_variant": "/".join(tcounts) or None,
           "launches": sum(counts.values()),
           "residual_plane": ops.tables.cxd.numel() > 0,
           "vs_plain": max(max_err(got, plain), max_err(wgot, plain),
                           max_err(tgot, plain)),
           "max_lsb_vs_exact": max(max_err(got, exact), max_err(wgot, exact),
                                   max_err(tgot, exact)),
           "max_lsb_vs_oracle": int(diff.max()), "mean_lsb_vs_oracle":
           float(diff.float().mean()), "flat_ok": flat_ok, "run_s": run_s,
           "card": card}
    ok = (len(counts) == 1 and len(wcounts) == 1 and len(tcounts) == 1
          and all("relaxed" in row[k] for k in ("variant", "windowed_variant", "twin_variant"))
          and row["vs_plain"] == 0
          and row["max_lsb_vs_exact"] <= RELAXED_LSB and flat_ok
          and (row["residual_plane"] or not residual))
    return {**row, "status": _status(ok)}


def relaxed_sweep(orc: Oracle, card: str):
    """GRADED and RELAXED_THUMBNAILS (required), the px2 draws,
    ``fuzz_cases(8, seed=20260818)`` and the forced residual plane
    (required): (rows, failures, skips)."""
    cases = ([(c, True, False) for c in GRADED + RELAXED_THUMBNAILS]
             + [(c, False, False) for c in RELAXED_PX2 + fuzz_cases(*RELAXED_FUZZ)]
             + [(RELAXED_RESIDUAL, True, True)])
    rows = []
    for case, required, residual in cases:
        rows.append(relaxed_case(case, orc, card, required, residual))
        _print("relaxed", rows[-1])
    return _tally(rows)


def carry_case(case, orc: Oracle, card: str) -> dict:
    """One case of the carry sweep (``LIBIQO_TPU_CARRY=1`` set by the
    caller): the facade's carry route, one frame and a batch of
    CARRY_BATCH, and the windowed carry form where ``carry_ok`` holds, ==
    ``numpy_ref``."""
    from ..core.plan import build_plan
    from ..ops import cuda_resize as cr

    alg, sw, sh, dw, dh, kw = case
    name = case_name(case, " [carry1]")
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    if not cr.supports_plan(plan):
        return {"case": name, "status": "skip-unsupported",
                "reason": "outside cuda_resize.supports_plan"}
    tiled, windowed = cr.tiled_carry_layout(plan) is not None, cr.carry_ok(plan)
    if not (tiled or windowed):
        return {"case": name, "status": "skip-not-engaged",
                "reason": "no carry layout takes the plan (rows not monotone "
                          "in a run, fetch >= 90 % of the band, or the ring "
                          "does not fit)"}
    r = facade(case)
    t0 = time.perf_counter()
    src = _frames(case, range(CARRY_BATCH))
    one, counts = launched(cr, lambda: r.resize(src[0]))
    many, counts_b = launched(cr, lambda: r.resize(src))
    run_s = time.perf_counter() - t0
    want = torch.from_numpy(np.stack([orc.get(case, f) for f in range(CARRY_BATCH)]))
    errs = {"vs_oracle": max(max_err(one.cpu(), want[0]), max_err(many.cpu(), want))}
    row = {"case": name, "variant": "/".join(counts) or None,
           "launches": sum(counts.values()) + sum(counts_b.values())}
    ok = len(counts) == 1 and "carry" in row["variant"] and counts_b == counts
    if windowed:
        wops = cr.pack_operands(plan, "cuda", carry=True, tiled=False)
        wgot, wcounts = launched(cr, lambda: cr.resize_fused(wops, src))
        row["windowed_variant"] = "/".join(wcounts) or None
        errs["windowed_vs_oracle"] = max_err(wgot.cpu(), want)
        ok &= list(wcounts) == [cr.variant(plan, carry=True)]
    ok &= not any(errs.values())
    return {**row, "status": _status(ok), "max_lsb_err": max(errs.values()),
            **errs, "run_s": run_s, "card": card}


def carry_sweep(orc: Oracle, card: str):
    """CARRY_CASES and ``fuzz_cases(6, seed=20260819)`` with
    ``LIBIQO_TPU_CARRY=1``: (rows, failures, skips)."""
    old = os.environ.get("LIBIQO_TPU_CARRY")
    os.environ["LIBIQO_TPU_CARRY"] = "1"
    rows = []
    try:
        for case in CARRY_CASES + fuzz_cases(*CARRY_FUZZ):
            rows.append(carry_case(case, orc, card))
            _print("carry", rows[-1])
    finally:
        if old is None:
            os.environ.pop("LIBIQO_TPU_CARRY", None)
        else:
            os.environ["LIBIQO_TPU_CARRY"] = old
    return _tally(rows)


def sharded_sweep(orc: Oracle, card: str):
    """``parallel.sharding`` on a mesh of one card and on ``cuda:0`` named
    SHARDS[-1] times: row-sharded, and batched over a (data, row) mesh of
    the same devices; every output == ``numpy_ref``; the Lanczos rows must
    run the kernel on every shard: (rows, failures, skips)."""
    from ..core.plan import build_plan
    from ..ops import cuda_resize as cr
    from ..parallel import sharding

    cuda = torch.device("cuda", 0)
    rows = []
    for case, required, batched in SHARDED_CASES:
        alg, sw, sh, dw, dh, kw = case
        plan = build_plan(alg, sw, sh, dw, dh, **kw)
        for n in SHARDS:
            if batched:
                mesh = sharding.Mesh([[cuda] * (n // 2 or 1)] * (2 if n > 1 else 1),
                                     ("data", "row"))
                fn, ops = sharding.make_batch_row_sharded_fn(plan, mesh)
                frames = range(SHARDED_BATCH)
                tag = f"[dpxsp {mesh.devices.shape[0]}x{mesh.devices.shape[1]} batch{SHARDED_BATCH}]"
            else:
                fn, ops = sharding.make_row_sharded_fn(
                    plan, sharding.Mesh([cuda] * n, ("row",)))
                frames = (0,)
                tag = f"[row n={n}]"
            name = f"sharded {case_name(case)} {tag}"
            kernel = all(r == "cuda" for r in fn.routes)
            if not kernel and required:
                rows.append({"case": name, "status": "FAIL-no-kernel",
                             "routes": list(fn.routes)})
                _print("sharded", rows[-1])
                continue
            t0 = time.perf_counter()
            src = _frames(case, frames)
            got, counts = launched(cr, lambda: sharding.gather(
                fn(*ops, src if batched else src[0])))
            run_s = time.perf_counter() - t0
            want = torch.from_numpy(np.stack([orc.get(case, f) for f in frames]))
            err = max_err(got.reshape(want.shape).cpu(), want)
            ok = err == 0 and (sum(counts.values()) > 0) == ("cuda" in fn.routes)
            rows.append({"case": name, "status": _status(ok),
                         "routes": sorted(set(fn.routes)),
                         "variant": "/".join(counts) or None,
                         "launches": sum(counts.values()), "max_lsb_err": err,
                         "run_s": run_s, "card": card})
            _print("sharded", rows[-1])
    return _tally(rows)


def border_div_sweep(orc: Oracle, card: str):
    """:func:`border_cases`, gated as the exact sweep (every case
    required), with each case's border shares: (rows, failures, skips)."""
    from ..core.plan import build_plan

    rows = []
    for case in border_cases():
        plan = build_plan(*case[:5], **case[5])
        share = {"border_rows": float(plan.y.is_border.mean()),
                 "border_cols": float(plan.x.is_border.mean())}
        for row in exact_case(case, orc, card, True):
            rows.append({**row, **share})
            _print("border_div", row)
    return _tally(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fuzz", type=int, default=20)
    ap.add_argument("--out", type=Path, default=RESULT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("card_check: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = nvidia_smi()
    print(card, flush=True)
    workers = max(1, (os.cpu_count() or 2) - 1)     # one core stays with the card's work
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        orc = Oracle(pool)
        # every oracle output up front, the largest first, while the card works
        jobs = ([(c, range(1 + max(BATCHES) * (c in BATCHED))) for c in
                 REQUIRED + fuzz_cases(args.fuzz)]
                + [(c, range(CARRY_BATCH)) for c in CARRY_CASES + fuzz_cases(*CARRY_FUZZ)]
                + [(c, (0,)) for c in RELAXED_PX2 + fuzz_cases(*RELAXED_FUZZ)
                   + border_cases()]
                + [(c, range(SHARDED_BATCH)) for c, _, _ in SHARDED_CASES])
        for case, frames in sorted(jobs, key=lambda j: -j[0][1] * j[0][2]):
            orc.submit(case, frames)
        sweeps = {"results": exact_sweep(orc, card, args.fuzz),
                  "relaxed": relaxed_sweep(orc, card),
                  "carry": carry_sweep(orc, card),
                  "sharded": sharded_sweep(orc, card),
                  "border_div": border_div_sweep(orc, card)}
    summary = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "n_cases": sum(len(rows) for rows, _, _ in sweeps.values()),
               "n_fail": sum(f for _, f, _ in sweeps.values()),
               "n_skip": sum(s for _, _, s in sweeps.values()),
               "seconds": time.perf_counter() - t0,
               **{k: rows for k, (rows, _, _) in sweeps.items()}}
    args.out.write_text(json.dumps(summary, indent=1) + "\n")
    print(f"\n{summary['n_cases']} cases ("
          + ", ".join(f"{k} {len(v[0])}" for k, v in sweeps.items())
          + f"): {summary['n_fail']} failures, {summary['n_skip']} skipped, "
          f"{summary['seconds']:.1f} s -> {args.out} ({card})")
    return 1 if summary["n_fail"] else 0


if __name__ == "__main__":
    sys.exit(main())
