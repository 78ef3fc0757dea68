#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Two main paths, each through the entry points a user calls:

* Lanczos: one YUV420 frame, 3840x2160 -> 1920x1080, Lanczos3, exact; luma
  at px_scale 1, U and V as one batch-of-2 call at px_scale 2.  It runs the
  kernel's ``wrap16`` instantiation.
* Area: ``YUV420Resizer("area", 1920, 1080, 640, 360)``, the benchmark
  CLI's default (``python -m libiqo_tpu_torch.cli.benchmark``).  It runs
  the kernel's ``u16`` instantiation, as Linear does.
* Both again with ``precision="relaxed"`` (<= 2 LSB, flat fields exact):
  the kernel's ``wrap16_relaxed`` and ``u16_relaxed`` instantiations.

Phases:

1. Device: ``nvidia-smi`` name and power limit, capability, and the build of
   the kernel library from ``libiqo_tpu_torch/csrc`` (nvcc, sm_90a).
2. Kernel vs plain, wrap16: ``resize_fused`` against ``resize_plain`` on the
   card at the Lanczos main path's plane shapes, byte for byte, then a
   seeded fuzz set of Lanczos geometries at px_scale 1-2 and a set at
   px_scale 3-4, each also against the NumPy oracle.
3. Kernel vs plain, u16, byte for byte: Area 1080p -> 360p, Area
   4K -> 1080p and Linear 1080p -> 4K, luma and chroma at full size; then a
   seeded fuzz set of 20 Area/Linear geometries, each also against the
   NumPy oracle.
4. The Lanczos main path: ``YUV420Resizer(..., device="cuda")``, ``resize``
   on 4 frames and ``resize_batch`` on 4; the wrap16 launch count over that
   run must equal its plane calls; every plane must equal the plain path;
   the resize CLI on a 3-frame file must write the API's bytes.
5. The Area main path: ``YUV420Resizer("area", ...)`` with no ``device``
   argument must resolve to the kernel on the card; over 4 frames and one
   ``resize_batch(4)`` the u16 launch count must be 2 per call; every plane
   must equal the plain path; the benchmark CLI's default mode, run in this
   process, must launch the u16 kernel twice per cycle.
6. The benchmark CLI as a user runs it: default mode, ``--amortized``,
   ``--batch 16`` and ``--stream 64 --batch 16``, each must exit 0 and
   print its elapsed time.
7. Times: CUDA events, minimum over repeats of the mean over back-to-back
   calls on inputs that each differ by one byte, for the kernel, the plain
   version and, for Area/Linear, ``torch.nn.functional.interpolate`` on a
   float32 copy as a yardstick (not the same function: not byte-equal);
   per plane and per frame, beside each instantiation's memory bound.
   Device times are taken with the card first held busy while the host
   queues every call; the kernel's and the frame's times are also given
   unprimed, at the pace the host issues them.
8. Relaxed kernel == relaxed plain, byte for byte, on the full-width planes
   of both main paths and of every ``U16_FRAMES`` frame, then on fuzz sets
   like phases 2-3 (every plan the relaxed form takes), each also within
   3 LSB of the NumPy oracle; within 2 LSB of the exact kernel on the
   full-width planes and on the five configs of
   ``scripts/check_relaxed_tpu.py``, whose max and mean error are printed
   beside the TPU's (``scripts/check_relaxed_result.json``); flat fields
   0/128/255 equal to the exact output.
9. The relaxed main paths: ``YUV420Resizer(..., precision="relaxed")`` with
   no ``device`` argument, Lanczos 4K and Area 360p, as phases 4-5, with
   the launch counts all of the relaxed variant; the resize CLI with
   ``--precision relaxed`` must write the API's bytes; the benchmark CLI
   with ``--precision relaxed`` in its default and ``--batch 16`` modes.
10. Times of the relaxed kernel beside the exact kernel, the relaxed plain
   version and the bound, per plane and per frame, on both main paths; and
   the exact wrap16 kernel on a px_scale-4 plane (Lanczos3 960x540 ->
   480x270, the chroma of a 4K -> 1080p YUV410 frame).
11. Sharding (``libiqo_tpu_torch.parallel.sharding``) on the one card, over
   meshes that name ``cuda:0`` several times: the sharded main path, with
   every count set to 0 just before, is Lanczos3 4K -> 1080p luma, its px2
   chroma and Area 1080p -> 360p luma, each row-sharded over 4 shards,
   ``make_yuv_step_fn`` at 4K -> 1080p on 4 frames over dp 4, and
   ``make_batch_row_sharded_fn`` on a 2x2 mesh with 3 frames and 1081
   output rows; one launch per shard per plane call.  Each output equals
   the unsharded kernel or the plain path byte for byte; then small
   row-sharded geometries (tests/test_sharding.py's, the multi-hop Area
   cases and 237 -> 119 rows among them, and a seeded fuzz set) equal
   ``numpy_ref``, and ``dryrun(8, "cuda")`` passes.  Times: the 4-shard call
   against the unsharded call, device-only and host-paced, beside the
   bound; one card running 4 shards, not a multi-card figure.
12. The row-halo carry form (``LIBIQO_TPU_CARRY=1``): carry kernel ==
   windowed kernel byte for byte, exact and relaxed, on every full-width
   plane where ``carry_ok`` holds (Lanczos3 4K luma, Linear 1080p -> 4K luma
   and chroma, Lanczos3 8K -> 1080p, Lanczos2 720p -> 1080p), on
   scripts/tpu_check.py's carry_sweep cases and on a small fuzz set, batch 4,
   also == ``numpy_ref`` at small sizes; ``YUV420Resizer`` with no device
   argument and the opt-in, Lanczos3 4K (carry on luma, windowed on chroma,
   where ``carry_ok`` refuses) and Linear 1080p -> 4K (carry on both), exact
   and relaxed, with launch counts by variant; carry beside windowed times,
   and on 4K luma against the run length (``CARRY_RUN_SWEEP``).

Any failure raises and exits non-zero.  Without a CUDA device it exits 2
and prints no result.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.modules["jax"] = None         # the port must not need JAX; any import fails
sys.modules["libiqo_tpu"] = None  # nor the JAX package

ROOT = Path(__file__).resolve().parent
SRC_W, SRC_H, DST_W, DST_H = 3840, 2160, 1920, 1080     # the Lanczos main path
AREA_MAIN = ("area", 1920, 1080, 640, 360)             # the Area main path
U16_FRAMES = {                    # name: (method, src_w, src_h, dst_w, dst_h)
    "area 1080p->360p": AREA_MAIN,
    "area 4K->1080p": ("area", 3840, 2160, 1920, 1080),
    "linear 1080p->4K": ("linear", 1920, 1080, 3840, 2160),
}
SEED = 20261016
FUZZ_CASES = 20
TOLERANCE = 0          # LSB: the contract is byte-exact
RELAXED_LSB = 2        # relaxed vs the exact output: the relaxed contract
RELAXED_ORACLE_LSB = 3  # relaxed vs numpy_ref on fuzz sets, as tests/test_relaxed.py
# scripts/check_relaxed_tpu.py's configs (name: method, kwargs, geometry)
RELAXED_GRADED = {
    "lanczos3 3840x2160->1920x1080": ("lanczos", dict(degree=3), 3840, 2160, 1920, 1080),
    "lanczos3 1920x1080->960x540 px2": ("lanczos", dict(degree=3, px_scale=2),
                                        1920, 1080, 960, 540),
    "lanczos2 1280x720->1920x1080": ("lanczos", dict(degree=2), 1280, 720, 1920, 1080),
    "area 1920x1080->480x270": ("area", {}, 1920, 1080, 480, 270),
    "linear 640x480->320x240": ("linear", {}, 640, 480, 320, 240),
}
PX4_PLANE = ("lanczos", dict(degree=3, px_scale=4), 960, 540, 480, 270)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
SPIN_CYCLES_PER_CALL = 2_000_000   # ~1 ms of the card's clock per call queued
CLI_RUNS = (["--cycles", "32"], ["--amortized"], ["--batch", "16"],
            ["--stream", "64", "--batch", "16"])
SHARDS = 4                      # row (or data) shards, all on the one card
SHARDED_PLANES = {              # name: (algo, kwargs, sw, sh, dw, dh, batch)
    "lanczos3 4K->1080p luma": ("lanczos", dict(degree=3), 3840, 2160, 1920, 1080, 1),
    "lanczos3 4K->1080p px2 chroma": ("lanczos", dict(degree=3, px_scale=2),
                                      1920, 1080, 960, 540, 2),
    "area 1080p->360p luma": ("area", {}, 1920, 1080, 640, 360, 1),
}
# dp x sp on a 2x2 mesh: 3 frames, 1081 output rows over 2 row shards
DP_SP_FRAME = ("lanczos", dict(degree=3), 3840, 2160, 1920, 1081, 3)
SHARDED_SMALL = (               # (shards, algo, kwargs, (sw, sh), (dw, dh))
    (8, "lanczos", dict(degree=3), (320, 240), (160, 120)),
    (8, "area", {}, (320, 240), (160, 120)),
    (8, "linear", {}, (320, 240), (160, 120)),
    (4, "lanczos", dict(degree=2), (64, 64), (128, 128)),
    (8, "lanczos", dict(degree=3), (320, 237), (160, 119)),   # odd heights
    (8, "area", {}, (128, 512), (64, 16)),                    # multi-hop Area
    (8, "area", {}, (64, 256), (32, 4)),      # halo taller than a shard
)
SHARDED_FUZZ = 8
CARRY_PLANES = {                # full-width planes where carry_ok holds
    "lanczos3 4K->1080p luma": ("lanczos", dict(degree=3), 3840, 2160, 1920, 1080, 1),
    "linear 1080p->4K luma": ("linear", {}, 1920, 1080, 3840, 2160, 1),
    "linear 1080p->4K chroma": ("linear", {}, 960, 540, 1920, 1080, 2),
    "lanczos3 8K->1080p": ("lanczos", dict(degree=3), 7680, 4320, 1920, 1080, 1),
    "lanczos2 720p->1080p": ("lanczos", dict(degree=2), 1280, 720, 1920, 1080, 1),
}
# scripts/tpu_check.py:carry_sweep's cases: GRADED, two more, and
# fuzz_cases(6, seed=20260819) (drawn by tpu_fuzz_cases)
CARRY_SWEEP = [
    ("linear", 640, 480, 320, 240, {}),
    ("area", 1920, 1080, 480, 270, {}),
    ("lanczos", 1280, 720, 1920, 1080, dict(degree=2)),
    ("lanczos", 3840, 2160, 1920, 1080, dict(degree=3)),
    ("lanczos", 1920, 1080, 960, 540, dict(degree=3, px_scale=2)),
    ("lanczos", 512, 520, 256, 130, dict(degree=4)),      # clamped tail
    ("lanczos", 7680, 4320, 1920, 1080, dict(degree=3)),
]
CARRY_SWEEP_FUZZ = (6, 20260819)
CARRY_FUZZ = 10
# CARRY_BLOCKS values for the run-length sweep on 4K luma: runs of 2, 3, 7,
# 13, 34 and 68 row tiles (510 down to 15 blocks)
CARRY_RUN_SWEEP = (1020, 264, 132, 66, 16, 1)
ORACLE_MAX_PIXELS = 400_000     # numpy_ref only on sources this small
CARRY_PATHS = (                 # (frame, luma variant, chroma variant, precision)
    (("lanczos3", 3840, 2160, 1920, 1080), "wrap16_carry", "wrap16", "exact"),
    (("linear", 1920, 1080, 3840, 2160), "u16_carry", "u16_carry", "exact"),
    (("lanczos3", 3840, 2160, 1920, 1080), "wrap16_relaxed_carry",
     "wrap16_relaxed", "relaxed"),
    (("linear", 1920, 1080, 3840, 2160), "u16_relaxed_carry",
     "u16_relaxed_carry", "relaxed"),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def first_diff(a: torch.Tensor, b: torch.Tensor) -> str:
    idx = torch.nonzero(a != b)[0].tolist()
    return (f"first differing pixel at {idx}: kernel {a[tuple(idx)].item()}"
            f" plain {b[tuple(idx)].item()}")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            tol: int = TOLERANCE) -> int:
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    err = int((got.int() - want.int()).abs().max().item()) if got.numel() else 0
    if err > tol:
        raise SmokeFailure(f"{name}: max abs err {err} > {tol}; "
                           + first_diff(got, want))
    return err


def random_u8(rng, shape) -> np.ndarray:
    return rng.integers(0, 256, shape, dtype=np.uint8)


def yuv_planes(build_plan, method, sw, sh, dw, dh):
    """[(plane, plan, batch)] of one YUV420 frame, as ``YUV420Resizer``
    builds them for even sizes: luma at full size, U and V as one batch-of-2
    call at half size (Lanczos chroma at px_scale 2)."""
    if method.startswith("lanczos"):
        degree = int(method[len("lanczos"):] or 3)
        kw, ckw = dict(degree=degree), dict(degree=degree, px_scale=2)
        algo = "lanczos"
    else:
        kw, ckw, algo = {}, {}, method
    return [("luma", build_plan(algo, sw, sh, dw, dh, **kw), 1),
            ("chroma", build_plan(algo, sw // 2, sh // 2, dw // 2, dh // 2,
                                  **ckw), 2)]


def lanczos_fuzz(rng):
    """Lanczos degree 2-5, px_scale 1 and 2, up and down, odd sizes."""
    for i in range(FUZZ_CASES):
        degree, px = 2 + i % 4, 1 + (i // 4) % 2
        src = rng.integers(9, 400, 2) | (i % 3 == 0)    # every third odd
        if i % 2:
            dst = src * rng.integers(1, 3, 2) + rng.integers(1, 7, 2)
        else:
            dst = np.maximum(1, src // rng.integers(2, 6, 2))
        yield "lanczos", dict(degree=degree, px_scale=px), src, dst


def lanczos_px34(rng):
    """K5's plans: Lanczos degree 2-9 at px_scale 3 and 4, whose X taps
    fall outside the s8 gate; up and down, odd sizes."""
    for i in range(8):
        src = rng.integers(9, 300, 2) | (i % 3 == 0)
        if i % 2:
            dst = np.maximum(1, src // rng.integers(2, 5, 2))
        else:
            dst = src * rng.integers(1, 3, 2) + rng.integers(1, 7, 2)
        yield "lanczos", dict(degree=2 + i, px_scale=3 + i % 2), src, dst


def area_linear_fuzz(rng):
    """Area and Linear, up and down, odd sizes, and three extremes: an
    Area ratio with 40/44 taps and two reference_oob Linear upscales."""
    for i in range(FUZZ_CASES - 3):
        src = rng.integers(9, 400, 2) | (i % 3 == 0)
        if i % 4 < 2:
            dst = np.maximum(1, src // rng.integers(2, 9, 2))
        else:
            dst = src * rng.integers(1, 3, 2) + rng.integers(1, 7, 2)
        yield ("area", "linear")[i % 2], {}, src, dst
    yield "area", {}, (300, 200), (7, 5)
    yield "linear", {}, (16, 12), (80, 60)
    yield "linear", {}, (5, 3), (300, 200)


def hold(cr, tag: str, plan, host: np.ndarray, oracle=None) -> int:
    """Kernel == plain on the card, byte for byte, for one plan and a
    (B, h, w) source; also == the NumPy oracle when one is given."""
    check(cr.supports_plan(plan), f"{tag}: kernel refuses the plan")
    ops = cr.pack_operands(plan, "cuda")
    src = torch.from_numpy(host).cuda()
    got = cr.resize_fused(ops, src)
    err = compare(tag, got, cr.resize_plain(ops, src))
    if oracle is not None:
        want = torch.from_numpy(np.stack([oracle.resize_u8(plan, f) for f in host]))
        err = max(err, compare(f"{tag} vs numpy_ref", got.cpu(), want))
    return err


def phase_device(build, device):
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}, capability {torch.cuda.get_device_capability(0)},"
          f" torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{device.describe()}")
    build.load()
    print(f"kernel library: {build.build_dir()} built in "
          f"{build.build_seconds!r} s (None = already built)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    return smi, name


def phase_kernel_vs_plain(cr, build_plan, numpy_ref, rng, variant, frames,
                          fuzz_sets):
    """Kernel == plain at full-size planes, then kernel == plain ==
    numpy_ref on each fuzz set; every plan must take ``variant``."""
    max_err = 0
    for frame in frames:
        for plane, plan, batch in yuv_planes(build_plan, *frame):
            check(cr.variant(plan) == variant, f"{frame} {plane}: variant "
                  f"{cr.variant(plan)}, expected {variant}")
            host = random_u8(rng, (batch, plan.y.n_src, plan.x.n_src))
            tag = f"{frame[0]} {plane} {tuple(host.shape)}"
            max_err = max(max_err, hold(cr, tag, plan, host))
            print(f"kernel[{variant}] == plain: {tag} -> "
                  f"({batch}, {plan.y.n_dst}, {plan.x.n_dst}), max abs err 0")
    for name, cases in fuzz_sets:
        n = 0
        for algo, kw, src, dst in cases:
            (sw, sh), (dw, dh) = map(int, src), map(int, dst)
            plan = build_plan(algo, sw, sh, dw, dh, **kw)
            check(cr.variant(plan) == variant, f"{name}: variant mismatch")
            tag = f"{name} {algo}{kw or ''} {sw}x{sh}->{dw}x{dh}"
            max_err = max(max_err, hold(cr, tag, plan,
                                        random_u8(rng, (2, sh, sw)), numpy_ref))
            n += 1
        print(f"kernel[{variant}] == plain == numpy_ref on {n} {name} geometries")
    return max_err


def drive_yuv(cr, yuv, build_plan, rng, frame, variant, chroma_variant=None,
              **kwargs):
    """``YUV420Resizer(*frame, **kwargs)`` on 4 frames and one
    ``resize_batch(4)`` with every launch count set to 0 just before;
    the launch counts must be 2 per call, all of ``variant``, or one of
    ``variant`` (luma) and one of ``chroma_variant``; every plane must
    equal the plain path (the relaxed one for a relaxed variant).
    Returns (launches by variant, max_err, frames, outs)."""
    method, sw, sh, dw, dh = frame
    relaxed = "_relaxed" in variant
    route = "cuda-relaxed" if relaxed else "cuda"
    r = yuv.YUV420Resizer(method, sw, sh, dw, dh, **kwargs)
    check(r.resolved_backend() == route,
          f"{method} path resolved to {r.resolved_backend()!r}, not {route!r}")
    frames = [yuv.YUV420Frame(random_u8(rng, (sh, sw)),
                              random_u8(rng, (sh // 2, sw // 2)),
                              random_u8(rng, (sh // 2, sw // 2)))
              for _ in range(4)]
    batch = [random_u8(rng, (4, sh, sw)), random_u8(rng, (4, sh // 2, sw // 2)),
             random_u8(rng, (4, sh // 2, sw // 2))]

    cr.reset_launches()
    outs = [r.resize(f) for f in frames]
    bout = r.resize_batch(*batch)
    torch.cuda.synchronize()
    launches, by_variant = cr.LAUNCHES, dict(cr.LAUNCHES_BY_VARIANT)
    calls = len(frames) + 1
    want = {variant: 2 * calls} if chroma_variant in (None, variant) else {
        variant: calls, chroma_variant: calls}
    check(launches == 2 * calls
          and all(by_variant[v] == n for v, n in want.items()),
          f"{method} path: {launches} kernel launches {by_variant}, expected "
          f"{want} (2 per resize, 2 per batch)")
    print(f"{method} path ({r.resolved_backend()} on {r._luma.device}): "
          f"{len(frames)} x resize + 1 x resize_batch(4) -> launches "
          f"{ {v: n for v, n in by_variant.items() if n} } (expected {want})")

    (_, luma, _), (_, chroma, _) = yuv_planes(build_plan, *frame)
    luma, chroma = (cr.pack_operands(p, "cuda", relaxed=relaxed)
                    for p in (luma, chroma))

    def plain(ops, planes):
        return cr.resize_plain(ops, torch.from_numpy(planes).cuda()).cpu()

    max_err = 0
    for i, (f, o) in enumerate(zip(frames, outs)):
        check(o.y.shape == (dh, dw) and o.u.shape == (dh // 2, dw // 2),
              f"frame {i}: output shapes {o.y.shape} {o.u.shape}")
        uv = plain(chroma, np.stack([f.u, f.v]))
        for name, got, want in (("y", o.y, plain(luma, f.y[None])[0]),
                                ("u", o.u, uv[0]), ("v", o.v, uv[1])):
            max_err = max(max_err, compare(f"{method} frame {i} {name}",
                                           torch.from_numpy(got), want))
    buv = plain(chroma, np.concatenate(batch[1:]))
    for name, got, want in (("y", bout[0], plain(luma, batch[0])),
                            ("u", bout[1], buv[:4]), ("v", bout[2], buv[4:])):
        max_err = max(max_err, compare(f"{method} batch {name}",
                                       torch.from_numpy(got), want))
    print(f"{method} path == plain path on every plane of every frame")
    return by_variant, max_err, frames, outs


def phase_lanczos_path(cr, yuv, build_plan, rng, tmp: Path,
                       variant="wrap16", **kwargs):
    frame = ("lanczos3", SRC_W, SRC_H, DST_W, DST_H)
    precision = "relaxed" if variant.endswith("_relaxed") else "exact"
    by_variant, max_err, frames, outs = drive_yuv(
        cr, yuv, build_plan, rng, frame, variant, precision=precision,
        **kwargs)
    launches = by_variant[variant]

    src_file, dst_file = tmp / "in.yuv", tmp / "out.yuv"
    yuv.write_yuv420(src_file, frames[:3])
    proc = subprocess.run(
        [sys.executable, "-m", "libiqo_tpu_torch.cli.resize_yuv420p",
         "-m", "lanczos3", "-i", str(src_file), "-iw", str(SRC_W),
         "-ih", str(SRC_H), "-o", str(dst_file), "-ow", str(DST_W),
         "-oh", str(DST_H), "--precision", precision],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    check(proc.returncode == 0, f"CLI failed ({proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    print(f"CLI: {proc.stdout.strip()}")
    cli_frames = yuv.read_yuv420(dst_file, DST_W, DST_H)
    check(len(cli_frames) == 3, f"CLI wrote {len(cli_frames)} frames, not 3")
    for i, (c, o) in enumerate(zip(cli_frames, outs)):
        for name in "yuv":
            check(np.array_equal(getattr(c, name), getattr(o, name)),
                  f"CLI frame {i} plane {name} differs from the API's")
    print(f"CLI --precision {precision} output == API output on 3 frames")
    return launches, max_err


def phase_area_path(cr, yuv, build_plan, benchmark, rng, variant="u16"):
    # no device argument: the user's default, which is the card
    precision = "relaxed" if variant.endswith("_relaxed") else "exact"
    by_variant, max_err, _, _ = drive_yuv(cr, yuv, build_plan, rng, AREA_MAIN,
                                          variant, precision=precision)
    launches = by_variant[variant]
    cycles = 8
    cr.reset_launches()
    check(benchmark.main(["--cycles", str(cycles), "--precision", precision]) == 0,
          "benchmark CLI failed")
    torch.cuda.synchronize()
    by_variant = dict(cr.LAUNCHES_BY_VARIANT)
    want = {**dict.fromkeys(by_variant, 0), variant: 2 * cycles}
    check(by_variant == want,
          f"benchmark CLI launched {by_variant}, expected {2 * cycles} {variant}")
    print(f"benchmark CLI --precision {precision} in process, {cycles} cycles "
          f"-> launches {by_variant}")
    return launches, max_err


def phase_benchmark_cli(card: str, runs=CLI_RUNS, route: str = "cuda"):
    for extra in runs:
        cmd = [sys.executable, "-m", "libiqo_tpu_torch.cli.benchmark", *extra]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              timeout=600)
        check(proc.returncode == 0, f"{' '.join(cmd[1:])} failed "
              f"({proc.returncode}): {proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()
        elapsed = [ln.strip() for ln in lines if "elapsed time:" in ln]
        check(len(elapsed) == 1, f"{' '.join(cmd[1:])}: no elapsed time line")
        mode = next((ln for ln in lines if ln.startswith("benchmark (")), "?")
        check(f"  backend: {route}" in lines,
              f"{' '.join(cmd[1:])}: backend is not {route}")
        print(f"benchmark CLI {' '.join(extra)}: {mode}: {elapsed[0]} ({card})")


def time_ms(fn, inputs, repeats: int = 5, primed: bool = True) -> float:
    """Min over repeats of the mean time of back-to-back calls, by CUDA
    events; every call has its own input.  Primed, the card first spins
    long enough for the host to enqueue every call, so the events time the
    device alone; unprimed, a call that the host issues more slowly than the
    card runs it is timed at the host's pace."""
    fn(inputs[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(repeats):
        if primed:
            torch.cuda._sleep(SPIN_CYCLES_PER_CALL * len(inputs))
        start.record()
        for x in inputs:
            fn(x)
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / len(inputs))
    return best


def perturbed(base: torch.Tensor, n: int) -> list[torch.Tensor]:
    """n copies of base, copy i with one byte raised by i (mod 256)."""
    out = []
    for i in range(n):
        x = base.clone()
        x.view(-1)[i] += i
        out.append(x)
    return out


def n_inputs(nbytes: int) -> int:
    """Enough distinct inputs (>= 8) that they exceed the 50 MB L2 together."""
    return max(8, math.ceil(64e6 / nbytes))


def bound(planes, x_ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, float]:
    """The two lower bounds (ms) on the card's time for these (plan, batch)
    planes: each source byte read once and each output byte written once at
    the memory rate; and the tap multiply-adds (two operations each) that
    the separable form needs (Y over every source column, X over every
    output), the Y pass's at the int8 tensor-core rate and the X pass's at
    ``x_ops_per_s`` (int8 for the exact kernel, bf16 for the relaxed
    one)."""
    nbytes = ops_s = 0.0
    for plan, batch in planes:
        (sh, sw, dh, dw) = (plan.y.n_src, plan.x.n_src, plan.y.n_dst, plan.x.n_dst)
        nbytes += batch * (sh * sw + dh * dw)
        ops_s += 2 * batch * (plan.y.num_coefs * dh * sw / INT8_OPS_PER_S
                              + plan.x.num_coefs * dh * dw / x_ops_per_s)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3


def phase_times(cr, yuv, build_plan, rng, card: str, frame) -> dict:
    """Kernel, plain and (Area/Linear) yardstick ms per plane and per frame,
    and the frame's bound."""
    method, sw, sh, dw, dh = frame
    mode = {"area": "area", "linear": "bilinear"}.get(method)
    F = torch.nn.functional
    rows, planes = {}, []
    for name, plan, batch in yuv_planes(build_plan, *frame):
        planes.append((plan, batch))
        ops = cr.pack_operands(plan, "cuda")
        shape = (batch, plan.y.n_src, plan.x.n_src)
        xs = perturbed(torch.from_numpy(random_u8(rng, shape)).cuda(),
                       n_inputs(math.prod(shape)))
        size = (plan.y.n_dst, plan.x.n_dst)
        yard = None
        if mode:
            fs = [x.float()[:, None] for x in xs]
            kw = {} if mode == "area" else dict(align_corners=False)
            yard = time_ms(lambda x: F.interpolate(x, size=size, mode=mode, **kw), fs)
            del fs
        fused = lambda x: cr.resize_fused(ops, x)      # noqa: E731
        rows[name] = (time_ms(fused, xs), time_ms(fused, xs, primed=False),
                      time_ms(lambda x: cr.resize_plain(ops, x), xs), yard)

    shapes = ((sh, sw), (sh // 2, sw // 2), (sh // 2, sw // 2))
    n = n_inputs(sum(map(math.prod, shapes)))
    fs = [yuv.YUV420Frame(*p) for p in zip(*(
        perturbed(torch.from_numpy(random_u8(rng, s)).cuda(), n) for s in shapes))]
    kernel = yuv.YUV420Resizer(method, sw, sh, dw, dh, backend="cuda")
    plain = yuv.YUV420Resizer(method, sw, sh, dw, dh, backend="torch")
    rows["frame (YUV420Resizer)"] = (
        time_ms(kernel.resize, fs), time_ms(kernel.resize, fs, primed=False),
        time_ms(plain.resize, fs), None)
    bytes_ms, ops_ms = bound(planes)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    tag = f"{method} {sw}x{sh}->{dw}x{dh}"
    for name, (k, ku, p, y) in rows.items():
        yard = (f", yardstick F.interpolate({mode}) on float32 {y!r} ms "
                "(not byte-equal)" if y is not None else "")
        print(f"time {tag} {name}: kernel {k!r} ms (unprimed {ku!r}), plain "
              f"{p!r} ms, plain/kernel {p / k!r}{yard} ({card})")
    k, p = (rows["luma"][i] + rows["chroma"][i] for i in (0, 2))
    y = rows["luma"][3] + rows["chroma"][3] if mode else None
    print(f"time {tag} planes per frame: kernel {k!r} ms, plain {p!r} ms, "
          f"yardstick {y!r} ms, bound {bound_ms!r} ms ({bound_by}; bytes "
          f"{bytes_ms!r} ms, operations {ops_ms!r} ms), kernel/bound "
          f"{k / bound_ms!r} ({card})")
    return {"ms": k, "plain_ms": p, "bound_ms": bound_ms, "bound_by": bound_by,
            "yardstick_ms": y}


def err_stats(got: torch.Tensor, want: torch.Tensor) -> tuple[int, float]:
    d = (got.int() - want.int()).abs()
    return int(d.max().item()), float(d.double().mean().item())


def hold_relaxed(cr, tag: str, plan, host: np.ndarray, oracle=None):
    """Relaxed kernel == relaxed plain on the card, byte for byte, for one
    plan and a (B, h, w) source; within RELAXED_LSB of the exact kernel, or
    with an oracle within RELAXED_ORACLE_LSB of it; flat fields 0/128/255
    equal to the exact output.  Returns the error against the relaxed plain
    version and the (max, mean) error against the exact output."""
    check(cr.supports_plan(plan, relaxed=True), f"{tag}: relaxed form refuses")
    rel = cr.pack_operands(plan, "cuda", relaxed=True)
    ex = cr.pack_operands(plan, "cuda")
    src = torch.from_numpy(host).cuda()
    got = cr.resize_fused(rel, src)
    plain_err = compare(f"{tag} relaxed", got, cr.resize_plain(rel, src))
    if oracle is None:
        want = cr.resize_fused(ex, src)
        compare(f"{tag} relaxed vs exact", got, want, RELAXED_LSB)
    else:
        want = torch.from_numpy(np.stack([oracle.resize_u8(plan, f) for f in host]))
        compare(f"{tag} relaxed vs numpy_ref", got.cpu(), want, RELAXED_ORACLE_LSB)
        want = want.cuda()
    for v in (0, 128, 255):
        flat = torch.full_like(src, v)
        compare(f"{tag} relaxed flat {v}", cr.resize_fused(rel, flat),
                cr.resize_fused(ex, flat))
    return (plain_err, *err_stats(got, want))


def phase_relaxed_vs_plain(cr, build_plan, numpy_ref, rng):
    """Phase 8.  Returns, per relaxed variant, the largest error against
    the relaxed plain version and against the exact output."""
    worst = {"wrap16_relaxed": [0, 0], "u16_relaxed": [0, 0]}

    def note(plan, stats):
        v = cr.variant(plan, relaxed=True)
        worst[v] = [max(worst[v][0], stats[0]), max(worst[v][1], stats[1])]
        return v

    frames = [("lanczos3", SRC_W, SRC_H, DST_W, DST_H), *U16_FRAMES.values()]
    for frame in frames:
        for plane, plan, batch in yuv_planes(build_plan, *frame):
            host = random_u8(rng, (batch, plan.y.n_src, plan.x.n_src))
            tag = f"{frame[0]} {plane} {tuple(host.shape)}"
            stats = hold_relaxed(cr, tag, plan, host)
            v = note(plan, stats)
            print(f"kernel[{v}] == plain: {tag}, flat fields exact; vs exact "
                  f"max {stats[1]} mean {stats[2]!r} LSB")
    tpu = {row["case"]: row for row in json.loads(
        (ROOT / "scripts" / "check_relaxed_result.json").read_text())}
    for name, (algo, kw, sw, sh, dw, dh) in RELAXED_GRADED.items():
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        stats = hold_relaxed(cr, name, plan, random_u8(rng, (1, sh, sw)))
        note(plan, stats)
        t = tpu[name]
        print(f"relaxed graded {name}: vs exact max {stats[1]} mean "
              f"{stats[2]!r} LSB (TPU vs oracle: max {t['max_lsb']} mean "
              f"{t['mean_lsb']}, scripts/check_relaxed_result.json)")
    fuzz = np.random.default_rng(SEED + 1)
    for name, cases in (("lanczos px1-2 fuzz", lanczos_fuzz(fuzz)),
                        ("lanczos px3-4", lanczos_px34(fuzz)),
                        ("area/linear fuzz", area_linear_fuzz(fuzz))):
        n = refused = 0
        for algo, kw, src, dst in cases:
            (sw, sh), (dw, dh) = map(int, src), map(int, dst)
            plan = build_plan(algo, sw, sh, dw, dh, **kw)
            if not cr.supports_plan(plan, relaxed=True):
                refused += 1
                continue
            tag = f"{name} {algo}{kw or ''} {sw}x{sh}->{dw}x{dh}"
            note(plan, hold_relaxed(cr, tag, plan, random_u8(fuzz, (2, sh, sw)),
                                    numpy_ref))
            n += 1
        print(f"relaxed kernel == relaxed plain, within {RELAXED_ORACLE_LSB} "
              f"LSB of numpy_ref, flat fields exact, on {n} {name} geometries "
              f"({refused} refused by supports_plan(relaxed=True))")
    return worst


def phase_relaxed_times(cr, build_plan, rng, card: str, frame) -> dict:
    """Phase 10: relaxed kernel, exact kernel and relaxed plain per plane
    and per frame, beside the frame's bound (the same bytes as exact)."""
    method, sw, sh, dw, dh = frame
    rows, planes = {}, []
    for name, plan, batch in yuv_planes(build_plan, *frame):
        planes.append((plan, batch))
        rel = cr.pack_operands(plan, "cuda", relaxed=True)
        ex = cr.pack_operands(plan, "cuda")
        shape = (batch, plan.y.n_src, plan.x.n_src)
        xs = perturbed(torch.from_numpy(random_u8(rng, shape)).cuda(),
                       n_inputs(math.prod(shape)))
        # in turns, exact, relaxed, relaxed, exact: min of each pair
        times = [time_ms(lambda x, o=o: cr.resize_fused(o, x), xs)
                 for o in (ex, rel, rel, ex)]
        rows[name] = (min(times[1:3]),
                      time_ms(lambda x: cr.resize_fused(rel, x), xs, primed=False),
                      min(times[0], times[3]),
                      time_ms(lambda x: cr.resize_plain(rel, x), xs))
    bytes_ms, ops_ms = bound(planes, BF16_OPS_PER_S)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    tag = f"{method} {sw}x{sh}->{dw}x{dh}"
    for name, (r, ru, e, p) in rows.items():
        print(f"time relaxed {tag} {name}: relaxed kernel {r!r} ms (unprimed "
              f"{ru!r}), exact kernel {e!r} ms, relaxed plain {p!r} ms, "
              f"relaxed/exact {r / e!r} ({card})")
    r, e, p = (rows["luma"][i] + rows["chroma"][i] for i in (0, 2, 3))
    print(f"time relaxed {tag} planes per frame: relaxed kernel {r!r} ms, "
          f"exact kernel {e!r} ms, relaxed plain {p!r} ms, bound {bound_ms!r} "
          f"ms ({bound_by}), relaxed/bound {r / bound_ms!r} ({card})")
    return {"ms": r, "exact_ms": e, "plain_ms": p, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_px4_time(cr, build_plan, rng, card: str) -> None:
    """Phase 10, K5's plans: the exact wrap16 kernel on one full-size
    px_scale-4 plane, held to its plain version, then timed."""
    algo, kw, sw, sh, dw, dh = PX4_PLANE
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    host = random_u8(rng, (1, sh, sw))
    hold(cr, "px4 plane", plan, host)
    ops = cr.pack_operands(plan, "cuda")
    xs = perturbed(torch.from_numpy(host).cuda(), n_inputs(host.size))
    k = time_ms(lambda x: cr.resize_fused(ops, x), xs)
    ku = time_ms(lambda x: cr.resize_fused(ops, x), xs, primed=False)
    p = time_ms(lambda x: cr.resize_plain(ops, x), xs)
    bytes_ms, ops_ms = bound([(plan, 1)])
    print(f"time px4 lanczos3 {sw}x{sh}->{dw}x{dh} (1 plane, wrap16): kernel "
          f"{k!r} ms (unprimed {ku!r}), plain {p!r} ms, bound "
          f"{max(bytes_ms, ops_ms)!r} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'};"
          f" bytes {bytes_ms!r}, operations {ops_ms!r}) ({card})")


def halo_rows(sharding, plan, shards: int) -> int:
    """Halo rows that a row-sharded call of ``plan`` writes into its bands
    (each is read once more by the kernel)."""
    padded = sharding._pad_rows_plan(plan, shards)[0]
    lay = sharding._row_shard_layout(padded, shards)
    return shards * (lay.halo_up + lay.halo_dn)


def sharded_small(rng):
    """tests/test_sharding.py's row-sharded geometries (the two multi-hop
    Area cases and the 237 -> 119-row odd height among them), then a seeded
    fuzz set: (shards, algo, kwargs, (sw, sh), (dw, dh))."""
    yield from SHARDED_SMALL
    for i in range(SHARDED_FUZZ):
        algo = ("lanczos", "area", "linear")[i % 3]
        src = rng.integers(16, 400, 2) | (i % 2)
        dst = (np.maximum(4, src // rng.integers(1, 5, 2)) if i % 4 < 2
               else src * 2 - rng.integers(0, 3, 2))
        kw = dict(degree=int(2 + i % 3)) if algo == "lanczos" else {}
        yield int(2 + i % 7), algo, kw, tuple(map(int, src)), tuple(map(int, dst))


def phase_sharded(cr, sharding, build_plan, numpy_ref, rng, card: str) -> dict:
    """Phase 11, sharding on one card: a mesh that names ``cuda:0``
    SHARDS times.  Returns the sharded entries of the kernels line."""
    t_phase = time.perf_counter()
    cuda = torch.device("cuda", 0)
    rows = sharding.Mesh([cuda] * SHARDS, ("row",))
    data = sharding.Mesh([cuda] * SHARDS, ("data",))
    grid = sharding.Mesh([[cuda] * 2] * 2, ("data", "row"))
    planes = {}
    for name, (algo, kw, sw, sh, dw, dh, batch) in SHARDED_PLANES.items():
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        fn, ops = sharding.make_row_sharded_fn(plan, rows)
        check(fn.routes == ("cuda",) * SHARDS, f"sharded {name}: routes {fn.routes}")
        shape = (sh, sw) if batch == 1 else (batch, sh, sw)
        planes[name] = (plan, fn, ops, torch.from_numpy(random_u8(rng, shape)).cuda())
    step, step_ops = sharding.make_yuv_step_fn(data, SRC_W, SRC_H, DST_W, DST_H)
    check(step.routes == ("cuda",) * 2 * SHARDS, f"yuv step routes {step.routes}")
    yuv_in = [torch.from_numpy(random_u8(rng, (SHARDS, h, w))).cuda()
              for h, w in ((SRC_H, SRC_W),) + ((SRC_H // 2, SRC_W // 2),) * 2]
    algo, kw, sw, sh, dw, dh, nb = DP_SP_FRAME
    dpsp_plan = build_plan(algo, sw, sh, dw, dh, **kw)
    dpsp, dpsp_ops = sharding.make_batch_row_sharded_fn(dpsp_plan, grid)
    check(dpsp.routes == ("cuda",) * 4, f"dp x sp routes {dpsp.routes}")
    dpsp_in = torch.from_numpy(random_u8(rng, (nb, sh, sw))).cuda()

    # the sharded main path: every count set to 0 just before, read after
    def launched(what: str, n: int, call):
        before = cr.LAUNCHES
        out = call()
        check(cr.LAUNCHES - before == n, f"{what}: {cr.LAUNCHES - before} "
              f"launches, expected {n} (one per shard per plane call)")
        return out

    cr.reset_launches()
    outs = {name: launched(f"sharded {name}", SHARDS, lambda: fn(*ops, x))
            for name, (_, fn, ops, x) in planes.items()}
    yuv_out = launched("yuv step", 3 * SHARDS, lambda: step(*step_ops, *yuv_in))
    dpsp_out = launched("dp x sp", 4, lambda: dpsp(*dpsp_ops, dpsp_in))
    torch.cuda.synchronize()
    by_variant = dict(cr.LAUNCHES_BY_VARIANT)
    want = {**dict.fromkeys(by_variant, 0),
            "wrap16": 2 * SHARDS + 3 * SHARDS + 4, "u16": SHARDS}
    check(by_variant == want, f"sharded main path launched {by_variant}, "
          f"expected {want}: one per shard per plane call")
    print(f"sharded main path on {SHARDS} x {cuda}: 4K luma, px2 chroma and "
          f"Area 360p row-sharded, YUV step 4K->1080p batch {SHARDS} over dp "
          f"{SHARDS}, dp x sp 2x2 -> launches "
          f"{ {v: n for v, n in by_variant.items() if n} }")

    max_err = {"wrap16": 0, "u16": 0}
    for name, (plan, fn, ops, x) in planes.items():
        got = sharding.gather(outs[name])
        x3 = x if x.ndim == 3 else x[None]
        ops_u = cr.pack_operands(plan, "cuda")
        whole = cr.resize_fused(ops_u, x3).reshape(got.shape)
        v = cr.variant(plan)
        err = max(compare(f"sharded {name} vs unsharded kernel", got, whole),
                  compare(f"sharded {name} vs plain",
                          got, cr.resize_plain(ops_u, x3).reshape(got.shape)))
        max_err[v] = max(max_err[v], err)
        print(f"sharded {name} {tuple(x.shape)} over {SHARDS} shards == "
              f"unsharded kernel == plain, byte for byte ({v})")
    luma = build_plan("lanczos", SRC_W, SRC_H, DST_W, DST_H, degree=3)
    chroma = build_plan("lanczos", SRC_W // 2, SRC_H // 2, DST_W // 2,
                        DST_H // 2, degree=3, px_scale=2)
    for plane, plan, got, x in zip("yuv", (luma, chroma, chroma),
                                   sharding.gather(yuv_out), yuv_in):
        max_err["wrap16"] = max(max_err["wrap16"], compare(
            f"yuv step {plane}", got,
            cr.resize_plain(cr.pack_operands(plan, "cuda"), x)))
    print(f"yuv step 4K->1080p, {SHARDS} frames over dp {SHARDS}: every plane "
          "== plain path")
    got = sharding.gather(dpsp_out)
    check(got.shape == (nb, dh, dw), f"dp x sp shape {tuple(got.shape)}")
    max_err["wrap16"] = max(max_err["wrap16"], compare(
        "dp x sp", got, cr.resize_plain(cr.pack_operands(dpsp_plan, "cuda"),
                                        dpsp_in)))
    print(f"dp x sp 2x2: {nb} frames {sw}x{sh}->{dw}x{dh} ({dh} rows over 2 "
          "row shards) == plain path")

    n_small = 0
    for shards, algo, kw, (sw, sh), (dw, dh) in sharded_small(rng):
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        fn, ops = sharding.make_row_sharded_fn(
            plan, sharding.Mesh([cuda] * shards, ("row",)))
        host = random_u8(rng, (sh, sw))
        before = cr.LAUNCHES
        got = sharding.gather(fn(*ops, torch.from_numpy(host).cuda())).cpu()
        kernel_shards = fn.routes.count("cuda")
        check(cr.LAUNCHES - before == kernel_shards,
              f"sharded {algo} {sw}x{sh}->{dw}x{dh}: {cr.LAUNCHES - before} "
              f"launches, {kernel_shards} kernel shards")
        compare(f"sharded {algo}{kw or ''} {sw}x{sh}->{dw}x{dh} on {shards} "
                "vs numpy_ref", got,
                torch.from_numpy(numpy_ref.resize_u8(plan, host)))
        n_small += 1
    print(f"row-sharded == numpy_ref on {n_small} small geometries "
          "(multi-hop Area and odd heights among them)")
    before = cr.LAUNCHES
    summary = sharding.dryrun(8, "cuda")
    check(cr.LAUNCHES > before, "dryrun launched no kernel")
    print(f"dryrun(8, 'cuda') == numpy_ref: {summary}, "
          f"{cr.LAUNCHES - before} launches")

    entries = {}
    for name, v in (("lanczos3 4K->1080p luma", "wrap16"),
                    ("area 1080p->360p luma", "u16")):
        plan, fn, ops, x = planes[name]
        ops_u = cr.pack_operands(plan, "cuda")
        fn_t, ops_t = sharding.make_row_sharded_fn(plan, rows, backend="torch")
        xs = perturbed(x, n_inputs(x.numel()))
        sharded = lambda t: fn(*ops, t)                          # noqa: E731
        whole = lambda t: cr.resize_fused(ops_u, t[None])        # noqa: E731
        # in turns, unsharded, sharded, sharded, unsharded
        times = [time_ms(f, xs) for f in (whole, sharded, sharded, whole)]
        k, u = min(times[1:3]), min(times[0], times[3])
        ku = time_ms(sharded, xs, primed=False)
        uu = time_ms(whole, xs, primed=False)
        p = time_ms(lambda t: fn_t(*ops_t, t), xs)
        halo = halo_rows(sharding, plan, SHARDS) * plan.x.n_src
        nbytes = (plan.y.n_src * plan.x.n_src + 2 * halo
                  + plan.y.n_dst * plan.x.n_dst)
        b = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"time sharded {name}, {SHARDS} shards on one card (not a "
              f"multi-card figure): sharded {k!r} ms (host-paced {ku!r}), "
              f"unsharded kernel {u!r} ms (host-paced {uu!r}), sharded plain "
              f"{p!r} ms, sharded/unsharded {k / u!r}, bound {b!r} ms (bytes: "
              f"source, {halo} halo bytes read and written once more, output)"
              f" ({card})")
        entries[v] = {
            "name": f"resize_fused[{v},sharded]", "route": "cuda",
            "source": "libiqo_tpu_torch/csrc/resize_fused.cu",
            "replaces": "libiqo_tpu/parallel/sharding.py:197",
            "launches": by_variant[v], "max_abs_err": max_err[v], "ms": k,
            "plain_ms": p, "bound_ms": b, "bound_by": "bytes",
            "library_ms": None, "unsharded_ms": u, "host_paced_ms": ku,
            "shards_on_one_card": SHARDS}
    print(f"phase sharded: {time.perf_counter() - t_phase!r} s")
    return entries


def tpu_fuzz_cases(n: int, seed: int):
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
        kw = dict(degree=int(rng.integers(1, 10))) if alg == "lanczos" else {}
        cases.append((str(alg), sw, sh, dw, dh, kw))
    return cases


def carry_small(rng, cr, build_plan):
    """A seeded fuzz set of small plans on which carry_ok holds."""
    n = tries = 0
    while n < CARRY_FUZZ and tries < 400:
        tries += 1
        algo = ("lanczos", "linear")[tries % 2]
        sw, sh = (int(v) for v in rng.integers(64, 400, 2))
        dw, dh = ((sw // 2, sh // 2) if tries % 4 < 2
                  else (sw * 3 // 2 + tries % 3, sh * 3 // 2 + tries % 5))
        kw = dict(degree=int(2 + tries % 3)) if algo == "lanczos" else {}
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        if cr.supports_plan(plan) and cr.carry_ok(plan):
            n += 1
            yield algo, kw, sw, sh, dw, dh, plan


def hold_carry(cr, tag: str, plan, host: np.ndarray, oracle=None) -> int:
    """Carry kernel == windowed kernel on the card, byte for byte, exact and
    (where the relaxed form takes the plan) relaxed; exact also == the
    NumPy oracle when one is given.  Returns the largest error."""
    check(cr.carry_ok(plan), f"{tag}: carry_ok refuses")
    src = torch.from_numpy(host).cuda()
    err = 0
    for relaxed in (False, True):
        if relaxed and not cr.supports_plan(plan, relaxed=True):
            continue
        carry = cr.pack_operands(plan, "cuda", relaxed, carry=True)
        windowed = cr.pack_operands(plan, "cuda", relaxed)
        check(cr.variant(carry.tables) == cr.variant(plan, relaxed, carry=True),
              f"{tag}: carry tables are {cr.variant(carry.tables)}")
        got = cr.resize_fused(carry, src)
        err = max(err, compare(f"{tag} {cr.variant(carry.tables)} vs windowed",
                               got, cr.resize_fused(windowed, src)))
        if oracle is not None and not relaxed:
            want = np.stack([oracle.resize_u8(plan, f) for f in host])
            err = max(err, compare(f"{tag} carry vs numpy_ref", got.cpu(),
                                   torch.from_numpy(want)))
    return err


def phase_carry(cr, yuv, build_plan, numpy_ref, rng, card: str) -> dict:
    """Phase 12, the carry form.  Returns its entries of the kernels line."""
    t_phase = time.perf_counter()
    max_err = dict.fromkeys(("wrap16_carry", "u16_carry", "wrap16_relaxed_carry",
                             "u16_relaxed_carry"), 0)

    def note(plan, err):
        for relaxed in (False, True):
            max_err[cr.variant(plan, relaxed, carry=True)] = max(
                max_err[cr.variant(plan, relaxed, carry=True)], err)

    plans = {}
    for name, (algo, kw, sw, sh, dw, dh, batch) in CARRY_PLANES.items():
        plan = plans[name] = build_plan(algo, sw, sh, dw, dh, **kw)
        lay = cr.carry_layout(plan)
        check(lay is not None, f"carry_ok refuses {name}")
        note(plan, hold_carry(cr, name, plan, random_u8(rng, (batch, sh, sw))))
        print(f"carry == windowed, exact and relaxed: {name} ({batch}, {sh}, "
              f"{sw}); run {lay.run} row tiles, ring {lay.ring_rows} rows x "
              f"{lay.ring_pitch} B, fetch/band {lay.fetch / lay.band!r}")
    n = skipped = 0
    for algo, sw, sh, dw, dh, kw in CARRY_SWEEP + tpu_fuzz_cases(*CARRY_SWEEP_FUZZ):
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        if not (cr.supports_plan(plan) and cr.carry_ok(plan)):
            skipped += 1
            continue
        small = sw * sh <= ORACLE_MAX_PIXELS
        note(plan, hold_carry(cr, f"carry sweep {algo}{kw or ''} {sw}x{sh}->"
                              f"{dw}x{dh}", plan, random_u8(rng, (4, sh, sw)),
                              numpy_ref if small else None))
        n += 1
    print(f"carry == windowed (batch 4, exact and relaxed) on {n} "
          f"scripts/tpu_check.py:carry_sweep cases ({skipped} where carry_ok "
          f"or supports_plan refuses: the windowed form serves them)")
    n = 0
    for algo, kw, sw, sh, dw, dh, plan in carry_small(rng, cr, build_plan):
        note(plan, hold_carry(cr, f"carry fuzz {algo}{kw or ''} {sw}x{sh}->"
                              f"{dw}x{dh}", plan, random_u8(rng, (4, sh, sw)),
                              numpy_ref))
        n += 1
    print(f"carry == windowed == numpy_ref (batch 4) on {n} small fuzz plans")

    launches = {}
    for frame, luma_v, chroma_v, precision in CARRY_PATHS:
        by_variant, err, _, _ = drive_yuv(cr, yuv, build_plan, rng, frame,
                                          luma_v, chroma_v, precision=precision)
        launches[luma_v] = by_variant[luma_v]
        max_err[luma_v] = max(max_err[luma_v], err)
    print(f"carry main paths with LIBIQO_TPU_CARRY=1 -> launches {launches}")

    entries = {}
    for v, name in (("wrap16_carry", "lanczos3 4K->1080p luma"),
                    ("u16_carry", "linear 1080p->4K luma"),
                    ("wrap16_relaxed_carry", "lanczos3 4K->1080p luma"),
                    ("u16_relaxed_carry", "linear 1080p->4K luma")):
        relaxed = "_relaxed" in v
        plan = plans[name]
        carry = cr.pack_operands(plan, "cuda", relaxed, carry=True)
        windowed = cr.pack_operands(plan, "cuda", relaxed)
        x = torch.from_numpy(random_u8(rng, (1, plan.y.n_src, plan.x.n_src))).cuda()
        xs = perturbed(x, n_inputs(x.numel()))
        run_c = lambda t: cr.resize_fused(carry, t)              # noqa: E731
        run_w = lambda t: cr.resize_fused(windowed, t)           # noqa: E731
        times = [time_ms(f, xs) for f in (run_w, run_c, run_c, run_w)]
        k, w = min(times[1:3]), min(times[0], times[3])
        ku = time_ms(run_c, xs, primed=False)
        p = time_ms(lambda t: cr.resize_plain(carry, t), xs)
        bytes_ms, ops_ms = bound([(plan, 1)], BF16_OPS_PER_S if relaxed
                                 else INT8_OPS_PER_S)
        b = max(bytes_ms, ops_ms)
        print(f"time carry {v} {name}: carry {k!r} ms (unprimed {ku!r}), "
              f"windowed {w!r} ms, carry/windowed {k / w!r}, plain {p!r} ms, "
              f"bound {b!r} ms ({card})")
        entries[v] = {
            "name": f"resize_fused[{v.replace('_', ',')}]", "route": "cuda",
            "source": "libiqo_tpu_torch/csrc/resize_fused.cu",
            "replaces": "libiqo_tpu/ops/pallas_resize.py:1242",
            "launches": launches[v], "max_abs_err": max_err[v], "ms": k,
            "plain_ms": p, "bound_ms": b,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "windowed_ms": w, "plane": name}
    for name in ("lanczos3 8K->1080p", "lanczos2 720p->1080p",
                 "linear 1080p->4K chroma"):
        plan, batch = plans[name], CARRY_PLANES[name][-1]
        carry = cr.pack_operands(plan, "cuda", carry=True)
        windowed = cr.pack_operands(plan, "cuda")
        x = torch.from_numpy(random_u8(rng, (batch, plan.y.n_src, plan.x.n_src))).cuda()
        xs = perturbed(x, n_inputs(x.numel()))
        times = [time_ms(lambda t, o=o: cr.resize_fused(o, t), xs)
                 for o in (windowed, carry, carry, windowed)]
        k, w = min(times[1:3]), min(times[0], times[3])
        print(f"time carry {cr.variant(carry.tables)} {name} {tuple(x.shape)}: "
              f"carry {k!r} ms, windowed {w!r} ms, carry/windowed {k / w!r}, "
              f"bound {bound([(plan, batch)])[0]!r} ms ({card})")
    # the run length against the grid's size, on 4K luma
    plan = plans["lanczos3 4K->1080p luma"]
    windowed = cr.pack_operands(plan, "cuda")
    x = torch.from_numpy(random_u8(rng, (1, plan.y.n_src, plan.x.n_src))).cuda()
    xs = perturbed(x, n_inputs(x.numel()))
    n_ct = -(-plan.x.n_dst // cr.TILE_COLS)
    saved = cr.CARRY_BLOCKS
    try:
        for blocks in CARRY_RUN_SWEEP:
            cr.CARRY_BLOCKS = blocks
            lay = cr.carry_layout(plan)
            carry = cr.pack_operands(plan, "cuda", carry=True)
            compare(f"carry run {lay.run} vs windowed", cr.resize_fused(carry, x),
                    cr.resize_fused(windowed, x))
            times = [time_ms(lambda t, o=o: cr.resize_fused(o, t), xs)
                     for o in (windowed, carry, carry, windowed)]
            k, w = min(times[1:3]), min(times[0], times[3])
            print(f"time carry run sweep, lanczos3 4K luma: run {lay.run} row "
                  f"tiles, {n_ct * -(-len(lay.rwin) // lay.run)} blocks, "
                  f"fetch/band {lay.fetch / lay.band!r}: carry {k!r} ms, "
                  f"windowed {w!r} ms, carry/windowed {k / w!r} ({card})")
    finally:
        cr.CARRY_BLOCKS = saved
    print(f"phase carry: {time.perf_counter() - t_phase!r} s")
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from libiqo_tpu_torch import build_plan, yuv
    from libiqo_tpu_torch.cli import benchmark
    from libiqo_tpu_torch.golden import numpy_ref
    from libiqo_tpu_torch.ops import _build, cuda_resize
    from libiqo_tpu_torch.parallel import sharding
    from libiqo_tpu_torch.utils import device

    rng = np.random.default_rng(SEED)
    smi, name = phase_device(_build, device)
    err16 = phase_kernel_vs_plain(
        cuda_resize, build_plan, numpy_ref, rng, "wrap16",
        [("lanczos3", SRC_W, SRC_H, DST_W, DST_H)],
        [("lanczos px1-2 fuzz", lanczos_fuzz(rng)),
         ("lanczos px3-4", lanczos_px34(rng))])
    erru = phase_kernel_vs_plain(
        cuda_resize, build_plan, numpy_ref, rng, "u16", U16_FRAMES.values(),
        [("area/linear fuzz", area_linear_fuzz(rng))])
    with tempfile.TemporaryDirectory() as tmp:
        launches16, e = phase_lanczos_path(cuda_resize, yuv, build_plan, rng,
                                           Path(tmp))
    err16 = max(err16, e)
    launchesu, e = phase_area_path(cuda_resize, yuv, build_plan, benchmark, rng)
    erru = max(erru, e)
    phase_benchmark_cli(smi)

    t16 = phase_times(cuda_resize, yuv, build_plan, rng, smi,
                      ("lanczos3", SRC_W, SRC_H, DST_W, DST_H))
    tu = [phase_times(cuda_resize, yuv, build_plan, rng, smi, f)
          for f in U16_FRAMES.values()][0]          # AREA_MAIN comes first

    rrng = np.random.default_rng(SEED + 2)
    rerr = phase_relaxed_vs_plain(cuda_resize, build_plan, numpy_ref, rrng)
    with tempfile.TemporaryDirectory() as tmp:
        launches16r, e = phase_lanczos_path(cuda_resize, yuv, build_plan, rrng,
                                            Path(tmp), "wrap16_relaxed")
    plain16r, err16r = max(rerr["wrap16_relaxed"][0], e), rerr["wrap16_relaxed"][1]
    launchesur, e = phase_area_path(cuda_resize, yuv, build_plan, benchmark,
                                    rrng, "u16_relaxed")
    plainur, errur = max(rerr["u16_relaxed"][0], e), rerr["u16_relaxed"][1]
    phase_benchmark_cli(smi, [["--cycles", "32", "--precision", "relaxed"],
                              ["--batch", "16", "--precision", "relaxed"]],
                        route="cuda-relaxed")
    t16r = phase_relaxed_times(cuda_resize, build_plan, rrng, smi,
                               ("lanczos3", SRC_W, SRC_H, DST_W, DST_H))
    tur = phase_relaxed_times(cuda_resize, build_plan, rrng, smi, AREA_MAIN)
    phase_px4_time(cuda_resize, build_plan, rrng, smi)

    sharded = phase_sharded(cuda_resize, sharding, build_plan, numpy_ref,
                            np.random.default_rng(SEED + 3), smi)
    os.environ["LIBIQO_TPU_CARRY"] = "1"          # the opt-in, from here on
    carry = phase_carry(cuda_resize, yuv, build_plan, numpy_ref,
                        np.random.default_rng(SEED + 4), smi)

    src = "libiqo_tpu_torch/csrc/resize_fused.cu"
    replaces = "libiqo_tpu/ops/pallas_resize.py:1687"
    replaces_relaxed = "libiqo_tpu/ops/pallas_resize.py:1486"
    print(json.dumps({"kernels": [
        {"name": "resize_fused[wrap16]", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches16, "max_abs_err": err16,
         "ms": t16["ms"], "plain_ms": t16["plain_ms"],
         "bound_ms": t16["bound_ms"], "bound_by": t16["bound_by"],
         "library_ms": None},
        {"name": "resize_fused[u16]", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launchesu, "max_abs_err": erru,
         "ms": tu["ms"], "plain_ms": tu["plain_ms"],
         "bound_ms": tu["bound_ms"], "bound_by": tu["bound_by"],
         "library_ms": None, "yardstick_ms": tu["yardstick_ms"]},
        # max_abs_err: against the relaxed plain version; max_lsb_vs_exact:
        # against the exact output, the relaxed contract's <= 2 LSB
        {"name": "resize_fused[wrap16,relaxed]", "route": "cuda", "source": src,
         "replaces": replaces_relaxed, "launches": launches16r,
         "max_abs_err": plain16r, "max_lsb_vs_exact": err16r,
         "ms": t16r["ms"], "plain_ms": t16r["plain_ms"],
         "bound_ms": t16r["bound_ms"], "bound_by": t16r["bound_by"],
         "library_ms": None, "exact_kernel_ms": t16r["exact_ms"]},
        {"name": "resize_fused[u16,relaxed]", "route": "cuda", "source": src,
         "replaces": replaces_relaxed, "launches": launchesur,
         "max_abs_err": plainur, "max_lsb_vs_exact": errur,
         "ms": tur["ms"], "plain_ms": tur["plain_ms"],
         "bound_ms": tur["bound_ms"], "bound_by": tur["bound_by"],
         "library_ms": None, "yardstick_ms": tu["yardstick_ms"],
         "exact_kernel_ms": tur["exact_ms"]},
        sharded["wrap16"], sharded["u16"], carry["wrap16_carry"],
        carry["u16_carry"], carry["wrap16_relaxed_carry"],
        carry["u16_relaxed_carry"]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))     # the one card driven
    return 0


if __name__ == "__main__":
    sys.exit(main())
