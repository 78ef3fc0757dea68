#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

The main path is one YUV420 frame, 3840x2160 -> 1920x1080, Lanczos3, exact:
luma at px_scale 1, U and V as one batch-of-2 call at px_scale 2.  Phases:

1. Device: ``nvidia-smi`` name and power limit, capability, and the build of
   the kernel library from ``libiqo_tpu_torch/csrc`` (nvcc, sm_90a).
2. Kernel vs plain: ``resize_fused`` against ``resize_plain`` on the card at
   the main path's plane shapes, byte for byte, then a seeded fuzz set of
   small Lanczos geometries, each also against the NumPy oracle.
3. Main path through the user's entry points: ``YUV420Resizer`` on
   ``device="cuda"``, ``resize`` on 4 frames and ``resize_batch`` on 4;
   the kernel's launch count over that run must equal its plane calls;
   every plane must equal the plain path; the CLI on a 3-frame file must
   write the API's bytes.
4. Times: CUDA events, minimum over repeats of the mean over back-to-back
   calls on inputs that each differ by one byte, for the kernel and the
   plain version: luma, chroma and the whole frame.

Any failure raises and exits non-zero.  Without a CUDA device it exits 2
and prints no result.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.modules["jax"] = None  # the port must not need JAX; any import fails

ROOT = Path(__file__).resolve().parent
SRC_W, SRC_H, DST_W, DST_H = 3840, 2160, 1920, 1080
SEED = 20261016
FUZZ_CASES = 20
TOLERANCE = 0  # LSB: the contract is byte-exact


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


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    err = int((got.int() - want.int()).abs().max().item()) if got.numel() else 0
    if err > TOLERANCE:
        raise SmokeFailure(f"{name}: max abs err {err} > {TOLERANCE}; "
                           + first_diff(got, want))
    return err


def random_u8(rng, shape) -> np.ndarray:
    return rng.integers(0, 256, shape, dtype=np.uint8)


def fuzz_geometries(rng):
    """Lanczos degree 2-5, px_scale 1 and 2, up and down, odd sizes."""
    for i in range(FUZZ_CASES):
        degree, px = 2 + i % 4, 1 + (i // 4) % 2
        src = rng.integers(9, 400, 2) | (i % 3 == 0)    # every third odd
        if i % 2:
            dst = src * rng.integers(1, 3, 2) + rng.integers(1, 7, 2)
        else:
            dst = np.maximum(1, src // rng.integers(2, 6, 2))
        yield (degree, px, *map(int, src), *map(int, dst))


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
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return smi, name


def phase_kernel_vs_plain(cr, api, build_plan, rng):
    max_err = 0
    planes = [("luma", build_plan("lanczos", SRC_W, SRC_H, DST_W, DST_H,
                                  degree=3), 1),
              ("chroma", build_plan("lanczos", SRC_W // 2, SRC_H // 2,
                                    DST_W // 2, DST_H // 2, degree=3,
                                    px_scale=2), 2)]
    for name, plan, batch in planes:
        check(cr.supports_plan(plan), f"{name}: kernel refuses the plan")
        ops = cr.pack_operands(plan, "cuda")
        src = torch.from_numpy(random_u8(rng, (batch, plan.y.n_src,
                                               plan.x.n_src))).cuda()
        got = cr.resize_fused(ops, src)
        want = cr.resize_plain(ops, src)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(f"{name} {tuple(src.shape)}", got, want))
        print(f"kernel == plain: {name} {tuple(src.shape)} -> "
              f"{tuple(got.shape)}, max abs err 0")
    for degree, px, sw, sh, dw, dh in fuzz_geometries(rng):
        plan = build_plan("lanczos", sw, sh, dw, dh, degree=degree,
                          px_scale=px)
        tag = f"fuzz lanczos{degree} px{px} {sw}x{sh}->{dw}x{dh}"
        check(cr.supports_plan(plan), f"{tag}: kernel refuses the plan")
        ops = cr.pack_operands(plan, "cuda")
        host = random_u8(rng, (2, sh, sw))
        src = torch.from_numpy(host).cuda()
        got = cr.resize_fused(ops, src)
        max_err = max(max_err, compare(tag, got, cr.resize_plain(ops, src)))
        oracle = torch.from_numpy(
            api.Resizer.from_plan(plan, backend="numpy").resize(host))
        max_err = max(max_err, compare(f"{tag} vs numpy_ref", got.cpu(), oracle))
    print(f"kernel == plain == numpy_ref on {FUZZ_CASES} fuzz geometries")
    return max_err


def phase_main_path(cr, yuv, build_plan, rng, tmp: Path):
    r = yuv.YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H,
                          device="cuda")
    check(r.resolved_backend() == "cuda",
          f"main path resolved to {r.resolved_backend()!r}, not 'cuda'")
    frames = [yuv.YUV420Frame(random_u8(rng, (SRC_H, SRC_W)),
                              random_u8(rng, (SRC_H // 2, SRC_W // 2)),
                              random_u8(rng, (SRC_H // 2, SRC_W // 2)))
              for _ in range(4)]
    batch = [random_u8(rng, (4, SRC_H, SRC_W)),
             random_u8(rng, (4, SRC_H // 2, SRC_W // 2)),
             random_u8(rng, (4, SRC_H // 2, SRC_W // 2))]

    cr.LAUNCHES = 0
    outs = [r.resize(f) for f in frames]
    bout = r.resize_batch(*batch)
    torch.cuda.synchronize()
    launches = cr.LAUNCHES
    expected = 2 * len(frames) + 2
    check(launches == expected, f"kernel launched {launches} times on the "
          f"main path, expected {expected} (2 per resize, 2 per batch)")
    print(f"main path: {len(frames)} x resize + 1 x resize_batch(4) -> "
          f"{launches} kernel launches (expected {expected})")

    luma = cr.pack_operands(build_plan("lanczos", SRC_W, SRC_H, DST_W, DST_H,
                                       degree=3), "cuda")
    chroma = cr.pack_operands(build_plan(
        "lanczos", SRC_W // 2, SRC_H // 2, DST_W // 2, DST_H // 2, degree=3,
        px_scale=2), "cuda")

    def plain(ops, planes):
        return cr.resize_plain(ops, torch.from_numpy(planes).cuda()).cpu()

    max_err = 0
    for i, (f, o) in enumerate(zip(frames, outs)):
        check(o.y.shape == (DST_H, DST_W) and o.u.shape == (DST_H // 2, DST_W // 2),
              f"frame {i}: output shapes {o.y.shape} {o.u.shape}")
        uv = plain(chroma, np.stack([f.u, f.v]))
        for name, got, want in (("y", o.y, plain(luma, f.y[None])[0]),
                                ("u", o.u, uv[0]), ("v", o.v, uv[1])):
            max_err = max(max_err, compare(f"frame {i} {name}",
                                           torch.from_numpy(got), want))
    buv = plain(chroma, np.concatenate(batch[1:]))
    for name, got, want in (("y", bout[0], plain(luma, batch[0])),
                            ("u", bout[1], buv[:4]), ("v", bout[2], buv[4:])):
        max_err = max(max_err, compare(f"batch {name}", torch.from_numpy(got),
                                       want))
    print("main path == plain path on every plane of every frame")

    src_file, dst_file = tmp / "in.yuv", tmp / "out.yuv"
    yuv.write_yuv420(src_file, frames[:3])
    proc = subprocess.run(
        [sys.executable, "-m", "libiqo_tpu_torch.cli.resize_yuv420p",
         "-m", "lanczos3", "-i", str(src_file), "-iw", str(SRC_W),
         "-ih", str(SRC_H), "-o", str(dst_file), "-ow", str(DST_W),
         "-oh", str(DST_H)],
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
    print("CLI output == API output on 3 frames")
    return launches, max_err


def time_ms(fn, inputs, repeats: int = 5) -> float:
    """Min over repeats of the mean time of back-to-back calls, by CUDA
    events; every call has its own input."""
    fn(inputs[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(repeats):
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


def phase_times(cr, yuv, build_plan, rng, card: str):
    n = 8   # 8 luma inputs (66 MB) exceed the 50 MB L2
    rows = {}
    for name, plan, batch in (
            ("luma", build_plan("lanczos", SRC_W, SRC_H, DST_W, DST_H,
                                degree=3), 1),
            ("chroma", build_plan("lanczos", SRC_W // 2, SRC_H // 2,
                                  DST_W // 2, DST_H // 2, degree=3,
                                  px_scale=2), 2)):
        ops = cr.pack_operands(plan, "cuda")
        xs = perturbed(torch.from_numpy(random_u8(
            rng, (batch, plan.y.n_src, plan.x.n_src))).cuda(), n)
        rows[name] = (time_ms(lambda x: cr.resize_fused(ops, x), xs),
                      time_ms(lambda x: cr.resize_plain(ops, x), xs))

    def frames():
        planes = [perturbed(torch.from_numpy(random_u8(rng, s)).cuda(), n)
                  for s in ((SRC_H, SRC_W), (SRC_H // 2, SRC_W // 2),
                            (SRC_H // 2, SRC_W // 2))]
        return [yuv.YUV420Frame(*p) for p in zip(*planes)]

    fs = frames()
    kernel = yuv.YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H,
                               backend="cuda", device="cuda")
    plain = yuv.YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H,
                              backend="torch", device="cuda")
    rows["frame"] = (time_ms(kernel.resize, fs), time_ms(plain.resize, fs))
    for name, (k, p) in rows.items():
        print(f"time {name}: kernel {k!r} ms/frame, plain {p!r} ms/frame, "
              f"plain/kernel {p / k!r} ({card})")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from libiqo_tpu_torch import api, build_plan, yuv
    from libiqo_tpu_torch.ops import _build, cuda_resize
    from libiqo_tpu_torch.utils import device

    rng = np.random.default_rng(SEED)
    smi, name = phase_device(_build, device)
    err = phase_kernel_vs_plain(cuda_resize, api, build_plan, rng)
    with tempfile.TemporaryDirectory() as tmp:
        launches, err2 = phase_main_path(cuda_resize, yuv, build_plan, rng,
                                         Path(tmp))
    rows = phase_times(cuda_resize, yuv, build_plan, rng, smi)
    kernel_ms = rows["luma"][0] + rows["chroma"][0]
    plain_ms = rows["luma"][1] + rows["chroma"][1]
    print(json.dumps({"kernels": [{
        "name": "resize_fused", "route": "cuda",
        "source": "libiqo_tpu_torch/csrc/resize_fused.cu",
        "replaces": "libiqo_tpu/ops/pallas_resize.py:1687",
        "launches": launches, "max_abs_err": max(err, err2),
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
