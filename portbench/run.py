"""Run one cell of ``BENCHMARK.json`` on one card and print its result.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1> [--precision exact|relaxed]

Set-up (timed from the process's start): the port's ``YUV420Resizer`` for
the configuration, its kernels loaded (built by nvcc into the checkout's
``build/`` on a checkout's first run), the frames made on the card from the
seed, and one call of the cell's shape.  Then the traffic's loop
(``loops/<loop>.py``) measures for ``--seconds``.  With ``--trace 0`` the
cell's end-to-end metrics are reported; with ``--trace 1`` its per-layer
metrics, the host's from the same untraced window and the device's from
a second window of the same load, under the profiler (``trace.py``).  Afterwards a sample of the
window's outputs, drawn from the seed, is compared with the plain reference
(``check.py``).  ``--precision relaxed`` runs the port's relaxed path in
place of the configuration's: the control, which has to come out not
correct.

Earlier lines give the route, the card (name, power limit, SM clock) and
the window's counts; the last line of standard output is the result, one
JSON object, and the last lines of standard error the numbers compared
beside their limits.  Exits 2 without a card, 3 if the port cannot be
imported, 4 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import time


def process_age_s() -> float:
    """Seconds since this process started, from its start time in /proc
    (10 ms steps)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start / os.sysconf("SC_CLK_TCK")


_STARTED = process_age_s()


def keep_bytecode() -> None:
    """Keep the compiled bytecode of every module this process imports
    (PyTorch's, NumPy's, the port's) under the checkout's ``build/pycache``,
    even where the environment says not to write it, so that each run
    after a checkout's first loads it instead of compiling some 2,000
    modules anew: seconds of host work that spread with the host's load."""
    import sys
    from pathlib import Path
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(Path(__file__).resolve().parent.parent / "build" / "pycache")


if __name__ == "__main__":
    keep_bytecode()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import check, frames, spec  # noqa: E402
from portbench.harness import Context, GcPauses, Run, Sampler, Spans  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "libiqo_tpu")
PREROLL_S = 0.5


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``libiqo_tpu_torch`` is not ``libiqo_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"


def traced_window(loop, ctx, state, on_card: bool, strata: int):
    """The traffic again, as long as the window, under the profiler: the
    device's side of a traced run, and the traced window's own counts.  The
    window itself runs untraced, so that its host spans hold the program's
    time and not the tracer's."""
    from portbench.trace import Tracer

    spans = Spans()
    quiet = dataclasses.replace(ctx, spans=spans, sampler=Sampler(strata, 0, ctx.seed))
    with Tracer(on_card) as tracer:
        ctx.synchronize()
        loop.run(dataclasses.replace(quiet, seconds=PREROLL_S, spans=Spans()), state)
        tracer.mark()
        window = loop.run(quiet, state)
        tracer.mark()
    return tracer.read(window, spans), window


def run_cell(bench: dict, cell: dict, *, seed: int, seconds: float, trace: bool,
             precision: str | None, device, backend: str, event, synchronize,
             kind: str, age=process_age_s, log=print, marks=()) -> dict:
    """Set up, measure and check one cell on ``device``; the result object.
    ``event`` and ``synchronize`` are the device's (stand-ins on the CPU)."""
    import torch
    from libiqo_tpu_torch.yuv import YUV420Resizer

    marks = list(marks)
    on_card = torch.device(device).type == "cuda"
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    loop = spec.loop(traffic["loop"])
    resizer = YUV420Resizer(cfg["method"], cfg["src_w"], cfg["src_h"], cfg["dst_w"],
                            cfg["dst_h"], backend=backend,
                            precision=precision or cfg["precision"], device=device)
    marks.append(("resizer", age()))
    pool = frames.make(loop.pool_frames(traffic), cfg["src_w"], cfg["src_h"], seed, device)
    synchronize()
    marks.append(("frames", age()))
    strata, per_stratum, per_call = loop.sampling(traffic)
    spans, sampler = Spans(), Sampler(strata, per_stratum, seed)
    ctx = Context(resizer, pool, traffic, seed, seconds, spans, sampler, event, synchronize,
                  torch.cuda.current_stream(device) if on_card else None)
    state = loop.prepare(ctx)
    synchronize()
    marks.append(("first call", age()))
    # the cell's load for a moment, unmeasured, so that the window opens on
    # a card already at its working clocks
    loop.run(dataclasses.replace(ctx, seconds=PREROLL_S, spans=Spans(),
                                 sampler=Sampler(strata, 0, seed)), state)
    marks.append(("pre-roll", age()))
    setup_s = age()
    with GcPauses() as collections:
        window = loop.run(ctx, state)
    windows, traced = [window], None
    if trace:
        traced, again = traced_window(loop, ctx, state, on_card, strata)
        windows.append(again)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    log("setup s: " + ", ".join(f"{k} {b - a:.3f}" for (_, a), (k, b)
                                 in zip([("start", 0.0)] + marks, marks)))
    log(f"route {resizer.resolved_backend()}, precision {precision or cfg['precision']}, "
        f"pool {len(pool)} frames {pool.nbytes} B")
    issue = spans.array("issue")
    log(f"window {window.seconds:.6f} s, {window.calls} calls, {window.frames} frames, "
        f"{window.failed} failed, issue {spans.total_ns('issue') / 1e9:.6f} s, longest "
        f"{(issue[:, 1] - issue[:, 0]).max(initial=0) / 1e6:.3f} ms")
    log(f"cycle collections in the window: {collections.line()}")
    if traced is not None:
        log(f"traced window {traced.window_s:.6f} s, {traced.spans.count('issue')} calls, "
            f"{traced.frames} frames, {windows[-1].failed} failed, "
            f"issue {traced.spans.total_ns('issue') / 1e9:.6f} s; "
            f"{len(traced.kernels)} kernels, {len(traced.copies)} copies; "
            f"placed by {traced.placed_by}")
    run = Run(cfg, kind, setup_s, window, spans, traced)
    del state, ctx
    jobs = check.gather(sampler, pool, per_call, seed)
    del sampler, pool, resizer
    numbers = check.compare(spec.reference(cfg["reference"]).Frame(
        cfg["method"], cfg["src_w"], cfg["src_h"], cfg["dst_w"], cfg["dst_h"]), jobs)
    wanted = spec.per_layer(bench, cell["name"]) if trace else spec.end_to_end(bench, cell["name"])
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": memory_peak}
    failed = sum(w.failed for w in windows)
    result = {"correct": check.verdict(numbers) and failed == 0,
              "attempted": sum(w.attempted for w in windows), "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    log(f"checked {numbers['frames']} frames")
    result["check"] = {k: {"value": numbers[k], "limit": lim}
                       for k, lim in check.LIMITS.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", choices=("exact", "relaxed"),
                    help="the control: the port's relaxed path (default: the configuration's)")
    args = ap.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    marks = [("interpreter", _STARTED)]
    try:
        import torch
        marks.append(("torch", process_age_s()))
        import libiqo_tpu_torch.yuv  # noqa: F401
        marks.append(("port", process_age_s()))
    except ImportError as e:
        print(f"portbench: cannot import the port: {e}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    torch.zeros(1, device="cuda")
    marks.append(("cuda init", process_age_s()))
    result = run_cell(bench, cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), precision=args.precision,
                      device=torch.device("cuda", 0), backend="auto",
                      event=torch.cuda.Event, synchronize=torch.cuda.synchronize, kind=kind,
                      log=lambda s: print(s, flush=True), marks=marks)
    card = card_line()
    print(f"card {card}", flush=True)
    for name, m in result["metrics"].items():
        if "roofline" in name:
            print(f"{name} {m['value']} % of the data sheet's peaks, on {card}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
