"""One cell with the port's own spans recorded: the six numbers of
``port_trace.py``, the idle split and the port's counters.

    python3 -m portbench.port_run --workload <config>.<traffic> --seed <n>
        --seconds <s>

The cell's set-up as ``run.py`` makes it (resizer, frames, one call), under
a recording; the pre-roll; then ``run.traced_window`` for ``--seconds``
under a second recording, which the six numbers read beside the device
trace.  The existing per-layer numbers are read from that traced window
too, so its ``issue_ms.batch`` is the host's time a call with the port
recording (``run.py --trace 1`` logs the same window's without it).
Outputs are not checked (``run.py`` does that).  Earlier lines give the
counts; the last line of standard output is one JSON object.  Against a
port with no ``tracing`` module nothing is recorded: the new numbers are
absent and the rest is as it would be.  Exits 2 without a card.  Not run
by the benchmark: it stands in for the edits to ``run.py`` that would
record inside a traced run, and goes when they are made.
"""

from __future__ import annotations

if __name__ == "__main__":
    from portbench.run import keep_bytecode
    keep_bytecode()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from portbench import frames, port_trace, readers, run, spec  # noqa: E402
from portbench.harness import Context, Run, Sampler, Spans  # noqa: E402

STALL_EDGES_S = (1e-5, 1e-4, 1e-3)     # starved pieces by length: <10 us, <100 us, <1 ms, more


def _recording(tracing):
    return tracing.record() if tracing is not None else contextlib.nullcontext()


def measure(bench: dict, cell: dict, *, seed: int, seconds: float, device, backend: str,
            event, synchronize, kind: str, log=print) -> dict:
    """Set up and read one traced window of one cell on ``device``
    (stand-ins for the card's events off it)."""
    import torch
    from libiqo_tpu_torch.yuv import YUV420Resizer

    tracing = port_trace.port_tracing()
    on_card = torch.device(device).type == "cuda"
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    loop = spec.loop(traffic["loop"])
    strata, _, _ = loop.sampling(traffic)
    with _recording(tracing) as setup_rec:
        resizer = YUV420Resizer(cfg["method"], cfg["src_w"], cfg["src_h"], cfg["dst_w"],
                                cfg["dst_h"], backend=backend, precision=cfg["precision"],
                                device=device)
        pool = frames.make(loop.pool_frames(traffic), cfg["src_w"], cfg["src_h"], seed, device)
        ctx = Context(resizer, pool, traffic, seed, seconds, Spans(), Sampler(strata, 0, seed),
                      event, synchronize,
                      torch.cuda.current_stream(device) if on_card else None)
        state = loop.prepare(ctx)
        synchronize()
    loop.run(dataclasses.replace(ctx, seconds=run.PREROLL_S, spans=Spans()), state)
    with _recording(tracing) as rec:
        traced, window = run.traced_window(loop, ctx, state, on_card, strata)
    pt = port_trace.PortTrace.of(traced, rec) if rec is not None else None
    record = Run(cfg, kind, 0.0, window, traced.spans, traced)
    old = {"issue_ms.batch": readers.issue_ms(record),
           "kernel_roofline.batch": readers.kernel_roofline_pct(record),
           "device_idle_pct.batch": readers.device_idle_pct(record)}
    result = {"cell": cell["name"], "metrics": port_trace.metrics(pt, setup_rec, cfg, kind),
              "existing": {k: v for k, v in old.items() if v is not None},
              "idle_gaps": traced.idle_gaps()}
    for name, r in (("setup", setup_rec), ("traced", rec)):
        if r is not None:
            result[f"counters_{name}"] = dict(r.counters)
            log(f"port counters, {name}: " + (", ".join(
                f"{k} {v}" for k, v in sorted(r.counters.items())) or "none"))
    if pt is not None:
        result["idle_split"] = pt.idle_gaps()
        result["checks"] = checks(pt, result["metrics"], old, cfg, kind)
    log(f"traced window {traced.window_s:.6f} s, {traced.spans.count('issue')} calls, "
        f"{traced.frames} frames, {len(traced.kernels)} kernels; placed by {traced.placed_by}")
    return result


def checks(pt: port_trace.PortTrace, new: dict, old: dict, cfg: dict, kind: str) -> dict:
    """What the six numbers must agree with: kernels a frame call; luma's
    and chroma's kernel time against the union of all kernels; the two
    rooflines combined, by their least times, against the whole frame's;
    the idle rows against the idle time.  Also the starved time by the
    length of its pieces (``STALL_EDGES_S``) and its longest piece."""
    t = pt.trace
    out = {"frame_calls": len(pt.calls), "kernels": len(t.kernels),
           "kernels_a_call": len(t.kernels) / len(pt.calls) if len(pt.calls) else None}
    luma, chroma = pt.plane_s(port_trace.LUMA), pt.plane_s(port_trace.CHROMA)
    if luma is not None and t.kernel_s > 0:
        out["planes_over_union"] = (luma + chroma) / t.kernel_s
    bounds = [port_trace.plane_bound_s(cfg, kind, p) for p in (port_trace.LUMA, port_trace.CHROMA)]
    rl, rc = new.get("luma_roofline.batch"), new.get("chroma_roofline.batch")
    if rl and rc and None not in bounds and old.get("kernel_roofline.batch") is not None:
        combined = sum(bounds) / (bounds[0] / rl + bounds[1] / rc)
        out["rooflines_combined"] = combined
        out["rooflines_combined_less_whole"] = combined - old["kernel_roofline.batch"]
    rows = pt.idle_gaps()
    idle = t.window_s - t.busy_s
    if rows is not None and idle > 0:
        out["idle_rows_over_idle"] = sum(v for k, v in rows if not k.startswith("longest:")) / idle
    split = pt.idle_split()
    if split is not None:
        # how much of the starved time lies in long host stalls
        length = split[1][:, 1] - split[1][:, 0]
        bins = np.digitize(length / 1e9, STALL_EDGES_S)
        out["starved_s_by_length"] = [float(length[bins == i].sum() / 1e9)
                                      for i in range(len(STALL_EDGES_S) + 1)]
        out["starved_longest_s"] = float(length.max(initial=0) / 1e9)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print(f"portbench: {cell['name']} needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = measure(bench, cell, seed=args.seed, seconds=args.seconds,
                     device=torch.device("cuda", 0),
                     backend="auto", event=torch.cuda.Event,
                     synchronize=torch.cuda.synchronize, kind=torch.cuda.get_device_name(0),
                     log=lambda s: print(s, flush=True))
    result["card"] = run.card_line()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
