"""Run a cell several times, each run a process of its own, and report the
spread of each metric: how the bounds in ``BENCHMARK.json`` are set.

    python3 -m portbench.sets --workload <cell> --seeds 11,12,13 --seconds <s>
        [--sets 2] [--trace 0|1] [--precision relaxed] [--out FILE]

Each set runs every seed once, in order; the sets use the same seeds.  Per
metric and set: the median and the spread, (Q3 - Q1) / median with
``statistics.quantiles(n=4)``; then the wider of the sets' spreads.  Each
run's result line and the lines before it go to ``--out`` (JSON lines).
Not run by the benchmark.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from portbench.stats import quartile_spread


def run_once(args, seed: int) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", args.workload,
           "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
    if args.precision:
        cmd += ["--precision", args.precision]
    t = time.monotonic()
    p = subprocess.run(cmd, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        result = None
    return {"seed": seed, "rc": p.returncode, "wall_s": time.monotonic() - t,
            "result": result, "lines": lines[:-1], "stderr_tail": p.stderr[-2000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--precision")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    values: dict[str, list[list[float]]] = {}
    bad = 0
    for k in range(args.sets):
        for seed in seeds:
            rec = run_once(args, seed)
            rec["set"] = k
            r = rec["result"]
            summary = {"set": k, "seed": seed, "rc": rec["rc"], "wall_s": round(rec["wall_s"], 3)}
            if r is not None:
                summary.update(correct=r["correct"], check=r.get("check"),
                               metrics={m: v["value"] for m, v in r["metrics"].items()})
                for m, v in r["metrics"].items():
                    values.setdefault(m, [[] for _ in range(args.sets)])[k].append(v["value"])
            bad += rec["rc"] != 0 or r is None or not r["correct"]
            print(json.dumps(summary), flush=True)
            if args.out:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                with args.out.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
    for m, sets in values.items():
        rows = [{"median": statistics.median(v), "spread": quartile_spread(v) if len(v) > 1 else None,
                 "n": len(v)} for v in sets if v]
        spreads = [r["spread"] for r in rows if r["spread"] is not None]
        print(json.dumps({"metric": m, "sets": rows,
                          "widest_spread": max(spreads) if spreads else None}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
