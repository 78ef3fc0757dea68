"""Whether the timed path's outputs are right: the sampled calls' frames,
whole (every plane, border rows and columns included), against the plain
reference computed from the same inputs.

The number compared is ``max_lsb``, the largest difference of an output
byte from the reference's, with the limit 0: the configuration states
byte-exact output.  A sampled frame for which the call gave no output, or
a plane of the wrong shape, reads 256, past any byte's difference.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LIMITS = {"max_lsb": 0}
MISSING = 256


def picks(count: int, n: int, rng) -> list[int]:
    """n of a call's ``count`` frames, one drawn from each of n equal runs
    (so both halves of a batch are seen)."""
    edges = np.linspace(0, count, n + 1).astype(int)
    return [int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def gather(sampler, pool, per_call: int, seed: int) -> list:
    """(inputs, outputs) as NumPy planes for each frame compared; outputs
    None where the call gave none for that frame."""
    rng = np.random.default_rng(seed % 2**63)
    jobs = []
    for out in sampler.payloads():
        for k in picks(out.count, per_call, rng):
            try:
                got = tuple(p[k].cpu().numpy() for p in out.planes)
            except IndexError:
                got = None
            jobs.append((pool.host(out.first + k), got))
    return jobs


def _diff(reference, job) -> int:
    inputs, outputs = job
    if outputs is None:
        return MISSING
    worst = 0
    for want, got in zip(reference(*inputs), outputs):
        if want.shape != got.shape:
            return MISSING
        worst = max(worst, int(np.abs(want.astype(np.int16) - got.astype(np.int16)).max()))
    return worst


def compare(reference, jobs: list) -> dict:
    """{"max_lsb", "frames"}: the reference over every job, on a few
    threads (NumPy releases the interpreter's lock)."""
    with ThreadPoolExecutor(min(4, os.cpu_count() or 1)) as ex:
        worst = max(ex.map(lambda j: _diff(reference, j), jobs), default=0)
    return {"max_lsb": worst, "frames": len(jobs)}


def verdict(numbers: dict) -> bool:
    return numbers["frames"] > 0 and all(numbers[k] <= lim for k, lim in LIMITS.items())
