"""What a loop is given and what it gives back.

A loop (``loops/<name>.py``) gets a :class:`Context`: the resizer, the pool
of frames, its traffic's parameters, the seed, the window's length, the
host spans it records, the sampler of outputs for the check, and the
device's events and synchronize (a stand-in on the CPU in the tests).  It
warms up in ``prepare`` and measures in ``run``, which returns a
:class:`Window`.
"""

from __future__ import annotations

import array
import dataclasses
import gc
import random
import time
from typing import Any, Callable

import numpy as np

clock = time.perf_counter_ns


class Spans:
    """Host spans by label, (start, end) in ``perf_counter_ns``, kept while
    the window runs in flat int64 arrays: no object a span, so that the
    record leaves the cycle collector nothing to walk.  A tuple a span
    would set off a full collection of the process, 67-130 ms inside a
    call, about once in a 10 s window."""

    def __init__(self):
        self.by_label: dict[str, array.array] = {}

    def recorder(self, label: str) -> Callable[[tuple[int, int]], None]:
        """What records a span of ``label``: call it with (start, end)."""
        return self.by_label.setdefault(label, array.array("q")).extend

    def add(self, label: str, start: int, end: int) -> None:
        self.recorder(label)((start, end))

    def array(self, label: str) -> np.ndarray:
        flat = self.by_label.get(label, array.array("q"))
        return np.frombuffer(flat, dtype=np.int64).astype(np.float64).reshape(-1, 2)

    def total_ns(self, label: str) -> float:
        a = self.array(label)
        return float((a[:, 1] - a[:, 0]).sum())

    def count(self, label: str) -> int:
        return len(self.by_label.get(label, ())) // 2


class GcPauses:
    """The interpreter's cycle collections while entered, by generation:
    ``pauses[g]`` = [count, total ns, longest ns]."""

    def __enter__(self):
        self.pauses = [[0, 0, 0] for _ in range(3)]
        self._start = 0
        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)

    def _note(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = clock()
            return
        d = clock() - self._start
        p = self.pauses[info["generation"]]
        p[0], p[1], p[2] = p[0] + 1, p[1] + d, max(p[2], d)

    def line(self) -> str:
        return "; ".join(f"generation {g}: {n} pauses, {t / 1e6:.3f} ms, longest {m / 1e6:.3f}"
                         for g, (n, t, m) in enumerate(self.pauses))


class Sampler:
    """A uniform sample of the calls of each stratum (reservoir sampling),
    ``per_stratum`` calls each, drawn from the seed: which calls it keeps
    depends on the seed and the number of calls alone.  ``slot(stratum)``
    is asked once a call, and the call's outputs are kept with ``put`` only
    where it gives a slot."""

    def __init__(self, strata: int, per_stratum: int, seed: int):
        self.per_stratum = per_stratum
        self.kept: list[list] = [[] for _ in range(strata)]
        self._seen = [0] * strata
        self._rng = random.Random(seed)

    def slot(self, stratum: int = 0) -> int:
        """The slot of ``stratum`` the next call's outputs go to, or -1."""
        n = self._seen[stratum]
        self._seen[stratum] = n + 1
        if n < self.per_stratum:
            self.kept[stratum].append(None)
            return n
        j = self._rng.randrange(n + 1)
        return j if j < self.per_stratum else -1

    def put(self, stratum: int, slot: int, payload) -> None:
        self.kept[stratum][slot] = payload

    def payloads(self) -> list:
        return [p for stratum in self.kept for p in stratum if p is not None]


@dataclasses.dataclass
class Output:
    """One call's outputs: frames ``first .. first + count - 1`` of the
    pool."""
    first: int
    count: int
    planes: tuple


@dataclasses.dataclass
class Context:
    resizer: Any
    pool: Any
    traffic: dict
    seed: int
    seconds: float
    spans: Spans
    sampler: Sampler
    event: Callable[..., Any]          # torch.cuda.Event or a stand-in
    synchronize: Callable[[], None]
    stream: Any = None                 # the stream events are recorded on


@dataclasses.dataclass
class Window:
    t0_ns: int                  # the window's start, perf_counter_ns
    t1_ns: int                  # its end: the synchronize after the last call
    calls: int
    frames: int                 # frames whose calls completed in the window
    attempted: int              # frames the traffic sent
    failed: int                 # frames whose call raised or never completed

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


@dataclasses.dataclass
class Run:
    """What a metric's reader reads: the cell's configuration, the card's
    name, the set-up time, the window, the host spans and, in a traced run,
    the device trace (:class:`portbench.trace.Trace`)."""
    cfg: dict
    kind: str
    setup_s: float
    window: Window
    spans: Spans
    trace: Any = None
