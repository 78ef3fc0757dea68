"""The device's side of a traced run, from ``torch.profiler``.

A traced run measures its window untraced, then runs the traffic again for
as long under the profiler: the traced window.  The profiler records the
card's kernels, copies and sets alone (no host-side operators), with its
own clock.  Two anchors, a spin kernel launched on the idle card just
before the traced window and another just after it, each beside the
host-clock reading at which its launch returned, give the line that
carries every device interval onto the host's ``perf_counter_ns``, where
the harness's spans are.  Where the trace lacks an anchor, the profiler's
own clock, which counts Unix time, is carried over by the offset between
``time.time_ns`` and ``perf_counter_ns`` read at each mark; the trace says
which line it took.  Intervals are clipped to the traced window.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .harness import Spans, Window, clock
from .stats import gaps, merge, overlap, union_length

COPY_PREFIXES = ("Memcpy", "Memset")
ANCHOR = "spin_kernel"          # the kernel of torch.cuda._sleep
ANCHOR_CYCLES = 20_000          # about 10 us at the card's clock


@dataclasses.dataclass
class Trace:
    t0: float                  # the traced window, host ns
    t1: float
    frames: int                # frames whose calls completed in it
    spans: Spans               # its host spans
    kernels: np.ndarray        # (n, 2) host ns
    kernel_names: list
    copies: np.ndarray         # (m, 2) host ns
    copy_names: list
    placed_by: str = ""        # how device times were carried onto the host clock

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self) -> np.ndarray:
        return merge(np.concatenate([self.kernels, self.copies]))

    @property
    def busy_s(self) -> float:
        return union_length(self.busy()) / 1e9

    @property
    def kernel_s(self) -> float:
        return union_length(self.kernels) / 1e9

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        total: dict[str, float] = {}
        for iv, names in ((self.kernels, self.kernel_names), (self.copies, self.copy_names)):
            for (a, b), name in zip(iv, names):
                total[name] = total.get(name, 0.0) + (b - a) / 1e9
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """[label, seconds] of the device's idle time by the host span it
        fell in (``none``: in no span), longest first, then the longest
        single gap as ``longest:<label>``."""
        idle = gaps(self.busy(), self.t0, self.t1)
        if not len(idle):
            return []
        rows, spans = [], self.spans
        for label in spans.by_label:
            s = overlap(idle, spans.array(label))
            if s > 0:
                rows.append([label, s / 1e9])
        rows.append(["none", max(0.0, union_length(idle) / 1e9 - sum(r[1] for r in rows))])
        rows.sort(key=lambda r: -r[1])
        rows = rows[:top - 1]
        longest = idle[np.argmax(idle[:, 1] - idle[:, 0])]
        rows.append([f"longest:{label_at(spans, (longest[0] + longest[1]) / 2)}",
                     (longest[1] - longest[0]) / 1e9])
        return rows


def unix_offset_ns() -> float:
    """``time.time_ns()`` less ``perf_counter_ns()``, from the closest of a
    few paired readings."""
    best = None
    for _ in range(5):
        a, u, b = clock(), time.time_ns(), clock()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) / 2)
    return best[1]


def label_at(spans: Spans, t: float) -> str:
    for label in spans.by_label:
        a = spans.array(label)
        i = np.searchsorted(a[:, 0], t, side="right") - 1
        if i >= 0 and a[i, 1] >= t:
            return label
    return "none"


class Tracer:
    """``torch.profiler`` over the window, the card's activity alone, with
    the two anchors.  Off the card it records nothing: the trace it reads
    holds no device time."""

    def __init__(self, on_card: bool):
        self._prof = None
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._marks: list[float] = []
        self._offsets: list[float] = []     # unix_offset_ns() at each mark

    def __enter__(self):
        if self._prof is not None:
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            return self._prof.__exit__(*exc)
        return None

    def mark(self) -> None:
        """One anchor: a spin kernel on the idle card, whose start is placed
        at the host's time when its launch returned (a few microseconds of
        launch latency apart, the same at both anchors)."""
        self._offsets.append(unix_offset_ns())
        if self._prof is None:
            self._marks.append(clock())
            return
        import torch
        torch.cuda.synchronize()
        torch.cuda._sleep(ANCHOR_CYCLES)
        self._marks.append(clock())
        torch.cuda.synchronize()

    def _events(self):
        """(name, start ns, end ns) of every device event, in the profiler's
        clock, from its raw results (no per-event objects of Python built)."""
        from torch.autograd import DeviceType
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                yield e.name(), e.start_ns(), e.start_ns() + e.duration_ns()

    def read(self, window: Window, spans: Spans) -> Trace:
        """The trace of ``window``, whose host spans are ``spans``."""
        t0, t1 = window.t0_ns, window.t1_ns
        if self._prof is None:
            empty = np.empty((0, 2))
            return Trace(t0, t1, window.frames, spans, empty, [], empty, [])
        anchors, names, starts, ends = [], [], [], []
        for name, start, end in self._events():
            if ANCHOR in name:
                anchors.append(start)
            else:
                names.append(name)
                starts.append(start)
                ends.append(end)
        offset = float(np.mean(self._offsets))
        if len(anchors) == 2:
            (ua, ub), (ha, hb) = sorted(anchors), self._marks
            scale = (hb - ha) / (ub - ua)
            placed_by = (f"2 anchors; the profiler's clock places them "
                         f"{(ua - offset - ha) / 1e3:.1f} and {(ub - offset - hb) / 1e3:.1f} us "
                         f"from their marks")
        else:
            ua, ha, scale = offset, 0.0, 1.0
            placed_by = (f"{len(anchors)} of the 2 anchors among {len(names)} device events; "
                         f"the profiler's Unix clock, offsets {np.ptp(self._offsets) / 1e3:.1f} us "
                         f"apart")
        a = np.maximum(ha + (np.asarray(starts, np.float64) - ua) * scale, t0)
        b = np.minimum(ha + (np.asarray(ends, np.float64) - ua) * scale, t1)
        keep = b > a
        copy = np.array([n.startswith(COPY_PREFIXES) for n in names], bool)
        iv = np.stack([a, b], axis=1).reshape(-1, 2)
        kern, cop = keep & ~copy, keep & copy
        return Trace(t0, t1, window.frames, spans, iv[kern],
                     [n for n, k in zip(names, kern) if k],
                     iv[cop], [n for n, c in zip(names, cop) if c], placed_by)
