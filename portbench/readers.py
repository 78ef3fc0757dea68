"""The arithmetic of the metrics' readers (``metrics/<name>.py``), over a
:class:`portbench.harness.Run`.  Each returns None where the run holds
nothing to read: no trace, no device time, no peaks for the card."""

from __future__ import annotations

from . import work


def setup_s(run) -> float:
    return run.setup_s


def frames_per_s(run) -> float | None:
    w = run.window
    return w.frames / w.seconds if w.frames else None


def issue_ms(run) -> float | None:
    """Host time of the window's calls (the ``issue`` spans), per call: the
    untraced window's, so that the tracer's own cost is not in it."""
    n = run.spans.count("issue")
    return run.spans.total_ns("issue") / n / 1e6 if n else None


def kernel_roofline_pct(run) -> float | None:
    """The traced window's frames' least time on this card over the union of
    all kernels' device intervals in that window, whatever their names."""
    if run.trace is None or run.trace.kernel_s <= 0 or not run.trace.frames:
        return None
    bound = work.frame_bound_s(run.cfg, run.kind)
    if bound is None:
        return None
    return 100.0 * run.trace.frames * bound[0] / run.trace.kernel_s


def device_idle_pct(run) -> float | None:
    """Share of the traced window with no kernel, copy or set on the card."""
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
