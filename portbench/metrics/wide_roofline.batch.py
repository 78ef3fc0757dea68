"""``wide_roofline.batch``: the frames of the traced window's recorded
wide-kernel launches x luma's least time on the card, over the union of
the intervals of the kernels whose name holds ``resize_wide_kernel``.

Luma's least time is ``port_trace.plane_bound_s``: its bytes (the source
plane read once, the evened output written once) at the card's HBM rate,
or its operations (a multiply and an add for each tap the reference's two
passes apply to luma) at its int8 rate, whichever is longer.  That is the
data sheet's yardstick of ``work.py``, which reads the same work whatever
kernel does the luma, so that no faster implementation can read above
100 %.  Each call (an ``issue`` span) launches the luma of its frames
once, so a launch stands for the window's frames over its calls: a launch
whose events the profiler lost leaves both the frames and the time it
would bring.  None without a trace or peaks for the card, where no wide
kernel ran, and where the window holds more wide-kernel intervals than
calls.
"""

from portbench import port_trace
from portbench.stats import union_length

KERNEL = "resize_wide_kernel"


def read(run) -> float | None:
    t = run.trace
    calls = t.spans.count("issue") if t is not None else 0
    if not calls or not t.frames:
        return None
    bound = port_trace.plane_bound_s(run.cfg, run.kind, port_trace.LUMA)
    wide = t.kernels[[KERNEL in name for name in t.kernel_names]]
    if bound is None or not len(wide) or len(wide) > calls:
        return None
    frames = len(wide) * t.frames / calls
    return 100.0 * frames * bound / (union_length(wide) / 1e9)
