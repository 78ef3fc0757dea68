"""Closed loop, one client, dispatched ahead: a transcoding or preview
worker whose decoder leaves frames on the card.

It hands ``batch`` frames a call to ``YUV420Resizer.resize_batch`` and keeps
at most ``in_flight`` calls in flight: before issuing call k it waits on the
event recorded after call k - ``in_flight``.  The calls cycle through
``batches`` distinct batches of the pool.  The window ends at a synchronize
after the last call issued before ``seconds`` had passed.

Traffic keys: ``batch``, ``in_flight``, ``batches``, ``check_frames``.
"""

from __future__ import annotations

import math

from portbench.harness import Context, Output, Window, clock


def pool_frames(traffic: dict) -> int:
    return traffic["batch"] * traffic["batches"]


def sampling(traffic: dict) -> tuple[int, int, int]:
    """(strata, calls kept a stratum, frames compared a call): one call of
    each distinct batch, so that a stale output shows, and ``check_frames``
    frames in all, spread over each batch."""
    nb = traffic["batches"]
    return nb, 1, min(traffic["batch"], math.ceil(traffic["check_frames"] / nb))


def prepare(ctx: Context):
    """One call of the cell's shape, then the loop's events."""
    ctx.resizer.resize_batch(*ctx.pool.batch(0, ctx.traffic["batch"]))
    ctx.synchronize()
    return [ctx.event() for _ in range(ctx.traffic["in_flight"])]


def run(ctx: Context, events) -> Window:
    size, depth, nb = (ctx.traffic[k] for k in ("batch", "in_flight", "batches"))
    batches = [ctx.pool.batch(b, size) for b in range(nb)]
    resize, sampler, stream = ctx.resizer.resize_batch, ctx.sampler, ctx.stream
    issued, waited = ctx.spans.recorder("issue"), ctx.spans.recorder("wait_event")
    calls = failed = 0
    t0 = clock()
    deadline = t0 + int(ctx.seconds * 1e9)
    now = t0
    while now < deadline:
        ev = events[calls % depth]
        if calls >= depth:
            ev.synchronize()
            t = clock()
            waited((now, t))
            now = t
        b = calls % nb
        try:
            out = resize(*batches[b])
        except RuntimeError:
            failed += size
            out = None
        issued((now, clock()))
        ev.record(stream)
        slot = sampler.slot(b)
        if out is not None and slot >= 0:
            sampler.put(b, slot, Output(b * size, size, out))
        calls += 1
        now = clock()
    ctx.synchronize()
    t1 = clock()
    ctx.spans.add("wait_end", now, t1)
    return Window(t0, t1, calls=calls, frames=calls * size - failed,
                  attempted=calls * size, failed=failed)
