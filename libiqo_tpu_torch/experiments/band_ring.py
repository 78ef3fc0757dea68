"""The ring forms of kernels E and G (``libiqo_tpu_torch/csrc/exp/
exp_band_ring.cu``) on the host: their geometry, the persistent walk, the
ring of window stages, the barrier schedule and a NumPy model of the kernels.

Both kernels split their work into items: E ``(frame, chunk, tile)``, the
32 output rows of a row tile over a column chunk of 128 columns; G ``(chunk,
tile, side)``, the 96 output rows over one 64-column side of the chunk.
``per_group`` consecutive items form a group (a column chunk, and frame),
whose items walk the row tiles in
order.  A persistent grid of one block an SM takes contiguous runs of the
items (:func:`ring_walk`), so the TPU's sequential grid and its parallel one
are one schedule on the card.  A producer warp loads each item's window
(``work.rows`` rows x 128 bytes, 128-byte swizzled) by TMA as one box into a
ring of window stages; consecutive items with the same window (G's two
sides of a tile, clamped windows that coincide) share one load, released
after the last of them (:func:`ring_events`).  The consumer warps take the
items of a run in turn: E in two groups of four warps, G in four groups of
two.

:func:`ydot_model` and :func:`overlap_model` run the walk, the ring (stages
filled with noise first, written through the swizzle, checked to hold the
window an item reads) and the tile bodies with the kernel's own permutation
of each K step's rows (:func:`perm_row`), so that a wrong address shows as a
wrong output.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["IMPLS", "RING", "RingGeometry", "RingWork", "banks", "barrier_schedule", "impl_of",
           "issued_bytes",
           "overlap_model", "overlap_work", "perm_row", "ring_ctas", "ring_events",
           "ring_walk", "run_barriers", "run_lengths", "wave_efficiency", "word_col", "ydot_model",
           "ydot_work"]

H100_SMS = 132
IMPLS = ("ring", "sync")   # E's and G's implementations; the first is the default


def impl_of(impl: str | None) -> str:
    """``impl``, or the default if None; refuses a name not in :data:`IMPLS`."""
    if impl is None:
        return IMPLS[0]
    if impl not in IMPLS:
        raise ValueError(f"impls are {IMPLS}, got {impl!r}")
    return impl


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """The ring kernels' geometry, as ``exp_band_ring.cu`` states it."""
    chunk: int = 128        # source columns of a window: one 128-byte box row
    consumers: int = 256    # consumer threads: 8 warps
    groups_e: int = 2       # consumer groups, kernel E: item i of a run to group i % 2
    groups_g: int = 4       # kernel G: item i to group i % 4
    stages_e: int = 8       # windows in flight, kernel E
    stages_g: int = 4       # kernel G
    e_pitch: int = 96 + 16  # C's pitch in shared memory, kernel E
    g_pitch: int = 128 + 16  # kernel G

    @property
    def threads(self) -> int:
        return self.consumers + 32                  # + the producer warp

    @property
    def stage_e(self) -> int:
        return 96 * self.chunk                      # a window of E

    @property
    def stage_g(self) -> int:
        return 208 * self.chunk                     # a window of G (blocked: 192 rows)

    @property
    def smem_e(self) -> int:
        return self.stages_e * (self.stage_e + 16) + 32 * self.e_pitch + 1024

    @property
    def smem_g(self) -> int:
        return self.stages_g * (self.stage_g + 16) + 96 * self.g_pitch + 1024


RING = RingGeometry()


def perm_row(k: int) -> int:
    """The window row that mma k index ``k`` (0 .. 31) of a K step reads:
    ``16 h + 4 q + j -> 16 h + 8 (j >> 1) + 2 q + (j & 1)``."""
    return (k & 16) | ((k & 2) << 2) | ((k >> 1) & 6) | (k & 1)


PERM = np.array([perm_row(k) for k in range(32)])


def word_col(wide: bool, wl: int, n: int) -> int:
    """The word column (four chunk columns) whose B fragment a lane of warp
    ``wl`` loads for mma n index ``n``, and so where its sums land: ``8 wl +
    n``, or with ``wide`` (E's i32 rows) ``8 wl + 4 (n & 1) + (n >> 1)``."""
    return 8 * wl + 4 * (n & 1) + (n >> 1) if wide else 8 * wl + n


@dataclasses.dataclass(frozen=True)
class RingWork:
    """A ring kernel's items: ``groups`` groups of ``per_group`` items;
    ``offs[j]`` the first row of the window of the j-th item of a group, a
    box of ``rows`` rows at column ``x[g]``, row ``y[g] + offs[j]`` of a map
    of ``height`` rows (rows past it arrive as zeros), staged in a ring of
    ``stages``; the consumer warps take its items in ``consumer_groups``
    groups, item i of a run to group i % consumer_groups."""
    per_group: int
    offs: tuple[int, ...]
    rows: int
    x: tuple[int, ...]
    y: tuple[int, ...]
    height: int
    stages: int
    consumer_groups: int

    @property
    def groups(self) -> int:
        return len(self.x)

    @property
    def items(self) -> int:
        return self.groups * self.per_group

    def window(self, i: int) -> tuple[int, int]:
        """(group, first row) of item i's window: the key the kernel compares."""
        return i // self.per_group, self.offs[i % self.per_group]


def ydot_work(h: int, w: int, frames: int = 1, clamp: bool = False) -> RingWork:
    """Kernel E's items: (frame, chunk, tile), tile t's window 96 rows at
    64 t (clamped to h - 96 in the clamp forms, which never binds)."""
    n_t = (h - 96) // 64 + 1
    chunks = w // RING.chunk
    return RingWork(n_t, tuple(min(h - 96, 64 * t) if clamp else 64 * t for t in range(n_t)),
                    96, tuple(RING.chunk * c for f in range(frames) for c in range(chunks)),
                    tuple(f * h for f in range(frames) for c in range(chunks)), frames * h,
                    RING.stages_e, RING.groups_e)


def overlap_work(variant: str, h: int, nd: int, n_ty: int) -> RingWork:
    """Kernel G's items: (chunk, tile, side); tile t's window 192 rows at
    192 t (blocked) or 208 rows at max(0, min(clamp_hi, 192 t))."""
    clamp_hi = (h - 208) // 32 * 32
    blocked = variant == "blocked"
    offs = [192 * t if blocked else max(0, min(clamp_hi, 192 * t)) for t in range(n_ty)]
    chunks = nd // RING.chunk
    return RingWork(2 * n_ty, tuple(o for o in offs for _ in range(2)), 192 if blocked else 208,
                    tuple(RING.chunk * c for c in range(chunks)), (0,) * chunks, h,
                    RING.stages_g, RING.groups_g)


def ring_ctas(work: RingWork, sms: int = H100_SMS) -> int:
    """Blocks of the persistent grid: one an SM, at most one an item."""
    return min(sms, work.items)


def ring_walk(work: RingWork, ctas: int) -> list[list[tuple[int, list[int]]]]:
    """Each block's run as segments ``(group, [items])``: block b takes the
    items [b N / ctas, (b + 1) N / ctas), in order."""
    n = work.items
    runs = []
    for b in range(ctas):
        i, i1, segs = b * n // ctas, (b + 1) * n // ctas, []
        while i < i1:
            grp = i // work.per_group
            end = min(i1, (grp + 1) * work.per_group)
            segs.append((grp, list(range(i, end))))
            i = end
        runs.append(segs)
    return runs


def run_lengths(work: RingWork, sms: int = H100_SMS) -> list[int]:
    """Items in each block's run."""
    return [sum(len(items) for _, items in r) for r in ring_walk(work, ring_ctas(work, sms))]


def wave_efficiency(work: RingWork, sms: int = H100_SMS) -> float:
    """The mean run over the longest: the share of the card's time its
    blocks have items, if every item takes the same time."""
    runs = run_lengths(work, sms)
    return sum(runs) / len(runs) / max(runs)


def ring_events(work: RingWork, segs: list[tuple[int, list[int]]]) -> list[tuple]:
    """One block's ring in program order: ``("load", n, group, row)`` for
    the producer's n-th box (the window at that row of the group),
    ``("item", i, n)`` for item i reading load n, ``("release", n)`` after
    the last item that reads load n."""
    run = [i for _, items in segs for i in items]
    events, n = [], -1
    for k, i in enumerate(run):
        if k == 0 or work.window(i) != work.window(run[k - 1]):
            n += 1
            events.append(("load", n, *work.window(i)))
        events.append(("item", i, n))
        if k + 1 == len(run) or work.window(run[k + 1]) != work.window(i):
            events.append(("release", n))
    return events


def issued_bytes(work: RingWork, ctas: int) -> int:
    """Bytes the ring form's TMA loads issue in one launch (rows past the
    map included, as zeros), computed from the walk (not measured)."""
    return work.rows * RING.chunk * sum(e[0] == "load" for segs in ring_walk(work, ctas)
                                        for e in ring_events(work, segs))


def barrier_schedule(work: RingWork, segs) -> dict:
    """Per stage of one block's ring: TMA boxes (each ``expect_tx`` of a
    window's bytes and one producer arrival on the full barrier), waits of
    each consumer thread on the full barrier, arrivals of all consumer
    threads on the empty barrier, and the producer's waits on it."""
    out = {k: dict.fromkeys(("loads", "tx_bytes", "full_arrivals", "full_waits",
                             "empty_arrivals", "empty_waits"), 0) for k in range(work.stages)}
    for e in ring_events(work, segs):
        stage = out[e[1] % work.stages]
        if e[0] == "load":
            stage["loads"] += 1
            stage["tx_bytes"] += work.rows * RING.chunk
            stage["full_arrivals"] += 1
            stage["empty_waits"] += 1
            stage["full_waits"] += 1                 # one a consumer thread
        elif e[0] == "release":
            stage["empty_arrivals"] += RING.consumers
    return out


class _Barrier:
    """An mbarrier: ``count`` arrivals (and the expected bytes) complete a
    phase; a wait on parity p passes once the phase of parity p is done."""

    def __init__(self, count: int):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx: int = 0) -> None:
        self.pending -= 1
        self.tx += tx
        self._step()

    def land(self, nbytes: int) -> None:
        self.tx -= nbytes
        self._step()

    def _step(self) -> None:
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity: int) -> bool:
        return (self.phase & 1) != parity


def run_barriers(work: RingWork, segs, seed: int | None = None) -> int:
    """Run one block's producer and consumer threads (one stand-in a warp,
    arriving for its 32 threads) on model mbarriers, each thread's steps in
    the kernel's order (``produce``/``consume`` of the source), scheduled
    round robin (``seed`` None) or at random; raises on a deadlock or on an
    item that reads a stage not holding its window.  Returns the steps."""
    s = work.stages
    full = [_Barrier(1) for _ in range(s)]
    empty = [_Barrier(RING.consumers) for _ in range(s)]
    stage_load = [None] * s
    events = ring_events(work, segs)
    nbytes = work.rows * RING.chunk

    def producer():
        for e in events:
            if e[0] != "load":
                continue
            n = e[1]
            while not empty[n % s].passed(((n // s) & 1) ^ 1):
                yield False
            full[n % s].arrive(tx=nbytes)
            stage_load[n % s] = n                    # the box lands at once
            full[n % s].land(nbytes)
            yield True

    def consumer(group):
        k = 0
        for e in events:
            if e[0] == "load":
                n = e[1]
                while not full[n % s].passed((n // s) & 1):
                    yield False
            elif e[0] == "item":
                if k % work.consumer_groups == group and stage_load[e[2] % s] != e[2]:
                    raise AssertionError(f"item {e[1]} read stage {e[2] % s} holding load "
                                         f"{stage_load[e[2] % s]}, not {e[2]}")
                k += 1
                yield True
            else:
                for _ in range(32):
                    empty[e[1] % s].arrive()
                yield True

    rng = None if seed is None else np.random.default_rng(seed)
    warps = RING.consumers // 32
    live = [producer()] + [consumer(w // (warps // work.consumer_groups)) for w in range(warps)]
    steps, stalled = 0, 0
    while live:
        k = steps % len(live) if rng is None else int(rng.integers(len(live)))
        try:
            moved = next(live[k])
        except StopIteration:
            live.pop(k)
            stalled = 0
            continue
        steps += 1
        stalled = 0 if moved else stalled + 1
        if stalled > 50 * (len(live) + 1) ** 2:
            raise AssertionError("deadlock: every thread waits")
    return steps


def banks(pitch: int, rows, col_of_lane, swizzle: bool = True) -> int:
    """The most lanes of one 4-byte shared-memory load that hit one bank
    with distinct addresses: lane l reads row ``rows[l]`` at column
    ``col_of_lane(l)`` of a tile at ``pitch`` bytes (128-byte swizzled)."""
    hits = {}
    for lane in range(32):
        r, c = rows[lane], col_of_lane(lane)
        piece = ((c >> 4) ^ (r & 7)) if swizzle else c >> 4
        addr = r * pitch + 16 * piece + (c & 15)
        hits.setdefault((addr // 4) % 32, set()).add(addr // 4)
    return max(len(v) for v in hits.values())


# ---- the NumPy model --------------------------------------------------------------

class _RingBytes:
    """A block's ring as its shared memory holds it: stages of a window's
    rows x 128 bytes, filled with noise, written by TMA through the 128-byte
    swizzle."""

    def __init__(self, plane: np.ndarray, work: RingWork, rng):
        self.plane, self.work = plane, work
        self.mem = rng.integers(0, 256, (work.stages, work.rows * RING.chunk), np.uint8)
        self.holds = [None] * work.stages
        r = np.arange(work.rows)[:, None]
        c = np.arange(RING.chunk)[None, :]
        self.swz = r * RING.chunk + 16 * ((c >> 4) ^ (r & 7)) + (c & 15)   # (rows, 128)

    def load(self, n: int, grp: int, off: int, released: set) -> None:
        stage = n % self.work.stages
        if self.holds[stage] is not None and self.holds[stage] not in released:
            raise AssertionError(f"load {n} overwrote load {self.holds[stage]} before "
                                 f"its release")
        y0, x0 = self.work.y[grp] + off, self.work.x[grp]
        box = np.zeros((self.work.rows, RING.chunk), np.uint8)
        rows = self.plane[y0:min(y0 + self.work.rows, self.work.height), x0:x0 + RING.chunk]
        box[:rows.shape[0], :rows.shape[1]] = rows
        self.mem[stage][self.swz] = box
        self.holds[stage] = n

    def rows(self, n: int, wr: np.ndarray) -> np.ndarray:
        """Window rows ``wr`` of load n read from its stage, (len(wr), 128) u8."""
        stage = n % self.work.stages
        if self.holds[stage] != n:
            raise AssertionError(f"stage {stage} holds load {self.holds[stage]}, not {n}")
        return self.mem[stage][self.swz[wr]]


def _permuted_coef(coef: np.ndarray, pitch: int) -> np.ndarray:
    """C in shared memory as ``load_coef`` writes it: column 32 s + k holds
    C's column 32 s + perm_row(k), rows at ``pitch`` (the pad unused)."""
    rows, k = coef.shape
    cs = np.zeros((rows, pitch), np.int8)
    cols = np.array([(c & ~31) + perm_row(c & 31) for c in range(k)])
    cs[:, :k] = coef[:, cols]
    return cs


def _walk(work: RingWork, plane: np.ndarray, sms: int, seed: int, body) -> None:
    rng = np.random.default_rng(seed)
    for segs in ring_walk(work, ring_ctas(work, sms)):
        ring, released = _RingBytes(plane, work, rng), set()
        for e in ring_events(work, segs):
            if e[0] == "load":
                ring.load(e[1], e[2], e[3], released)
            elif e[0] == "item":
                body(ring, e[2], *divmod(e[1], work.per_group))
            else:
                released.add(e[1])


def ydot_model(coef: np.ndarray, src: np.ndarray, form: str, ops=None,
               sms: int = H100_SMS, seed: int = 0) -> np.ndarray:
    """Kernel E's ring form in NumPy: ``src`` (frames, h, w) or (h, w) u8
    (the word form's bytes for ``"i32"``), ``ops`` the streamed operands as NumPy
    arrays ``(rows, cols, slab)``; the output as the kernel writes it."""
    flat = src.ndim == 2
    src = src[None] if flat else src
    frames, h, w = src.shape
    n_t = (h - 96) // 64 + 1
    chunks = w // RING.chunk
    clamp = form in ("clamp", "u8out", "streams", "vmem")
    work = ydot_work(h, w, frames, clamp)
    cs = _permuted_coef(coef, RING.e_pitch)[:, :96].astype(np.int64)
    out = np.zeros((frames, n_t * 32, w), np.int64)
    plane = src.reshape(frames * h, w)

    def body(ring, n, grp, t):
        frame, chunk = divmod(grp, chunks)
        acc = np.zeros((32, RING.chunk), np.int64)
        for ks in range(3):
            b = ring.rows(n, 32 * ks + PERM).view(np.int8) ^ np.int8(-128)
            acc += cs[:, 32 * ks:32 * ks + 32] @ b.astype(np.int64)
        out[frame, 32 * t:32 * t + 32, RING.chunk * chunk:RING.chunk * (chunk + 1)] = acc

    _walk(work, plane, sms, seed, body)
    if form == "i32":
        perm = np.concatenate([np.arange(p, w, 4) for p in range(4)])
        return out[0][:, perm].astype(np.int32)          # (h, w) only
    if form in ("streams", "vmem"):
        rows, cols, slab = ops
        out = out + sum(r.astype(np.int64) for r in rows)
        col = sum(c.astype(np.int64) for c in cols)[0]
        out = out + col[np.arange(w) % col.shape[0]]
        if form == "vmem":
            out = out + slab[0].astype(np.int64)[np.arange(w) % slab.shape[1]]
    if form in ("u8out", "streams", "vmem"):
        out = out & 255
    out = out.astype(np.uint8 if form in ("u8out", "streams") else np.int32)
    return out[0] if flat else out


def overlap_model(src: np.ndarray, coef: np.ndarray, variant: str, p: int, nd: int,
                  n_ty: int, sms: int = H100_SMS, seed: int = 0) -> np.ndarray:
    """Kernel G's ring form in NumPy: ``src`` (h, w) u8; (96 n_ty, nd) u8."""
    work = overlap_work(variant, src.shape[0], nd, n_ty)
    cs = _permuted_coef(coef, RING.g_pitch)[:, :128].astype(np.int64)
    out = np.zeros((96 * n_ty, nd), np.uint8)

    def body(ring, n, chunk, j):
        t, side = divmod(j, 2)
        rows = slice(96 * t, 96 * t + 96)
        cols = slice(RING.chunk * chunk + 64 * side, RING.chunk * chunk + 64 * side + 64)
        side_cols = slice(64 * side, 64 * side + 64)
        if p == 0:
            out[rows, cols] = ring.rows(n, np.arange(96))[:, side_cols]
            return
        acc = np.zeros((96, 64), np.int64)
        for ks in range(4):
            for i in range(p):
                b = ring.rows(n, 8 * i + 32 * ks + PERM)[:, side_cols].view(np.int8)
                acc += cs[:, 32 * ks:32 * ks + 32] @ b.astype(np.int64)
        out[rows, cols] = (acc & 255).astype(np.uint8)

    _walk(work, src, sms, seed, body)
    return out
