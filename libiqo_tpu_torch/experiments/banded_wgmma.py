"""Kernel D's ``wgmma`` form (``libiqo_tpu_torch/csrc/exp/exp_banded_wgmma.cu``)
on the host: its geometry, the two kernels' walks, the X kernel's ring of
stages and its barrier schedule, and a NumPy model of both kernels.

The form runs in two launches.  The Y kernel computes each tile's work rows
transposed, ``w^T = band^T @ cy^T``: an item is (tile, 64 band columns),
one a warpgroup; a persistent grid of blocks of two warpgroups strides over
the items (:func:`y_walk`), each warpgroup on its own, and each item walks the
band in chunks of 64 rows (the last of 16) and issues one K step of 16 a
wgmma: m64n160 in mono, or in grouped m64n40 for each group of 40 output
rows whose 96-row window reaches the step (:func:`y_steps`).  Its A
fragments come from a bf16 stage of the band by ``ldmatrix.trans``
(:func:`ldmatrix_trans_rows`, :func:`a_fragment`).  The X kernel's item is
128 work rows x 64 outputs (:func:`x_items`); a persistent grid takes
contiguous runs of them (:func:`x_walk`), and a producer warp streams each
item's K chunks (work rows and the three coefficient planes) into a ring of
:data:`X_STAGES` stages for two consumer warpgroups (:func:`x_ring_events`,
:func:`run_barriers`).

:func:`model` runs both walks with the kernels' decomposition (Y's K steps
and groups, X's chunks and the split of ``exp_slice_align.split_bf16``),
every f32 sum checked exact, so that the CPU tests can hold the schedule
against ``banded_tile_plain``; on the card the kernels themselves are held
against it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .exp_slice_align import split_bf16

__all__ = ["GEOMETRY", "Geometry", "X_STAGES", "a_fragment", "check_shape", "issued_bytes",
           "ldmatrix_trans_rows", "model", "run_barriers", "wave_efficiency", "x_chunks",
           "x_ctas", "x_items", "x_ring_events", "x_walk", "y_ctas", "y_items", "y_steps",
           "y_walk"]

H100_SMS = 132
TH, BH, BW, TW = 160, 336, 896, 384
MODES = ("mono", "grouped", "skip")
X_STAGES = 4
_F32_EXACT = 2**24


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The two kernels' geometry, as ``exp_banded_wgmma.cu`` states it."""
    y_threads: int = 256       # two warpgroups, an item at a time each
    y_cols: int = 64           # band columns of a Y item
    y_chunk: int = 64          # band rows of a chunk
    y_stage_pitch: int = 64 * 2 + 16     # bytes a bf16 band row of a stage
    y_out_pitch: int = 64 * 2 + 16       # bytes an output row of an item's staging
    cy_kblocks: int = 6        # cy^T K blocks of 64 (K padded to 384)
    x_rows: int = 128          # work rows of an X item, 64 a consumer warpgroup
    x_cols: int = 64           # outputs of an X item
    x_kc: int = 64             # K of a chunk
    x_stages: int = X_STAGES
    x_consumers: int = 2

    @property
    def y_chunks(self) -> int:
        return -(-BH // self.y_chunk)

    @property
    def y_smem(self) -> int:
        return (self.cy_kblocks * TH * 128 + 4 * self.y_chunk * self.y_stage_pitch +
                2 * TH * self.y_out_pitch + 1024)

    @property
    def x_threads(self) -> int:
        return 128 * self.x_consumers + 32

    @property
    def x_stage(self) -> int:
        return self.x_rows * 128 + 3 * self.x_cols * 128

    @property
    def x_smem(self) -> int:
        return self.x_stages * self.x_stage + 2 * self.x_stages * 8 + 1024


GEOMETRY = Geometry()


def check_shape(lib_) -> None:
    """The kernels' compiled geometry (``iqo_exp_banded_wgmma_shape``) must
    be :data:`GEOMETRY`."""
    import ctypes
    got = (ctypes.c_int * 12)()
    lib_.iqo_exp_banded_wgmma_shape(got)
    g = GEOMETRY
    want = [g.y_threads, g.y_cols, g.y_chunk, g.y_chunks, g.y_smem, g.x_rows, g.x_cols, g.x_kc,
            g.x_stages, g.x_threads, g.x_stage, g.x_smem]
    if list(got) != want:
        raise RuntimeError(f"exp_banded_wgmma.cu's geometry {list(got)} != the host's {want}")


# ---- Y --------------------------------------------------------------------------

def y_items(tiles: int, xskip: bool) -> int:
    """Y items (tile, 64-column block); with X skip only the columns below
    384 are needed."""
    return tiles * (TW if xskip else BW) // GEOMETRY.y_cols


def y_ctas(tiles: int, xskip: bool, sms: int = H100_SMS) -> int:
    """Blocks of the Y grid: one an SM, at most half the items, so that each
    of a block's two warpgroups has a first item (in which both wait for
    cy^T's copy together)."""
    return min(sms, y_items(tiles, xskip) // 2)


def y_walk(tiles: int, xskip: bool, ctas: int) -> list[list[tuple[int, int]]]:
    """Each warpgroup's Y items ``(tile, first column)``, block by block and
    warpgroup by warpgroup: warpgroup w of block b takes items 2 b + w,
    2 b + w + 2 ctas, ... (the kernel's stride)."""
    blocks = BW // GEOMETRY.y_cols if not xskip else TW // GEOMETRY.y_cols
    n = y_items(tiles, xskip)
    return [[(i // blocks, GEOMETRY.y_cols * (i % blocks)) for i in range(2 * b + w, n, 2 * ctas)]
            for b in range(ctas) for w in range(2)]


def y_group_window(g: int) -> tuple[int, int]:
    """(first K step, K steps) of Y group g's window (``:39``)."""
    return min(80 * g, BH - 96) // 16, 96 // 16


def y_steps(ymode: str) -> list[tuple[int, int, int, int]]:
    """The Y kernel's wgmma issues of an item in order: ``(chunk, K step,
    first output row, rows)``, one an n160 in mono, one an n40 group per K
    step its window reaches in grouped."""
    g = GEOMETRY
    out = []
    for c in range(g.y_chunks):
        for kl in range(min(g.y_chunk, BH - g.y_chunk * c) // 16):
            ks = 4 * c + kl
            if ymode == "mono":
                out.append((c, ks, 0, TH))
            else:
                for grp in range(4):
                    s0, n = y_group_window(grp)
                    if s0 <= ks < s0 + n:
                        out.append((c, ks, 40 * grp, 40))
    return out


def ldmatrix_trans_rows(lane: int, kl: int, m0: int) -> tuple[int, int]:
    """(stage row, stage column) of the row address lane ``lane`` gives
    ``ldmatrix.x4.trans`` for K step ``kl`` of a chunk and the warp's band
    columns ``m0 ..``: matrix ``lane // 8``, row ``lane % 8``."""
    i, r = lane // 8, lane % 8
    return 16 * kl + r + 8 * (i >> 1), m0 + 8 * (i & 1)


def a_fragment(stage: np.ndarray, kl: int, m0: int) -> np.ndarray:
    """Each lane's A fragment, (32, 4, 2) [lane, register, half], as
    ``ldmatrix.x4.trans`` distributes the four 8 x 8 matrices whose rows
    :func:`ldmatrix_trans_rows` names: thread (g, q) gets stored elements
    (2 q, g) and (2 q + 1, g) of each."""
    out = np.zeros((32, 4, 2), stage.dtype)
    for i in range(4):
        rows = [ldmatrix_trans_rows(8 * i + r, kl, m0) for r in range(8)]
        mat = np.stack([stage[k, c:c + 8] for k, c in rows])     # [stored row][column]
        for lane in range(32):
            g, q = lane // 4, lane % 4
            out[lane, i] = mat[2 * q, g], mat[2 * q + 1, g]
    return out


def _wrap(v: np.ndarray, bits: int) -> np.ndarray:
    half = 1 << (bits - 1)
    return (v.astype(np.int64) + half) % (1 << bits) - half


def y_model(band: np.ndarray, cy: np.ndarray, ymode: str, tiles: int,
            xskip: bool = False, sms: int = H100_SMS) -> np.ndarray:
    """The Y kernel's work values in NumPy, (tiles, 160, 896) int64 wrapped
    to int16 (with X skip the columns below 384 only, the rest -1 << 20):
    item by item along :func:`y_walk`, each wgmma of :func:`y_steps` on its
    K step's 16 band rows and output rows, summed in float64 and checked
    exact in f32."""
    g = GEOMETRY
    w = np.full((tiles, TH, BW), -1 << 20, np.int64)
    seen = np.zeros((tiles, BW // g.y_cols), np.int64)
    cyf = cy.astype(np.float64)
    for run in y_walk(tiles, xskip, y_ctas(tiles, xskip, sms)):
        for t, c0 in run:
            cols = slice(c0, c0 + g.y_cols)
            if ymode == "skip":
                w[t, :, cols] = _wrap(band[t, :TH, cols].astype(np.int64) * 37, 16)
            else:
                d = np.zeros((g.y_cols, TH))              # w^T of the item
                worst = np.zeros_like(d)
                for _, ks, n0, n in y_steps(ymode):
                    a = band[t, 16 * ks:16 * ks + 16, cols].astype(np.float64).T
                    b = cyf[n0:n0 + n, 16 * ks:16 * ks + 16].T
                    d[:, n0:n0 + n] += a @ b
                    worst[:, n0:n0 + n] += np.abs(a) @ np.abs(b)
                if worst.max() >= _F32_EXACT:
                    raise AssertionError("a Y sum of |products| reaches 2^24")
                w[t, :, cols] = _wrap(np.trunc(d).astype(np.int64).T, 16)
            seen[t, c0 // g.y_cols] += 1
    need = TW // g.y_cols if xskip else BW // g.y_cols
    if not (seen[:, :need] == 1).all() or seen[:, need:].any():
        raise AssertionError("the Y walk did not cover every item once")
    return w


# ---- X --------------------------------------------------------------------------

def x_items(tiles: int) -> list[tuple[int, int]]:
    """X items in the kernel's order, ``(column block, row pair)``: column-
    block-major, 6 blocks of 64 outputs x ceil(tiles x 160 / 128) items of
    128 work rows (the last pair's rows past the end arrive as zeros)."""
    pairs = -(-tiles * TH // GEOMETRY.x_rows)
    return [(cb, mp) for cb in range(TW // GEOMETRY.x_cols) for mp in range(pairs)]


def x_ctas(tiles: int, sms: int = H100_SMS) -> int:
    return min(sms, len(x_items(tiles)))


def x_walk(tiles: int, ctas: int) -> list[list[tuple[int, int]]]:
    """Each block's run: block b takes the items [b N / ctas, (b + 1) N /
    ctas), in order."""
    items = x_items(tiles)
    n = len(items)
    return [items[b * n // ctas:(b + 1) * n // ctas] for b in range(ctas)]


def wave_efficiency(tiles: int, sms: int = H100_SMS) -> float:
    """The X walk's mean run over its longest."""
    runs = [len(r) for r in x_walk(tiles, x_ctas(tiles, sms))]
    return sum(runs) / len(runs) / max(runs)


def x_chunks(cb: int, grouped: bool) -> list[int]:
    """The first work column of each K chunk of an item of column block
    ``cb``: all 896 in mono, the group's 384-wide window (``:40``) in
    grouped."""
    k0 = max(0, 256 * (GEOMETRY.x_cols * cb // 128) - 128) if grouped else 0
    return list(range(k0, k0 + (384 if grouped else BW), GEOMETRY.x_kc))


def x_ring_events(run: list[tuple[int, int]], grouped: bool) -> list[tuple]:
    """One block's ring in program order: ``("load", n, item, k)`` for the
    producer's n-th stage fill (chunk k of the item), ``("release", n)``
    where both consumers hand it back (after the next chunk's first K step
    has retired the products that read it, or at the item's end)."""
    events, n = [], 0
    for item in run:
        ks = x_chunks(item[0], grouped)
        for c, k in enumerate(ks):
            events.append(("load", n, item, k))
            if c > 0:
                events.append(("release", n - 1))
            n += 1
        events.append(("release", n - 1))
    return events


def issued_bytes(tiles: int, xmode: str, sms: int = H100_SMS) -> dict:
    """Bytes each kernel reads, from the walks (not measured): Y's band
    rows and cy once a block; X's work rows and coefficient planes, a stage
    a chunk (rows past the end included, as TMA's zeros)."""
    g = GEOMETRY
    xskip = xmode == "skip"
    y = y_items(tiles, xskip) * BH * g.y_cols + y_ctas(tiles, xskip, sms) * TH * BH * 2
    if xskip:
        return {"y": y, "x_work": 0, "x_coefficients": 0}
    chunks = sum(len(x_chunks(cb, xmode == "grouped")) for cb, _ in x_items(tiles))
    return {"y": y, "x_work": chunks * g.x_rows * 128,
            "x_coefficients": chunks * 3 * g.x_cols * 128}


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


def run_barriers(run: list[tuple[int, int]], grouped: bool, seed: int | None = None) -> int:
    """Run one X block's producer and its eight consumer warps (each
    arriving for its 32 threads) on model mbarriers, each in the kernel's
    order, round robin (``seed`` None) or at random; raises on a deadlock or
    on a chunk read from a stage that does not hold it.  Returns the steps."""
    g = GEOMETRY
    s = g.x_stages
    full = [_Barrier(1) for _ in range(s)]
    empty = [_Barrier(128 * g.x_consumers) for _ in range(s)]
    held = [None] * s
    loads = [e for e in x_ring_events(run, grouped) if e[0] == "load"]

    def producer():
        for _, n, item, k in loads:
            while not empty[n % s].passed(((n // s) & 1) ^ 1):
                yield False
            full[n % s].arrive(tx=g.x_stage)
            held[n % s] = (item, k)
            full[n % s].land(g.x_stage)
            yield True

    def consumer():
        n = 0
        for item in run:
            ks = x_chunks(item[0], grouped)
            for c, k in enumerate(ks):
                while not full[n % s].passed((n // s) & 1):
                    yield False
                if held[n % s] != (item, k):
                    raise AssertionError(f"chunk {k} of item {item} read stage {n % s} "
                                         f"holding {held[n % s]}")
                yield True
                if c > 0:
                    for _ in range(32):
                        empty[(n - 1) % s].arrive()
                n += 1
            for _ in range(32):
                empty[(n - 1) % s].arrive()
            yield True

    rng = None if seed is None else np.random.default_rng(seed)
    live = [producer()] + [consumer() for _ in range(4 * g.x_consumers)]
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


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def x_model(w: np.ndarray, cxt: np.ndarray, xmode: str, sms: int = H100_SMS) -> np.ndarray:
    """The X kernel's output in NumPy from the int16 work values ``w``
    (tiles, 160, 896) and the K-major planes ``cxt`` (3, 384, 896): item by
    item along :func:`x_walk`, chunk by chunk of :func:`x_chunks`, the
    planes split as ``split_pair`` splits them, each plane's f32 sum checked
    exact, truncated, met in uint32, rounded, wrapped and clipped."""
    g = GEOMETRY
    tiles = w.shape[0]
    rows = tiles * TH
    pairs = -(-rows // g.x_rows)
    padded = np.zeros((pairs * g.x_rows, BW), np.int16)
    padded[:rows] = w.reshape(rows, BW)
    planes = [_bf16_value(p) for p in split_bf16(padded)]
    cx = cxt.astype(np.float64)
    out = np.full((pairs * g.x_rows, TW), -1, np.int64)
    for run in x_walk(tiles, x_ctas(tiles, sms)):
        for cb, mp in run:
            r = slice(g.x_rows * mp, g.x_rows * (mp + 1))
            cols = slice(g.x_cols * cb, g.x_cols * (cb + 1))
            d = []
            for p, c in zip(planes, cx):
                acc = np.zeros((g.x_rows, g.x_cols))
                worst = np.zeros_like(acc)
                for k in x_chunks(cb, xmode == "grouped"):
                    pk, ck = p[r, k:k + g.x_kc], c[cols, k:k + g.x_kc].T
                    acc += pk @ ck
                    worst += np.abs(pk) @ np.abs(ck)
                if worst.max() >= _F32_EXACT:
                    raise AssertionError("an X sum of |products| reaches 2^24: f32 sums would "
                                         "depend on their order")
                d.append(np.trunc(acc).astype(np.int64))
            if (out[r, cols] >= 0).any():
                raise AssertionError("the X walk computed an item twice")
            s = _wrap(d[0] * 65280 - d[1] * 255 + d[2] * 256, 32)
            out[r, cols] = np.clip(_wrap(_wrap(s + (1 << 19), 32) >> 20, 16), 0, 255)
    if (out[:rows] < 0).any():
        raise AssertionError("the X walk did not cover every output")
    return out[:rows].astype(np.uint8).reshape(tiles, TH, TW)


def model(band: np.ndarray, cy: np.ndarray, cxt: np.ndarray, ymode: str, xmode: str,
          sms: int = H100_SMS) -> np.ndarray:
    """Kernel D's wgmma form in NumPy: ``band`` (tiles, 336, 896) u8, ``cy``
    (160, 336) and ``cxt`` (3, 384, 896) integer-valued -> (tiles, 160, 384)
    u8, through :func:`y_model` and :func:`x_model` (X skip: the Y kernel's
    epilogue)."""
    if ymode not in MODES or xmode not in MODES:
        raise ValueError(f"modes are {MODES}, got {ymode!r}, {xmode!r}")
    tiles = band.shape[0]
    w = y_model(band, cy, ymode, tiles, xmode == "skip", sms)
    if xmode != "skip":
        return x_model(w, cxt, xmode, sms)
    wx = w[..., :TW]
    b = ((wx + 128) & 255) - 128
    a = (wx - b) >> 8
    s = _wrap(a * 65280 + b * 256, 32)
    return np.clip(_wrap(_wrap(s + (1 << 19), 32) >> 20, 16), 0, 255).astype(np.uint8)
