"""One overlapping band window against a disjoint step plus a halo: what
each costs a column-sum Y pass on the card.

Port of ``scripts/exp_blocked_halo.py`` to one NVIDIA H100.  Kernel H,
``band_colsum(x, variant, n_t, step, halo)`` (``libiqo_tpu_torch/csrc/exp/
exp_colsum_walk.cu`` and ``exp_band.cu``), replaces ``build``
(``pl.pallas_call`` at ``:82``).  Per
tile ``t < n_t`` of a (n_t step + halo, w) u8 plane, the i32 column sums,
written to 8 rows, (8 n_t, w) i32:

* ``element``: rows ``[t step, t step + step + halo)``, one loop;
* ``blocked2``: rows ``[t step, (t + 1) step)`` of plane A, then
  ``[(t + 1) step, (t + 1) step + halo)`` of plane B, two loops; the probe
  passes the plane twice, as the script's ``call(x, x)`` (``:88``);
* ``blocked1``: the step rows alone: the no-overlap floor.

Configs (name, n_t, step, halo, w), as ``main`` (``:126-130``):
luma-like (64, 64, 64, 3840), luma-halo32 (64, 64, 32, 3840) and narrow
(256, 64, 64, 512).  The script runs them on its sequential grid.  Two
forms, the same function:

* ``form="walk"`` (the default, ``csrc/exp/exp_colsum_walk.cu``): one
  block a (column chunk, run of consecutive tiles), several resident an SM,
  which reads every source row of its run's windows once: each thread sums
  one 16-byte column unit of a piece of rows (4-byte where ``w`` or a
  plane's address is not a multiple of 16) into its own slot of shared
  memory, the run's loads all in flight at once, and the block stores each
  tile once the pieces of its window are summed.
  :func:`colsum_walk` sets the chunk, the run and the threads per (variant,
  n_t, step, halo, w); :func:`colsum_model` is the kernel's partition,
  phases, slots and stores in NumPy;
* ``form="grid"`` (the first form, ``band_colsum_kernel``): one block per (tile,
  column chunk of 128 columns) (1,920 blocks on the luma configs, 1,024 on
  the narrow one), each thread summing one 4-byte word (4 columns) over
  every fourth row straight from device memory, the halo rows read again
  by the next tile; the four row groups meet in shared memory.

The probe draws a new source for every (config, variant) from one seed-0
generator, in the script's order (``:122-141``).  Each row times both forms
and one PyTorch call (:func:`library`) in turns, back-to-back launches on 8
sources that each differ in ``x[0, 0]`` (8 x 16 MB on the luma configs), and
prints the bytes the script's windows fetch (its "MB", halo rows re-read),
the walk's layout, wave efficiency and the rows it re-reads at run ends.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_blocked_halo``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _harness
from ._harness import HBM_BYTES_PER_S, Launches
from .band_ring import H100_SMS
from .xpass_gemm import sm_count

__all__ = ["CONFIGS", "EDGE_SHAPES", "FORMS", "LAUNCHES", "VARIANTS", "ColsumWalk",
           "WalkPass", "band_colsum", "band_colsum_plain", "bound", "colsum_model",
           "colsum_walk", "launch_key", "library", "main", "sources", "walk_passes"]

CONFIGS = (("luma-like", 64, 64, 64, 3840),
           ("luma-halo32", 64, 64, 32, 3840),
           ("narrow", 256, 64, 64, 512))
# shapes off the script's: (name, n_t, step, halo, w), each a case the walk
# must keep right: halo past the step, n_t not a multiple of the run, w not
# a multiple of the chunk (and not of 16: 4-byte loads), one tile, no halo
EDGE_SHAPES = (("halo>step", 37, 48, 100, 1000),
               ("one-tile-w4", 1, 64, 0, 4),
               ("odd-step", 100, 7, 3, 3088),
               ("long-halo", 5, 16, 300, 512))
VARIANTS = ("element", "blocked2", "blocked1")
FORMS = ("walk", "grid")        # the first the default
ITERS = 8
# the walk's compiled constants (csrc/exp/exp_colsum_walk.cu,
# iqo_exp_band_colsum_walk_shape)
WALK_MAX_THREADS = 640
WALK_PIECE_BYTES = 128          # bytes a thread loads of a piece
WALK_SMEM = 232448
WALK_REGS = 48                  # registers a thread (ptxas, sm_90a, both instantiations)
WALK_CHUNKS = (16, 32, 64, 128, 256, 512)
# the walk's launch where the caller does not fix it: chunks of 128 bytes (a
# warp load of a narrower one takes part of each 128-byte line), runs of 3
# tiles, each thread one piece (one phase): of the chunks 128 and 256, runs
# 1-16 and one to four phases timed in turns on an H100 on the narrow and
# luma-like element and blocked1 rows, the fastest or close to it on each
WALK_CHUNK = 128
WALK_RUN = 3
WALK_PHASES = 1


def launch_key(variant: str, form: str) -> str:
    """The :data:`LAUNCHES` key: ``"<variant>"`` for the grid form,
    ``"<variant>[walk]"`` for the walk."""
    return variant if form == "grid" else f"{variant}[walk]"


LAUNCHES = Launches(launch_key(v, f) for f in reversed(FORMS) for v in VARIANTS)


def reset_launches() -> None:
    LAUNCHES.reset()


def _check(x, y, variant, n_t, step, halo) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variants are {VARIANTS}, got {variant!r}")
    if n_t < 1 or step < 1 or halo < 0:
        raise ValueError(f"n_t={n_t}, step={step}, halo={halo}")
    need = n_t * step + (0 if variant == "blocked1" else halo)
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.uint8 or t.ndim != 2 or t.shape[0] < need:
            raise ValueError(f"{name} must be (>= {need}, w) uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if y.shape[1] != x.shape[1]:
        raise ValueError(f"x and y differ in width: {x.shape[1]} != {y.shape[1]}")


def band_colsum_plain(x: torch.Tensor, variant: str, n_t: int, step: int, halo: int,
                      y: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel H's function in plain PyTorch: each tile's row range summed
    from running column sums in int64 (exact), as int32, 8 rows a tile."""
    y = x if y is None else y
    _check(x, y, variant, n_t, step, halo)
    zero = x.new_zeros((1, x.shape[1]), dtype=torch.int64)
    cx = torch.cat([zero, x.to(torch.int64).cumsum(0)])
    t = torch.arange(n_t, device=x.device) * step
    s = cx[t + step] - cx[t]
    if variant == "element":
        s = cx[t + step + halo] - cx[t]
    elif variant == "blocked2":
        cy = torch.cat([zero, y.to(torch.int64).cumsum(0)])
        s = s + cy[t + step + halo] - cy[t + step]
    return s.to(torch.int32).repeat_interleave(8, dim=0)


@dataclasses.dataclass(frozen=True)
class WalkPass:
    """One plane's windows in the walk: tile t's window is ``length`` rows
    of plane ``plane`` (0: A, 1: B) from row ``t step + alpha``, ``length
    = q step + h`` (0 <= h < step); a step block's head (its first h rows)
    and tail are cut into ``nh`` and ``nt`` pieces (both 0: no window)."""
    plane: int
    alpha: int
    length: int
    q: int
    h: int
    nh: int
    nt: int


def walk_passes(variant: str, step: int, halo: int, rows: int) -> tuple[WalkPass, ...]:
    """The variant's passes, as ``iqo_exp_band_colsum_walk`` builds them
    (pieces of ``rows`` rows)."""
    def one(plane, alpha, length):
        if length == 0:
            return WalkPass(plane, alpha, 0, 0, 0, 0, 0)
        q, h = divmod(length, step)
        # a window inside one step block (q 0) is its head alone: no tails
        return WalkPass(plane, alpha, length, q, h, -(-h // rows),
                        -(-(step - h) // rows) if q else 0)
    if variant == "blocked2":
        return one(0, 0, step), one(1, step, halo)
    return (one(0, 0, step + halo if variant == "element" else step),)


@dataclasses.dataclass(frozen=True)
class ColsumWalk:
    """The walk's launch: blocks of (``cw`` bytes of columns, ``run``
    tiles), ``tps`` thread rows of ``cw / vec`` threads, each taking a
    column unit of ``vec`` bytes of one piece a phase; the last run of a
    column chunk may be short."""
    variant: str
    n_t: int
    step: int
    halo: int
    w: int
    vec: int
    cw: int
    run: int
    tps: int
    sms: int

    @property
    def rows_piece(self) -> int:
        return WALK_PIECE_BYTES // self.vec

    @property
    def passes(self) -> tuple[WalkPass, ...]:
        return walk_passes(self.variant, self.step, self.halo, self.rows_piece)

    @property
    def group_pieces(self) -> int:
        """Pieces of one step block, every pass's."""
        return sum(ps.nh + ps.nt for ps in self.passes)

    @property
    def qmax(self) -> int:
        return max(ps.q for ps in self.passes)

    @property
    def threads(self) -> int:
        return -(-self.cw // self.vec * self.tps // 32) * 32

    @property
    def chunks(self) -> int:
        return -(-self.w // self.cw)

    @property
    def runs(self) -> int:
        return -(-self.n_t // self.run)

    @property
    def blocks(self) -> int:
        return self.chunks * self.runs

    def run_lengths(self) -> list[int]:
        return [min(self.run, self.n_t - t0) for t0 in range(0, self.n_t, self.run)]

    def pieces(self, tiles: int | None = None) -> int:
        """Piece slots of a block of ``tiles`` tiles (a full run by default)."""
        tiles = self.run if tiles is None else tiles
        return (tiles + self.qmax) * self.group_pieces

    def phases(self, tiles: int | None = None) -> int:
        """Pieces a thread takes in turn, one a phase."""
        return -(-self.pieces(tiles) // self.tps)

    @property
    def smem(self) -> int:
        """A slot of cw / 2 words a piece, bytes."""
        return self.pieces() * self.cw * 2

    def rows_read(self, tiles: int) -> int:
        """Source rows a block of ``tiles`` tiles reads, every pass's: the
        union of its windows."""
        return sum(_union(ps, tiles, self.step) for ps in self.passes)

    @property
    def unique_rows(self) -> int:
        return self.rows_read(self.n_t)

    @property
    def reread(self) -> float:
        """Rows read beyond each window row once (the halos at run ends), over
        those rows."""
        got = sum(self.rows_read(r) for r in self.run_lengths())
        return got / self.unique_rows - 1 if self.unique_rows else 0.0

    @property
    def resident(self) -> int:
        """Blocks an SM holds at once: by threads, registers (``WALK_REGS``
        a thread) and shared memory."""
        return max(1, min(32, 2048 // self.threads, 65536 // (self.threads * WALK_REGS),
                          WALK_SMEM // max(1, self.smem)))

    @property
    def wave_efficiency(self) -> float:
        """Blocks over the SMs' slots (``resident`` blocks an SM) of the waves
        they take."""
        slots = self.sms * self.resident
        return self.blocks / (slots * -(-self.blocks // slots))

    def summary(self) -> dict:
        return {"vec": self.vec, "cw": self.cw, "run": self.run, "threads": self.threads,
                "phases": self.phases(), "blocks": self.blocks, "resident": self.resident,
                "smem": self.smem,
                "wave_efficiency": self.wave_efficiency, "reread": self.reread}


def _union(ps: WalkPass, tiles: int, step: int) -> int:
    """Rows in the union of ``tiles`` consecutive windows of a pass."""
    if ps.length == 0:
        return 0
    return tiles * ps.h if ps.q == 0 else (tiles - 1) * step + ps.length


@functools.lru_cache(maxsize=None)
def colsum_walk(variant: str, n_t: int, step: int, halo: int, w: int, vec: int = 16,
                sms: int = H100_SMS, cw: int | None = None,
                run: int | None = None) -> ColsumWalk:
    """The walk's launch for one call: chunks of ``WALK_CHUNK`` bytes (or the
    smallest power of two, at least 16, that holds a narrower ``w``), runs
    of ``WALK_RUN`` tiles (fewer where the plane has fewer, or where the
    run's slots do not fit shared memory), and the thread rows that give
    each thread ``WALK_PHASES`` pieces, or more where ``WALK_MAX_THREADS``
    threads cannot hold them; ``cw`` and ``run`` fix either."""
    if variant not in VARIANTS or vec not in (4, 16) or w % vec or n_t < 1 or step < 1 \
            or halo < 0:
        raise ValueError(f"no walk for {variant} n_t={n_t} step={step} halo={halo} w={w} "
                         f"vec={vec}")
    if cw is None:
        cw = min(WALK_CHUNK, max(16, vec, 1 << (w - 1).bit_length()))
    if cw not in WALK_CHUNKS or cw < vec or cw // vec > WALK_MAX_THREADS:
        raise ValueError(f"no walk of chunk {cw} with {vec}-byte loads")
    rows_max = WALK_MAX_THREADS // (cw // vec)               # thread rows a block holds
    for r in ([run] if run is not None else range(min(WALK_RUN, n_t), 0, -1)):
        probe = ColsumWalk(variant, n_t, step, halo, w, vec, cw, r, 1, sms)
        wk = dataclasses.replace(probe, tps=min(-(-probe.pieces() // WALK_PHASES), rows_max))
        if wk.smem <= WALK_SMEM:
            return wk
    raise ValueError(f"no walk of {variant} n_t={n_t} step={step} halo={halo} w={w} "
                     f"fits {WALK_SMEM} bytes of shared memory")


def colsum_model(x: np.ndarray, variant: str, n_t: int, step: int, halo: int,
                 y: np.ndarray | None = None,
                 walk: ColsumWalk | None = None) -> tuple[np.ndarray, dict]:
    """The walk in NumPy, in the kernel's order: each block's phases, every
    thread row's piece of the phase (its column sums, each within the packed
    16 bits, written to the piece's slot), then the stores of the tiles
    whose step blocks' pieces are all summed, each tile's sum added up from
    its window's slots in uint32; raises if a store reads a slot no piece
    has written, or a piece writes a slot twice.  Returns out (8 n_t, w)
    int32 and {"writes": (n_t, w) stores a tile and column, "rows_read":
    source rows read, every block's, "reread": the rows read beyond each
    window row of each chunk once, over those, "walk": the launch}."""
    y = x if y is None else y
    w = x.shape[1]
    walk = walk or colsum_walk(variant, n_t, step, halo, w, 16 if w % 16 == 0 else 4)
    planes = (x, y)
    passes, nug, kr = walk.passes, walk.group_pieces, walk.rows_piece
    nu0 = passes[0].nh + passes[0].nt
    out = np.zeros((8 * n_t, w), np.uint32)
    writes = np.zeros((n_t, w), np.int64)
    rows_read = 0
    for b in range(walk.blocks):
        c0 = b % walk.chunks * walk.cw
        cols = slice(c0, min(c0 + walk.cw, w))
        t0 = b // walk.chunks * walk.run
        R = min(walk.run, n_t - t0)
        G = R + walk.qmax
        pieces = G * nug
        phases = -(-pieces // walk.tps)
        slots: dict = {}
        emitted = 0
        for ph in range(phases):
            for i in range(ph * walk.tps, min((ph + 1) * walk.tps, pieces)):
                g, j = divmod(i, nug)
                p = 0 if j < nu0 else 1
                jj = j - (nu0 if p else 0)
                ps = passes[p]
                if g >= R + ps.q or (jj >= ps.nh and g == R + ps.q - 1):
                    continue
                if jj < ps.nh:
                    lo = jj * kr
                    n = min(kr, ps.h - lo)
                else:
                    lo = ps.h + (jj - ps.nh) * kr
                    n = min(kr, step - lo)
                r0 = (t0 + g) * step + ps.alpha + lo
                sums = planes[ps.plane][r0:r0 + n, cols].astype(np.uint64).sum(0)
                if sums.size and sums.max() > 0xFFFF:
                    raise AssertionError(f"a piece's column sum {sums.max()} overflows 16 bits")
                if i in slots:
                    raise AssertionError(f"block {b}: piece {i} written twice")
                rows_read += n
                slots[i] = sums
            done = G if ph + 1 >= phases else min(G, (ph + 1) * walk.tps // nug)
            ready = min(R, done - walk.qmax)
            for k in range(emitted, ready):
                v = np.zeros(cols.stop - c0, np.uint64)
                for p, ps in enumerate(passes):
                    off = nu0 if p else 0
                    for g in range(k, k + ps.q + 1):
                        for j in range(ps.nh + ps.nt if g < k + ps.q else ps.nh):
                            i = g * nug + off + j
                            if i not in slots:
                                raise AssertionError(f"block {b}: tile {t0 + k} stored before "
                                                     f"piece {i} is summed")
                            v = v + slots[i]
                out[8 * (t0 + k):8 * (t0 + k) + 8, cols] = (v & 0xFFFFFFFF).astype(np.uint32)
                writes[t0 + k, cols] += 1
            emitted = max(emitted, ready)
        if emitted != R:
            raise AssertionError(f"block {b}: {emitted} of {R} tiles stored")
    return out.view(np.int32), {"writes": writes, "rows_read": rows_read, "walk": walk,
                                "reread": rows_read / (walk.unique_rows * walk.chunks) - 1}


@functools.cache
def _walk_lib(device: torch.device):
    """The probes' library with the walk's shared-memory limit raised on
    ``device``, after checking its compiled constants against this module's."""
    lib = _harness.lib_with_setup("iqo_exp_band_colsum_walk_setup", device)
    got = (ctypes.c_int * 3)()
    _harness.check_rc(lib.iqo_exp_band_colsum_walk_shape(got), "band_colsum_walk_shape")
    want = (WALK_MAX_THREADS, WALK_PIECE_BYTES, WALK_SMEM)
    if tuple(got) != want:
        raise RuntimeError(f"exp_band.cu's walk constants {tuple(got)} != {want}")
    return lib


def band_colsum(x: torch.Tensor, variant: str, n_t: int, step: int, halo: int,
                y: torch.Tensor | None = None, form: str | None = None,
                walk: ColsumWalk | None = None) -> torch.Tensor:
    """Kernel H: x (rows, w) u8 (and blocked2's halo plane ``y``, x if None)
    -> (8 n_t, w) int32, in ``form`` (``"walk"``, the default, or
    ``"grid"``); ``walk`` fixes the walk's launch (:func:`colsum_walk` by
    default).  A CPU tensor takes :func:`band_colsum_plain`; a CUDA tensor
    launches the kernel (w a multiple of 4) or raises."""
    form = FORMS[0] if form is None else form
    if form not in FORMS:
        raise ValueError(f"band_colsum takes form 'walk' or 'grid', got {form!r}")
    y = x if y is None else y
    _check(x, y, variant, n_t, step, halo)
    if walk is not None and (walk.variant, walk.n_t, walk.step, walk.halo, walk.w) != \
            (variant, n_t, step, halo, x.shape[1]):
        raise ValueError(f"the walk {walk} is another call's")
    if not _harness.on_card(x, y):
        return band_colsum_plain(x, variant, n_t, step, halo, y)
    w = x.shape[1]
    if w % 4:
        raise ValueError(f"the kernel takes w a multiple of 4, got {w}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("band_colsum takes contiguous tensors")
    out = torch.empty((8 * n_t, w), dtype=torch.int32, device=x.device)
    if form == "grid":
        _harness.check_rc(_harness.lib().iqo_exp_band_colsum(
            VARIANTS.index(variant), x.data_ptr(), y.data_ptr(), out.data_ptr(), w,
            n_t, step, halo, _harness.stream(x)), f"band_colsum[{variant}]")
    else:
        vec = 16 if w % 16 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0 else 4
        wk = walk or colsum_walk(variant, n_t, step, halo, w, vec, sm_count(x.device))
        _harness.check_rc(_walk_lib(x.device).iqo_exp_band_colsum_walk(
            VARIANTS.index(variant), x.data_ptr(), y.data_ptr(), out.data_ptr(), w, n_t,
            step, halo, wk.vec, wk.cw, wk.run, wk.tps, _harness.stream(x)),
            f"band_colsum[{variant},walk]")
    LAUNCHES.add(launch_key(variant, form))
    return out


def library(x: torch.Tensor, variant: str, n_t: int, step: int, halo: int) -> torch.Tensor:
    """One PyTorch call computing the probe's sums: an int32 sum over a
    strided view of the windows (the step rows for blocked1; for blocked2
    the probe's halo plane is x itself), expanded to 8 rows as a view,
    (n_t, 8, w)."""
    rows = step if variant == "blocked1" else step + halo
    v = x.as_strided((n_t, rows, x.shape[1]), (step * x.shape[1], x.shape[1], 1))
    return v.sum(1, dtype=torch.int32)[:, None].expand(n_t, 8, x.shape[1])


def sources(device, configs=CONFIGS):
    """(name, n_t, step, halo, w, variant, x) for every config and variant,
    each x (n_t step + halo, w) uint8 drawn anew from one seed-0 generator
    in the script's order (``main``, ``:123-136``)."""
    rng = np.random.default_rng(0)
    for name, n_t, step, halo, w in configs:
        for variant in VARIANTS:
            x = rng.integers(0, 256, (n_t * step + halo, w), np.uint8)
            yield name, n_t, step, halo, w, variant, torch.from_numpy(x).to(device)


def bound(variant: str, n_t: int, step: int, halo: int,
          w: int) -> tuple[float, str, int, int]:
    """(ms, 'bytes', bytes, bytes fetched): the rows the variant reads
    (their union) once and the output once at 3.35 TB/s; and the bytes its
    windows fetch, halo rows re-read (the script's "MB")."""
    extra = 0 if variant == "blocked1" else halo
    nbytes = (n_t * step + extra) * w + 8 * n_t * w * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes, n_t * (step + extra) * w


def main() -> dict:
    """Every config and variant on card 0, both forms held to the plain
    version and timed in turns with :func:`library` (held equal to it
    first); returns {"<config> <variant>": {ms (the walk), grid_ms,
    library_ms, bound_ms, ..., walk}}."""
    _harness.require_card()
    card = _harness.card()
    found = {}
    for name, n_t, step, halo, w, variant, x in sources(torch.device("cuda", 0)):
        xs = _harness.perturbed(x, ITERS)
        want = band_colsum_plain(xs[-1], variant, n_t, step, halo)
        for form in FORMS:
            if not torch.equal(band_colsum(xs[-1], variant, n_t, step, halo, form=form), want):
                raise AssertionError(f"{name} {variant}: the {form} kernel differs from its "
                                     "plain version")
        if not torch.equal(library(xs[-1], variant, n_t, step, halo).reshape(8 * n_t, w), want):
            raise AssertionError(f"{name} {variant}: the library call differs from the plain "
                                 "version")
        walk = colsum_walk(variant, n_t, step, halo, w, 16, sm_count(x.device))
        ms = _harness.turns_ms({
            "walk": (lambda v: band_colsum(v, variant, n_t, step, halo), xs),
            "grid": (lambda v: band_colsum(v, variant, n_t, step, halo, form="grid"), xs),
            "library": (lambda v: library(v, variant, n_t, step, halo), xs)})
        b_ms, by, nbytes, fetched = bound(variant, n_t, step, halo, w)
        wk = walk.summary()
        print(f"{name:11s} {variant}: walk {ms['walk'] * 1e3!r} us ({b_ms / ms['walk']!r} of "
              f"the bound's pace), grid {ms['grid'] * 1e3!r} us ({fetched / 1e6!r}MB fetched, "
              f"{fetched / 1e9 / (ms['grid'] * 1e-3)!r}GB/s), library "
              f"{ms['library'] * 1e3!r} us, in turns; bound {b_ms * 1e3!r} us ({by}); walk "
              f"chunk {wk['cw']} B x run {wk['run']} tiles, {wk['threads']} threads, "
              f"{wk['phases']} phases, {wk['blocks']} blocks, wave efficiency "
              f"{wk['wave_efficiency']!r}, rows re-read {wk['reread']!r} ({card})", flush=True)
        found[f"{name} {variant}"] = {"ms": ms["walk"], "grid_ms": ms["grid"],
                                      "library_ms": ms["library"], "bound_ms": b_ms,
                                      "bound_by": by, "bytes": nbytes, "fetched": fetched,
                                      "walk": wk}
    for name, *_ in CONFIGS:
        for form, key in (("walk", "ms"), ("grid", "grid_ms")):
            e = found[f"{name} element"][key]
            print(f"{name:11s} [{form}] blocked2/element "
                  f"{found[f'{name} blocked2'][key] / e!r}, blocked1/element "
                  f"{found[f'{name} blocked1'][key] / e!r} ({card})", flush=True)
    return found


if __name__ == "__main__":
    main()
