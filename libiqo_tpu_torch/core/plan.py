"""Resize plans: geometry -> exact integer tap tables, built once per shape.

The port's copy of ``libiqo_tpu/core/plan.py`` (the same plans, field for
field), plus :func:`plan_from_arrays`, which carries a plan built elsewhere
into this module's types.

A :class:`ResizePlan` is the analog of the reference's construct-once
resizer state (ref: include/libiqo/LanczosResizer.hpp:17-25): all
geometry-dependent work — gcd reduction, tap counts, quantized phase tables,
border ranges and denominators — happens here on the host, once.  The device
paths (the plain PyTorch path, the CUDA kernel) are pure compute over these
tables.

Per-axis contract (one :class:`AxisPlan` each for H and W):

* ``coef[d, i]``  int32 quantized tap i of output coordinate d, with taps
  whose source index falls outside [0, n_src) zeroed (the reference instead
  skips them at runtime, ref: src/IQOLanczosResizerImpl_Generic.cpp:563-570).
* ``start[d]``    first source index of output d's tap window.
* ``deno[d]``     the in-range tap sum used by border renormalization
  (== ``bias`` for main outputs, by the exact-sum quantization guarantee).
* ``is_border[d]`` whether output d takes the border epilogue (integer
  divide by deno) instead of the main epilogue (shift round).

Fixed-point contract per algorithm (the bias bits below are the observable
output semantics, ref SURVEY.md §3.3):

===========  =======  =======  ==========================================
algorithm    Y bias   X bias   epilogues
===========  =======  =======  ==========================================
lanczos      2**6     2**14    signed; int16 wrap in Y; border renorm both
area         2**8     2**15    unsigned; no borders
linear       2**8     2**15    unsigned; borders replicate edge (folded)
===========  =======  =======  ==========================================
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..coeffs import engine, native

__all__ = ["AxisPlan", "ResizePlan", "build_plan", "plan_from_arrays"]


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    n_src: int
    n_dst: int
    num_coefs: int
    num_tables: int          # distinct phases (= reduced dst length)
    coef: np.ndarray         # int32 (n_dst, num_coefs), OOB taps zeroed
    start: np.ndarray        # int64 (n_dst,)
    deno: np.ndarray         # int32 (n_dst,)
    is_border: np.ndarray    # bool  (n_dst,)
    bias_bit: int
    main_begin: int = 0      # border/main split (diagnostics; baked into masks)
    main_end: int = 0
    # True when the reference would read out of bounds (UB) for this axis —
    # we clamp instead, so outputs legitimately diverge there.
    reference_oob: bool = False

    @property
    def bias(self) -> int:
        return 1 << self.bias_bit

    def dense(self, dtype=np.float32) -> np.ndarray:
        """Materialize the (n_dst, n_src) banded coefficient matrix."""
        m = np.zeros((self.n_dst, self.n_src), dtype=np.int64)
        for i in range(self.num_coefs):
            src = self.start + i
            ok = (src >= 0) & (src < self.n_src)
            d = np.nonzero(ok)[0]
            # += not =: adjacent taps of one output can hit the same source
            # index only if starts repeat, which they don't within a window;
            # plain assignment would still be safe but += is future-proof.
            np.add.at(m, (d, src[ok]), self.coef[d, i])
        return m.astype(dtype)


def _expand_phases(
    tables: np.ndarray, n_dst: int
) -> np.ndarray:
    """Tile per-phase tap tables out to one row per output coordinate.

    The reference walks the phase table cyclically in output order
    (ref: src/IQOLanczosResizerImpl_Generic.cpp:403-406), i.e. output d uses
    phase d % num_tables.
    """
    num_tables = tables.shape[0]
    idx = np.arange(n_dst, dtype=np.int64) % num_tables
    return tables[idx]


def _clip_oob(coef: np.ndarray, start: np.ndarray, n_src: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero taps whose source index is out of range; return (coef, in-range sums)."""
    num_coefs = coef.shape[1]
    src = start[:, None] + np.arange(num_coefs, dtype=np.int64)[None, :]
    ok = (src >= 0) & (src < n_src)
    kept = np.where(ok, coef, 0)
    return kept.astype(np.int32), kept.sum(axis=1, dtype=np.int64).astype(np.int32)


def _expand_phases_at(tables: np.ndarray, it: np.ndarray) -> np.ndarray:
    """Phase rows for explicit iterator positions (cyclic)."""
    return tables[it % tables.shape[0]]


def _axis_lanczos(degree: int, src_len: int, dst_len: int, px_scale: int,
                  bias_bit: int, is_vertical: bool) -> AxisPlan:
    """Lanczos axis (ref: src/IQOLanczosResizerImpl_Generic.cpp:291-339).

    When src_len == dst_len the reference bypasses this axis entirely and
    just scales by kBias (ref: :378-388,520-527); an identity single-tap
    plan reproduces that exactly.
    """
    bias = 1 << bias_bit
    if src_len == dst_len:
        n = src_len
        return AxisPlan(
            n_src=n, n_dst=n, num_coefs=1, num_tables=1,
            coef=np.full((n, 1), bias, dtype=np.int32),
            start=np.arange(n, dtype=np.int64),
            deno=np.full(n, bias, dtype=np.int32),
            is_border=np.zeros(n, dtype=bool),
            bias_bit=bias_bit,
            main_begin=0, main_end=n,
        )

    g = engine.gcd(src_len, dst_len)
    r_src, r_dst = src_len // g, dst_len // g
    num_coefs = engine.calc_num_coefs_lanczos(degree, r_src, r_dst, px_scale)

    tables = native.lanczos_tables(degree, r_src, r_dst, px_scale, num_coefs, bias)
    if tables is None:
        tables = np.empty((r_dst, num_coefs), dtype=np.int32)
        for d in range(r_dst):
            taps, f_sum = engine.set_lanczos_table(degree, r_src, r_dst, d, px_scale, num_coefs)
            tables[d] = engine.adjust_coefs(taps, f_sum, bias)

    n_on2 = num_coefs // 2
    # main region: ceil((n_on2-1)*dst/src) .. floor((src-n_on2)*dst/src)
    # (ref: :392-393,531-532)
    main_begin = ((n_on2 - 1) * dst_len + src_len - 1) // src_len
    main_end = max(0, (src_len - n_on2) * dst_len // src_len)

    # Y-axis iterator-shift quirk: when main_end < main_begin (extreme
    # downscales), the reference's second border loop continues a *stale*
    # LinearIterator/table cursor — it has advanced main_begin steps but the
    # loop restarts at dstY = main_end, so rewritten rows use iterator
    # position dstY + (main_begin - main_end)
    # (ref: src/IQOLanczosResizerImpl_Generic.cpp:396-453: iTable/iSrcOY are
    # shared across the three row loops, unlike resizeX which re-seeds).
    # The X axis re-seeds per region (ref: :546-549) and needs no shift.
    d = np.arange(dst_len, dtype=np.int64)
    shift = max(0, main_begin - main_end) if is_vertical else 0
    it = d + np.where(d >= main_end, shift, 0)

    coef = _expand_phases_at(tables, it)
    # srcOY = floor(it*srcLen/dstLen) + 1; window starts n_on2 before it
    # (ref: :401,480)
    start = (it * src_len) // dst_len + 1 - n_on2
    coef, deno = _clip_oob(coef, start, src_len)
    if is_vertical:
        # The reference's Y-border denominator accumulates in int16_t and
        # wraps for pathological px_scale phases whose in-range |tap| sums
        # exceed 32767 (ref: src/IQOLanczosResizerImpl_Generic.cpp:482-483:
        # ``deno[dstX] = int16_t(deno[dstX] + coef)``).  The X-border deno
        # is int32 (ref: :560-570) and needs no wrap.
        deno = (((deno.astype(np.int64) + 32768) & 65535) - 32768).astype(np.int32)

    is_border = (d < main_begin) | (d >= main_end)
    return AxisPlan(src_len, dst_len, num_coefs, r_dst, coef, start,
                    deno, is_border, bias_bit,
                    main_begin=main_begin, main_end=main_end)


def _axis_area(src_len: int, dst_len: int, bias_bit: int) -> AxisPlan:
    """Area axis (ref: src/IQOAreaResizerImpl_Generic.cpp:174-220).

    No border regions: the box window is always interior for downsampling
    (ref: :277-294); trailing +1 taps are zero-weight so OOB clipping is a
    no-op numerically.  src_len == dst_len reduces to an exact identity via
    the normal path (single tap == bias).
    """
    bias = 1 << bias_bit
    if src_len == dst_len:
        n = src_len
        return AxisPlan(
            n_src=n, n_dst=n, num_coefs=1, num_tables=1,
            coef=np.full((n, 1), bias, dtype=np.int32),
            start=np.arange(n, dtype=np.int64),
            deno=np.full(n, bias, dtype=np.int32),
            is_border=np.zeros(n, dtype=bool),
            bias_bit=bias_bit,
            main_begin=0, main_end=n,
        )
    g = engine.gcd(src_len, dst_len)
    r_src, r_dst = src_len // g, dst_len // g
    num_coefs = engine.calc_num_coefs_area(r_src, r_dst)
    tables = native.area_tables(r_src, r_dst, num_coefs, bias)
    if tables is None:
        tables = np.empty((r_dst, num_coefs), dtype=np.int32)
        for d in range(r_dst):
            taps, f_sum = engine.set_area_table(r_src, r_dst, d, num_coefs)
            tables[d] = engine.adjust_coefs(taps, f_sum, bias, signed=False)
    coef = _expand_phases(tables, dst_len)
    start = engine.src_origin_floor(dst_len, src_len, dst_len)  # (ref: :279-280)
    coef, deno = _clip_oob(coef, start, src_len)
    return AxisPlan(src_len, dst_len, num_coefs, r_dst, coef, start, deno,
                    np.zeros(dst_len, dtype=bool), bias_bit,
                    main_begin=0, main_end=dst_len)


def _axis_linear(src_len: int, dst_len: int, bias_bit: int) -> AxisPlan:
    """Linear axis (ref: src/IQOLinearResizerImpl_Generic.cpp:157-208).

    The reference's border outputs replicate the edge pixel
    (ref: :290-299,355-366); that folds exactly into a single full-bias tap
    on source pixel 0 / n_src-1, because
    (w*bias_x + half) >> shift == (w + 128) >> 8 identically.

    Main outputs use the center-aligned LinearIterator origin.  The
    reference reads out of bounds when an upscale factor exceeds 3x (srcO
    can be -1 at dst=1, UB in C++); we clamp the window into range and
    document the divergence — for factors <= 3x outputs are identical.
    """
    bias = 1 << bias_bit
    g = engine.gcd(src_len, dst_len)
    r_src, r_dst = src_len // g, dst_len // g
    tables = native.linear_tables(r_src, r_dst, bias)
    if tables is None:
        taps_f = engine.set_linear_table(r_src, r_dst)
        tables = engine.adjust_coefs_linear(taps_f, bias)  # (r_dst, 2)
    coef = _expand_phases(tables, dst_len).astype(np.int64)
    start = engine.src_origin_centered(dst_len, src_len, dst_len)

    # border outputs: mainBegin==1 for every geometry (convertCoordinate is
    # called with toLen=0 so it always yields ceil(0.5)==1,
    # ref: :236-238,339-341); mainEnd = dst_len - 1.  When dst_len == 1 the
    # reference's border loops overlap (mainBegin=1 > mainEnd=0) and the
    # hi-border loop runs second, rewriting output 0 with the LAST source
    # pixel (ref: :274-281,343-345) — so main_end may drop below main_begin
    # and the hi assignment below must come after the lo assignment.
    main_begin = min(1, dst_len)
    main_end = max(0, dst_len - main_begin)
    # clamp OOB windows (reference UB: >3x upscales put srcO at -1, and the
    # setX seeding quirk can push srcO past src_len-2 on strong gcd=1
    # downscales) into range; must precede the border assignments, whose
    # single tap sits at src_len-1
    d = np.arange(dst_len, dtype=np.int64)
    main = (d >= main_begin) & (d < main_end)
    reference_oob = bool(
        (start[main] < 0).any() or (start[main] > src_len - 2).any()
    )
    start = np.clip(start, 0, max(0, src_len - 2))
    lo = d < main_begin
    hi = d >= main_end
    coef[lo] = [bias, 0]
    start[lo] = 0
    coef[hi] = [bias, 0]
    start[hi] = src_len - 1

    coef, deno = _clip_oob(coef.astype(np.int32), start, src_len)
    # Rows whose window was clamped away from the reference's OOB read (UB
    # there, so the behavior is ours to define): replicate the nearest
    # in-range pixel instead of leaving an underweighted window.
    if reference_oob:
        short = deno != bias
        coef[short] = [bias, 0]
        deno[short] = bias
    return AxisPlan(src_len, dst_len, 2, r_dst, coef, start, deno,
                    np.zeros(dst_len, dtype=bool), bias_bit,
                    main_begin=main_begin, main_end=main_end,
                    reference_oob=reference_oob)


@dataclasses.dataclass(frozen=True)
class ResizePlan:
    """Full 2-D separable plan: vertical pass then horizontal pass.

    ``wrap16`` marks the Lanczos int16 work-row wraparound, which is part of
    the observable Generic output (ref: src/IQOLanczosResizerImpl_Generic.cpp:513
    accumulates ``int16_t(dst[dstX] + src*coef)``).
    """
    algorithm: str
    y: AxisPlan
    x: AxisPlan
    signed: bool          # lanczos taps can be negative
    wrap16: bool          # emulate int16 work-row wrap (lanczos only)
    degree: int = 0
    px_scale: int = 1

    @property
    def out_shift(self) -> int:
        return self.y.bias_bit + self.x.bias_bit

    @property
    def geometry(self):
        return (self.y.n_src, self.x.n_src, self.y.n_dst, self.x.n_dst)

    def cache_key(self):
        return (self.algorithm, self.degree, self.px_scale) + self.geometry


def build_plan(
    algorithm: str,
    src_w: int, src_h: int,
    dst_w: int, dst_h: int,
    *,
    degree: int = 3,
    px_scale: int = 1,
) -> ResizePlan:
    """Build the exact integer plan for one geometry.

    Mirrors the constructors of the three facades
    (ref: include/libiqo/{Lanczos,Area,Linear}Resizer.hpp).
    """
    for name, v in (("src_w", src_w), ("src_h", src_h), ("dst_w", dst_w), ("dst_h", dst_h)):
        if v <= 0:
            raise ValueError(f"{name} must be positive, got {v}")
    if algorithm == "lanczos":
        if degree < 1:
            raise ValueError(f"lanczos degree must be >= 1, got {degree}")
        if px_scale < 1:
            raise ValueError(f"px_scale must be >= 1, got {px_scale}")
        y = _axis_lanczos(degree, src_h, dst_h, px_scale, bias_bit=6, is_vertical=True)
        x = _axis_lanczos(degree, src_w, dst_w, px_scale, bias_bit=14, is_vertical=False)
        return ResizePlan("lanczos", y, x, signed=True, wrap16=True,
                          degree=degree, px_scale=px_scale)
    if algorithm == "area":
        y = _axis_area(src_h, dst_h, bias_bit=8)
        x = _axis_area(src_w, dst_w, bias_bit=15)
        return ResizePlan("area", y, x, signed=False, wrap16=False)
    if algorithm == "linear":
        y = _axis_linear(src_h, dst_h, bias_bit=8)
        x = _axis_linear(src_w, dst_w, bias_bit=15)
        return ResizePlan("linear", y, x, signed=False, wrap16=False)
    raise ValueError(f"unknown algorithm {algorithm!r}")


_AXIS_INTS = ("n_src", "n_dst", "num_coefs", "num_tables", "bias_bit",
              "main_begin", "main_end")
_AXIS_ARRAYS = {"coef": np.int32, "start": np.int64, "deno": np.int32,
                "is_border": bool}


def _axis_from_arrays(ax) -> AxisPlan:
    return AxisPlan(
        **{k: int(getattr(ax, k)) for k in _AXIS_INTS},
        **{k: np.array(getattr(ax, k), dtype=t, copy=True)
           for k, t in _AXIS_ARRAYS.items()},
        reference_oob=bool(ax.reference_oob))


def plan_from_arrays(obj) -> ResizePlan:
    """This module's :class:`ResizePlan` from any plan object with the same
    fields (e.g. one built by the JAX package), read by attribute: the plan's
    ``algorithm``, ``signed``, ``wrap16``, ``degree`` and ``px_scale``, and
    per axis ``n_src``, ``n_dst``, ``num_coefs``, ``num_tables``, ``coef``,
    ``start``, ``deno``, ``is_border``, ``bias_bit``, ``main_begin``,
    ``main_end`` and ``reference_oob``.  The arrays are copied."""
    return ResizePlan(str(obj.algorithm), _axis_from_arrays(obj.y),
                      _axis_from_arrays(obj.x), signed=bool(obj.signed),
                      wrap16=bool(obj.wrap16), degree=int(obj.degree),
                      px_scale=int(obj.px_scale))
