"""What the card's tensor cores give a hand-written kernel in f32 (TF32),
bf16, s8 -> s32 and s8 -> f32, at one shape.

Port of ``scripts/exp_int8_mxu.py`` to one NVIDIA H100.  Kernel C,
``mma_steps(a, bt, acc, form=None)``: ``out[t] = a[t] @ b`` for every step
t, with ``b`` held K-major as ``bt = k_major(b)`` (laid out once, as the TPU
kernel kept ``b`` resident); replaces ``make`` (``pl.pallas_call`` at
``:29``).  Two forms (:data:`FORMS`):

* ``"wgmma"``, the default (``libiqo_tpu_torch/csrc/exp/exp_mma_wgmma.cu``):
  a persistent grid of one block an SM walking 128 x 256 output tiles
  (:func:`tile_walk`), a producer warp's TMA loads of 128-byte K chunks into
  a ring of 4 stages, two consumer warpgroups' wgmma on the swizzled tiles,
  and the tile handed to TMA bulk stores through a staging in shared memory;
  M a multiple of 128, N of 256, K of 128 bytes
  (:data:`WGMMA` states the geometry, :func:`wgmma_model` walks it in
  NumPy);
* ``"mma_sync"``, the first form (``csrc/exp/exp_mma.cu``): 64 x 64 tiles of 4
  warps, ``mma.sync`` on fragments from shared memory; M and N multiples of
  64, K of 128 bytes.

:data:`LAUNCHES` counts each row's ``mma_sync`` launches under the row's
name and the ``wgmma`` form's under ``row[wgmma]``.  Rows, as the script's
``__main__`` (``:68-82``): ``f32xf32->f32`` (the script's ``"bf16 -> f32"``
row at ``:71``, whose inputs are float32: TF32 here, exact on its integer
inputs), ``bf16xbf16->f32``, ``s8xs8->i32`` and ``s8xs8->f32`` (int32 sums
converted at the store: Hopper has no s8 -> f32 product).  Each row times
both forms and the row's PyTorch call (:func:`library`) in turns, each over
back-to-back calls on inputs that each differ in ``a[0, 0, 0]``, as the
script's loop does, holds each one's output to the plain version, and prints
the effective multiply-adds per second (``:64-65``) beside the row's bound.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_int8_mxu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from . import _harness
from ._harness import (BF16_OPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S,
                       TF32_OPS_PER_S, Launches, wrap)

__all__ = ["FORMS", "LAUNCHES", "ROWS", "WGMMA", "k_major", "launch_key", "library", "main",
           "mma_steps", "mma_steps_plain", "tile_walk", "wgmma_model"]

M, K, N = 256, 1024, 512
STEPS = 64
ITERS = 8                  # launches per timed run, as the script's fori_loop
# row: (input dtype, accumulator dtype)
ROWS = {"f32xf32->f32": (torch.float32, torch.float32),
        "bf16xbf16->f32": (torch.bfloat16, torch.float32),
        "s8xs8->i32": (torch.int8, torch.int32),
        "s8xs8->f32": (torch.int8, torch.float32)}
_KIND = {dt: i for i, dt in enumerate(ROWS.values())}
PEAK = {torch.float32: TF32_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S,
        torch.int8: INT8_OPS_PER_S}
_F32_EXACT = 2**24         # f32 sums of integers are exact below this
_TF32_EXACT = 2**11        # integers TF32 holds exactly
FORMS = ("wgmma", "mma_sync")   # the first is the default
H100_SMS = 132


def launch_key(row: str, form: str) -> str:
    """The :data:`LAUNCHES` key of a row's form: the row's name for the first,
    ``mma_sync`` form, ``row[form]`` otherwise."""
    return row if form == "mma_sync" else f"{row}[{form}]"


LAUNCHES = Launches([launch_key(r, f) for f in reversed(FORMS) for r in ROWS])


@dataclasses.dataclass(frozen=True)
class WgmmaGeometry:
    """The wgmma form's geometry, as ``exp_mma_wgmma.cu`` states it."""
    bm: int = 128           # output tile rows (2 consumer warpgroups of 64)
    bn: int = 256           # output tile columns (2 wgmma m64n128 a warpgroup)
    kc: int = 128           # bytes of K a stage
    stages: int = 4
    consumers: int = 2      # warpgroups
    out_cols: int = 64      # columns a warpgroup stages for its TMA stores, a pass

    @property
    def threads(self) -> int:
        return 128 * self.consumers + 32           # + the producer warp

    @property
    def stage_bytes(self) -> int:
        return (self.bm + self.bn) * self.kc

    @property
    def out_bytes(self) -> int:
        """One warpgroup's staging of its 64 rows for the TMA stores."""
        return 64 * self.out_cols * 4

    @property
    def smem(self) -> int:
        return (self.stages * self.stage_bytes + self.consumers * self.out_bytes
                + 2 * self.stages * 8 + 1024)      # + barriers, slack

    def takes(self, m: int, n: int, kbytes: int) -> bool:
        return m % self.bm == 0 and n % self.bn == 0 and kbytes % self.kc == 0


WGMMA = WgmmaGeometry()


def reset_launches() -> None:
    LAUNCHES.reset()


def _row(in_dtype, acc_dtype) -> str:
    try:
        return list(ROWS)[_KIND[(in_dtype, acc_dtype)]]
    except KeyError:
        raise ValueError(f"no mma_steps row for {in_dtype} -> {acc_dtype}; "
                         f"rows: {list(ROWS)}") from None


def k_major(b: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (N, K) contiguous: the layout kernel C reads ``b`` in."""
    return b.t().contiguous()


def mma_steps_plain(a: torch.Tensor, bt: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """Kernel C's function in plain PyTorch: float64 products of integers,
    exact below 2^53, then the int32 wrap or the f32 conversion.  The float
    rows hold integers: their f32 sums are exact only while every output's
    sum of |terms| stays below 2^24 (TF32 also needs |x| <= 2^11), which is
    asserted here, so kernel and plain agree bit for bit."""
    row = _row(a.dtype, acc)
    ad, bd = a.to(torch.float64), bt.to(torch.float64)
    if a.dtype != torch.int8:
        for v in (ad, bd):
            if not torch.equal(v, v.round()):
                raise ValueError(f"{row}: the plain version takes integer values")
        if a.dtype == torch.float32 and max(ad.abs().max(), bd.abs().max()) > _TF32_EXACT:
            raise ValueError(f"{row}: |x| > 2^11 is not exact in TF32")
        worst = torch.matmul(ad.abs(), bd.abs().t()).max()
        if worst >= _F32_EXACT:
            raise ValueError(f"{row}: a sum of |terms| reaches {worst}, not "
                             "below 2^24: f32 sums would depend on their order")
    out = torch.matmul(ad, bd.t())
    if a.dtype == torch.int8:
        out = wrap(out.to(torch.int64), 32).to(torch.int32)
    return out.to(acc)


def tile_walk(steps: int, m: int, n: int, ctas: int) -> list[list[tuple[int, int, int]]]:
    """The wgmma form's persistent walk: for each of ``ctas`` blocks, its
    tiles (step, row tile, column tile) in order; tile t of the (steps M) x
    N product is row tile t // (N / 256), column tile t % (N / 256), and
    block b takes t = b, b + ctas, ..."""
    g = WGMMA
    n_tiles, m_tiles = n // g.bn, m // g.bm
    tiles = steps * m_tiles * n_tiles
    return [[(t // n_tiles // m_tiles, t // n_tiles % m_tiles, t % n_tiles)
             for t in range(b, tiles, ctas)] for b in range(ctas)]


def wgmma_ctas(steps: int, m: int, n: int, sms: int) -> int:
    """Blocks of the persistent grid: one an SM, at most one a tile."""
    return min(sms, steps * (m // WGMMA.bm) * (n // WGMMA.bn))


def wgmma_model(a: np.ndarray, bt: np.ndarray, in_dtype, acc: torch.dtype,
                sms: int = H100_SMS) -> np.ndarray:
    """The wgmma form's schedule in NumPy: block by block along
    :func:`tile_walk`, each tile summed K chunk (128 bytes) by K chunk in
    int64 from integer inputs ``a`` (steps, M, K) and ``bt`` (N, K), then
    the int32 wrap (s8 rows) or the f32 conversion."""
    g = WGMMA
    steps, m, k = a.shape
    n = bt.shape[0]
    kc = g.kc // torch.empty(0, dtype=in_dtype).element_size()
    out = np.zeros((steps, m, n), np.int64)
    seen = np.zeros((steps, m // g.bm, n // g.bn), np.int64)
    for tiles in tile_walk(steps, m, n, wgmma_ctas(steps, m, n, sms)):
        for step, mt, nt in tiles:
            rows, cols = slice(g.bm * mt, g.bm * (mt + 1)), slice(g.bn * nt, g.bn * (nt + 1))
            d = np.zeros((g.bm, g.bn), np.int64)
            for k0 in range(0, k, kc):
                d += a[step, rows, k0:k0 + kc].astype(np.int64) @ \
                    bt[cols, k0:k0 + kc].astype(np.int64).T
            out[step, rows, cols] = d
            seen[step, mt, nt] += 1
    if not (seen == 1).all():
        raise AssertionError("the walk did not cover every tile once")
    if in_dtype == torch.int8:
        out = (out + 2**31) % 2**32 - 2**31
        return out.astype(np.int32 if acc == torch.int32 else np.float32)
    return out.astype(np.float32)


def _form(form: str | None) -> str:
    if form is None:
        return FORMS[0]
    if form not in FORMS:
        raise ValueError(f"mma_steps takes form {FORMS}, got {form!r}")
    return form


@functools.cache
def _wgmma_lib(device: torch.device):
    """The probes' library with the wgmma form's shared memory raised on
    ``device``, its compiled geometry checked against :data:`WGMMA`."""
    import ctypes
    lib_ = _harness.lib_with_setup("iqo_exp_mma_wgmma_setup", device)
    got = (ctypes.c_int * 6)()
    lib_.iqo_exp_mma_wgmma_shape(got)
    want = [WGMMA.bm, WGMMA.bn, WGMMA.kc, WGMMA.stages, WGMMA.threads, WGMMA.smem]
    if list(got) != want:
        raise RuntimeError(f"exp_mma_wgmma.cu's geometry {list(got)} != the host's {want}")
    return lib_


def mma_steps(a: torch.Tensor, bt: torch.Tensor, acc: torch.dtype,
              form: str | None = None) -> torch.Tensor:
    """Kernel C: (steps, M, K) @ bt (N, K) -> (steps, M, N) of ``acc``, in
    ``form`` (:data:`FORMS`, ``"wgmma"`` by default).  A CPU tensor takes
    :func:`mma_steps_plain`; a CUDA tensor launches the form's kernel (wgmma:
    M a multiple of 128, N of 256, K of 128 bytes; mma_sync: M and N
    multiples of 64) or raises."""
    form = _form(form)
    row = _row(a.dtype, acc)
    if bt.dtype != a.dtype or a.ndim != 3 or bt.ndim != 2 or bt.shape[1] != a.shape[2]:
        raise ValueError(f"a (steps, M, K) and bt (N, K) of one dtype, got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(bt.shape)} {bt.dtype}")
    if not _harness.on_card(a, bt):
        return mma_steps_plain(a, bt, acc)
    steps, m, k = a.shape
    n = bt.shape[0]
    kbytes = k * a.element_size()
    if form == "wgmma" and not WGMMA.takes(m, n, kbytes):
        raise ValueError(f"the wgmma form takes M a multiple of {WGMMA.bm}, N of {WGMMA.bn} "
                         f"and K of {WGMMA.kc} bytes, got M={m} N={n} K={k}")
    if form == "mma_sync" and (m % 64 or n % 64 or kbytes % 128):
        raise ValueError(f"the mma_sync form takes M, N multiples of 64 and K of 128 "
                         f"bytes, got M={m} N={n} K={k}")
    if not (a.is_contiguous() and bt.is_contiguous()):
        raise ValueError("mma_steps takes contiguous tensors")
    out = torch.empty((steps, m, n), dtype=acc, device=a.device)
    kind = _KIND[(a.dtype, acc)]
    if form == "wgmma":
        ctas = wgmma_ctas(steps, m, n, torch.cuda.get_device_properties(a.device)
                          .multi_processor_count)
        rc = _wgmma_lib(a.device).iqo_exp_mma_wgmma(
            kind, a.data_ptr(), bt.data_ptr(), out.data_ptr(), steps, m, n, k, ctas,
            _harness.stream(a))
    else:
        rc = _harness.lib().iqo_exp_mma_steps(
            kind, a.data_ptr(), bt.data_ptr(), out.data_ptr(), steps, m, n, k,
            _harness.stream(a))
    _harness.check_rc(rc, f"mma_steps[{form}]")
    LAUNCHES.add(launch_key(row, form))
    return out


@contextlib.contextmanager
def _tf32(on: bool):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def library(row: str, b: torch.Tensor):
    """(one PyTorch call computing ``row``'s function of ``a`` with the
    row's ``b`` (K, N), its description, whether it is one call): s8 -> i32
    ``torch._int_mm`` with ``b`` column-major (the layout cuBLASLt's s8 path
    takes); s8 -> f32 the same and ``.to(float32)``, two calls, a yardstick;
    bf16 ``torch.mm(out_dtype=float32)``; f32 ``torch.mm`` on TF32, which
    :func:`main` turns on around it (exact on the integer inputs)."""
    in_dt, acc = ROWS[row]
    bcol = k_major(b).t() if in_dt == torch.int8 else b

    def flat(a):
        return a.view(-1, a.shape[-1])

    if in_dt == torch.int8:
        if acc == torch.int32:
            return (lambda a: torch._int_mm(flat(a), bcol).view(*a.shape[:2], -1),
                    "torch._int_mm (b column-major)", True)
        return (lambda a: torch._int_mm(flat(a), bcol).to(torch.float32).view(*a.shape[:2], -1),
                "torch._int_mm (b column-major) then .to(float32)", False)
    if in_dt == torch.bfloat16:
        return (lambda a: torch.mm(flat(a), bcol, out_dtype=torch.float32).view(*a.shape[:2], -1),
                "torch.mm(out_dtype=float32)", True)
    return (lambda a: torch.mm(flat(a), bcol).view(*a.shape[:2], -1),
            "torch.mm with allow_tf32", True)


def inputs(in_dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's inputs (``bench``, ``:41-44``): integers in [-100, 100)
    from seed 0, as ``in_dtype``."""
    rng = np.random.default_rng(0)
    a = rng.integers(-100, 100, (STEPS, M, K))
    b = rng.integers(-100, 100, (K, N))
    to = lambda v: torch.from_numpy(v.astype(np.float32)).to(device).to(in_dtype)  # noqa: E731
    return to(a), to(b)


def bound(in_dtype, acc_dtype) -> tuple[float, str, int, float]:
    """(ms, 'bytes' or 'operations', bytes, operations) of the least time
    the card could take for one launch at the module's shapes."""
    isz = torch.empty(0, dtype=in_dtype).element_size()
    osz = torch.empty(0, dtype=acc_dtype).element_size()
    nbytes = STEPS * M * K * isz + K * N * isz + STEPS * M * N * osz
    ops = 2.0 * STEPS * M * K * N
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK[in_dtype] * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, ops


def main() -> dict:
    """Every row on card 0, both forms and the row's library call in turns
    (order wgmma, mma_sync, library, then reversed; min of two each);
    returns {row: {ms, ms_mma_sync, library_ms, tmacs, bound_ms, ...}}."""
    _harness.require_card()
    card = _harness.card()
    dev = torch.device("cuda", 0)
    rows = {}
    for name, (in_dt, acc) in ROWS.items():
        a, b = inputs(in_dt, dev)
        bt = k_major(b)
        xs = _harness.perturbed(a, ITERS)
        lib_fn, lib_what, one_call = library(name, b)
        calls = {"wgmma": lambda x: mma_steps(x, bt, acc, "wgmma"),
                 "mma_sync": lambda x: mma_steps(x, bt, acc, "mma_sync"), "library": lib_fn}
        with _tf32(in_dt == torch.float32):
            want = mma_steps_plain(xs[-1], bt, acc)
            for what, fn in calls.items():
                if not torch.equal(fn(xs[-1]), want):
                    raise AssertionError(f"{name}: {what} differs from the plain version")
            times = {what: [] for what in calls}
            for what in list(calls) + list(calls)[::-1]:
                times[what].append(_harness.launches_ms(calls[what], xs))
        t = {what: min(v) for what, v in times.items()}
        ms = t["wgmma"]
        tmacs = STEPS * M * K * N / (ms * 1e-3) / 1e12
        b_ms, by, nbytes, ops = bound(in_dt, acc)
        print(f"{name:18s}: wgmma {ms!r} ms  {tmacs!r} Tmac/s, mma_sync {t['mma_sync']!r} ms; "
              f"library {lib_what}{'' if one_call else ' (two calls: a yardstick)'} "
              f"{t['library']!r} ms, wgmma/library {ms / t['library']!r}; bound {b_ms!r} ms "
              f"({by}: {nbytes} B, {ops!r} operations), wgmma/bound {ms / b_ms!r} ({card})",
              flush=True)
        rows[name] = {"ms": ms, "ms_mma_sync": t["mma_sync"], "library_ms": t["library"],
                      "library": lib_what, "library_one_call": one_call, "tmacs": tmacs,
                      "tmacs_mma_sync": STEPS * M * K * N / (t["mma_sync"] * 1e-3) / 1e12,
                      "bound_ms": b_ms, "bound_by": by, "bytes": nbytes, "ops": ops}
        del xs
    return rows


if __name__ == "__main__":
    main()
