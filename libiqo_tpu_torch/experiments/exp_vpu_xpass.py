"""CUDA cores against tensor cores for a single-phase X pass: a 12-tap
stride-2 correlation over deinterleaved work rows against the dense X pass of
four bf16 dots, each repeated in the kernel.

Port of ``scripts/exp_vpu_xpass.py`` to one NVIDIA H100.  Kernel J,
``vpu_xpass(variant, ops, reps)`` (``libiqo_tpu_torch/csrc/exp/exp_xpass.cu``,
``vpu_xpass_tile<Variant>``), replaces ``make`` (``pl.pallas_call`` at
``:156``) and ``check_exact`` (``:191``, ``corr_i32`` at ``reps = 1``).
``out = sum_{r < reps} body(we + r, wo + r, wd + r)`` with int32 wraps,
(160, 384) int32, on ``we``, ``wo`` (160, 512) and ``wd`` (160, 896) int32 in
+-32768, ``cxh`` (896, 384) in [-128, 127] and ``cxl`` in [0, 255] as bf16,
and 12 integer taps ``C``:

* ``empty``: ``we[:, :384]``;
* ``dense4``: ``int(hi) * 256 + int(lo)`` summed over ``cc`` in (cxh, cxl),
  where ``hi = (wd >> 8) @ cc`` and ``lo = (wd & 255) @ cc`` in bf16 with f32
  sums: exact, since no sum of |products| reaches 2^24 (the plain version
  asserts it for every element and repeat);
* ``corr_i32``: ``sum_k C[2k] we[:, k:k+384] + C[2k+1] wo[:, k:k+384]``;
* ``corr_f32``: the same on the byte-split planes ``we >> 8``, ``we & 255``
  (and ``wo``'s) in float32, in the script's source order, then
  ``int(h) * 256 + int(l)``;
* ``muls_i32``, ``muls_f32``: the taps on the unshifted first 384 columns.

**Facts of the script, left unedited.**  ``muls_f32``'s sums pass 2^31 on
1.8 % of the elements; XLA's conversion saturates (and maps NaN to 0), so
the plain version saturates explicitly and the kernel uses
``__float2int_rz``, which saturates.  XLA does not evaluate ``muls_f32`` in
the source order, so the CPU tests hold it to the script within an f32
rounding bound (:func:`f32_bound`); on the card the kernel and the plain
version both take the source order without contraction
(``__fmul_rn``/``__fadd_rn``) and agree bit for bit.

**On Hopper.**  ``dense4`` runs ``mma.sync`` m16n8k16 bf16 -> f32 with the
coefficients K-major (:func:`operands` lays them out once, as the TPU kernel
holds them in VMEM); the other variants run on CUDA cores, ``IMAD`` for the
int32 ones.  The script parked its scheme because Mosaic cannot slice with
stride 2 (``:10-12, :38-44``); on Hopper a strided read from shared memory
is legal, which this probe does not add as a variant.  The TPU keeps all
operands in VMEM across the repeats (each ``cx`` plane 688 KB); the kernel
splits the output over 120 blocks of (16 rows, 32 columns): ``dense4``
keeps its 16 work rows and 2 x 32 K-major coefficient columns (172 KB) in
shared memory and splits K over its 4 warps (exact partial sums, added in
shared memory); the CUDA-core variants keep each thread's 9 + 9 work values
of 4 outputs in registers.  The script's v5e figures are TPU history, not
this card's.

**Forms.**  ``vpu_xpass(..., form=)`` picks the kernel: ``"serial"`` is the
form above; ``"gemm"`` (``dense4`` only, and its default) is the redesign in
``csrc/exp/exp_xpass_gemm.cu``, ``vpu_dense4_gemm``: one warpgroup's bf16
``wgmma`` m64n64k16 over 256 A rows a step that stack 8 repeats x 2 planes of
16 work rows, the A fragments split in registers, the coefficients (``cxt``,
as :func:`operands` lays them out) in K chunks of 64 staged by ``cp.async``
in four stages, 128-byte swizzled, read by the tensor cores; each warp holds
its rows over the full K; a block's slice of the repeats meets the others in
a zeroed output by uint32 ``atomicAdd`` (:mod:`.xpass_gemm` states its
geometry and models it in NumPy); ``"wide"`` (``corr_f32`` and ``muls_f32``
only, and their default) is the redesign in ``csrc/exp/exp_vpu_f32.cu``,
``vpu_f32_wide_kernel``: the int -> float conversions on the FP32 pipe by
the exponent trick (``I2F`` for a warp whose values do not fit), 4 outputs
a thread with corr_f32's window shared in registers, and the repeats split
in thirds over the 3 warps of each of 480 blocks, 1440 warps on 132 SMs
(:mod:`.vpu_f32` states the thread map and models it in NumPy).
:data:`LAUNCHES` counts each variant's serial launches under its name and
the other forms' under ``"variant[form]"``.

Times: per launch by back-to-back launches on 8 operand sets that each
differ in ``we[0, 0]``, ``wo[0, 0]`` and ``wd[0, 0]``, at ``reps = R`` and
``R / 8``; per application is the slope between the two, and ``t(R) / R``.
The gemm form computes whole steps of 8 repeats (a repeat past ``reps`` is
computed and left out), so at ``R / 8`` = 3 it does a whole step's products
and the slope understates its cost: its row adds the slope between ``R`` and
one whole step, 8.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_vpu_xpass``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _harness, vpu_f32, xpass_gemm
from ._harness import (BF16_OPS_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S, INT32_OPS_PER_S,
                       Launches, wrap)

__all__ = ["F32_OPS_PER_OUTPUT", "LAUNCHES", "ROWS", "VARIANTS", "WIDE_VARIANTS",
           "XpassOperands", "bound", "check_exact", "f32_bound", "f32_to_i32", "gold_corr", "launch_key", "main",
           "operands", "split_dense", "vpu_xpass", "vpu_xpass_plain"]

TH, TW, TAPS = 160, 384, 12
HALF = TAPS // 2
BAND = 2 * TW + 128
WDI = TW + 128
R = 24
VARIANTS = ("empty", "dense4", "corr_i32", "corr_f32", "muls_i32", "muls_f32")
GEMM_VARIANT = "dense4"    # the one variant with a gemm form, and its default
WIDE_VARIANTS = ("corr_f32", "muls_f32")   # the variants with a wide form, their default
ITERS = 8


def launch_key(variant: str, form: str) -> str:
    """The :data:`LAUNCHES` key of a variant's form."""
    return xpass_gemm.launch_key(variant, form)


# main()'s rows, (variant, form): every variant's serial form, then the wide
# and the gemm forms
ROWS = tuple((v, "serial") for v in VARIANTS) + tuple((v, "wide") for v in WIDE_VARIANTS) + \
    ((GEMM_VARIANT, "gemm"),)
LAUNCHES = Launches(launch_key(v, f) for v, f in ROWS)
_F32_EXACT = 2**24


def reset_launches() -> None:
    LAUNCHES.reset()


@dataclasses.dataclass(frozen=True)
class XpassOperands:
    """Kernel J's operands: the script's arrays, and ``cxt`` (2, 384, 896)
    bf16, ``(cxh, cxl)`` K-major for the tensor cores."""
    we: torch.Tensor
    wo: torch.Tensor
    wd: torch.Tensor
    cxh: torch.Tensor
    cxl: torch.Tensor
    taps: tuple[int, ...]
    cxt: torch.Tensor

    def perturbed(self, i: int) -> "XpassOperands":
        """A copy whose three work planes start with ``i``."""
        planes = []
        for t in (self.we, self.wo, self.wd):
            t = t.clone()
            t.view(-1)[0] = i
            planes.append(t)
        return dataclasses.replace(self, we=planes[0], wo=planes[1], wd=planes[2])


def operands(device) -> XpassOperands:
    """The script's draws (``:62-69``), from seed 0, in its order:
    ``W_DENSE``, ``W_E``, ``W_O``, ``C``, ``CX_HI``, ``CX_LO``."""
    rng = np.random.default_rng(0)
    wd = rng.integers(-32768, 32768, (TH, BAND)).astype(np.int32)
    we = rng.integers(-32768, 32768, (TH, WDI)).astype(np.int32)
    wo = rng.integers(-32768, 32768, (TH, WDI)).astype(np.int32)
    taps = tuple(int(v) for v in rng.integers(-2000, 16384, TAPS))
    cxh = rng.integers(-128, 128, (BAND, TW)).astype(np.float32)
    cxl = rng.integers(0, 256, (BAND, TW)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    bf = lambda a: t(a).to(torch.bfloat16)        # noqa: E731
    h, lo = bf(cxh), bf(cxl)
    return XpassOperands(t(we), t(wo), t(wd), h, lo, taps,
                         torch.stack([h.t(), lo.t()]).contiguous())


def gold_corr(we: torch.Tensor, wo: torch.Tensor, taps) -> torch.Tensor:
    """The script's ``gold_corr`` (``:72-77``), int64 wrapped to int32."""
    we, wo = we.to(torch.int64), wo.to(torch.int64)
    acc = sum(taps[2 * k] * we[:, k:k + TW] + taps[2 * k + 1] * wo[:, k:k + TW]
              for k in range(HALF))
    return wrap(acc, 32).to(torch.int32)


def check_exact(ops: XpassOperands) -> bool:
    """The script's ``check_exact`` (``:191``): one application of
    ``corr_i32`` == :func:`gold_corr`."""
    return torch.equal(vpu_xpass("corr_i32", ops, 1), gold_corr(ops.we, ops.wo, ops.taps))


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 -> int32 conversion, as int64: truncate toward zero,
    saturate at the int32 range, NaN to 0 (a plain ``.to(torch.int32)`` of an
    out-of-range float is undefined; the CPU gives INT_MIN)."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return x.clamp(-2.0**31, 2.0**31 - 1).to(torch.int64)


def _form(variant: str, form: str | None) -> str:
    return xpass_gemm.form_of(variant, form, (GEMM_VARIANT,), WIDE_VARIANTS)


@functools.cache
def _wide_lib(device: torch.device):
    """The probe library, its wide form's compiled thread map checked
    against :mod:`.vpu_f32` once per device."""
    lib = _harness.lib()
    shape = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _harness.check_rc(lib.iqo_exp_vpu_f32_shape(shape), "iqo_exp_vpu_f32_shape")
    want = (vpu_f32.OUTS, vpu_f32.SLICES, vpu_f32.THREADS, vpu_f32.BLOCKS)
    if tuple(shape) != want:
        raise RuntimeError(f"exp_vpu_f32.cu's thread map {tuple(shape)} != vpu_f32's {want}")
    return lib


def _check(variant: str, ops: XpassOperands, reps: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variants are {VARIANTS}, got {variant!r}")
    for name, t, shape, dt in (("we", ops.we, (TH, WDI), torch.int32),
                               ("wo", ops.wo, (TH, WDI), torch.int32),
                               ("wd", ops.wd, (TH, BAND), torch.int32),
                               ("cxh", ops.cxh, (BAND, TW), torch.bfloat16),
                               ("cxl", ops.cxl, (BAND, TW), torch.bfloat16),
                               ("cxt", ops.cxt, (2, TW, BAND), torch.bfloat16)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {shape} {dt}, got {tuple(t.shape)} {t.dtype}")
    if len(ops.taps) != TAPS:
        raise ValueError(f"{TAPS} taps, got {len(ops.taps)}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")


def _f32_corr(xs, ys, taps, shifted: bool) -> torch.Tensor:
    """The script's float32 correlation in its source order: per k,
    ``t = c_e x + c_o y`` (two products, one add), ``acc = t`` then
    ``acc + t``; each operation rounds once."""
    acc = None
    for k in range(HALF):
        x = xs[..., k:k + TW] if shifted else xs[..., :TW]
        y = ys[..., k:k + TW] if shifted else ys[..., :TW]
        t = (torch.tensor(float(taps[2 * k]), dtype=torch.float32) * x +
             torch.tensor(float(taps[2 * k + 1]), dtype=torch.float32) * y)
        acc = t if acc is None else acc + t
    return acc


def split_dense(wd: torch.Tensor, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dense4's work planes for the repeats ``r`` (reps,): ``(w >> 8, w & 255)``
    of ``w = wd + r`` wrapped to int32 as the script adds, int64 (reps, 160,
    896)."""
    w = wrap(wd.to(torch.int64) + r[:, None, None], 32)
    return w >> 8, w & 255


def _body(variant: str, ops: XpassOperands, r: torch.Tensor) -> torch.Tensor:
    """One application per repeat in ``r`` (reps,), int64 (reps, 160, 384)."""
    if variant == "dense4":
        planes = [p.to(torch.float64) for p in split_dense(ops.wd, r)]
        s = 0
        for cc in (ops.cxh, ops.cxl):
            cc = cc.to(torch.float64)
            worst = max(float(torch.matmul(p.abs(), cc.abs()).max()) for p in planes)
            if worst >= _F32_EXACT:
                raise ValueError(f"dense4: a sum of |products| reaches {worst}, not below 2^24")
            hi, lo = (torch.matmul(p, cc).to(torch.int64) for p in planes)
            s = s + hi * 256 + lo
        return s
    r = r[:, None, None]          # the script's int32 adds, wrapped
    we, wo = wrap(ops.we.to(torch.int64) + r, 32), wrap(ops.wo.to(torch.int64) + r, 32)
    if variant == "empty":
        return we[..., :TW]
    if variant in ("corr_i32", "muls_i32"):
        shifted = variant == "corr_i32"
        return sum(ops.taps[2 * k] * (we[..., k:k + TW] if shifted else we[..., :TW]) +
                   ops.taps[2 * k + 1] * (wo[..., k:k + TW] if shifted else wo[..., :TW])
                   for k in range(HALF))
    if variant == "corr_f32":
        h = _f32_corr((we >> 8).to(torch.float32), (wo >> 8).to(torch.float32), ops.taps, True)
        lo = _f32_corr((we & 255).to(torch.float32), (wo & 255).to(torch.float32), ops.taps,
                       True)
        return f32_to_i32(h) * 256 + f32_to_i32(lo)
    return f32_to_i32(_f32_corr(we.to(torch.float32), wo.to(torch.float32), ops.taps, False))


def vpu_xpass_plain(variant: str, ops: XpassOperands, reps: int = R) -> torch.Tensor:
    """Kernel J's function in plain PyTorch: int64 with int32 wraps (the bf16
    dots as float64 products of integers, exact), the f32 variants in float32
    in the script's source order with XLA's saturating conversion."""
    _check(variant, ops, reps)
    acc = torch.zeros((TH, TW), dtype=torch.int64, device=ops.we.device)
    for r0 in range(0, reps, 8):
        r = torch.arange(r0, min(reps, r0 + 8), device=ops.we.device)
        acc += wrap(_body(variant, ops, r), 32).sum(0)
    return wrap(acc, 32).to(torch.int32)


def f32_bound(ops: XpassOperands, reps: int = R) -> torch.Tensor:
    """Per output, the most by which two float32 evaluations of
    ``muls_f32``'s sums in any order can differ after the conversion, summed
    over ``reps``: per application twice ``(2 TAPS) 2^-24 sum |c x|``, plus 1
    for the truncation; float64 (160, 384)."""
    _check("muls_f32", ops, reps)
    mag = torch.zeros((TH, TW), dtype=torch.float64, device=ops.we.device)
    for r in range(reps):
        we = (ops.we[:, :TW].to(torch.float64) + r).abs()
        wo = (ops.wo[:, :TW].to(torch.float64) + r).abs()
        mag += sum(abs(ops.taps[2 * k]) * we + abs(ops.taps[2 * k + 1]) * wo for k in range(HALF))
    return 2 * 2 * TAPS * 2.0**-24 * mag + reps


def vpu_xpass(variant: str, ops: XpassOperands, reps: int = R,
              form: str | None = None) -> torch.Tensor:
    """Kernel J: (160, 384) int32, in ``form`` (``"serial"``; ``"gemm"`` for
    ``dense4``, ``"wide"`` for ``corr_f32`` and ``muls_f32``, each their
    default).  CPU tensors take :func:`vpu_xpass_plain`; CUDA tensors launch
    the kernel or raise."""
    form = _form(variant, form)
    _check(variant, ops, reps)
    tensors = (ops.we, ops.wo, ops.wd, ops.cxt)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("vpu_xpass takes contiguous tensors")
    if not _harness.on_card(*tensors, ops.cxh, ops.cxl):
        return vpu_xpass_plain(variant, ops, reps)
    if form == "gemm":
        dev = ops.wd.device
        launch = xpass_gemm.geometry(xpass_gemm.DENSE4_GEMM, reps, xpass_gemm.sm_count(dev))
        out = torch.zeros((TH, TW), dtype=torch.int32, device=dev)
        _harness.check_rc(xpass_gemm.lib(dev).iqo_exp_vpu_gemm(
            ops.wd.data_ptr(), ops.cxt.data_ptr(), out.data_ptr(), reps, launch.slices,
            launch.steps_per_slice, _harness.stream(ops.wd)), f"vpu_xpass_tile[{variant},gemm]")
        LAUNCHES.add(launch_key(variant, form))
        return out
    taps = (ctypes.c_int * TAPS)(*ops.taps)
    if form == "wide":
        out = torch.empty((TH, TW), dtype=torch.int32, device=ops.we.device)
        _harness.check_rc(_wide_lib(ops.we.device).iqo_exp_vpu_f32_wide(
            WIDE_VARIANTS.index(variant), ops.we.data_ptr(), ops.wo.data_ptr(), taps,
            out.data_ptr(), reps, _harness.stream(ops.we)), f"vpu_xpass_tile[{variant},wide]")
        LAUNCHES.add(launch_key(variant, form))
        return out
    lib = _harness.lib_with_setup("iqo_exp_xpass_setup", ops.we.device)
    out = torch.empty((TH, TW), dtype=torch.int32, device=ops.we.device)
    _harness.check_rc(lib.iqo_exp_vpu_xpass(
        VARIANTS.index(variant), *(t.data_ptr() for t in tensors), taps, out.data_ptr(),
        reps, _harness.stream(ops.we)), f"vpu_xpass_tile[{variant}]")
    LAUNCHES.add(variant)
    return out


# float32 multiplies and adds of one output in the script's body_of: per
# plane, HALF terms of 2 FMUL and 1 FADD, summed by HALF - 1 FADD (the first
# term starts the sum); corr_f32 sums two planes (x >> 8, x & 255)
F32_OPS_PER_OUTPUT = {"corr_f32": 2 * (3 * HALF + HALF - 1), "muls_f32": 3 * HALF + HALF - 1}


def bound(variant: str, reps: int = R) -> tuple[float, str, float, int]:
    """(ms of one launch, 'bytes' or 'operations', µs of one application's
    operations, bytes): the operands the variant reads and the output once
    each at 3.35 TB/s, against its operations: ``dense4`` 4 x 160 x 896 x 384
    bf16 multiply-adds at 989 TFLOP/s, the int32 variants 12 ``IMAD`` per
    output at :data:`INT32_OPS_PER_S`, ``corr_f32`` 46 and ``muls_f32`` 23
    float32 instructions (mul or add) per output at half the 67 TFLOP/s:
    :data:`F32_OPS_PER_OUTPUT`, the script's ``body_of`` counted."""
    n = TH * TW
    ops_s = {"empty": (0, 1.0), "dense4": (4 * TH * BAND * TW, BF16_OPS_PER_S / 2),
             "corr_i32": (TAPS * n, INT32_OPS_PER_S), "muls_i32": (TAPS * n, INT32_OPS_PER_S),
             "corr_f32": (F32_OPS_PER_OUTPUT["corr_f32"] * n, FP32_OPS_PER_S / 2),
             "muls_f32": (F32_OPS_PER_OUTPUT["muls_f32"] * n, FP32_OPS_PER_S / 2)}[variant]
    reads = TH * BAND * 4 + 2 * BAND * TW * 2 if variant == "dense4" else \
        2 * TH * (TW + HALF - 1 if variant.startswith("corr") else TW) * 4
    if variant == "empty":
        reads = TH * TW * 4
    nbytes = reads + TH * TW * 4
    app_us = ops_s[0] / ops_s[1] * 1e6
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, reps * app_us * 1e-3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", app_us, nbytes


def main() -> dict:
    """Every variant and ``check_exact`` on card 0; returns {variant: {...},
    "checks": {...}}."""
    _harness.require_card()
    card = _harness.card()
    ops = operands(torch.device("cuda", 0))
    xs = [ops.perturbed(i) for i in range(ITERS)]
    rows = {}
    for variant, form in ROWS:
        if not torch.equal(vpu_xpass(variant, xs[-1], R // 8, form),
                           vpu_xpass_plain(variant, xs[-1], R // 8)):
            raise AssertionError(f"{variant}: kernel differs from its plain version")
        t = {reps: _harness.launches_ms(lambda o: vpu_xpass(variant, o, reps, form), xs)
             for reps in (R // 8, R)}
        us = (t[R] - t[R // 8]) / (R - R // 8) * 1e3
        b_ms, by, app_us, nbytes = bound(variant)
        key = launch_key(variant, form)
        print(f"{key:12s}: {us!r} us/application, slope (t(R)/R {t[R] / R * 1e3!r}; bound "
              f"{app_us!r}); per launch {t[R]!r} ms at R={R}, {t[R // 8]!r} ms at R={R // 8}; "
              f"launch bound {b_ms!r} ms ({by}) ({card})", flush=True)
        rows[key] = {"ms": t[R], "ms_r8": t[R // 8], "us_per_app": us,
                     "us_per_app_at_r": t[R] / R * 1e3, "bound_us_per_app": app_us,
                     "bound_ms": b_ms, "bound_by": by, "bytes": nbytes}
        if form == "gemm":
            # the form computes whole steps of 8 repeats, so R/8 = 3 repeats
            # cost it one step: the slope between whole steps as well
            step = xpass_gemm.DENSE4_GEMM.rep_step
            t_step = _harness.launches_ms(lambda o: vpu_xpass(variant, o, step, form), xs)
            whole = (t[R] - t_step) / (R - step) * 1e3
            print(f"{key:12s}: {whole!r} us/application, slope between whole steps R={R} and "
                  f"{step} ({t_step!r} ms at {step}) ({card})", flush=True)
            rows[key].update(ms_step=t_step, us_per_app_whole_steps=whole)
    exact = check_exact(ops)
    print(f"corr_i32 exact vs numpy: {exact}; corr_i32/dense4 per application "
          f"{rows['corr_i32']['us_per_app'] / rows['dense4']['us_per_app']!r}, "
          f"corr_i32/dense4[gemm] "
          f"{rows['corr_i32']['us_per_app'] / rows['dense4[gemm]']['us_per_app']!r} ({card})",
          flush=True)
    rows["checks"] = {"corr_i32_exact": exact}
    return rows


if __name__ == "__main__":
    main()
