"""Which X-pass arithmetic the card should use: four s8 dots, two f32 dots,
one int16 dot or one bf16 dot, on one resize work tile repeated in the kernel.

Port of ``scripts/exp_x_schemes.py`` to one NVIDIA H100.  Kernel I,
``x_scheme(variant, w, cvals, reps)`` (``libiqo_tpu_torch/csrc/exp/
exp_xpass.cu``, ``xscheme_tile<Variant>``), replaces ``make``
(``pl.pallas_call`` at ``:156``) and the three checks ``check_f32_exact``
(``:230``), ``check_s16_exact`` (``:248``) and ``check_bf16_error``
(``:271``), which are one application (``reps = 1``).  On a work tile ``w``
(160, 896) i32 and taps ``C`` (3, 384, 128) (Q14, 12 nonzero per column),
``out = sum_{r < reps} body(w + r)`` with int32 wraps, (160, 384) i32, where
``body`` runs group ``g`` of 128 outputs over the work columns
``[256 g, 256 g + 384)``:

* ``empty``: ``w[:, :384]``, the loop alone;
* ``s8_4dot``: ``a = int8(w >> 8)``, ``b = int8((w & 255) - 128)`` against
  ``e = int8(C >> 8)``, ``f = int8(C & 255)``: ``65536 ae + 256 (af + be) +
  bf + corr``;
* ``s8_2dot_cat``: the same with ``[e | f]`` as one (384, 256) plane;
* ``f32_2dot``: ``int(a @ C) * 256 + int(b @ C)`` with ``a = w >> 8``,
  ``b = w & 255`` and ``C`` in f32, exact (every sum of |terms| < 2^24);
* ``s16_1dot``: ``int16(w) @ int16(C)`` summed in int32;
* ``bf16_1dot``: ``int(bf16(w) @ bf16(C))`` with f32 sums (relaxed).

**Facts of the script, left unedited.**  ``s8_4dot`` and ``s8_2dot_cat`` pass
a zero ``corr`` (``:163-172``) while ``f`` is the low byte wrapped to s8
and ``b`` is rebased by -128, so neither equals :func:`gold`; this probe
holds them to their own formula.  ``bf16_1dot``'s sums reach ~1.3e9, far
past 2^24, so its f32 result depends on the order of summation: it errs by
up to ~2.2 LSB against :func:`gold` (the script's docstring expects about
1.5), and the kernel is held to the plain version within the f32 summation
bound of :func:`bf16_bound`.

**On Hopper.**  The s8 variants run ``mma.sync`` m16n8k32 s8 -> s32 (the two
issue the same four m16n8 products per 32 of K; only the coefficient planes'
layout differs, as the TPU's per-dot overhead has no counterpart);
``bf16_1dot`` ``mma.sync`` m16n8k16 bf16 -> f32; ``f32_2dot`` FP32 FMA on
CUDA cores (TF32 would round ``C``); ``s16_1dot`` an int32 multiply-add
(IMAD) dot on CUDA cores, its serial form's route (``__dp2a`` cannot serve:
``C`` does not fit s8); its gemm form is the exact route on the s8 tensor
cores, below.
The TPU keeps the whole tile and every coefficient plane in VMEM across the
repeats: 573 KB of work rows and 295-590 KB of planes, more than an SM's
227 KB.  The kernel splits the output over 120 blocks, (10 row blocks of
16) x (3 groups) x (4 chunks of 32 columns); each block keeps its 16 work
rows of the group's window and its coefficient slice on chip (registers,
or shared memory for the CUDA-core variants) for all ``reps`` repeats, so
12 SMs idle.  The repeat loop stays in the kernel, the ``+ r`` applied to
the work values and the split redone in every repeat, as the script's
``body_of``.

**Forms.**  ``x_scheme(..., form=)`` picks the kernel: ``"serial"`` is the
form above; ``"gemm"`` (every variant but ``empty``, and their default) is
the redesign in ``csrc/exp/exp_xpass_gemm.cu`` and, for the s8 variants,
``csrc/exp/exp_xpass_s8.cu``.  ``f32_2dot``'s,
``xscheme_f32_gemm``, is a register-tiled FFMA GEMM whose M stacks 4 repeats
x 2 planes of 16 work rows against the group's taps, held in shared memory
for a block's whole slice of the repeats.  ``bf16_1dot``'s,
``xscheme_bf16_gemm``, stacks 8 repeats of 16 work rows, one a warp, as two
warpgroups' wgmma m64n128k16 with A, ``bf16(w + r)``, made in registers,
against the group's taps laid out K-major (``cvals["cbf_k"]``) and
resident; each repeat's f32 dot is whole over K before it is truncated, and
the tensor cores' order of summation is held within :func:`bf16_bound`.
``s16_1dot``'s, ``xscheme_s16_gemm``, computes the exact int16 dot on the s8
tensor cores: with ``x = 256 xh + xl`` and ``c = 256 ch + cl`` (high byte
s8, low byte u8), ``x c = 65536 xh ch + 256 (xh cl + xl ch) + xl cl``, four
wgmma products on byte planes split in registers from ``int16(w + r)``,
against the taps' byte planes laid out K-major (``cvals["c16_k"]``); the s32
sums are recombined in uint32.  ``s8_4dot``'s and ``s8_2dot_cat``'s,
``xscheme_s8_gemm<kCat>``, take the same split (``a`` the high byte of
``int16(w + r)``, ``b`` its low byte XOR 0x80) against the taps' planes
``e`` and ``f`` laid out K-major (``cvals["ef_k"]``): four s8 wgmma
m64n64k32 a K step for ``s8_4dot``, two m64n128k32 against ``[e | f]`` for
``s8_2dot_cat``, on a persistent walk of (tile, step) units that gives each
SM an equal run.  In all of them the slices or runs meet in a zeroed
output by uint32 ``atomicAdd`` (:mod:`.xpass_gemm` states their geometry
and models them in NumPy).  :data:`LAUNCHES` counts each variant's serial
launches under its name and the gemm forms' under ``"<variant>[gemm]"``.

Times: per launch by back-to-back launches on 8 tiles that each differ in
``w[0, 0]``, at ``reps = R`` and ``R / 8``; per application is the slope
between the two, the script's ``us/application``, and ``t(R) / R``.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_x_schemes``.
"""

from __future__ import annotations


import numpy as np
import torch

from . import _harness, xpass_gemm
from ._harness import (BF16_OPS_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S, INT32_OPS_PER_S,
                       INT8_OPS_PER_S, Launches, wrap)

__all__ = ["LAUNCHES", "ROWS", "VARIANTS", "bf16_bound", "bound", "build_cvals", "gold",
           "inputs", "launch_key", "lsb_error", "main", "repeats", "split", "x_scheme",
           "x_scheme_plain"]

TH, TW = 160, 384
N_G, GN = 3, 128
K = 384
BAND = 896
R = 512
WINDOWS = ((0, 384), (256, 640), (512, 896))
NTAPS = 12
VARIANTS = ("empty", "s8_4dot", "s8_2dot_cat", "f32_2dot", "s16_1dot", "bf16_1dot")
# with a gemm form, their default
GEMM_VARIANT = ("s8_4dot", "s8_2dot_cat", "f32_2dot", "bf16_1dot", "s16_1dot")
ITERS = 8                  # work tiles per timed run
LSB = 2**20                # one u8 output LSB in the pre-shift i32 sum domain


def launch_key(variant: str, form: str) -> str:
    """The :data:`LAUNCHES` key of a variant's form."""
    return xpass_gemm.launch_key(variant, form)


# main()'s rows, (variant, form): every variant's serial form, then the gemm forms
ROWS = tuple((v, "serial") for v in VARIANTS) + tuple((v, "gemm") for v in GEMM_VARIANT)
LAUNCHES = Launches(launch_key(v, f) for v, f in ROWS)
_F32_EXACT = 2**24
_CHUNK_REPS = 32           # repeats per batched product in the plain version
# the operand planes each variant takes, in the kernel's argument order
_PLANES = {"empty": (), "s8_4dot": ("e", "f"), "s8_2dot_cat": ("ef",),
           "f32_2dot": ("cf32",), "s16_1dot": ("c16",), "bf16_1dot": ("cbf",)}
_GEMM_ENTRY = {"f32_2dot": (xpass_gemm.F32_GEMM, "iqo_exp_xscheme_gemm"),
               "bf16_1dot": (xpass_gemm.BF16_GEMM, "iqo_exp_xscheme_bf16_gemm"),
               "s16_1dot": (xpass_gemm.S16_GEMM, "iqo_exp_xscheme_s16_gemm"),
               "s8_4dot": (xpass_gemm.S8_GEMM, "iqo_exp_xscheme_s8_gemm"),
               "s8_2dot_cat": (xpass_gemm.S8_GEMM, "iqo_exp_xscheme_s8_gemm")}
_DTYPES = {"e": torch.int8, "f": torch.int8, "ef": torch.int8, "cf32": torch.float32,
           "c16": torch.int16, "cbf": torch.bfloat16, "corr": torch.int32}


def reset_launches() -> None:
    LAUNCHES.reset()


def inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's draws (``:52-66``), from seed 0, in its order: ``W16``
    (160, 896) int32, then per group and output column 12 taps and their
    scale: ``C`` (3, 384, 128) int32."""
    rng = np.random.default_rng(0)
    w16 = rng.integers(-21930, 21931, (TH, BAND)).astype(np.int32)
    c = np.zeros((N_G, K, GN), np.int32)
    for g in range(N_G):
        for col in range(GN):
            base = min(2 * col, K - NTAPS)
            taps = rng.integers(-8192, 8193, NTAPS)
            scale = min(1.0, 60000.0 / max(1, int(np.abs(taps).sum())))
            c[g, base:base + NTAPS, col] = (taps * scale).astype(np.int32)
    return torch.from_numpy(w16).to(device), torch.from_numpy(c).to(device)


def build_cvals(variant: str, c: torch.Tensor) -> dict[str, torch.Tensor]:
    """The script's operands of ``variant`` (``build_cvals``, ``:163-187``),
    each stacked over the 3 groups: ``e``, ``f`` (3, 384, 128) int8 and
    ``corr`` (3, 128) int32 zeros; ``ef`` (3, 384, 256) int8; for both s8
    variants' gemm form ``ef_k``, ``[e | f]`` K-major, (3, 256, 384) int8;
    ``cf32`` float32; ``c16`` int16 and, for the gemm form, ``c16_k`` its
    high and low bytes K-major, (3, 2, 128, 384) uint8; ``cbf`` bfloat16
    (rounded from float32) and, for the gemm form, ``cbf_k`` the same taps
    K-major, (3, 128, 384); each laid out once here as kernel C's
    ``k_major``."""
    _check_variant(variant)
    e = wrap(c.to(torch.int64) >> 8, 8).to(torch.int8)
    f = wrap(c.to(torch.int64) & 255, 8).to(torch.int8)
    corr = torch.zeros((N_G, GN), dtype=torch.int32, device=c.device)
    if variant.startswith("s8"):
        ef = torch.cat([e, f], dim=2).contiguous()
        planes = {"e": e, "f": f} if variant == "s8_4dot" else {"ef": ef}
        return {**planes, "corr": corr, "ef_k": ef.transpose(1, 2).contiguous()}
    if variant == "s16_1dot":
        c16 = c.to(torch.int16)
        v = c16.to(torch.int64)
        planes = torch.stack([(v >> 8) & 255, v & 255], dim=1).to(torch.uint8)
        return {"c16": c16, "c16_k": planes.transpose(2, 3).contiguous()}
    if variant == "bf16_1dot":
        cbf = c.to(torch.float32).to(torch.bfloat16)
        return {"cbf": cbf, "cbf_k": cbf.transpose(1, 2).contiguous()}
    return {"cf32": c.to(torch.float32)}          # f32_2dot, empty (unused there)


def gold(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The script's ``gold`` (``:69-74``): the banded product in int64,
    wrapped to int32, (160, 384)."""
    wf, cf = w.to(torch.float64), c.to(torch.float64)
    out = torch.cat([torch.matmul(wf[:, k0:k1], cf[g]) for g, (k0, k1) in enumerate(WINDOWS)],
                    dim=1)
    return wrap(out.to(torch.int64), 32).to(torch.int32)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variants are {VARIANTS}, got {variant!r}")


def _form(variant: str, form: str | None) -> str:
    return xpass_gemm.form_of(variant, form, GEMM_VARIANT)


def _check(variant: str, w: torch.Tensor, cvals: dict, reps: int) -> None:
    _check_variant(variant)
    if tuple(w.shape) != (TH, BAND) or w.dtype != torch.int32:
        raise ValueError(f"w must be ({TH}, {BAND}) int32, got {tuple(w.shape)} {w.dtype}")
    for name in _PLANES[variant] + (("corr",) if variant.startswith("s8") else ()):
        t = cvals.get(name)
        shape = (N_G, GN) if name == "corr" else (N_G, K, 2 * GN if name == "ef" else GN)
        if t is None or tuple(t.shape) != shape or t.dtype != _DTYPES[name]:
            raise ValueError(f"{variant} takes cvals[{name!r}] {shape} {_DTYPES[name]}, got "
                             f"{None if t is None else (tuple(t.shape), t.dtype)}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")


def _dot(a: torch.Tensor, b: torch.Tensor, f32_exact: bool = False) -> torch.Tensor:
    """a @ b in float64 on integer values (exact: every sum stays far below
    2^53), as int64; with ``f32_exact``, every output's sum of |terms| is
    asserted below 2^24, so that f32 sums in any order equal it."""
    if f32_exact and (worst := float(torch.matmul(a.abs(), b.abs()).max())) >= _F32_EXACT:
        raise ValueError(f"f32_2dot: a sum of |terms| reaches {worst}, not below 2^24")
    return torch.matmul(a, b).to(torch.int64)


def repeats(w: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """The int64 work values ``w + r`` of repeats ``r0 <= r < r1``, (r1 - r0,
    160, 896)."""
    return w.to(torch.int64) + torch.arange(r0, r1, device=w.device)[:, None, None]


def split(variant: str, wr: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The work planes ``variant``'s dots take from the int64 work values
    ``wr``: the s8 variants ``(a, b)``, f32_2dot ``(w >> 8, w & 255)``, both
    int64; s16_1dot the int16 wrap, int64; bf16_1dot ``w`` rounded to bf16."""
    if variant.startswith("s8"):
        return wrap(wr >> 8, 8), wrap((wr & 255) - 128, 8)
    if variant == "f32_2dot":
        return wr >> 8, wr & 255
    if variant == "s16_1dot":
        return (wrap(wr, 16),)
    if variant == "bf16_1dot":
        return (wr.to(torch.float32).to(torch.bfloat16),)
    raise ValueError(f"{variant!r} takes no work planes")


def _body(variant: str, wr: torch.Tensor, cvals: dict) -> torch.Tensor:
    """One application on the int64 work values ``wr`` (reps, 160, 896):
    the int64 result before the int32 wrap, (reps, 160, 384)."""
    if variant == "empty":
        return wr[..., :TW]
    outs = []
    planes = [p.to(torch.float64) for p in split(variant, wr)]
    if variant.startswith("s8"):
        a, b = planes
        for g, (k0, k1) in enumerate(WINDOWS):
            if variant == "s8_4dot":
                e, f = (cvals[n][g].to(torch.float64) for n in ("e", "f"))
            else:
                e, f = cvals["ef"][g].to(torch.float64).split(GN, dim=1)
            aw, bw = a[..., k0:k1], b[..., k0:k1]
            ae, af, be, bf = (_dot(x, y) for x, y in ((aw, e), (aw, f), (bw, e), (bw, f)))
            outs.append(ae * 65536 + (af + be) * 256 + bf + cvals["corr"][g].to(torch.int64))
    elif variant == "f32_2dot":
        a, b = planes
        for g, (k0, k1) in enumerate(WINDOWS):
            c = cvals["cf32"][g].to(torch.float64)
            outs.append(_dot(a[..., k0:k1], c, True) * 256 + _dot(b[..., k0:k1], c, True))
    elif variant == "s16_1dot":
        a, = planes
        for g, (k0, k1) in enumerate(WINDOWS):
            outs.append(_dot(a[..., k0:k1], cvals["c16"][g].to(torch.float64)))
    else:                                          # bf16_1dot
        a, = planes
        for g, (k0, k1) in enumerate(WINDOWS):
            exact = _dot(a[..., k0:k1], cvals["cbf"][g].to(torch.float64))
            # the float32 rounding of the exact sum, truncated (an integer)
            outs.append(exact.to(torch.float64).to(torch.float32).to(torch.int64))
    return torch.cat(outs, dim=-1)


def x_scheme_plain(variant: str, w: torch.Tensor, cvals: dict,
                   reps: int = R) -> torch.Tensor:
    """Kernel I's function in plain PyTorch: int64 (products of integers in
    float64, exact) wrapped to int32; ``bf16_1dot`` takes the float32
    rounding of the exact float64 sum of the bf16-rounded operands, the
    result every summation order approximates."""
    _check(variant, w, cvals, reps)
    acc = torch.zeros((TH, TW), dtype=torch.int64, device=w.device)
    for r0 in range(0, reps, _CHUNK_REPS):
        acc += wrap(_body(variant, repeats(w, r0, min(reps, r0 + _CHUNK_REPS)), cvals),
                    32).sum(0)
    return wrap(acc, 32).to(torch.int32)


def bf16_bound(w: torch.Tensor, cvals: dict, reps: int = R) -> torch.Tensor:
    """Per output, the most by which any f32 summation of ``bf16_1dot``'s
    dots can differ from :func:`x_scheme_plain`, summed over ``reps``:
    ``(K + 1) 2^-24 sum |a c|`` per application (K additions in f32, and the
    plain version's one rounding), float64 (160, 384)."""
    _check("bf16_1dot", w, cvals, reps)
    out = torch.zeros((TH, TW), dtype=torch.float64, device=w.device)
    for r0 in range(0, reps, _CHUNK_REPS):
        a, = split("bf16_1dot", repeats(w, r0, min(reps, r0 + _CHUNK_REPS)))
        a = a.to(torch.float64).abs()
        out += torch.cat([torch.matmul(a[..., k0:k1], cvals["cbf"][g].to(torch.float64).abs())
                          for g, (k0, k1) in enumerate(WINDOWS)], dim=-1).sum(0)
    return out * (K + 1) * 2.0**-24


def lsb_error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max, mean) |got - want| in output LSB (2^20), as ``check_bf16_error``."""
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().to(torch.float64)
    return float(err.max()) / LSB, float(err.mean()) / LSB


def x_scheme(variant: str, w: torch.Tensor, cvals: dict, reps: int = R,
             form: str | None = None) -> torch.Tensor:
    """Kernel I: (160, 384) int32 from ``w`` (160, 896) int32 and the
    variant's :func:`build_cvals` planes, in ``form`` (``"serial"``, or
    ``"gemm"`` for every variant but ``empty``, their default).  CPU tensors
    take :func:`x_scheme_plain`; CUDA tensors launch the kernel or raise."""
    form = _form(variant, form)
    _check(variant, w, cvals, reps)
    s8_gemm = form == "gemm" and variant.startswith("s8")
    planes = [cvals[n] for n in _PLANES[variant]]
    if form == "gemm" and variant in _K_MAJOR:
        planes = [_taps_k_major(variant, cvals)]
    corr = cvals["corr"] if variant.startswith("s8") else None
    if not all(t.is_contiguous() for t in (w, *planes)):
        raise ValueError("x_scheme takes contiguous tensors")
    if not _harness.on_card(w, *planes, *([] if corr is None else [corr])):
        return x_scheme_plain(variant, w, cvals, reps)
    if s8_gemm:
        return s8_gemm_launch(variant, w, planes[0], corr, xpass_gemm.s8_launch(
            reps, xpass_gemm.sm_count(w.device)))
    if form == "gemm":
        geom, entry = _GEMM_ENTRY[variant]
        launch = xpass_gemm.geometry(geom, reps, xpass_gemm.sm_count(w.device))
        out = torch.zeros((TH, TW), dtype=torch.int32, device=w.device)
        _harness.check_rc(getattr(xpass_gemm.lib(w.device), entry)(
            w.data_ptr(), planes[0].data_ptr(), out.data_ptr(), reps, launch.slices,
            launch.steps_per_slice, _harness.stream(w)), f"xscheme_tile[{variant},gemm]")
        LAUNCHES.add(launch_key(variant, form))
        return out
    lib = _harness.lib_with_setup("iqo_exp_xpass_setup", w.device)
    out = torch.empty((TH, TW), dtype=torch.int32, device=w.device)
    ptrs = [t.data_ptr() for t in planes] + [None] * (2 - len(planes))
    _harness.check_rc(lib.iqo_exp_xscheme(VARIANTS.index(variant), w.data_ptr(), *ptrs,
                                          None if corr is None else corr.data_ptr(),
                                          out.data_ptr(), reps, _harness.stream(w)),
                      f"xscheme_tile[{variant}]")
    LAUNCHES.add(variant)
    return out


def s8_gemm_launch(variant: str, w: torch.Tensor, ef_k: torch.Tensor, corr: torch.Tensor,
                   launch: xpass_gemm.S8Launch) -> torch.Tensor:
    """One launch of ``xscheme_s8_gemm`` on card tensors in ``launch``'s
    blocks (:func:`xpass_gemm.s8_launch`); :func:`x_scheme` picks the launch
    from the card's SM count.  Counted under ``"<variant>[gemm]"``."""
    if not all(t.is_contiguous() for t in (w, ef_k, corr)):
        raise ValueError("x_scheme takes contiguous tensors")
    out = torch.zeros((TH, TW), dtype=torch.int32, device=w.device)
    _harness.check_rc(getattr(xpass_gemm.s8_lib(w.device), _GEMM_ENTRY[variant][1])(
        w.data_ptr(), ef_k.data_ptr(), corr.data_ptr(), out.data_ptr(), launch.reps,
        int(variant == "s8_2dot_cat"), launch.blocks, _harness.stream(w)),
        f"xscheme_tile[{variant},gemm]")
    LAUNCHES.add(launch_key(variant, "gemm"))
    return out


# the gemm forms that read their taps K-major: (cvals key, shape, dtype)
_K_MAJOR = {"bf16_1dot": ("cbf_k", (N_G, GN, K), torch.bfloat16),
            "s16_1dot": ("c16_k", (N_G, 2, GN, K), torch.uint8),
            "s8_4dot": ("ef_k", (N_G, 2 * GN, K), torch.int8),
            "s8_2dot_cat": ("ef_k", (N_G, 2 * GN, K), torch.int8)}


def _taps_k_major(variant: str, cvals: dict) -> torch.Tensor:
    """``bf16_1dot``'s, ``s16_1dot``'s and the s8 variants' gemm forms read
    the taps K-major: ``cvals["cbf_k"]`` (3, 128, 384) bf16,
    ``cvals["c16_k"]`` (3, 2, 128, 384) uint8 (high, low byte),
    ``cvals["ef_k"]`` (3, 256, 384) int8 (``[e | f]``), from
    :func:`build_cvals`."""
    key, shape, dtype = _K_MAJOR[variant]
    t = cvals.get(key)
    if t is None or tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{variant}[gemm] takes cvals[{key!r}] {shape} {dtype}, the "
                         f"taps K-major from build_cvals, got "
                         f"{None if t is None else (tuple(t.shape), t.dtype)}")
    return t


def macs(variant: str, form: str = "serial") -> tuple[int, str]:
    """(multiply-adds of one application, the unit that runs them): the
    serial forms' (``s16_1dot`` an int32 dot), or with ``form="gemm"``
    ``s16_1dot``'s four s8 byte-plane products; the s8 variants' four s8
    products in either form."""
    per_dot = TH * K * GN * N_G                      # 23.6 M
    if variant == "s16_1dot" and form == "gemm":
        return 4 * per_dot, "int8"
    return {"empty": (0, "none"), "s8_4dot": (4 * per_dot, "int8"),
            "s8_2dot_cat": (4 * per_dot, "int8"), "f32_2dot": (2 * per_dot, "fp32"),
            "s16_1dot": (per_dot, "int32"), "bf16_1dot": (per_dot, "bf16")}[variant]


def bound(variant: str, reps: int = R, form: str = "serial") -> tuple[float, str, float, int]:
    """(ms of one launch, 'bytes' or 'operations', µs of one application's
    operations, bytes): the work tile, the variant's planes and the output
    once each at 3.35 TB/s, against the multiply-adds at the unit's peak
    (s8 1,979 TOP/s and bf16 989 TFLOP/s on the tensor cores, FP32 67
    TFLOP/s, int32 multiply-adds :data:`INT32_OPS_PER_S`).  ``form`` names
    the route where it changes the unit: ``s16_1dot``'s serial form is an
    IMAD dot (1.41 µs an application), its gemm form four s8 products
    (0.0954 µs)."""
    _check_variant(variant)
    m, unit = macs(variant, form)
    per_s = {"int8": INT8_OPS_PER_S / 2, "bf16": BF16_OPS_PER_S / 2, "fp32": FP32_OPS_PER_S / 2,
             "int32": INT32_OPS_PER_S, "none": float("inf")}[unit]
    planes = {"empty": 0, "s8_4dot": 2 * N_G * K * GN + 4 * N_G * GN,
              "s8_2dot_cat": 2 * N_G * K * GN + 4 * N_G * GN, "f32_2dot": 4 * N_G * K * GN,
              "s16_1dot": 2 * N_G * K * GN, "bf16_1dot": 2 * N_G * K * GN}[variant]
    nbytes = TH * BAND * 4 + planes + TH * TW * 4
    app_us = m / per_s * 1e6
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, reps * app_us * 1e-3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", app_us, nbytes


def _hold(variant: str, got: torch.Tensor, w: torch.Tensor, cvals: dict, reps: int) -> None:
    want = x_scheme_plain(variant, w, cvals, reps)
    if variant == "bf16_1dot":
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().to(torch.float64)
        if bool((err > bf16_bound(w, cvals, reps)).any()):
            raise AssertionError(f"{variant}: kernel outside the f32 summation bound")
    elif not torch.equal(got, want):
        raise AssertionError(f"{variant}: kernel differs from its plain version")


def main() -> dict:
    """Every variant in every form (:data:`ROWS`) and the three checks on
    card 0; returns {launch key: {ms, ms_r8, us_per_app, us_per_app_at_r,
    ...}, "checks": {...}}."""
    _harness.require_card()
    card = _harness.card()
    w, c = inputs(torch.device("cuda", 0))
    ws = _harness.perturbed(w, ITERS)
    rows = {}
    for variant, form in ROWS:
        cv = build_cvals(variant, c)
        _hold(variant, x_scheme(variant, ws[-1], cv, R // 8, form), ws[-1], cv, R // 8)
        t = {reps: _harness.launches_ms(lambda x: x_scheme(variant, x, cv, reps, form), ws)
             for reps in (R // 8, R)}
        us = (t[R] - t[R // 8]) / (R - R // 8) * 1e3
        b_ms, by, app_us, nbytes = bound(variant, form=form)
        key = launch_key(variant, form)
        print(f"{key:15s}: {us!r} us/application, slope (t(R)/R {t[R] / R * 1e3!r}; bound "
              f"{app_us!r}); per launch {t[R]!r} ms at R={R}, {t[R // 8]!r} ms at R={R // 8}; "
              f"launch bound {b_ms!r} ms ({by}) ({card})", flush=True)
        rows[key] = {"ms": t[R], "ms_r8": t[R // 8], "us_per_app": us,
                     "us_per_app_at_r": t[R] / R * 1e3, "bound_us_per_app": app_us,
                     "bound_ms": b_ms, "bound_by": by, "bytes": nbytes}
    want = gold(w, c)
    f32 = torch.equal(x_scheme("f32_2dot", w, build_cvals("f32_2dot", c), 1), want)
    f32_serial = torch.equal(x_scheme("f32_2dot", w, build_cvals("f32_2dot", c), 1, "serial"),
                             want)
    cv16 = build_cvals("s16_1dot", c)
    s16 = torch.equal(x_scheme("s16_1dot", w, cv16, 1), want)
    s16_serial = torch.equal(x_scheme("s16_1dot", w, cv16, 1, "serial"), want)
    cv8 = build_cvals("s8_4dot", c)
    s8 = torch.equal(x_scheme("s8_4dot", w, cv8, 1), want)
    s8_serial = torch.equal(x_scheme("s8_4dot", w, cv8, 1, "serial"), want)
    cvb = build_cvals("bf16_1dot", c)
    mx, mean = lsb_error(x_scheme("bf16_1dot", w, cvb, 1), want)
    mx_s, mean_s = lsb_error(x_scheme("bf16_1dot", w, cvb, 1, "serial"), want)
    print(f"f32_2dot exact vs numpy i32-wrap: {f32} (gemm form; serial form {f32_serial})",
          flush=True)
    print(f"s16_1dot exact vs numpy i32-wrap: {s16} (gemm form: four s8 byte-plane products; "
          f"serial form, an int32 IMAD dot on CUDA cores, {s16_serial})", flush=True)
    print(f"s8_4dot == gold: {s8} (gemm form; serial form {s8_serial}) (zero corr: the "
          f"script's formula, not the banded product)", flush=True)
    print(f"bf16_1dot max err: {mx!r} LSB (mean {mean!r}) (gemm form; serial form {mx_s!r} / "
          f"{mean_s!r}) ({card})", flush=True)
    rows["checks"] = {"f32_exact": f32, "f32_exact_serial": f32_serial, "s16_exact": s16,
                      "s16_exact_serial": s16_serial, "s8_4dot_gold": s8,
                      "s8_4dot_gold_serial": s8_serial, "bf16_max_lsb": mx, "bf16_mean_lsb": mean,
                      "bf16_max_lsb_serial": mx_s, "bf16_mean_lsb_serial": mean_s}
    return rows


if __name__ == "__main__":
    main()
