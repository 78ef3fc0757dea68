"""The card's streaming ceilings for the resize kernel's access pattern:
u8 planes in, u8 planes out, and a read-dominated fold.

Port of ``scripts/exp_dma_ceiling.py`` to one NVIDIA H100.  Kernels
(``libiqo_tpu_torch/csrc/exp/exp_stream.cu``):

* ``stream_map(x, op)`` (kernel A): ``inc_u8`` (x + 1 with u8 wrap),
  ``inc_i32`` (x + 1 with i32 wrap), ``mix_i32`` ((x ^ 0x5A5A5A5A) + 1) and
  ``copy``; replaces ``make_inc`` (``:57``) and ``main``'s mix (``:195``)
  and copy (``:224``);
* ``readsum(x, form=None)`` (kernel B): (H, W) u8 -> (H, 128) u8, every
  column folded into 128 lanes, ``& 255``; replaces ``make_readsum``
  (``:73``).  Two forms (:data:`FORMS_READSUM`, the first the default):
  ``"warp"`` (one warp a row, :data:`WARP_LOADS` pieces of the row loaded
  before their adds, a two-shuffle fold) and ``"rows8"``, the first form
  (8 threads a row); :func:`readsum_model` walks each in NumPy.

Rows, as the TPU script's ``main`` (``:147-255``): ``inc``, ``inc_i32``
(8.3 MB planes, which stay in the 50 MB L2: an L2 reading, as the TPU's
8.3 MB rows read VMEM), ``inc33MB``, ``inc33MB32``, ``mix33MB32``,
``copy33MB`` (4x the height, 66.4 MB moved per application, partly past L2),
the over-L2 rows ``inc133MB`` and ``copy133MB`` (16x the height, 265 MB per
application: device memory), ``readsum133MB`` (``readsum[warp]`` on the
16x plane: its read rate with the launch gap a small share), ``readsum``
(the ``rows8`` form) with ``readsum[warp]``, ``readsum_library`` (PyTorch's
``uint8`` fold, :func:`library_fold`) and ``launch_floor`` (an empty
kernel), timed in turns, and ``resize4k``, the port's resize kernel on the
4K Lanczos3 luma plan.  Each chain row is a serial
chain whose final checksum is asserted against :func:`expect_inc`,
:func:`expect_mix` or :func:`expect_copy`; ``readsum`` and ``resize4k`` run
back to back on perturbed inputs and one output is held to the plain
version.  GB/s counts the script's bytes per application (2·H·W for the
read-and-write rows, H·W for ``readsum``, source + output for ``resize4k``)
beside the data sheet's 3.35 TB/s.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_dma_ceiling``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _harness
from ._harness import HBM_BYTES_PER_S, Launches, signed32, wrap

__all__ = ["FORMS_READSUM", "LAUNCHES", "OPS", "WARP_LOADS", "expect_copy",
           "expect_inc", "expect_mix", "library_fold", "main", "readsum", "readsum_key",
           "readsum_model", "readsum_plain", "stream_map", "stream_map_plain"]

H, W = 2160, 3840
LANES = 128
MIX = 0x5A5A5A5A
OPS = {"inc_u8": 0, "inc_i32": 1, "mix_i32": 2, "copy": 3}
_DTYPES = {"inc_u8": (torch.uint8,), "inc_i32": (torch.int32,),
           "mix_i32": (torch.int32,), "copy": (torch.uint8,)}
# applications per timed chain: L2-resident planes, 4x and 16x the height
INNER = {1: 256, 4: 64, 16: 16}
READS = 8                  # perturbed inputs of readsum/resize4k (66 MB > L2)
FORMS_READSUM = ("warp", "rows8")   # the first is the default
WARP_LOADS = 8             # readsum[warp]: 16-byte loads a lane issues before it adds them


def readsum_key(form: str) -> str:
    """The :data:`LAUNCHES` key of a readsum form: ``readsum`` for the first,
    ``rows8`` form, ``readsum[form]`` otherwise."""
    return "readsum" if form == "rows8" else f"readsum[{form}]"


LAUNCHES = Launches((*OPS, *(readsum_key(f) for f in reversed(FORMS_READSUM))))


def reset_launches() -> None:
    LAUNCHES.reset()


def stream_map_plain(x: torch.Tensor, op: str) -> torch.Tensor:
    """Kernel A's function in plain PyTorch, exact in int64 with explicit
    wraps."""
    v = x.to(torch.int64)
    if op == "inc_u8":
        return ((v + 1) & 0xFF).to(torch.uint8)
    if op == "inc_i32":
        return wrap(v + 1, 32).to(torch.int32)
    if op == "mix_i32":
        return wrap(((v & 0xFFFFFFFF) ^ MIX) + 1, 32).to(torch.int32)
    if op == "copy":
        return x.clone()
    raise ValueError(f"unknown op {op!r}; one of {sorted(OPS)}")


def stream_map(x: torch.Tensor, op: str, out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel A: ``op`` applied to every element of ``x`` into ``out`` (a
    new tensor if None).  A CPU tensor takes :func:`stream_map_plain`; a
    CUDA tensor launches the kernel or raises."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {sorted(OPS)}")
    if x.dtype not in _DTYPES[op]:
        raise TypeError(f"{op} takes {_DTYPES[op]}, got {x.dtype}")
    out = torch.empty_like(x) if out is None else out
    if out.shape != x.shape or out.dtype != x.dtype:
        raise ValueError("out must match x in shape and dtype")
    if not _harness.on_card(x, out):
        out.copy_(stream_map_plain(x, op))
        return out
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("stream_map takes contiguous tensors")
    nbytes = x.numel() * x.element_size()
    _harness.check_rc(_harness.lib().iqo_exp_stream_map(
        OPS[op], x.data_ptr(), out.data_ptr(), nbytes, _harness.stream(x)),
        "stream_map")
    LAUNCHES.add(op)
    return out


def readsum_plain(x: torch.Tensor) -> torch.Tensor:
    """Kernel B's function in plain PyTorch: (H, W) u8 -> (H, 128) u8,
    ``sum over c of x[:, c * 128 + l] & 255``."""
    h, w = x.shape
    s = x.to(torch.int64).reshape(h, w // LANES, LANES).sum(dim=1)
    return (s & 0xFF).to(torch.uint8)


def library_fold(x: torch.Tensor) -> torch.Tensor:
    """Kernel B's function as one PyTorch call, the yardstick: a ``uint8``
    sum over a view (it wraps modulo 256)."""
    return x.view(x.shape[0], -1, LANES).sum(1, dtype=torch.uint8)


def _fold_lanes(acc: np.ndarray) -> np.ndarray:
    """A warp's 32 lanes of 16 byte sums (32, 16) folded as the kernel's two
    ``__shfl_xor_sync`` (8, then 16): lanes 0-7 hold the row's 128 lanes."""
    for off in (8, 16):
        acc = (acc + acc[np.arange(32) ^ off]) & 0xFF
    return acc[:8].reshape(-1)


def readsum_model(x: np.ndarray, form: str) -> np.ndarray:
    """Kernel B's schedule in ``form`` in NumPy, every sum modulo 256 as the
    kernel's ``__vadd4``: ``warp``, lane t of a row's warp sums its 16-byte
    pieces t, t + 32, ... (all on lane group t % 8) in rounds of
    :data:`WARP_LOADS`, then the lanes fold by the two shuffles; ``rows8``,
    thread j of a row sums pieces j, j + 8, ...  (H, W) u8 -> (H, 128) u8."""
    h, w = x.shape
    if w % LANES:
        raise ValueError(f"W % {LANES} != 0")
    pieces = x.reshape(h, w // 16, 16).astype(np.int64)
    out = np.full((h, LANES), -1, np.int64)
    if form == "rows8":
        for j in range(8):
            out[:, 16 * j:16 * j + 16] = pieces[:, j::8].sum(axis=1) & 0xFF
    elif form == "warp":
        for row in range(h):
            acc = np.zeros((32, 16), np.int64)
            for base in range(0, w // 16, 32 * WARP_LOADS):
                for t in range(32):
                    acc[t] = (acc[t] + pieces[row, base + t:base + 32 * WARP_LOADS:32]
                              .sum(axis=0)) & 0xFF
            out[row] = _fold_lanes(acc)
    else:
        raise ValueError(f"readsum takes form {FORMS_READSUM}, got {form!r}")
    if (out < 0).any():
        raise AssertionError("the walk left a row out")
    return out.astype(np.uint8)


def _readsum_form(form: str | None) -> str:
    if form is None:
        return FORMS_READSUM[0]
    if form not in FORMS_READSUM:
        raise ValueError(f"readsum takes form {FORMS_READSUM}, got {form!r}")
    return form


def readsum(x: torch.Tensor, form: str | None = None) -> torch.Tensor:
    """Kernel B on a (H, W) u8 plane, W a multiple of 128, in ``form``
    (:data:`FORMS_READSUM`, ``"warp"`` by default).  A CPU tensor takes
    :func:`readsum_plain`; a CUDA tensor launches the form's kernel or
    raises."""
    form = _readsum_form(form)
    if x.dtype != torch.uint8 or x.ndim != 2 or x.shape[1] % LANES:
        raise ValueError(f"readsum takes (H, W) uint8 with W % {LANES} == 0, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not _harness.on_card(x):
        return readsum_plain(x)
    if not x.is_contiguous():
        raise ValueError("readsum takes a contiguous plane")
    if x.data_ptr() % 16:
        raise ValueError("readsum takes a 16-byte aligned plane")
    h, w = x.shape
    out = torch.empty((h, LANES), dtype=torch.uint8, device=x.device)
    lib = _harness.lib()
    launch = lib.iqo_exp_readsum if form == "rows8" else lib.iqo_exp_readsum_warp
    _harness.check_rc(launch(x.data_ptr(), out.data_ptr(), h, w, _harness.stream(x)),
                      f"readsum[{form}]")
    LAUNCHES.add(readsum_key(form))
    return out


def expect_inc(dtype):
    """The checksum after ``inner`` applications of ``inc`` from ``x0``
    (``scripts/exp_dma_ceiling.py:_expect_inc``, ``:134-144``); ``dtype``
    is torch.uint8 or torch.int32, ``x0`` a tensor or an array."""
    def expect(x0, inner: int) -> int:
        fin = torch.as_tensor(x0).to(torch.int64) + inner
        fin = fin & 0xFF if dtype == torch.uint8 else fin & 0xFFFFFFFF
        return signed32(int(fin.sum().item()))
    return expect


def expect_mix(x0, inner: int) -> int:
    """The checksum after ``inner`` applications of ``mix_i32``
    (``main``'s ``expect_mix``, ``:203-208``)."""
    v = torch.as_tensor(x0).to(torch.int64) & 0xFFFFFFFF
    for _ in range(inner):
        v = ((v ^ MIX) + 1) & 0xFFFFFFFF
    return signed32(int(v.sum().item()))


def expect_copy(x0, inner: int) -> int:
    """The checksum after any number of copies (``main``'s ``expect_copy``,
    ``:232-234``)."""
    return signed32(int(torch.as_tensor(x0).to(torch.int64).sum().item()))


def _chain_row(card, name, op, x, expect, note):
    inner = INNER[x.shape[0] // H]
    want = expect(x, inner)
    ms = _harness.chain_ms(lambda a, b: stream_map(a, op, b), x, inner,
                           lambda *_: want)
    nbytes = 2 * x.numel() * x.element_size()
    gbs = nbytes / (ms * 1e-3) / 1e9
    print(f"{name:10s}: {ms * 1e3!r} us  {gbs!r} GB/s ({note}; {inner} "
          f"applications, checksum {want} verified; data sheet "
          f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s) ({card})", flush=True)
    return {"ms": ms, "gbs": gbs, "bytes": nbytes, "op": op,
            "shape": tuple(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "applications": inner, "checksum": want}


def _launch_row(card, name, fn, plain, x, nbytes, note):
    xs = _harness.perturbed(x, READS)
    got = fn(xs[-1])
    if not torch.equal(got, plain(xs[-1])):
        raise AssertionError(f"{name}: kernel differs from its plain version")
    ms = _harness.launches_ms(fn, xs)
    gbs = nbytes / (ms * 1e-3) / 1e9
    print(f"{name:10s}: {ms * 1e3!r} us  {gbs!r} GB/s ({note}; {READS} "
          f"perturbed inputs back to back, one output == plain) ({card})",
          flush=True)
    return {"ms": ms, "gbs": gbs, "bytes": nbytes, "shape": tuple(x.shape)}


def _readsum_rows(card, x) -> dict:
    """Kernel B's two forms and the library fold on :data:`READS` perturbed
    planes, in turns (the forms, the fold and an empty launch in order, then
    reversed; min of two each), each but the empty launch first held to the
    plain version: rows ``readsum`` (the ``rows8`` form), ``readsum[warp]``,
    ``readsum_library`` and ``launch_floor`` (a kernel
    that does nothing, ``torch.cuda._sleep(0)``, under the same protocol)."""
    xs = _harness.perturbed(x, READS)
    want = readsum_plain(xs[-1])
    calls = {readsum_key(f): functools.partial(readsum, form=f) for f in FORMS_READSUM}
    calls["readsum_library"] = library_fold
    for name, fn in calls.items():
        if not torch.equal(fn(xs[-1]), want):
            raise AssertionError(f"{name}: differs from the plain version")
    calls["launch_floor"] = lambda _: torch.cuda._sleep(0)
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(_harness.launches_ms(calls[name], xs))
    rows = {}
    for name, t in times.items():
        ms = min(t)
        if name == "launch_floor":
            print(f"{name:15s}: {ms * 1e3!r} us (an empty kernel, back to back in the same "
                  f"turns) ({card})", flush=True)
            rows[name] = {"ms": ms}
            continue
        gbs = H * W / (ms * 1e-3) / 1e9
        print(f"{name:15s}: {ms * 1e3!r} us  {gbs!r} GB/s (read, every column consumed; "
              f"{READS} perturbed inputs back to back, in turns with the other forms and "
              f"the library fold, one output == plain) ({card})", flush=True)
        rows[name] = {"ms": ms, "gbs": gbs, "bytes": H * W, "shape": tuple(x.shape)}
    return rows


def main() -> dict:
    """Every row on card 0; returns {row: {ms, gbs, bytes, ...}}."""
    _harness.require_card()
    card = _harness.card()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a).to(dev)

    x = put(rng.integers(0, 256, (H, W), np.uint8))
    rows = {"inc": _chain_row(card, "inc", "inc_u8", x, expect_inc(torch.uint8),
                              "u8 r+w, L2-resident")}
    x32 = put(rng.integers(0, 100, (H, W // 4), np.int32))
    rows["inc_i32"] = _chain_row(card, "inc_i32", "inc_i32", x32,
                                 expect_inc(torch.int32), "i32 r+w, L2-resident")
    xb = put(rng.integers(0, 256, (4 * H, W), np.uint8))
    rows["inc33MB"] = _chain_row(card, "inc33MB", "inc_u8", xb,
                                 expect_inc(torch.uint8), "u8 r+w, 66 MB per app")
    xb32 = put(rng.integers(0, 100, (4 * H, W // 4), np.int32))
    rows["inc33MB32"] = _chain_row(card, "inc33MB32", "inc_i32", xb32,
                                   expect_inc(torch.int32), "i32 r+w")
    rows["mix33MB32"] = _chain_row(card, "mix33MB32", "mix_i32", xb32, expect_mix,
                                   "i32 xor+add, no algebraic shortcut")
    rows["copy33MB"] = _chain_row(card, "copy33MB", "copy", xb, expect_copy,
                                  "u8 pure copy")
    del xb, xb32
    xh = put(rng.integers(0, 256, (16 * H, W), np.uint8))
    rows["inc133MB"] = _chain_row(card, "inc133MB", "inc_u8", xh,
                                  expect_inc(torch.uint8), "u8 r+w, over-L2")
    rows["copy133MB"] = _chain_row(card, "copy133MB", "copy", xh, expect_copy,
                                   "u8 pure copy, over-L2")
    rows["readsum133MB"] = _launch_row(card, "readsum133MB", readsum, readsum_plain, xh,
                                       16 * H * W, "readsum[warp], over-L2: read rate "
                                       "with the launch gap spread over 16x the rows")
    del xh
    rows.update(_readsum_rows(card, x))

    from ..core.plan import build_plan
    from ..ops import cuda_resize
    plan = build_plan("lanczos", W, H, 1920, 1080, degree=3)
    ops = cuda_resize.pack_operands(plan, dev)
    rows["resize4k"] = _launch_row(
        card, "resize4k", lambda s: cuda_resize.resize_fused(ops, s[None]),
        lambda s: cuda_resize.resize_plain(ops, s[None]), x, H * W + 1920 * 1080,
        "io estimate: source + output, Lanczos3 luma 4K->1080p")
    return rows


if __name__ == "__main__":
    main()
