"""Whether the band windows the padless resize design wants are legal on the
card: clamped windows, a window past the array's end, and a dynamic index
into a scratch filled by one copy.

Port of ``scripts/exp_element_clamp.py`` to one NVIDIA H100.  Kernel M
(``libiqo_tpu_torch/csrc/exp/exp_clamp.cu``), the port's first TMA and bulk
copies, replaces the three ``pl.pallas_call`` sites:

* ``window_x1(src, form)`` for ``run_x1`` (``:44``): on a (160, 640) int32
  source, or a batch of 3, a grid of (4, 4) tiles; tile (ty, tx) loads a
  (64, 256) window at ``(clamp(32 ty - 32, 0, 96), clamp(128 tx - 128, 0,
  384))`` by TMA (``cp.async.bulk.tensor.2d``, 3-D for the batch, on an
  mbarrier; the coordinates clamped in the kernel from ``blockIdx``, as the
  index map does) and writes its top-left (32, 128) to out tile (ty, tx):
  (128, 512), or (3, 128, 512).  ``form="boxes"`` (the default) loads each
  window as 8 boxes of (64, 32), one a block (:func:`x1_schedule`: 128
  blocks, 384 for the batch), and the 4 blocks whose boxes cover the
  window's columns 0-127 write their (32, 32) of the corner;
  ``form="single"`` is the first kernel, one block landing the whole window
  as **one 64 KB box** before any store;
* ``window_x2(src, spill, form)`` for ``run_x2`` (``:83``): the (64, 256)
  window at row 128 of the (160, 640) source, so 32 of its rows lie past the
  end; TMA fills them with zeros.  Rows 0-31, columns 0-127 (all inside the
  source) are written, (32, 128); ``spill`` takes the whole window, for
  :func:`main` to report what the rows past the end held (not gated).
  ``form="boxes"`` (the default) loads the window as 8 TMA boxes of (64, 32),
  one a block (:func:`x2_schedule`), each from row 128 past the end, each
  block writing its columns of ``out`` and of ``spill``; ``form="single"``
  is the first kernel, one block loading one (64, 256) box;
* ``window_x3(var, form)`` for ``run_x3`` (``:127``): the TPU's sequential
  grid of 4 with its scratch carried, ``var`` (3, 64, 256) float32 ->
  ``out`` (4, 64, 256), ``out[t] = scratch[v(t)]``, ``v = 0, 1, 1, 2``
  computed at run time.  ``form="cluster"`` (the default) runs the grid as
  a thread block cluster of 4 blocks, block rank t as step t, its scratch
  read through the cluster's distributed shared memory: 16 clusters, one a
  chunk of 4 rows (:func:`x3_schedule`); rank 0 fills the scratch once, at
  the start, by one ``cp.async.bulk`` a variant slice into its own shared
  memory, on its mbarrier; after a cluster barrier, rank t reads
  ``scratch[v(t)]`` from rank 0 (``ld.shared::cluster``), and a split
  cluster barrier keeps rank 0 until every peer has read.  (The slices
  spread over ranks 0-2 would need one more cluster barrier, for every
  owner's mbarrier to be initialised before rank 0's copies.)
  ``form="serial"`` is the first kernel: one block loops over t; at t = 0 one
  bulk copy of all of ``var`` (192 KB) into its dynamic shared memory on an
  mbarrier, the counterpart of ``make_async_copy`` and its semaphore.

The tensor maps are encoded on the host by ``cuTensorMapEncodeTiled``,
fetched through ``cudaGetDriverEntryPoint`` (the one ``nvcc -shared`` links
no ``libcuda``), and passed as ``__grid_constant__`` parameters.

:func:`main` times X3's two forms in turns with ``var.index_select(0, idx)``
(``var[[0, 1, 1, 2]]`` with the index on the card), X2 in turns with
``src[128:160, :128].clone()``, and X1's two forms, 2-D and batch, in turns
with the corner-gathering index (``src.view(-1)[flat]``, over the batch
``src.view(B, -1)[:, flat]``), each library call held equal to the plain
version first.  :data:`LAUNCHES` counts X3's serial form under ``"x3"``
and its cluster form under ``"x3[cluster]"``, X2's single box under
``"x2"`` and its boxes under ``"x2[boxes]"``, X1's single box under
``"x1"``/``"x1_batch"`` and its boxes under ``"x1[boxes]"``/
``"x1_batch[boxes]"``.

Run on a card: ``python -m libiqo_tpu_torch.experiments.exp_element_clamp``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _harness
from ._harness import HBM_BYTES_PER_S, Launches

__all__ = ["FORMS", "LAUNCHES", "ROWS", "X1_FORMS", "X2_FORMS", "bound", "corner_index",
           "inputs", "main", "window_x1", "window_x1_plain", "window_x2", "window_x2_plain",
           "window_x3", "window_x3_plain", "x1_model", "x1_schedule", "x2_model",
           "x2_schedule", "x3_model", "x3_schedule"]

H, W = 160, 640
TH, TW = 32, 128
BAND_H, BAND_W = 64, 256
STEP_H, STEP_W = 32, 128
PAD_LO_H, PAD_LO_W = 32, 128
N_TY, N_TX = 4, 4
BATCH = 3
N_VAR, A, B = 3, 64, 256
X3_STEPS = 4
X3_ROWS = 4                 # rows of each variant a cluster takes
X3_CHUNKS = A // X3_ROWS    # clusters of the cluster form
FORMS = ("cluster", "serial")   # X3's forms, the first its default
X2_FORMS = ("boxes", "single")  # X2's forms, the first its default
X1_FORMS = X2_FORMS             # X1's forms, the first its default
X2_BOXES = 8                    # boxes of X1's and X2's split forms, one a block
X2_BOX_W = BAND_W // X2_BOXES   # 32 columns each
# main()'s rows, each a LAUNCHES key: X3's serial form "x3", its cluster form
# "x3[cluster]"; X2's single box "x2", its boxes "x2[boxes]"; X1's single
# box "x1" / "x1_batch", its boxes "x1[boxes]" / "x1_batch[boxes]"
ROWS = ("x1", "x1_batch", "x1[boxes]", "x1_batch[boxes]", "x2", "x2[boxes]", "x3",
        "x3[cluster]")
ITERS = 8
LAUNCHES = Launches(ROWS)


def reset_launches() -> None:
    LAUNCHES.reset()


def inputs(device) -> dict[str, torch.Tensor]:
    """The scripts' sources: ``x1`` and ``x1_batch`` each from a fresh seed 0
    (``:67-72``), in [0, 2^20) int32; ``x2`` ``arange`` (160, 640) int32
    (``:96``); ``x3`` ``arange`` (3, 64, 256) float32 (``:149``)."""
    def draw(shape):
        rng = np.random.default_rng(0)
        return torch.from_numpy(rng.integers(0, 1 << 20, shape).astype(np.int32)).to(device)
    return {"x1": draw((H, W)), "x1_batch": draw((BATCH, H, W)),
            "x2": torch.arange(H * W, dtype=torch.int32, device=device).reshape(H, W),
            "x3": torch.arange(N_VAR * A * B, dtype=torch.float32,
                               device=device).reshape(N_VAR, A, B)}


def _offsets(n: int, step: int, pad: int, hi: int) -> list[int]:
    return [min(max(0, t * step - pad), hi) for t in range(n)]


def _window_offsets() -> tuple[list[int], list[int]]:
    """Each tile row's and tile column's clamped window offset."""
    hi_h, hi_w = (H - BAND_H) // 32 * 32, (W - BAND_W) // 128 * 128
    return (_offsets(N_TY, STEP_H, PAD_LO_H, hi_h), _offsets(N_TX, STEP_W, PAD_LO_W, hi_w))


def _corner_index(device) -> tuple[torch.Tensor, torch.Tensor]:
    """Source row of each output row and source column of each output column."""
    oy, ox = _window_offsets()
    rows = torch.tensor([o + i for o in oy for i in range(TH)], device=device)
    cols = torch.tensor([o + j for o in ox for j in range(TW)], device=device)
    return rows, cols


def corner_index(device) -> torch.Tensor:
    """The flat source index of every element of X1's output, (128, 512):
    ``src.view(-1)[flat]`` (``src.view(B, -1)[:, flat]`` over a batch) is
    ``window_x1_plain(src)``, the library call of X1's rows."""
    rows, cols = _corner_index(device)
    return (rows[:, None] * W + cols[None, :]).contiguous()


def _check_src(src: torch.Tensor, batched: bool) -> None:
    shape = (src.shape[0], H, W) if batched else (H, W)
    if src.dtype != torch.int32 or tuple(src.shape) != shape or (batched and src.shape[0] < 1):
        raise ValueError(f"src must be {'(B, ' if batched else '('}{H}, {W}) int32, got "
                         f"{tuple(src.shape)} {src.dtype}")


def window_x1_plain(src: torch.Tensor) -> torch.Tensor:
    """``run_x1``'s function: each tile's clamped window corner, (..., 128, 512)."""
    _check_src(src, src.ndim == 3)
    rows, cols = _corner_index(src.device)
    return src[..., rows, :][..., cols].contiguous()


def window_x2_plain(src: torch.Tensor) -> torch.Tensor:
    """``run_x2``'s function: rows 128-159, columns 0-127, (32, 128)."""
    _check_src(src, False)
    r0 = (H - 32) // 32 * 32
    return src[r0:r0 + 32, :TW].clone()


def window_x3_plain(var: torch.Tensor) -> torch.Tensor:
    """``run_x3``'s function: ``var[[0, 1, 1, 2]]``, (4, 64, 256)."""
    if var.dtype != torch.float32 or tuple(var.shape) != (N_VAR, A, B):
        raise ValueError(f"var must be ({N_VAR}, {A}, {B}) float32, got "
                         f"{tuple(var.shape)} {var.dtype}")
    return var[[0, 1, 1, 2]].clone()


def window_x1(src: torch.Tensor, form: str | None = None) -> torch.Tensor:
    """Kernel M, X1: src (160, 640) or (B, 160, 640) int32 -> (..., 128, 512),
    in ``form`` (``"boxes"``, the default, or ``"single"``).  A CPU tensor
    takes :func:`window_x1_plain`; a CUDA tensor launches the kernel or
    raises."""
    form = X1_FORMS[0] if form is None else form
    if form not in X1_FORMS:
        raise ValueError(f"window_x1 takes form 'boxes' or 'single', got {form!r}")
    batched = src.ndim == 3
    _check_src(src, batched)
    if not _harness.on_card(src):
        return window_x1_plain(src)
    if not src.is_contiguous():
        raise ValueError("window_x1 takes a contiguous source")
    out = torch.empty((*src.shape[:-2], N_TY * TH, N_TX * TW), dtype=torch.int32,
                      device=src.device)
    lib = _harness.lib_with_setup("iqo_exp_window_setup", src.device)
    _harness.check_rc(lib.iqo_exp_window_x1(
        X1_FORMS.index(form), src.data_ptr(), out.data_ptr(), src.shape[0] if batched else 0,
        _harness.stream(src)), f"window_x1[{form}]")
    row = "x1_batch" if batched else "x1"
    LAUNCHES.add(row if form == "single" else f"{row}[boxes]")
    return out


def x1_schedule(planes: int = 0) -> list[dict]:
    """X1's split form, one entry a block (planes 0: the 2-D source): its
    plane, tile (ty, tx) and box j, the box it loads (its row and column in
    the source, (64, 32)) from the tile's clamped window, and the output
    rows and columns it writes (rows 0-31 of the box; none for boxes 4-7,
    past the corner's 128 columns)."""
    oy, ox = _window_offsets()
    out = []
    for plane in range(max(planes, 1)):
        for ty in range(N_TY):
            for tx in range(N_TX):
                for j in range(X2_BOXES):
                    col = j * X2_BOX_W
                    out.append({"plane": plane, "ty": ty, "tx": tx, "box": j,
                                "row": oy[ty], "col": ox[tx] + col,
                                "shape": (BAND_H, X2_BOX_W),
                                "out_rows": range(ty * TH, ty * TH + TH),
                                "out_cols": range(tx * TW + col, tx * TW + col + X2_BOX_W)
                                if col < TW else range(0)})
    return out


def x1_model(src: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The split form in NumPy: each block's box read from ``src`` ((160,
    640) or (B, 160, 640)), its rows 0-31 written to its columns of the
    corner.  Returns out ((..., 128, 512)) and how often each element of
    every tile's (64, 256) window was loaded, (planes, 4, 4, 64, 256)."""
    planes = src[None] if src.ndim == 2 else src
    out = np.zeros((planes.shape[0], N_TY * TH, N_TX * TW), np.int32)
    writes = np.zeros(out.shape, np.int64)
    loads = np.zeros((planes.shape[0], N_TY, N_TX, BAND_H, BAND_W), np.int64)
    oy, ox = _window_offsets()
    for blk in x1_schedule(planes.shape[0] if src.ndim == 3 else 0):
        r, c = blk["row"], blk["col"]
        box = planes[blk["plane"], r:r + BAND_H, c:c + X2_BOX_W]
        j0 = c - ox[blk["tx"]]
        loads[blk["plane"], blk["ty"], blk["tx"], :, j0:j0 + X2_BOX_W] += 1
        if len(blk["out_cols"]):
            out[blk["plane"], blk["out_rows"].start:blk["out_rows"].stop,
                blk["out_cols"].start:blk["out_cols"].stop] = box[:TH]
            writes[blk["plane"], blk["out_rows"].start:blk["out_rows"].stop,
                   blk["out_cols"].start:blk["out_cols"].stop] += 1
    if not (writes == 1).all():
        raise AssertionError("the boxes do not write every output element once")
    return (out[0] if src.ndim == 2 else out), loads


def x2_schedule() -> list[dict]:
    """X2's split form, one entry a block: the box it loads (its column and
    row, (64, 32)), the source rows inside the box, the rows past the
    source's end that TMA fills with zeros, and the columns of ``out`` it
    writes (rows 0-31; none for boxes past ``out``'s 128 columns)."""
    r0 = (H - 32) // 32 * 32
    out = []
    for b in range(X2_BOXES):
        c0 = b * X2_BOX_W
        inside = max(0, min(BAND_H, H - r0))
        out.append({"block": b, "col": c0, "row": r0, "shape": (BAND_H, X2_BOX_W),
                    "rows_inside": inside, "rows_past_end": BAND_H - inside,
                    "out_cols": range(c0, c0 + X2_BOX_W) if c0 < TW else range(0)})
    return out


def x2_model(src: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The split form in NumPy: each block's box read from ``src`` with the
    rows past the end as zeros, written to its columns of ``out`` and of
    ``spill``.  Returns out (32, 128), spill (64, 256) and how often each
    element of the (64, 256) window was loaded."""
    out = np.zeros((32, TW), np.int32)
    spill = np.zeros((BAND_H, BAND_W), np.int32)
    loads = np.zeros((BAND_H, BAND_W), np.int64)
    for blk in x2_schedule():
        r, c = blk["row"], blk["col"]
        box = np.zeros(blk["shape"], np.int32)
        box[:blk["rows_inside"]] = src[r:r + blk["rows_inside"], c:c + X2_BOX_W]
        loads[:, c:c + X2_BOX_W] += 1
        if len(blk["out_cols"]):
            out[:, blk["out_cols"]] = box[:32]
        spill[:, c:c + X2_BOX_W] = box
    return out, spill, loads


def window_x2(src: torch.Tensor, spill: torch.Tensor | None = None,
              form: str | None = None) -> torch.Tensor:
    """Kernel M, X2: src (160, 640) int32 -> (32, 128), in ``form``
    (``"boxes"``, the default, or ``"single"``); ``spill`` (64, 256) int32,
    if given, takes the whole window (the card only).  A CPU tensor takes
    :func:`window_x2_plain`; a CUDA tensor launches the kernel or raises."""
    form = X2_FORMS[0] if form is None else form
    if form not in X2_FORMS:
        raise ValueError(f"window_x2 takes form 'boxes' or 'single', got {form!r}")
    _check_src(src, False)
    if spill is not None and (spill.dtype != torch.int32 or
                              tuple(spill.shape) != (BAND_H, BAND_W)):
        raise ValueError(f"spill must be ({BAND_H}, {BAND_W}) int32")
    if not _harness.on_card(src, *(() if spill is None else (spill,))):
        return window_x2_plain(src)
    if not src.is_contiguous() or (spill is not None and not spill.is_contiguous()):
        raise ValueError("window_x2 takes contiguous tensors")
    out = torch.empty((32, TW), dtype=torch.int32, device=src.device)
    lib = _harness.lib_with_setup("iqo_exp_window_setup", src.device)
    _harness.check_rc(lib.iqo_exp_window_x2(
        X2_FORMS.index(form), src.data_ptr(), out.data_ptr(),
        None if spill is None else spill.data_ptr(), _harness.stream(src)),
        f"window_x2[{form}]")
    LAUNCHES.add("x2" if form == "single" else "x2[boxes]")
    return out


def _variant(t: int) -> int:
    """v(t) of the TPU kernel: 0, 1, 1, 2."""
    return 0 if t == 0 else (2 if t == 3 else 1)


def x3_schedule() -> list[dict]:
    """The cluster form's schedule, one entry a block: its cluster (row
    chunk), rank t, the variant slices it bulk-copies into its own shared
    memory (rank 0: all three; the other ranks none), the variant v(t) it
    reads from rank 0's shared memory, and the rows it writes of
    ``out[t]``."""
    return [{"chunk": k, "rank": t, "copies": list(range(N_VAR)) if t == 0 else [],
             "reads": _variant(t), "rows": range(X3_ROWS * k, X3_ROWS * (k + 1))}
            for k in range(X3_CHUNKS) for t in range(X3_STEPS)]


def x3_model(var: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The cluster form in NumPy: the copies fill the scratch slices of the
    ranks that issue them ({(chunk, rank, variant): rows}), then every block
    reads its slice from rank 0 of its cluster, which must hold it.  Returns
    out (4, 64, 256) and how often each of its elements was written."""
    scratch = {}
    sched = x3_schedule()
    for blk in sched:
        for v in blk["copies"]:
            scratch[blk["chunk"], blk["rank"], v] = var[v, blk["rows"]].copy()
    out = np.zeros((X3_STEPS, A, B), np.float32)
    writes = np.zeros((X3_STEPS, A, B), np.int64)
    for blk in sched:
        key = blk["chunk"], 0, blk["reads"]
        if key not in scratch:
            raise AssertionError(f"block {blk} reads a slice that no copy filled")
        out[blk["rank"], blk["rows"]] = scratch[key]
        writes[blk["rank"], blk["rows"]] += 1
    return out, writes


def window_x3(var: torch.Tensor, form: str | None = None) -> torch.Tensor:
    """Kernel M, X3: var (3, 64, 256) float32 -> (4, 64, 256), in ``form``
    (``"cluster"``, the default, or ``"serial"``).  A CPU tensor takes
    :func:`window_x3_plain`; a CUDA tensor launches the kernel or raises
    (also where the card refuses the cluster launch)."""
    form = FORMS[0] if form is None else form
    if form not in FORMS:
        raise ValueError(f"window_x3 takes form 'cluster' or 'serial', got {form!r}")
    if var.dtype != torch.float32 or tuple(var.shape) != (N_VAR, A, B):
        raise ValueError(f"var must be ({N_VAR}, {A}, {B}) float32, got "
                         f"{tuple(var.shape)} {var.dtype}")
    if not _harness.on_card(var):
        return window_x3_plain(var)
    if not var.is_contiguous():
        raise ValueError("window_x3 takes a contiguous var")
    out = torch.empty((X3_STEPS, A, B), dtype=torch.float32, device=var.device)
    if form == "cluster":
        with torch.cuda.device(var.device):
            rc = _harness.lib().iqo_exp_window_x3_cluster(
                var.data_ptr(), out.data_ptr(), _harness.stream(var))
        _harness.check_rc(rc, "window_x3[cluster]")
        LAUNCHES.add("x3[cluster]")
        return out
    lib = _harness.lib_with_setup("iqo_exp_window_setup", var.device)
    _harness.check_rc(lib.iqo_exp_window_x3(
        var.data_ptr(), out.data_ptr(), X3_STEPS, _harness.stream(var)), "window_x3")
    LAUNCHES.add("x3")
    return out


def bound(row: str) -> tuple[float, str, int]:
    """(ms, 'bytes', bytes) of one launch: what the function reads and writes,
    once each, at 3.35 TB/s (a launch's latency is far longer)."""
    corners = N_TY * N_TX * TH * TW * 4
    nbytes = {"x1": 2 * corners, "x1_batch": 2 * BATCH * corners,
              "x2": 2 * 32 * TW * 4, "x3": (N_VAR + X3_STEPS) * A * B * 4}[row.split("[")[0]]
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def main() -> dict:
    """The script's four runs on card 0, X1, X2 and X3 in both forms, each
    held to its plain version, with the script's OK / WRONG / REJECTED lines
    (the default forms, X1's and X2's boxes and X3's cluster, under the
    script's labels); X1's two forms timed in turns with the corner-gathering
    index (2-D and batch), X2's with ``src[128:160, :128].clone()``, X3's
    with ``var.index_select(0, idx)``; the spill of both X2 forms checked:
    rows inside == src, rows past the end zeros; returns {row: {ok, ms,
    ...}, "x2_past_end": ...}."""
    _harness.require_card()
    card = _harness.card()
    dev = torch.device("cuda", 0)
    srcs = inputs(dev)
    x3 = {f: functools.partial(window_x3, form=f) for f in FORMS}
    x2 = {f: functools.partial(window_x2, form=f) for f in X2_FORMS}
    x1 = {f: functools.partial(window_x1, form=f) for f in X1_FORMS}
    calls = {"x1": (x1["single"], window_x1_plain), "x1_batch": (x1["single"], window_x1_plain),
             "x1[boxes]": (x1["boxes"], window_x1_plain),
             "x1_batch[boxes]": (x1["boxes"], window_x1_plain),
             "x2": (x2["single"], window_x2_plain), "x2[boxes]": (x2["boxes"], window_x2_plain),
             "x3": (x3["serial"], window_x3_plain),
             "x3[cluster]": (x3["cluster"], window_x3_plain)}
    label = {"x1": "X1 [single] batch=None", "x1_batch": f"X1 [single] batch={BATCH}",
             "x1[boxes]": "X1 batch=None", "x1_batch[boxes]": f"X1 batch={BATCH}",
             "x2": "X2 [single] (OOB-high Element window)",
             "x2[boxes]": "X2 (OOB-high Element window)",
             "x3": "X3 [serial] (dynamic scratch leading index)",
             "x3[cluster]": "X3 (dynamic scratch leading index)"}
    rows, verdicts = {}, {}
    for row, (fn, plain) in calls.items():
        x = srcs[row.split("[")[0]]
        try:
            ok = torch.equal(fn(x), plain(x))
        except RuntimeError as e:        # a refused launch or tensor map: the script's REJECTED
            print(f"{label[row]}: REJECTED: {type(e).__name__}: {str(e)[:300]}", flush=True)
            rows[row] = {"ok": False, "rejected": True}
            continue
        verdicts[row] = ("OK" if ok else "VALUE MISMATCH") if row.startswith("x1") else \
            ("ran, in-bounds part " + ("OK" if ok else "WRONG")) if row.startswith("x2") else \
            ("ran, " + ("OK" if ok else "WRONG VALUES"))
        rows[row] = {"ok": ok, "rejected": False}
    # library calls, each held to the plain version first
    r0 = (H - 32) // 32 * 32
    idx = torch.tensor([0, 1, 1, 2], device=dev)
    flat = corner_index(dev)
    library = {"x1": lambda t: t.view(-1)[flat],
               "x1_batch": lambda t: t.view(t.shape[0], -1)[:, flat],
               "x2": lambda t: t[r0:r0 + 32, :TW].clone(),
               "x3": lambda t: t.index_select(0, idx)}
    for row, fn in library.items():
        if not torch.equal(fn(srcs[row]), calls[row][1](srcs[row])):
            raise AssertionError(f"the library call of {row} differs from its plain version")
    ran = [r for r in ROWS if not rows[r]["rejected"]]
    ms = {}
    for group in (("x1", "x1[boxes]"), ("x1_batch", "x1_batch[boxes]"), ("x2", "x2[boxes]"),
                  ("x3", "x3[cluster]")):
        base = group[0]
        turns = {r: (calls[r][0], _harness.perturbed(srcs[base], ITERS)) for r in group if r in ran}
        turns[base + " library"] = (library[base], _harness.perturbed(srcs[base], ITERS))
        ms.update(_harness.turns_ms(turns))
    for row in ran:
        b_ms, by, nbytes = bound(row)
        base = row.split("[")[0]
        extra = {"library_ms": ms[base + " library"]} if base in library else {}
        if row == "x3[cluster]" and "x3" in ms:
            extra["serial_ms"] = ms["x3"]
        if row in ("x1[boxes]", "x1_batch[boxes]", "x2[boxes]") and base in ms:
            extra["single_ms"] = ms[base]
        print(f"{label[row]}: {verdicts[row]}; {ms[row] * 1e3!r} us per launch, {nbytes} bytes, "
              f"bound {b_ms * 1e3!r} us ({by})"
              + "".join(f"; {k} {v * 1e3!r} us in the same turns" for k, v in extra.items())
              + f" ({card})", flush=True)
        rows[row].update(ms=ms[row], bound_ms=b_ms, bound_by=by, bytes=nbytes, **extra)
    inside = H - (H - 32) // 32 * 32
    zeros, same = True, True
    for form in X2_FORMS:
        spill = torch.full((BAND_H, BAND_W), -1, dtype=torch.int32, device=srcs["x2"].device)
        window_x2(srcs["x2"], spill, form)
        past = spill[inside:]
        zeros &= bool((past == 0).all())
        same &= torch.equal(spill[:inside], srcs["x2"][128:, :BAND_W])
        print(f"X2 [{form}] rows past the end ({past.shape[0]} x {BAND_W}): "
              f"{'all zeros' if (past == 0).all() else 'not all zeros: ' + str(past.unique()[:8].tolist())}; "
              f"rows inside == src: {torch.equal(spill[:inside], srcs['x2'][128:, :BAND_W])} "
              f"({card})", flush=True)
    rows["x2_past_end"] = {"all_zeros": zeros, "inside_equal": same, "rows": BAND_H - inside}
    return rows


if __name__ == "__main__":
    main()
