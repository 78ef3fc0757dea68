"""Multi-device sharding for batched and spatial resize, on PyTorch.

The port of ``libiqo_tpu/parallel/sharding.py``, with the same four
functions and the same ``(fn, operands)`` shape, ``fn(*operands, src)``:

* :func:`resize_batch_dp`: frames over one mesh axis; each device resizes
  its local frames; no communication.
* :func:`make_row_sharded_fn`: source and output rows over one axis.  The
  Y pass's taps cross shard boundaries, so each shard is extended by halo
  rows of its neighbours before it is resized (:func:`_halo_exchange`).
* :func:`make_batch_row_sharded_fn`: the two over a 2-D mesh, halos along
  the row axis only.
* :func:`make_yuv_step_fn`: the batched YUV420 step, frames over one axis,
  one frame call of the executables per device.

**One controller.**  A :class:`Mesh` is a grid of ``torch.device``s held
by one process, as a JAX ``Mesh`` is: the JAX functions build one
``shard_map`` and return one callable.  A process per rank over NCCL would
need a card per rank (NCCL refuses two ranks on one GPU), so a one-card
machine could put no halo on the card.  Here a mesh may name one device
more than once: eight shards on one CPU, four on one card.  Halos move as
device-to-device copies (``Tensor.to(device, non_blocking=True)``), the
counterpart of ``jax.lax.ppermute``; between distinct cards they are peer
copies.

**The per-device body is the port's kernel** (K8's counterpart): each row
shard resizes its halo-extended band with ``cuda_resize.resize_fused`` on
its own local plan (its output rows' Y taps, with their starts moved into
the band), packed on its device through the operand cache, so shards with
equal local plans share tables.  The JAX package's shift-invariance check,
``union_border`` template and per-device byte-plane stacking exist only
because ``shard_map`` runs one program on every device; per-device tables
need none of them.  A shard whose local plan the kernel refuses
(``cuda_resize.supports_plan``) takes ``torch_resize.resize``: the route is
a predicate of the plan and the device, with ``api.Resizer``'s meaning of
``backend`` ("auto", "cuda", "torch"), and each function reports it, as
``Resizer.resolved_backend()`` does (``fn.routes``).

Outputs stay on the devices that computed them, as JAX leaves them
sharded: a :class:`Sharded` grid of blocks, from which :func:`gather`
assembles one tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import api
from ..core.plan import ResizePlan, build_plan
from ..golden import numpy_ref
from ..ops import cuda_resize, torch_resize
from ..ops.executable import launch_frame
from ..utils.device import resolve_device

__all__ = ["Mesh", "Sharded", "ShardedFn", "dryrun", "gather",
           "make_batch_row_sharded_fn", "make_row_sharded_fn",
           "make_yuv_step_fn", "resize_batch_dp"]

_BACKENDS = ("auto", "cuda", "torch")


def _objects(items, shape=None) -> np.ndarray:
    """An object array of ``items`` (NumPy would unpack tensors)."""
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr if shape is None else arr.reshape(shape)


class Mesh:
    """A grid of devices with one name per axis: the counterpart of
    ``jax.sharding.Mesh``.  ``devices`` is any array-like of devices or
    device strings (CUDA ones are checked to exist); ``shape[axis]`` is an
    axis's extent, as in JAX.  A device may appear more than once."""

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"{arr.ndim}-D device grid, axis names {names}")
        self.devices = _objects([resolve_device(d) for d in arr.ravel()],
                                arr.shape)
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))

    def grid(self, *axes) -> np.ndarray:
        """The devices over ``axes``, in that order, at index 0 of every
        other axis (over which JAX replicates the computation; the port
        computes it once)."""
        idx = [self.axis_names.index(a) for a in axes]
        arr = np.moveaxis(self.devices, idx, range(len(idx)))
        return arr[(slice(None),) * len(idx) + (0,) * (arr.ndim - len(idx))]


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A result left on the devices that computed it: ``blocks`` is an
    object array of tensors, one per device, laid out as the mesh axes the
    result is sharded over; grid axis ``k`` joins along tensor dimension
    ``dims[k]``.  Padding is already cut from the blocks."""
    blocks: np.ndarray
    dims: tuple[int, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        shape = list(self.blocks.flat[0].shape)
        for k, dim in enumerate(self.dims):
            line = np.moveaxis(self.blocks, k, 0).reshape(
                self.blocks.shape[k], -1)[:, 0]
            shape[dim] = sum(b.shape[dim] for b in line)
        return tuple(shape)


def gather(out, device=None):
    """One tensor of a :class:`Sharded` result (each of a tuple of them,
    as the YUV step returns) on ``device``, by default the first block's."""
    if isinstance(out, tuple):
        return tuple(gather(o, device) for o in out)
    dev = out.blocks.flat[0].device if device is None else torch.device(device)
    return _join(out.blocks, out.dims, dev)


def _join(blocks: np.ndarray, dims, dev) -> torch.Tensor:
    parts = [b.to(dev) if blocks.ndim == 1 else _join(b, dims[1:], dev)
             for b in blocks]
    return torch.cat(parts, dim=dims[0])


class ShardedFn:
    """A sharded resize, called as ``fn(*operands, src)``.  ``routes``
    holds, in mesh order, the route each device's body takes: "cuda" (the
    kernel) or "torch" (the plain path)."""

    def __init__(self, fn, routes):
        self._fn = fn
        self.routes = tuple(routes)

    def __call__(self, *args):
        return self._fn(*args)


def _route(plan: ResizePlan, dev: torch.device, backend: str) -> str:
    """``api.Resizer``'s rule for an exact plan: the kernel where it takes
    the plan, for data on a CUDA device (``"auto"``) or anywhere
    (``"cuda"``, whose CPU tensors run the kernel's plain version); else
    the plain path."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    kernel = backend == "cuda" or (backend == "auto" and dev.type == "cuda")
    return "cuda" if kernel and cuda_resize.supports_plan(plan) else "torch"


def _resize(route: str, ops: cuda_resize.KernelOperands,
            x: torch.Tensor) -> torch.Tensor:
    """(h, w) or (B, h, w) -> the same leading shape, resized on x's device
    in one call: the kernel for route "cuda", else the plain path."""
    x3 = x if x.ndim == 3 else x.unsqueeze(0)
    if route == "cuda":
        out = cuda_resize.resize_fused(ops, x3)
    else:
        out = torch_resize.resize(ops.plain, x3)
    return out if x.ndim == 3 else out[0]


def _tensor(src) -> torch.Tensor:
    if isinstance(src, torch.Tensor):
        return src
    arr = np.asarray(src)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    # asynchronous only toward a card, which orders the copy on its
    # streams; a copy toward the host must be complete when it returns
    return x.to(dev, non_blocking=dev.type == "cuda")


def _pad(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` with ``n`` zero entries appended along ``dim``."""
    if not n:
        return t
    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _dp(devices, routes, ops, src) -> Sharded:
    """Frames of ``src`` (B, h, w) split over ``devices``, zero-padded to a
    multiple of their count, each device's frames resized in one call, the
    padding cut off."""
    t = _tensor(src)
    n, b = len(devices), t.shape[0]
    t = _pad(t, 0, -b % n)
    bl = t.shape[0] // n
    blocks = [_resize(r, o, _to(t[i * bl:(i + 1) * bl], dev))
              [:max(0, min(bl, b - i * bl))]
              for i, (dev, r, o) in enumerate(zip(devices, routes, ops))]
    return Sharded(_objects(blocks), (0,))


def resize_batch_dp(plan: ResizePlan, frames, mesh: Mesh, axis: str = "data",
                    backend: str = "auto") -> Sharded:
    """Resize a (B, H, W) uint8 batch (NumPy or tensor) with B split over
    ``axis``: one call per device on its local frames, no communication.
    Batches not divisible by the axis are zero-padded on the frame axis and
    the padding is cut off, as in the JAX package.  The output stays on the
    devices (:func:`gather`)."""
    devices = list(mesh.grid(axis))
    digest = api._plan_digest(plan)
    return _dp(devices, [_route(plan, dev, backend) for dev in devices],
               [api.operands_for(plan, dev, digest=digest) for dev in devices],
               frames)


@dataclasses.dataclass(frozen=True)
class RowShardLayout:
    """Row sharding of a plan whose heights divide the shard count: each
    shard holds ``hs`` source rows and computes ``hd`` output rows, over a
    band of ``halo_up`` rows of the shards above, its own rows and
    ``halo_dn`` rows of the shards below."""
    hs: int
    hd: int
    halo_up: int
    halo_dn: int

    @property
    def band(self) -> int:
        return self.halo_up + self.hs + self.halo_dn


def _row_shard_layout(plan: ResizePlan, n: int) -> RowShardLayout:
    """The port of ``sharding._row_shard_layout`` (``:94-127``): the halo
    sizes from each output block's source rows.  Out-of-range taps are
    zero in the plan, so the rows are clipped to the frame.  Requires
    src_h and dst_h divisible by n (``_pad_rows_plan`` pads first).  The
    JAX function also builds dense per-device Y blocks for its XLA body;
    here :func:`_local_plan` gives each shard its own Y taps instead."""
    y = plan.y
    src_h, dst_h = y.n_src, y.n_dst
    if src_h % n or dst_h % n:
        raise ValueError(f"src_h={src_h} and dst_h={dst_h} must divide the "
                         f"row-shard count {n}")
    hs, hd = src_h // n, dst_h // n
    starts = y.start
    lo = np.array([max(0, int(starts[d * hd:(d + 1) * hd].min())) for d in range(n)])
    hi = np.array([min(src_h, int(starts[d * hd:(d + 1) * hd].max()) + y.num_coefs)
                   for d in range(n)])
    halo_up = int(np.max(np.maximum(0, np.arange(n) * hs - lo)))
    halo_dn = int(np.max(np.maximum(0, hi - (np.arange(n) + 1) * hs)))
    return RowShardLayout(hs, hd, halo_up, halo_dn)


def _local_plan(plan: ResizePlan, lay: RowShardLayout, d: int) -> ResizePlan:
    """Shard ``d``'s plan: a (band, src_w) -> (hd, dst_w) resize whose Y
    axis holds output rows [d*hd, (d+1)*hd) of ``plan``, their taps moved
    into the band (``start - d*hs + halo_up``).  Every nonzero tap lands
    inside the band; zero taps may land on zero halo rows or be clamped,
    harmlessly."""
    y = plan.y
    sl = slice(d * lay.hd, (d + 1) * lay.hd)
    return dataclasses.replace(plan, y=dataclasses.replace(
        y, n_src=lay.band, n_dst=lay.hd, coef=y.coef[sl],
        start=y.start[sl] - d * lay.hs + lay.halo_up, deno=y.deno[sl],
        is_border=y.is_border[sl]))


def _halo_exchange(shards, halo_up: int, halo_dn: int):
    """Each row shard extended with its neighbours' halo rows: the port of
    ``sharding._halo_exchange`` (``:130-158``) over the list of shards.

    Hop ``h`` copies the tail rows (upward halo) or head rows (downward)
    of the shard ``h`` positions away onto the receiving shard's device,
    so halos taller than a shard chain hops.  Rows that would come from
    before shard 0 or after the last shard are zeros, as are their taps.
    Rows stay on axis -2, so ``(rows, w)`` and ``(b, rows, w)`` shards are
    served alike.

    Ordering: every piece is copied, and the band concatenated, on the
    receiving device's current stream, where the kernel that reads the
    band is launched next.  With one device repeated, everything is on
    one stream.  Between distinct cards PyTorch's peer copy runs on the
    source device's current stream and makes both devices' current streams
    wait for it, so the band is complete before its kernel starts."""
    n = len(shards)
    hs = shards[0].shape[-2]

    def piece(i: int, j: int, rows: slice) -> torch.Tensor:
        own = shards[i]
        if 0 <= j < n:
            return _to(shards[j][..., rows, :], own.device)
        shape = own.shape[:-2] + (rows.stop - rows.start, own.shape[-1])
        return torch.zeros(shape, dtype=own.dtype, device=own.device)

    bands = []
    for i in range(n):
        parts = []
        for h in range(-(-halo_up // hs), 0, -1):    # farthest first
            t = min(hs, halo_up - (h - 1) * hs)      # rows carried by hop h
            parts.append(piece(i, i - h, slice(hs - t, hs)))
        parts.append(shards[i])
        for h in range(1, -(-halo_dn // hs) + 1):
            t = min(hs, halo_dn - (h - 1) * hs)
            parts.append(piece(i, i + h, slice(0, t)))
        bands.append(torch.cat(parts, dim=-2) if len(parts) > 1 else shards[i])
    return bands


def _pad_rows_plan(plan: ResizePlan, n: int):
    """The port of ``sharding._pad_rows_plan`` (``:259-284``): extend a
    plan's Y axis so src_h and dst_h divide ``n``.  Padded source rows hold
    zeros and no real output's taps reach them; padded output rows get
    all-zero taps, deno 1 and no border, and are cut off by the caller.
    Returns (padded_plan, src_pad, dst_pad)."""
    y = plan.y
    src_pad = -y.n_src % n
    dst_pad = -y.n_dst % n
    if not src_pad and not dst_pad:
        return plan, 0, 0
    coef = np.concatenate(
        [y.coef, np.zeros((dst_pad, y.num_coefs), y.coef.dtype)])
    # pad starts repeat the last real window (kept in range so per-device
    # band bounds stay tight); their taps are zero so values don't matter
    start = np.concatenate(
        [y.start, np.full(dst_pad, int(y.start[-1]) if y.n_dst else 0,
                          y.start.dtype)])
    deno = np.concatenate([y.deno, np.ones(dst_pad, y.deno.dtype)])
    is_border = np.concatenate([y.is_border, np.zeros(dst_pad, bool)])
    y_pad = dataclasses.replace(
        y, n_src=y.n_src + src_pad, n_dst=y.n_dst + dst_pad,
        coef=coef, start=start, deno=deno, is_border=is_border)
    return dataclasses.replace(plan, y=y_pad), src_pad, dst_pad


def _row_shards(plan: ResizePlan, devices, backend: str):
    """Layout, routes and operands of a padded plan's row shards, shard d
    on ``devices[d]``."""
    lay = _row_shard_layout(plan, len(devices))
    routes, operands = [], []
    for d, dev in enumerate(devices):
        local = _local_plan(plan, lay, d)
        routes.append(_route(local, dev, backend))
        operands.append(api.operands_for(local, dev))
    return lay, routes, operands


def _run_rows(lay: RowShardLayout, routes, ops, devices, t: torch.Tensor,
              true_rows: int):
    """``t`` (..., rows, w) split into row shards on ``devices``, halos
    exchanged, each band resized in one call; output rows past
    ``true_rows`` cut off.  Returns the output blocks."""
    hs, hd = lay.hs, lay.hd
    shards = [_to(t[..., d * hs:(d + 1) * hs, :], dev)
              for d, dev in enumerate(devices)]
    bands = _halo_exchange(shards, lay.halo_up, lay.halo_dn)
    return [_resize(r, o, band)[..., :max(0, min(hd, true_rows - d * hd)), :]
            for d, (r, o, band) in enumerate(zip(routes, ops, bands))]


def make_row_sharded_fn(plan: ResizePlan, mesh: Mesh, axis: str = "row",
                        backend: str = "auto"):
    """A (src_h, src_w) -> (dst_h, dst_w) resize with source and output rows
    split over ``axis``; halo rows move between shards, over several hops
    when a tap window spans several shards.  Any height works: heights not
    divisible by the shard count are zero-padded (``_pad_rows_plan``) and
    the padded output rows cut off.  Each shard's body is the kernel on its
    own local plan where ``supports_plan`` takes it, else the plain path
    (``fn.routes``).

    Returns (fn, operands): ``fn(*operands, src)`` returns a
    :class:`Sharded` over the rows."""
    devices = list(mesh.grid(axis))
    plan_p, src_pad, _ = _pad_rows_plan(plan, len(devices))
    lay, routes, operands = _row_shards(plan_p, devices, backend)

    def fn(*args):
        *ops, src = args
        t = _pad(_tensor(src), -2, src_pad)
        return Sharded(_objects(_run_rows(lay, routes, ops, devices, t,
                                          plan.y.n_dst)), (-2,))

    return ShardedFn(fn, routes), tuple(operands)


def make_batch_row_sharded_fn(plan: ResizePlan, mesh: Mesh,
                              data_axis: str = "data", row_axis: str = "row",
                              backend: str = "auto"):
    """dp x sp over a 2-D mesh: a (B, src_h, src_w) uint8 batch with frames
    split over ``data_axis`` and rows over ``row_axis``.  Halos move along
    the row axis only, once per call whatever the batch, and each device
    resizes all its local frames in one call (the kernel's frame grid
    dimension).  Any batch size and height work (zero-padded and cut back).

    Returns (fn, operands): ``fn(*operands, batch)`` returns a
    :class:`Sharded` over (frames, rows); operands are in (data, row)
    order."""
    grid = mesh.grid(data_axis, row_axis)
    n_data, n_row = grid.shape
    plan_p, src_pad, _ = _pad_rows_plan(plan, n_row)
    lay, routes, operands = None, [], []
    for i in range(n_data):
        lay, r, o = _row_shards(plan_p, list(grid[i]), backend)
        routes.append(r)
        operands += o

    def fn(*args):
        *ops, src = args
        t = _tensor(src)
        b = t.shape[0]
        t = _pad(_pad(t, 0, -b % n_data), -2, src_pad)
        bl = t.shape[0] // n_data
        blocks = []
        for i in range(n_data):
            outs = _run_rows(lay, routes[i], ops[i * n_row:(i + 1) * n_row],
                             list(grid[i]), t[i * bl:(i + 1) * bl],
                             plan.y.n_dst)
            blocks += [o[:max(0, min(bl, b - i * bl))] for o in outs]
        return Sharded(_objects(blocks, (n_data, n_row)), (0, -2))

    return ShardedFn(fn, [r for rs in routes for r in rs]), tuple(operands)


def _dp_yuv(devices, routes, luma, chroma, y, u, v):
    """Frames of the planes ``y``, ``u``, ``v`` split over ``devices``, as
    :func:`_dp`; each device's frames in one frame call of its luma and
    chroma executables where both routes are "cuda", else plane by plane."""
    n = len(devices)
    ts = [_tensor(p) for p in (y, u, v)]
    b = ts[0].shape[0]
    ts = [_pad(t, 0, -b % n) for t in ts]
    bl = ts[0].shape[0] // n
    blocks = ([], [], [])
    for i, dev in enumerate(devices):
        yi, ui, vi = (_to(t[i * bl:(i + 1) * bl], dev) for t in ts)
        if routes[i] == routes[n + i] == "cuda":
            outs = launch_frame(luma[i], chroma[i], yi, ui, vi)
        else:
            outs = (_resize(routes[i], luma[i].ops, yi),
                    _resize(routes[n + i], chroma[i].ops, ui),
                    _resize(routes[n + i], chroma[i].ops, vi))
        keep = max(0, min(bl, b - i * bl))
        for block, out in zip(blocks, outs):
            block.append(out[:keep])
    return tuple(Sharded(_objects(block), (0,)) for block in blocks)


def make_yuv_step_fn(mesh: Mesh, src_w: int, src_h: int, dst_w: int,
                     dst_h: int, degree: int = 3, data_axis: str = "data",
                     backend: str = "auto"):
    """The batched YUV420 Lanczos step with frames split over
    ``data_axis``: luma at its true (possibly odd) size, U and V at the
    halves of the evened size with px_scale 2, as ``yuv.YUV420Resizer``
    (ref: sample/resize_yuv420p.cpp:66-69,150-163).  One frame call per
    device (``ops/executable.launch_frame``: luma, and U and V in place);
    no communication.

    Returns (step, operands): ``step(*operands, y, u, v)`` returns
    (Y', U', V'), each a :class:`Sharded` over frames; operands hold the
    luma executables per device, then the chroma ones (each with its
    ``ops``)."""
    sw, sh = src_w + src_w % 2, src_h + src_h % 2
    dw, dh = dst_w + dst_w % 2, dst_h + dst_h % 2
    plans = (build_plan("lanczos", src_w, src_h, dst_w, dst_h, degree=degree),
             build_plan("lanczos", sw // 2, sh // 2, dw // 2, dh // 2,
                        degree=degree, px_scale=2))
    devices = list(mesh.grid(data_axis))
    n = len(devices)
    routes, executables = [], []
    for plan in plans:
        digest = api._plan_digest(plan)
        routes += [_route(plan, dev, backend) for dev in devices]
        executables += [api.executable_for(plan, dev, digest=digest)
                        for dev in devices]

    def step(*args):
        luma, chroma, (y, u, v) = args[:n], args[n:2 * n], args[2 * n:]
        return _dp_yuv(devices, routes, luma, chroma, y, u, v)

    return ShardedFn(step, routes), tuple(executables)


def _expect(name: str, got: torch.Tensor, plan: ResizePlan,
            frames: np.ndarray) -> None:
    want = np.stack([numpy_ref.resize_u8(plan, f) for f in frames])
    got = got.cpu().numpy()
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"dryrun {name}: output {got.shape} differs "
                             f"from numpy_ref {want.shape}")


def dryrun(n_devices: int, device="cuda") -> dict:
    """The three sections of ``__graft_entry__.dryrun_multichip`` on a mesh
    of ``n_devices`` entries of ``device``, with the kernel asked for
    (``backend="cuda"``; its plain version on the CPU): the YUV step over
    a (n/2, 2) ("data", "row") mesh, a row-sharded frame over n shards, and
    dp x sp with an odd batch and a destination height that does not
    divide.  Unlike the JAX dry run, which checks shapes, every output is
    held byte for byte against ``numpy_ref``; a mismatch raises
    AssertionError.  Returns the frames checked per section."""
    n = n_devices
    devs = _objects([resolve_device(device)] * n)
    rng = np.random.default_rng(0)
    rows = 2 if n % 2 == 0 and n > 1 else 1
    mesh2d = Mesh(devs.reshape(n // rows, rows), ("data", "row"))

    step, ops = make_yuv_step_fn(mesh2d, 64, 48, 32, 24, degree=3,
                                 backend="cuda")
    b = 2 * (n // rows)
    y, u, v = (rng.integers(0, 256, (b, h, w), np.uint8)
               for h, w in ((48, 64), (24, 32), (24, 32)))
    oy, ou, ov = gather(step(*ops, y, u, v))
    luma = build_plan("lanczos", 64, 48, 32, 24, degree=3)
    chroma = build_plan("lanczos", 32, 24, 16, 12, degree=3, px_scale=2)
    for name, got, plan, frames in (("yuv y", oy, luma, y),
                                    ("yuv u", ou, chroma, u),
                                    ("yuv v", ov, chroma, v)):
        _expect(name, got, plan, frames)

    plan = build_plan("lanczos", 128, 16 * n, 64, 8 * n, degree=3)
    fn, ops = make_row_sharded_fn(plan, Mesh(devs, ("row",)), backend="cuda")
    src = rng.integers(0, 256, (16 * n, 128), np.uint8)
    _expect("row-sharded", gather(fn(*ops, src))[None], plan, src[None])

    plan2 = build_plan("lanczos", 96, 64, 64, 8 * rows + 3, degree=2)
    fn2, ops2 = make_batch_row_sharded_fn(plan2, mesh2d, backend="cuda")
    frames = rng.integers(0, 256, (n // rows + 1, 64, 96), np.uint8)
    _expect("dp x sp", gather(fn2(*ops2, frames)), plan2, frames)
    return {"yuv_step": b, "row_sharded": 1, "batch_row_sharded": len(frames)}
