"""Public API: LanczosResizer / AreaResizer / LinearResizer on PyTorch.

The port of ``libiqo_tpu/api.py``, with the same construct-once /
resize-many contract (ref: include/libiqo/LanczosResizer.hpp:26-52): the
constructor builds the plan, ``resize`` is pure compute through a cached
executable over device operands.

* Computation runs on the input tensor's device.  NumPy input runs on the
  resizer's ``device=`` (default ``"cuda"``: the card) and comes back as
  NumPy; a tensor in gives a tensor out on the same device.
* ``device="cuda"`` with no card raises, so constructing a resizer without
  ``device="cpu"`` on a machine with no card raises; nothing falls back to
  the CPU.
* ``backend=``: ``"auto"`` takes the hand-written CUDA kernel when the data
  is on a CUDA device and the kernel takes the plan
  (:func:`~libiqo_tpu_torch.ops.cuda_resize.supports_plan`), the exact
  ``"torch"`` path otherwise.  On a CUDA device the choice depends on the
  plan alone: a card the kernel cannot be built or run for (no ``nvcc``,
  not sm_90) raises on the first ``resize`` instead of running the plain
  path.  ``"cuda"`` asks for the kernel on every plan it takes (a CPU
  tensor then runs the kernel's plain version).  ``"numpy"`` is the golden
  oracle.
* ``precision="relaxed"`` (<= 2 LSB, flat fields exact) runs the
  kernel's relaxed form on the kernel backends (``"auto"`` on a CUDA
  device, and ``"cuda"``), as the JAX package runs its relaxed Pallas
  kernel.  The route is picked by predicates of the plan, in this order:
  the relaxed kernel when ``supports_plan(plan, relaxed=True)``, else the
  exact kernel when ``supports_plan(plan)``, else the exact ``torch``
  path.  ``"torch"`` and ``"numpy"`` always compute exactly, as the JAX
  package's ``"xla"`` and ``"numpy"`` do.
* ``resize`` takes leading batch dimensions; one launch serves the batch.
* ``LIBIQO_TPU_CARRY=1`` (or ``2``), the JAX package's opt-in, runs the
  kernel's row-halo carry form wherever one applies
  (``cuda_resize.tiled_carry_layout``, else ``cuda_resize.carry_ok``); it
  is read where executables are built, so it takes effect for executables
  not yet built.
* Each plan's launch is packed once into an executable
  (:class:`~libiqo_tpu_torch.ops.executable.Executable`, the counterpart
  of the JAX package's ``jax.jit`` executables), kept in an LRU of at most
  ``LIBIQO_TPU_CACHE_SIZE`` entries (default 256; 0 disables caching), as
  the JAX package's ``_COMPILED_CACHE``; a resizer remembers its own per
  device and carry choice, so a ``resize`` issues one ctypes call.
* While the port records (:mod:`.tracing`), a facade's plan build and a
  resizer's plan checks and digest are ``port.plan`` spans, the tables
  packed on a cache miss a ``port.tables`` span, and the cache counts
  ``exec_cache.hit`` and ``exec_cache.miss``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import hashlib
import os
import threading

import numpy as np
import torch

from . import tracing
from .core.plan import ResizePlan, build_plan, plan_from_arrays
from .golden import numpy_ref
from .ops import cuda_resize, torch_resize
from .ops.executable import Executable
from .utils.device import resolve_device

__all__ = ["Resizer", "LanczosResizer", "AreaResizer", "LinearResizer",
           "clear_compiled_cache", "clear_operand_cache", "executable_for",
           "operands_for"]

_BACKENDS = ("auto", "cuda", "torch", "numpy")
_PRECISIONS = ("exact", "relaxed")


class _ExecutableCache:
    """LRU of executables (their packed plan operands and C handles) by
    (plan content, precision, carry, device).

    The reference's benchmark builds a fresh resizer every cycle
    (ref: benchmark/benchmark.cpp:1019-1031); with this cache a fresh
    construction reuses the executable and its device tables.  Entries are
    never written after they are built; a lock guards the dictionary, so
    two threads building one key end with one entry.  ``max_entries`` <= 0
    caches nothing.  An evicted executable is freed, C handle and tables,
    once no resizer holds it."""

    def __init__(self, max_entries: int):
        self.max_entries = max_entries
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, build):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                tracing.count("exec_cache.hit")
                return self._entries[key]
            tracing.count("exec_cache.miss")
            value = build()
            if self.max_entries > 0:
                self._entries[key] = value
                if len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
            return value

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


def cache_size(environ=os.environ) -> int:
    """The executable cache's size: ``LIBIQO_TPU_CACHE_SIZE`` (default 256),
    read once at import, as the JAX package reads it."""
    return int(environ.get("LIBIQO_TPU_CACHE_SIZE", "256"))


_CACHE = _ExecutableCache(cache_size())


def clear_compiled_cache() -> None:
    """Drop every cached executable and its device tables (resizers keep
    the ones they hold)."""
    _CACHE.clear()


clear_operand_cache = clear_compiled_cache


def _plan_digest(plan: ResizePlan) -> str:
    h = hashlib.sha256(repr((plan.algorithm, plan.wrap16, plan.out_shift,
                             plan.geometry)).encode())
    for ax in (plan.y, plan.x):
        h.update(repr((ax.num_coefs, ax.bias_bit)).encode())
        for a in (ax.coef, ax.start, ax.deno, ax.is_border):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def executable_for(plan: ResizePlan, dev: torch.device, relaxed: bool = False,
                   digest: str | None = None, carry: bool | None = None) -> Executable:
    """The plan's executable on ``dev``, through the executable cache, keyed
    by the plan's content (``digest``, computed when not given), the
    precision route, the carry choice (read from ``LIBIQO_TPU_CARRY`` now
    when not given) and the device: executables of different routes or
    carry choices are never shared."""
    if carry is None:
        carry = cuda_resize.carry_requested()
    key = (digest or _plan_digest(plan), "relaxed" if relaxed else "exact",
           "carry" if carry else "windowed", str(dev))

    def build() -> Executable:
        with tracing.span("port.tables"):
            ops = cuda_resize.pack_operands(plan, dev, relaxed=relaxed, carry=carry)
        return Executable(ops)

    return _CACHE.get(key, build)


def operands_for(plan: ResizePlan, dev: torch.device, relaxed: bool = False,
                 digest: str | None = None) -> cuda_resize.KernelOperands:
    """The operands of :func:`executable_for`'s executable."""
    return executable_for(plan, dev, relaxed, digest).ops


def as_tensor(src: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A NumPy array's copy on ``dev``."""
    return torch.from_numpy(src if src.flags.writeable else src.copy()).to(dev)


def _spawn_warmup(fn, *args) -> concurrent.futures.Future:
    """Run ``fn`` on a daemon thread, returning a Future.  Not a
    ThreadPoolExecutor: its threads are joined at interpreter exit, so a
    wedged warmup would block the process from exiting."""
    fut: concurrent.futures.Future = concurrent.futures.Future()

    def run():
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 — relayed via the future
            fut.set_exception(e)

    threading.Thread(target=run, name="libiqo-warmup", daemon=True).start()
    return fut


class Resizer:
    """Base resizer bound to one geometry and one algorithm."""

    def __init__(self, plan: ResizePlan, backend: str = "auto",
                 precision: str = "exact", device="cuda"):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        if precision not in _PRECISIONS:
            raise ValueError(
                f"precision must be one of {_PRECISIONS}, got {precision!r}")
        self._plan = plan
        self._backend = backend
        self._precision = precision
        self._device = resolve_device(device)
        with tracing.span("port.plan"):
            self._kernel_ok = cuda_resize.supports_plan(plan)
            self._relaxed_ok = (precision == "relaxed"
                                and cuda_resize.supports_plan(plan, relaxed=True))
            self._digest = _plan_digest(plan)
        self._bound: dict = {}   # (device, carry) -> (kernel route?, Executable)

    @classmethod
    def from_plan(cls, plan, backend: str = "auto",
                  precision: str = "exact", device="cuda") -> "Resizer":
        """A resizer over a plan built elsewhere.  A :class:`ResizePlan` of
        this package is taken as it is; any other plan object with the same
        fields (e.g. the JAX package's) is copied by
        :func:`~libiqo_tpu_torch.core.plan.plan_from_arrays`."""
        if not isinstance(plan, ResizePlan):
            plan = plan_from_arrays(plan)
        return Resizer(plan, backend=backend, precision=precision,
                       device=device)

    # -- introspection ----------------------------------------------------

    @property
    def plan(self) -> ResizePlan:
        return self._plan

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def src_shape(self) -> tuple[int, int]:
        return (self._plan.y.n_src, self._plan.x.n_src)

    @property
    def dst_shape(self) -> tuple[int, int]:
        return (self._plan.y.n_dst, self._plan.x.n_dst)

    def resolved_backend(self) -> str:
        """The route that data on this resizer's device takes: "cuda" (the
        exact kernel), "cuda-relaxed" (its relaxed form), "torch" or
        "numpy"."""
        return self._backend_for(self._device)

    def _backend_for(self, dev: torch.device) -> str:
        if self._backend in ("torch", "numpy"):
            return self._backend
        if self._backend == "cuda" or dev.type == "cuda":
            if self._relaxed_ok:
                return "cuda-relaxed"
            return "cuda" if self._kernel_ok else "torch"
        return "torch"

    def _operands(self, dev: torch.device,
                  relaxed: bool = False) -> cuda_resize.KernelOperands:
        return operands_for(self._plan, dev, relaxed, self._digest)

    def _bind(self, dev: torch.device) -> tuple[bool, Executable]:
        """Whether data on ``dev`` takes a kernel route, and the executable
        of its route, remembered per (device, carry choice): after the
        first call on a device no digest, key or lock work is done."""
        key = (dev, cuda_resize.carry_requested())
        bound = self._bound.get(key)
        if bound is None:
            route = self._backend_for(dev)
            bound = (route.startswith("cuda"),
                     executable_for(self._plan, dev, route == "cuda-relaxed",
                                    self._digest, key[1]))
            self._bound[key] = bound
        return bound

    def _check(self, src) -> bool:
        """Raise unless ``src`` is a uint8 array or tensor of this
        geometry; returns whether it is NumPy."""
        if tuple(src.shape[-2:]) != self.src_shape:
            raise ValueError(
                f"source spatial shape {tuple(src.shape[-2:])} != "
                f"constructed geometry {self.src_shape}")
        if src.dtype not in (np.uint8, torch.uint8):
            raise TypeError(f"source must be uint8, got {src.dtype}")
        is_numpy = isinstance(src, np.ndarray)
        if not is_numpy and not isinstance(src, torch.Tensor):
            raise TypeError(f"source must be a numpy array or a tensor, "
                            f"got {type(src).__name__}")
        return is_numpy

    # -- compute ----------------------------------------------------------

    def resize(self, src):
        """Resize (src_h, src_w) or (..., src_h, src_w) uint8 -> uint8.

        NumPy in -> NumPy out; tensor in -> tensor out on its device."""
        is_numpy = self._check(src)
        if self._backend == "numpy":
            arr = src if is_numpy else src.cpu().numpy()
            flat = arr.reshape((-1,) + arr.shape[-2:])
            out = np.stack([numpy_ref.resize_u8(self._plan, im) for im in flat])
            return out.reshape(arr.shape[:-2] + out.shape[-2:])

        t = as_tensor(src, self._device) if is_numpy else src
        kernel, ex = self._bind(t.device)
        if kernel and t.dim() in (2, 3):
            out = ex(t)
        else:
            flat = t.reshape((-1,) + self.src_shape)
            out = ex(flat) if kernel else torch_resize.resize(ex.ops.plain, flat)
            out = out.reshape(tuple(t.shape[:-2]) + self.dst_shape)
        return out.cpu().numpy() if is_numpy else out

    # -- warmup -----------------------------------------------------------

    def warmup(self, batch: int | None = None):
        """Build the executable (device operands and, on the kernel path,
        the kernel library and the C handle) now, instead of on the first
        real ``resize``.  Returns ``self``."""
        if self._backend == "numpy":
            return self
        shape = self.src_shape if batch is None else (batch, *self.src_shape)
        self.resize(torch.zeros(shape, dtype=torch.uint8, device=self._device))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return self

    def warmup_async(self, batch: int | None = None):
        """``warmup`` on a daemon thread; returns a
        ``concurrent.futures.Future`` resolving to ``self``."""
        return _spawn_warmup(self.warmup, batch)


def _plan(algorithm: str, *geometry, **kw) -> ResizePlan:
    """A facade's :func:`build_plan`, a ``port.plan`` span while the port
    records."""
    with tracing.span("port.plan"):
        return build_plan(algorithm, *geometry, **kw)


class LanczosResizer(Resizer):
    """Lanczos resampler (ref: include/libiqo/LanczosResizer.hpp:26-33).

    :param degree: window size (2 = Lanczos2, 3 = Lanczos3, ...)
    :param px_scale: pixel scale — pass 2 for U/V planes of YUV420 so the
        kernel support matches luma units (ref: sample/resize_yuv420p.cpp:159)
    """

    def __init__(self, degree: int, src_w: int, src_h: int,
                 dst_w: int, dst_h: int, px_scale: int = 1,
                 backend: str = "auto", precision: str = "exact",
                 device="cuda"):
        super().__init__(
            _plan("lanczos", src_w, src_h, dst_w, dst_h,
                  degree=degree, px_scale=px_scale),
            backend, precision, device)


class AreaResizer(Resizer):
    """Area-average resampler, downscale-oriented
    (ref: include/libiqo/AreaResizer.hpp:20-27)."""

    def __init__(self, src_w: int, src_h: int, dst_w: int, dst_h: int,
                 backend: str = "auto", precision: str = "exact",
                 device="cuda"):
        super().__init__(_plan("area", src_w, src_h, dst_w, dst_h),
                         backend, precision, device)


class LinearResizer(Resizer):
    """Bilinear resampler (ref: include/libiqo/LinearResizer.hpp:20-27)."""

    def __init__(self, src_w: int, src_h: int, dst_w: int, dst_h: int,
                 backend: str = "auto", precision: str = "exact",
                 device="cuda"):
        super().__init__(_plan("linear", src_w, src_h, dst_w, dst_h),
                         backend, precision, device)
