"""Spans and counters at the port's layer boundaries, off unless recorded.

    from libiqo_tpu_torch import tracing

    with tracing.record() as rec:
        out = resizer.resize_batch(y, u, v)
    rec.spans("port.frame_call")    # (n, 3) int64: start ns, end ns, call number
    rec.launch_planes()             # (n, 2): luma and chroma launches of each port.launch
    rec.counters                    # {"exec_cache.hit": 1, ...}

Off, the default, each instrumented site reads the one slot
:data:`RECORDING`, finds None and goes on: no clock read, no allocation, no
lock.  On, a span's start and end are ``time.perf_counter_ns()``, the
host clock of ``portbench`` and of its device trace's placement, and are
kept in flat ``array('q')`` buffers by name, with no object a span kept,
so that a long recording leaves the cycle collector nothing to walk.  A
span opened while no other is open starts a call and takes the next call
number; the spans opened inside it share that number.

Spans (name: where, what):

* ``port.frame_call``: ``YUV420Resizer.resize`` and ``resize_batch``, one
  a user call whatever the route, the NumPy round trip included.
* ``port.launch``: the ctypes launch, ``iqo_exec_launch_frame`` in
  ``ops/executable.launch_frame`` and ``iqo_exec_launch`` in
  ``Executable.__call__``; each carries its launches by plane, luma then
  chroma, in the order the card runs them (``csrc/resize_fused.cu``: luma,
  then U and V as one launch for a lone frame, or U then V for a batch).
  A one-plane launch (``Executable.__call__``, whose plane the executable
  cannot know) records :data:`UNKNOWN_PLANE`.
* ``port.plan``: a facade's plan built (``api._plan``), and a resizer's
  plan checked and digested (``Resizer.__init__``): two spans a resizer.
* ``port.tables``: ``cuda_resize.pack_operands`` on an executable-cache miss.
* ``port.library``: the kernel library loaded (``_build.load``), nvcc's
  build included when one happens.
* ``port.exec_create``: ``Executable._create``, the C handle made.

Counters: ``exec_cache.hit`` and ``exec_cache.miss``
(``api._ExecutableCache.get``), ``exec.create`` (``Executable._create``),
``library.build`` (``_build.load`` when it runs nvcc), ``tiled.x_window``
and ``tiled.x_taps`` (the tiled kernel's launches by the form of their X
pass), ``wide.y_s8``, ``wide.y_whole`` and ``wide.y_sliced`` (the
wide-window kernel's launches by the form of their Y pass: s8 ``mma.sync``
over a band streamed in slabs, all of a row's taps in one item, or ``ks`` >
1 slices met by shared-memory atomics), each where
``ops/executable.py`` counts its launches.

One recording at a time, for the process; threads that issue while it is
open share its call numbers.
"""

from __future__ import annotations

import array
import contextlib
import time

import numpy as np

__all__ = ["RECORDING", "Recording", "UNKNOWN_PLANE", "count", "record", "span"]

_clock = time.perf_counter_ns

RECORDING: "Recording | None" = None   # the slot every site reads
UNKNOWN_PLANE = (-1, -1)   # (luma, chroma) of one launch whose plane its site cannot know


class Recording:
    """What was recorded while :func:`record` was open."""

    def __init__(self):
        self._spans: dict[str, array.array] = {}
        self._planes = array.array("q")
        self.counters: dict[str, int] = {}
        self._depth = 0
        self._call = 0

    def begin(self) -> int:
        """Open a span; its start.  Close it with :meth:`end`."""
        if not self._depth:
            self._call += 1
        self._depth += 1
        return _clock()

    def end(self, name: str, start: int) -> None:
        t = _clock()
        self._depth -= 1
        buf = self._spans.get(name)
        if buf is None:
            buf = self._spans[name] = array.array("q")
        buf.append(start)
        buf.append(t)
        buf.append(self._call)

    def launched(self, start: int, luma: int, chroma: int) -> None:
        """Close the ``port.launch`` span opened at ``start``, which issued
        ``luma`` then ``chroma`` launches (:data:`UNKNOWN_PLANE` for one
        launch of a plane not known).  Close it also when the launch
        raised, so that later spans keep their own call numbers."""
        self.end("port.launch", start)
        self._planes.append(luma)
        self._planes.append(chroma)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    @property
    def calls(self) -> int:
        """Call numbers given so far."""
        return self._call

    def spans(self, name: str) -> np.ndarray:
        """(n, 3) int64 rows of ``name``'s spans in the order they closed:
        start ns, end ns, call number."""
        return np.frombuffer(self._spans.get(name, array.array("q")),
                             dtype=np.int64).reshape(-1, 3).copy()

    def launch_planes(self) -> np.ndarray:
        """(n, 2) int64: luma and chroma launches of each ``port.launch``
        span, row for row with ``spans("port.launch")``."""
        return np.frombuffer(self._planes, dtype=np.int64).reshape(-1, 2).copy()


class _Span:
    __slots__ = ("_rec", "_name", "_start")

    def __init__(self, rec: Recording, name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        self._start = self._rec.begin()

    def __exit__(self, *exc):
        self._rec.end(self._name, self._start)


_OFF = contextlib.nullcontext()


def span(name: str):
    """A span of ``name`` around a ``with`` block, or, off, a shared
    context that does nothing."""
    rec = RECORDING
    return _OFF if rec is None else _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    rec = RECORDING
    if rec is not None:
        rec.count(name, n)


@contextlib.contextmanager
def record():
    """Record the port's spans and counters while the block runs; yields
    the :class:`Recording`.  Raises if a recording is already open."""
    global RECORDING
    if RECORDING is not None:
        raise RuntimeError("a recording is already open")
    rec = RECORDING = Recording()
    try:
        yield rec
    finally:
        RECORDING = None
