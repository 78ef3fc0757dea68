"""The port's executable layer (``libiqo_tpu_torch/ops/executable.py``, the
executable cache in ``api.py``, the frame call of ``yuv.py`` and
``parallel/sharding.make_yuv_step_fn``) on the CPU, against the JAX
package's executable layer (``libiqo_tpu/api.py`` ``_COMPILED_CACHE``,
``libiqo_tpu/yuv.py``, ``libiqo_tpu/parallel/sharding.py``).

On the CPU an executable runs the kernel's plain version; the C handles,
the one-call frame launch and its launch counts are held on the card by
``chip_smoke.py``.  Exact outputs are held at 0 LSB, relaxed ones within
2 LSB of exact, as ``tests/test_torch_relaxed.py`` holds them.
"""

from __future__ import annotations

import ctypes
import gc
import os
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from libiqo_tpu import yuv as jax_yuv
from libiqo_tpu.core import plan as jax_plan
from libiqo_tpu.parallel import sharding as jax_sharding
from libiqo_tpu_torch import api, yuv
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import _build, cuda_resize, executable, torch_resize
from libiqo_tpu_torch.parallel import sharding

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
RELAXED_LSB = 2
# (method, src_w, src_h, dst_w, dst_h): even and odd sizes, down and up
FRAMES = [
    ("lanczos3", 64, 48, 32, 24),
    ("lanczos3", 63, 47, 31, 23),
    ("area", 66, 50, 22, 18),
    ("linear", 41, 29, 64, 50),
    ("lanczos2", 40, 30, 61, 45),
]


def _ids(frame):
    return "-".join(map(str, frame))


def _planes(rng, b, sw, sh):
    ew, eh = sw + sw % 2, sh + sh % 2
    return (rng.integers(0, 256, (b, eh, ew), np.uint8),
            rng.integers(0, 256, (b, eh // 2, ew // 2), np.uint8),
            rng.integers(0, 256, (b, eh // 2, ew // 2), np.uint8))


@pytest.fixture
def fresh_cache(monkeypatch):
    """A cache of the default size of its own for one test."""
    monkeypatch.setattr(api, "_CACHE", api._ExecutableCache(api.cache_size({})))
    return api._CACHE


# -- LIBIQO_TPU_CACHE_SIZE and the cache -------------------------------------

def test_cache_size_is_read_as_the_jax_package_reads_it():
    """``LIBIQO_TPU_CACHE_SIZE``, default 256, read once at import by both
    packages (one subprocess, with the variable set to 2)."""
    assert api.cache_size({}) == 256
    assert api.cache_size({"LIBIQO_TPU_CACHE_SIZE": "0"}) == 0
    code = ("import libiqo_tpu.api as j, libiqo_tpu_torch.api as t; "
            "print(j._COMPILED_CACHE_MAX, t._CACHE.max_entries)")
    env = {**os.environ, "LIBIQO_TPU_CACHE_SIZE": "2", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120, check=True).stdout.split()
    assert out == ["2", "2"]


def _plan(i):
    return build_plan("area", 16 + 2 * i, 12, 8, 6)


def test_cache_of_two_keeps_the_two_most_recent(monkeypatch):
    cache = api._ExecutableCache(2)
    monkeypatch.setattr(api, "_CACHE", cache)
    ex = [api.executable_for(_plan(i), CPU) for i in range(3)]
    assert len(cache._entries) == 2
    assert api.executable_for(_plan(1), CPU) is ex[1]
    assert api.executable_for(_plan(2), CPU) is ex[2]
    assert api.executable_for(_plan(0), CPU) is not ex[0]      # evicted, rebuilt
    # the LRU order: 0 was the most recent, so 1 went
    assert api.executable_for(_plan(2), CPU) is ex[2]
    assert api.executable_for(_plan(1), CPU) is not ex[1]


def test_cache_of_zero_caches_nothing(monkeypatch):
    cache = api._ExecutableCache(0)
    monkeypatch.setattr(api, "_CACHE", cache)
    a = api.executable_for(_plan(0), CPU)
    assert api.executable_for(_plan(0), CPU) is not a
    assert not cache._entries
    # a resizer still builds its executable once and keeps it
    r = api.AreaResizer(16, 12, 8, 6, backend="cuda", device="cpu")
    src = np.arange(16 * 12, dtype=np.uint8).reshape(12, 16)
    out = r.resize(src)
    kept = r._bind(CPU)[1]
    np.testing.assert_array_equal(r.resize(src), out)
    assert r._bind(CPU)[1] is kept and not cache._entries


@pytest.mark.parametrize("clear", ["clear_compiled_cache", "clear_operand_cache"])
def test_both_clears_empty_the_one_cache(fresh_cache, clear):
    assert api.clear_operand_cache is api.clear_compiled_cache
    r = api.LanczosResizer(3, 32, 24, 16, 12, device="cpu")
    ops = r._operands(CPU)
    assert fresh_cache._entries
    getattr(api, clear)()
    assert not fresh_cache._entries
    assert r._operands(CPU) is not ops


def test_an_evicted_executable_is_freed(monkeypatch):
    """Nothing but the cache and the resizers holds an executable: once
    evicted and unheld it is collected, which frees its C handle
    (``weakref.finalize`` on ``iqo_exec_destroy``)."""
    monkeypatch.setattr(api, "_CACHE", api._ExecutableCache(1))
    ref = weakref.ref(api.executable_for(_plan(0), CPU))
    assert ref() is not None
    api.executable_for(_plan(1), CPU)
    gc.collect()
    assert ref() is None


def test_concurrent_builds_of_one_key_end_with_one_entry(fresh_cache, monkeypatch):
    built = []
    pack = cuda_resize.pack_operands

    def slow_pack(*args, **kwargs):
        built.append(1)
        time.sleep(0.05)
        return pack(*args, **kwargs)

    monkeypatch.setattr(cuda_resize, "pack_operands", slow_pack)
    got = [None] * 4

    def run(i):
        got[i] = api.executable_for(_plan(0), CPU)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and len(fresh_cache._entries) == 1
    assert all(g is got[0] for g in got)


# -- the resizer's executable --------------------------------------------------

def test_fresh_construction_reuses_executables(fresh_cache):
    """The port's counterpart of tests/test_cache_and_video.py::
    test_fresh_construction_reuses_executables: a fresh resizer of one
    geometry is served the cached executable, by identity."""
    rng = np.random.default_rng(16)
    src = rng.integers(0, 256, (48, 64), np.uint8)
    r1 = api.AreaResizer(64, 48, 32, 24, backend="cuda", device="cpu")
    out1 = r1.resize(src)
    key = (r1._digest, "exact", "windowed", "cpu")
    assert key in fresh_cache._entries
    r2 = api.AreaResizer(64, 48, 32, 24, backend="cuda", device="cpu")
    np.testing.assert_array_equal(r2.resize(src), out1)
    assert r2._bind(CPU)[1] is r1._bind(CPU)[1] is fresh_cache._entries[key]
    np.testing.assert_array_equal(out1, numpy_ref.resize_u8(r1.plan, src))


def test_a_resizer_looks_its_executable_up_once(fresh_cache, monkeypatch):
    """After the first call on a device a resize does no cache lookup;
    ``LIBIQO_TPU_CARRY`` selects another executable, built once."""
    r = api.LanczosResizer(3, 64, 48, 32, 24, backend="cuda", device="cpu")
    src = np.zeros((48, 64), np.uint8)
    calls = []
    real = api.executable_for
    monkeypatch.setattr(api, "executable_for",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    monkeypatch.delenv("LIBIQO_TPU_CARRY", raising=False)
    for _ in range(3):
        r.resize(src)
    assert len(calls) == 1
    monkeypatch.setenv("LIBIQO_TPU_CARRY", "1")
    for _ in range(2):
        r.resize(src)
    assert len(calls) == 2
    assert r._bind(CPU)[1] is not r._bound[(CPU, False)][1]


@pytest.mark.parametrize("route", ["cuda", "torch"])
def test_executable_on_the_cpu_is_the_plain_version(route):
    plan = build_plan("lanczos", 40, 30, 20, 15, degree=3)
    ex = executable.Executable(cuda_resize.pack_operands(plan))
    src = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 30, 40), np.uint8))
    np.testing.assert_array_equal(ex(src).numpy(),
                                  np.stack([numpy_ref.resize_u8(plan, s) for s in src.numpy()]))
    assert ex.variant is None and ex.dst_shape == (15, 20)
    with pytest.raises(ValueError, match="CUDA device"):
        ex.handle
    r = api.Resizer(plan, backend=route, device="cpu")
    np.testing.assert_array_equal(r.resize(src).numpy(), ex(src).numpy())


def test_executable_checks_its_source():
    ex = executable.Executable(cuda_resize.pack_operands(build_plan("area", 16, 12, 8, 6)))
    for good in (torch.zeros((2, 12, 16), dtype=torch.uint8),
                 torch.zeros((12, 20), dtype=torch.uint8)[:, 2:18]):
        ex.check(good)
    for bad, err in ((torch.zeros((2, 12, 15), dtype=torch.uint8), ValueError),
                     (torch.zeros((1, 2, 12, 16), dtype=torch.uint8), ValueError),
                     (torch.zeros((65536, 12, 16), dtype=torch.uint8)[:, :1, :1]
                      .expand(65536, 12, 16), ValueError),
                     (torch.zeros((2, 12, 16), dtype=torch.int16), TypeError),
                     (torch.zeros((2, 16, 12), dtype=torch.uint8).transpose(1, 2), ValueError)):
        with pytest.raises(err):
            ex.check(bad)


def test_bindings_take_the_entries_arguments():
    """Each ``*_exec_create`` binding takes its ``iqo_resize_*`` entry's
    arguments but the five per call and the stream, plus the handle's
    address, in the order ``cuda_resize.entry_args`` packs them for both."""

    class Fn:
        argtypes = restype = None

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    lib = _build._bind(Lib())
    plans = {"tiled": build_plan("lanczos", 64, 48, 32, 24, degree=3),
             "wide": build_plan("area", 8192, 4, 16, 4),
             "wide_s8": build_plan("lanczos", 3840, 2160, 256, 144, degree=3),
             "fused": build_plan("lanczos", 64, 48, 32, 24, degree=3)}
    for kind, plan in plans.items():
        ops = cuda_resize.KernelOperands(
            plain=torch_resize.pack_operands(plan),
            tables=cuda_resize.kernel_tables(plan, tiled=kind == "tiled"))
        got, head, tail = cuda_resize.entry_args(ops)
        assert got == kind
        assert len(getattr(lib, f"iqo_resize_{kind}").argtypes) == len(head) + len(tail) + 6
        create = getattr(lib, f"iqo_resize_{kind}_exec_create").argtypes
        assert len(create) == len(head) + len(tail) + 1
        assert create[-1] == ctypes.POINTER(ctypes.c_void_p)
        assert create[:len(head)] == getattr(lib, f"iqo_resize_{kind}").argtypes[:len(head)]
    assert len(lib.iqo_exec_launch_frame.argtypes) == 15


# -- the frame call against the JAX package -----------------------------------

def _want(frame, planes):
    r = jax_yuv.YUV420Resizer(*frame, backend="xla")
    y, u, v = planes
    return r.resize_batch(y[..., :frame[2], :frame[1]], u, v)


def _jax_frame(frame, y, u, v):
    r = jax_yuv.YUV420Resizer(*frame, backend="xla")
    out = r.resize(jax_yuv.YUV420Frame(y[:frame[2], :frame[1]], u, v))
    return out.y, out.u, out.v


@pytest.mark.parametrize("layout", ["separate", "one_buffer"])
@pytest.mark.parametrize("frame", FRAMES, ids=_ids)
def test_yuv_frame_and_batch_equal_the_jax_package(frame, layout):
    """``resize`` (a lone frame) and ``resize_batch`` (3 frames) on tensors,
    U and V as tensors of their own or as views of one buffer, == the JAX
    package's ``YUV420Resizer(backend="xla")`` byte for byte."""
    rng = np.random.default_rng(2 * FRAMES.index(frame) + (layout == "one_buffer"))
    y, u, v = _planes(rng, 3, frame[1], frame[2])
    r = yuv.YUV420Resizer(*frame, backend="cuda", device="cpu")
    if layout == "one_buffer":
        uv = torch.from_numpy(np.concatenate([u, v]))
        tu, tv = uv[:3], uv[3:]
    else:
        tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    ty = torch.from_numpy(y)
    got = r.resize_batch(ty, tu, tv)
    for g, w in zip(got, _want(frame, (y, u, v))):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = r.resize(yuv.YUV420Frame(ty[1], tu[1], tv[1]))
    for g, w in zip((one.y, one.u, one.v), _jax_frame(frame, y[1], u[1], v[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("frame", FRAMES[:3], ids=_ids)
def test_yuv_numpy_planes_come_back_as_numpy(frame):
    rng = np.random.default_rng(7)
    y, u, v = _planes(rng, 1, frame[1], frame[2])
    r = yuv.YUV420Resizer(*frame, device="cpu")
    out = r.resize(yuv.YUV420Frame(y[0], u[0], torch.from_numpy(v[0])))
    assert isinstance(out.y, np.ndarray) and isinstance(out.u, np.ndarray)
    assert isinstance(out.v, torch.Tensor)
    for g, w in zip((out.y, out.u, out.v.numpy()), _jax_frame(frame, y[0], u[0], v[0])):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("frame", [FRAMES[0], FRAMES[2]], ids=_ids)
def test_yuv_relaxed_within_two_lsb_of_exact(frame):
    rng = np.random.default_rng(9)
    y, u, v = (torch.from_numpy(p) for p in _planes(rng, 2, frame[1], frame[2]))
    exact = yuv.YUV420Resizer(*frame, device="cpu").resize_batch(y, u, v)
    relaxed = yuv.YUV420Resizer(*frame, precision="relaxed", backend="cuda", device="cpu")
    assert relaxed.resolved_backend() == "cuda-relaxed"
    for g, w in zip(relaxed.resize_batch(y, u, v), exact):
        assert (g.int() - w.int()).abs().max().item() <= RELAXED_LSB


def test_yuv_planes_are_checked():
    r = yuv.YUV420Resizer("lanczos3", 64, 48, 32, 24, device="cpu")
    y = np.zeros((48, 64), np.uint8)
    with pytest.raises(ValueError):
        r.resize(yuv.YUV420Frame(y, np.zeros((24, 31), np.uint8), np.zeros((24, 32), np.uint8)))
    with pytest.raises(TypeError):
        r.resize(yuv.YUV420Frame(y, np.zeros((24, 32), np.int16), np.zeros((24, 32), np.uint8)))


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_yuv_step_on_one_device_mesh_equals_the_jax_package(backend):
    """The port's ``make_yuv_step_fn`` on a one-device mesh: one frame call
    of its executables (``"cuda"``; ``"auto"`` on the CPU takes the plain
    path plane by plane), == the JAX package's step on its own one-device
    mesh and == numpy_ref."""
    sw, sh, dw, dh = 63, 47, 31, 23
    rng = np.random.default_rng(11)
    y, u, v = _planes(rng, 3, sw, sh)
    y = np.ascontiguousarray(y[..., :sh, :sw])
    step, ops = sharding.make_yuv_step_fn(sharding.Mesh(np.array(["cpu"], dtype=object),
                                                        ("data",)), sw, sh, dw, dh,
                                          backend=backend)
    assert step.routes == (("cuda",) if backend == "cuda" else ("torch",)) * 2
    assert all(isinstance(o, executable.Executable) for o in ops)
    got = sharding.gather(step(*ops, y, u, v))
    jmesh = JaxMesh(np.array(jax.devices()[:1]), ("data",))
    jstep, jops = jax_sharding.make_yuv_step_fn(jmesh, sw, sh, dw, dh, degree=3)
    want = jstep(*jops, y, u, v)
    plans = (build_plan("lanczos", sw, sh, dw, dh, degree=3),
             build_plan("lanczos", 32, 24, 16, 12, degree=3, px_scale=2))
    for g, w, plan, frames in zip(got, want, (plans[0], plans[1], plans[1]), (y, u, v)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            g.numpy(), np.stack([numpy_ref.resize_u8(plan, f) for f in frames]))


@pytest.mark.parametrize("case", [("lanczos", dict(degree=3), 64, 48, 32, 24),
                                  ("area", {}, 66, 50, 22, 18),
                                  ("linear", {}, 41, 29, 64, 50)],
                         ids=lambda c: f"{c[0]}-{c[2]}x{c[3]}")
def test_from_plan_of_a_jax_plan_builds_the_ports_executable(fresh_cache, case):
    """A JAX plan carried by ``Resizer.from_plan`` keys, packs and resizes
    as the port's own plan: the same cache entry, the same bytes."""
    algo, kw, sw, sh, dw, dh = case
    own = api.Resizer(build_plan(algo, sw, sh, dw, dh, **kw), backend="cuda", device="cpu")
    carried = api.Resizer.from_plan(jax_plan.build_plan(algo, sw, sh, dw, dh, **kw),
                                    backend="cuda", device="cpu")
    src = np.random.default_rng(5).integers(0, 256, (2, sh, sw), np.uint8)
    np.testing.assert_array_equal(carried.resize(src), own.resize(src))
    assert carried._digest == own._digest
    assert carried._bind(CPU)[1] is own._bind(CPU)[1]
    assert len(fresh_cache._entries) == 1


def test_executable_module_imports_nothing_of_jax():
    """``ops/executable.py`` is among the files tests/test_torch_plan.py
    walks (the package's every module), and imports torch, not JAX."""
    import ast

    path = ROOT / "libiqo_tpu_torch" / "ops" / "executable.py"
    assert path in sorted((ROOT / "libiqo_tpu_torch").rglob("*.py"))
    names = {a.name for node in ast.walk(ast.parse(path.read_text()))
             if isinstance(node, ast.Import) for a in node.names}
    assert "torch" in names and not any(n.split(".")[0] in ("jax", "libiqo_tpu")
                                        for n in names)


@pytest.mark.parametrize("lone", [True, False])
def test_launch_frame_on_the_cpu_runs_each_plane(lone):
    """On the CPU the frame call runs each plane's plain version, a lone
    frame's planes without a batch dimension."""
    plans = (build_plan("lanczos", 64, 48, 32, 24, degree=3),
             build_plan("lanczos", 32, 24, 16, 12, degree=3, px_scale=2))
    luma, chroma = (api.executable_for(p, CPU) for p in plans)
    rng = np.random.default_rng(2)
    y, u, v = (torch.from_numpy(p[0] if lone else p) for p in _planes(rng, 2, 64, 48))
    outs = executable.launch_frame(luma, chroma, y, u, v)
    for got, plan, src in zip(outs, (plans[0], plans[1], plans[1]), (y, u, v)):
        assert got.shape == src.shape[:-2] + (plan.y.n_dst, plan.x.n_dst)
        want = [numpy_ref.resize_u8(plan, f) for f in src.reshape((-1,) + src.shape[-2:]).numpy()]
        np.testing.assert_array_equal(got.reshape((-1,) + got.shape[-2:]).numpy(), np.stack(want))


def test_host_split_needs_a_card(monkeypatch):
    """``tools/host_split.py`` measures the card and has no CPU form: it
    exits 2 without one, as the other measurement modules do."""
    from libiqo_tpu_torch.tools import host_split

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        host_split.main([])
    assert exc.value.code == 2
