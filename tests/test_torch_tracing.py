"""The port's spans and counters (``libiqo_tpu_torch/tracing.py``): off,
the facade reads no clock and keeps nothing; on, one ``port.frame_call`` a
user call with its set-up and launch spans nested under its call number,
the executable cache's hits and misses, and, on the card, each launch's
planes and a warm window's creates and builds."""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest
import torch

from libiqo_tpu_torch import api, tracing
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.yuv import YUV420Frame, YUV420Resizer


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty executable cache of the default size."""
    monkeypatch.setattr(api, "_CACHE", api._ExecutableCache(api.cache_size({})))


@pytest.fixture
def clock_reads(monkeypatch):
    """The number of times the tracing module read its clock so far."""
    reads = [0]
    real = tracing._clock

    def counted():
        reads[0] += 1
        return real()
    monkeypatch.setattr(tracing, "_clock", counted)
    return reads


def planes(batch=None, w=16, h=12, device="cpu"):
    lead = () if batch is None else (batch,)
    g = torch.Generator().manual_seed(w * h + (batch or 0))
    y, u, v = (torch.randint(0, 256, lead + s, dtype=torch.uint8, generator=g).to(device)
               for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    return y, u, v


def test_off_facade_calls_read_no_clock_and_keep_nothing(clock_reads, monkeypatch):
    r = YUV420Resizer("area", 16, 12, 8, 6, device="cpu")
    done = (object(), object(), object())
    monkeypatch.setattr(r, "_planes", lambda y, u, v: done)
    y, u, v = planes(2)
    frame = YUV420Frame(*planes())
    r.resize_batch(y, u, v)
    r.resize(frame)
    gc.collect()
    before = len(gc.get_objects())
    for _ in range(10_000):
        r.resize_batch(y, u, v)
        r.resize(frame)
    after = len(gc.get_objects())
    assert after - before < 10
    assert clock_reads[0] == 0 and tracing.RECORDING is None


def test_off_whole_route_reads_no_clock(clock_reads, fresh_cache):
    r = YUV420Resizer("lanczos3", 16, 12, 8, 6, device="cpu")
    r.resize_batch(*planes(2))
    r.resize(YUV420Frame(*(p.numpy() for p in planes())))
    api.LanczosResizer(3, 16, 12, 8, 6, device="cpu").resize(planes()[0])
    api.Resizer.from_plan(build_plan("area", 16, 12, 8, 6), device="cpu")
    assert clock_reads[0] == 0


def test_on_one_frame_call_a_call_in_order(fresh_cache):
    r = YUV420Resizer("area", 16, 12, 8, 6, device="cpu")
    batch, frame = planes(3), YUV420Frame(*planes())
    host = YUV420Frame(*(p.numpy() for p in planes()))
    with tracing.record() as rec:
        for _ in range(5):
            r.resize_batch(*batch)
            r.resize(frame)
        r.resize(host)
    calls = rec.spans("port.frame_call")
    assert len(calls) == 11 == rec.calls
    assert calls[:, 2].tolist() == list(range(1, 12))
    assert (calls[:, 1] >= calls[:, 0]).all() and (calls[1:, 0] >= calls[:-1, 1]).all()
    # the first call packed both planes' tables, under its own call number
    tables = rec.spans("port.tables")
    assert tables[:, 2].tolist() == [1, 1]
    assert (tables[:, 0] >= calls[0, 0]).all() and (tables[:, 1] <= calls[0, 1]).all()
    assert rec.counters == {"exec_cache.miss": 2}
    assert len(rec.spans("port.launch")) == 0 == len(rec.launch_planes())   # no card


def test_first_build_records_plan_and_tables(fresh_cache):
    with tracing.record() as rec:
        r = YUV420Resizer("lanczos3", 20, 14, 10, 8, device="cpu")
        r.resize_batch(*planes(2, 20, 14))
    plan, tables = rec.spans("port.plan"), rec.spans("port.tables")
    # luma's and chroma's plan built, then checked and digested, each a call
    assert plan[:, 2].tolist() == [1, 2, 3, 4]
    assert tables[:, 2].tolist() == [5, 5]          # inside the first frame call
    assert (plan[:, 1] > plan[:, 0]).all() and (tables[:, 1] > tables[:, 0]).all()
    assert (np.diff(plan[:, 0]) > 0).all()
    with tracing.record() as again:
        api.Resizer.from_plan(build_plan("area", 16, 12, 8, 6), device="cpu")
    assert again.spans("port.plan")[:, 2].tolist() == [1]


def test_second_resizer_of_a_geometry_hits_the_cache(fresh_cache):
    YUV420Resizer("area", 16, 12, 8, 6, device="cpu").resize_batch(*planes(2))
    with tracing.record() as rec:
        r = YUV420Resizer("area", 16, 12, 8, 6, device="cpu")
        r.resize_batch(*planes(2))
        r.resize_batch(*planes(2))                  # bound: no lookup at all
    assert rec.counters == {"exec_cache.hit": 2}
    assert len(rec.spans("port.tables")) == 0 and len(rec.spans("port.frame_call")) == 2


def test_calls_nest_and_launches_carry_their_planes(clock_reads):
    with tracing.record() as rec:
        with tracing.span("port.frame_call"):
            with tracing.span("port.tables"):
                pass
            rec.launched(rec.begin(), 1, 2)
        rec.launched(rec.begin(), 1, 0)             # a launch of its own: a call
        tracing.count("exec.create")
        tracing.count("exec.create", 2)
    assert rec.spans("port.frame_call")[:, 2].tolist() == [1]
    assert rec.spans("port.tables")[:, 2].tolist() == [1]
    assert rec.spans("port.launch")[:, 2].tolist() == [1, 2]
    assert rec.launch_planes().tolist() == [[1, 2], [1, 0]]
    assert rec.counters == {"exec.create": 3}
    assert clock_reads[0] == 8 and tracing.RECORDING is None
    assert rec.spans("port.plan").shape == (0, 3)


def test_one_recording_at_a_time_and_closed_on_error():
    with pytest.raises(ZeroDivisionError):
        with tracing.record() as rec:
            with tracing.span("port.frame_call"):
                1 / 0
    assert tracing.RECORDING is None and len(rec.spans("port.frame_call")) == 1
    with tracing.record():
        with pytest.raises(RuntimeError):
            with tracing.record():
                pass
    assert tracing.RECORDING is None


def test_recorded_spans_leave_nothing_to_collect():
    with tracing.record() as rec:
        gc.collect()
        before = len(gc.get_objects())
        for _ in range(20_000):
            with tracing.span("port.frame_call"):
                rec.launched(rec.begin(), 1, 2)
        after = len(gc.get_objects())
    assert after - before < 10
    assert len(rec.spans("port.frame_call")) == 20_000 == rec.calls
    assert rec.launch_planes().sum(axis=0).tolist() == [20_000, 40_000]


class _OnCard(torch.Tensor):
    """A CPU tensor that an executable takes for one on a card."""

    @property
    def is_cuda(self):
        return True


class _Launches:
    """The C launches of ``ops/executable.py``, done by nothing: a frame
    call reports one luma launch and two chroma ones (one for a lone
    frame)."""

    def iqo_exec_launch(self, *args):
        return 0

    def iqo_exec_launch_frame(self, hl, hc, n, *args):
        return 3 if n > 1 else 2


def _on_card_executable(plan, relaxed: bool = False):
    """A CPU executable of ``plan`` with the kernel's tables (exact, or
    ``relaxed``), whose launches go to :class:`_Launches`."""
    from libiqo_tpu_torch.ops import cuda_resize, executable
    ops = cuda_resize.pack_operands(plan)
    ex = executable.Executable(dataclasses.replace(
        ops, tables=cuda_resize.kernel_tables(plan, relaxed=relaxed)))
    ex._handle, ex._lib = 1, _Launches()
    return ex


def _on_card(*shape):
    """Zero planes of ``shape`` that an executable takes for ones on a card."""
    return torch.zeros(shape, dtype=torch.uint8).as_subclass(_OnCard)


def test_x_form_counters_count_launches_by_form(monkeypatch):
    """``tiled.x_window`` and ``tiled.x_taps`` count the tiled kernel's
    launches by the form of their X pass, where the executables count
    their launches, and only while a recording is open."""
    from libiqo_tpu_torch.ops import cuda_resize, executable
    monkeypatch.setattr(executable, "_stream", lambda index: 0)
    window = _on_card_executable(build_plan("lanczos", 128, 96, 64, 48, degree=3))
    taps = _on_card_executable(build_plan("lanczos", 512, 64, 64, 8, degree=3))   # 8:1
    assert (window.form, taps.form) == ("tiled.x_window", "tiled.x_taps")
    y, u = _on_card(4, 96, 128), _on_card(4, 64, 512)
    cuda_resize.reset_launches()
    with tracing.record() as rec:
        executable.launch_frame(window, taps, y, u, u)          # 1 luma, 2 chroma launches
        executable.launch_frame(taps, window, u[0], y[0], y[0])  # 1, then U and V as one
        window(y)
        taps(u[0])
    assert rec.counters == {"tiled.x_window": 3, "tiled.x_taps": 4}
    assert cuda_resize.LAUNCHES == 7 == len(rec.spans("port.launch")) + 3
    executable.launch_frame(window, taps, y, u, u)               # off: nothing kept
    assert cuda_resize.LAUNCHES == 10 and tracing.RECORDING is None


@pytest.mark.parametrize("case, relaxed, form", [
    (("lanczos", 960, 540, 64, 36, {}), True, "wide.y_whole"),   # 15:1, 90 Y taps: ks 1
    (("lanczos", 3840, 2160, 256, 144, {}), False, "wide.y_s8"),   # the 144p rung's luma
    (("lanczos", 1024, 1080, 64, 8, {}), False, "wide.y_sliced"),   # 810 Y taps
    (("area", 960, 540, 64, 4, {}), True, "wide.y_sliced"),      # 135 Y taps
    (("lanczos", 3840, 2160, 1920, 16, {}), False, "wide.y_sliced"),   # the 4K strips
    (("lanczos", 128, 96, 64, 48, {}), False, "tiled.x_window"),   # 2:1
    (("lanczos", 1920, 1080, 128, 72, {"px_scale": 2}), False, "tiled.x_taps"),  # its chroma
    (("linear", 3840, 2160, 256, 144, {}), False, "wide.y_whole"),  # Y taps past s8
    (("lanczos", 1920, 1080, 128, 72, {}), False, "wide.y_whole"),  # 20 s8 blocks: too few
], ids=["wide_whole", "rung_luma", "wide_sliced", "wide_sliced_relaxed", "strips",
        "tiled_window", "rung_chroma", "wide_whole_exact", "wide_s8_rung_1080p"])
def test_launch_form_names_each_kernels_form(case, relaxed, form):
    """One name a form, for both kernels: the wide-window kernel's by its Y
    pass, on the tensor cores (``wide.y_s8``) or in scalar items by their
    slices (``ks``), the tiled kernel's by its X pass; none for the
    windowed kernel or no tables."""
    from libiqo_tpu_torch.ops import cuda_resize
    algo, sw, sh, dw, dh, kw = case
    plan = build_plan(algo, sw, sh, dw, dh, **({"degree": 3} if algo == "lanczos" else {}),
                      **kw)
    k = cuda_resize.kernel_tables(plan, relaxed=relaxed)
    assert cuda_resize.launch_form(k) == form
    if k.wide:
        assert k.y_s8 == (form == "wide.y_s8")
        if not k.y_s8:
            assert (k.layout.ks == 1) == (form == "wide.y_whole")
    assert cuda_resize.launch_form(
        cuda_resize.kernel_tables(plan, relaxed=relaxed, tiled=False, wide=False)) is None
    assert cuda_resize.launch_form(None) is None


def test_wide_form_counters_count_launches(monkeypatch):
    """The wide-window kernel's launches are counted by Y form at the same
    sites as the tiled kernel's: a thumbnail frame call counts its luma
    under ``wide.y_s8`` once (``wide.y_whole`` not at all) and its chroma
    under ``tiled.x_taps`` as many times as it launches; the scalar forms
    count theirs; without a recording nothing is counted."""
    from libiqo_tpu_torch.ops import cuda_resize, executable
    monkeypatch.setattr(executable, "_stream", lambda index: 0)
    luma = _on_card_executable(build_plan("lanczos", 3840, 2160, 256, 144, degree=3))
    chroma = _on_card_executable(build_plan("lanczos", 1920, 1080, 128, 72, degree=3,
                                            px_scale=2))
    sliced = _on_card_executable(build_plan("lanczos", 1024, 1080, 64, 8, degree=3))
    sliced_relaxed = _on_card_executable(build_plan("area", 960, 540, 64, 4), relaxed=True)
    whole = _on_card_executable(build_plan("linear", 3840, 2160, 256, 144))
    assert (luma.form, chroma.form, sliced.form, sliced_relaxed.form, whole.form) == (
        "wide.y_s8", "tiled.x_taps", "wide.y_sliced", "wide.y_sliced", "wide.y_whole")
    y, u = _on_card(4, 2160, 3840), _on_card(4, 1080, 1920)
    cuda_resize.reset_launches()
    with tracing.record() as rec:
        executable.launch_frame(luma, chroma, y, u, u)               # 1 luma, 2 chroma
        executable.launch_frame(luma, chroma, y[0], u[0], u[0])      # 1, then U and V as one
        sliced(_on_card(2, 1080, 1024))
        sliced_relaxed(_on_card(2, 540, 960))
        whole(_on_card(2160, 3840))
    want = {"wide.y_s8": 2, "tiled.x_taps": 3, "wide.y_sliced": 2, "wide.y_whole": 1}
    assert rec.counters == want
    assert rec.launch_planes().tolist() == [[1, 2], [1, 1]] + [list(tracing.UNKNOWN_PLANE)] * 3
    assert cuda_resize.LAUNCHES_BY_VARIANT["wrap16_wide_s8"] == 2
    assert cuda_resize.LAUNCHES_BY_VARIANT["wrap16_wide"] == 1
    executable.launch_frame(luma, chroma, y, u, u)                   # off: nothing kept
    sliced(_on_card(2, 1080, 1024))
    assert rec.counters == want
    assert cuda_resize.LAUNCHES == 12 and tracing.RECORDING is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lanczos3", "area"])
def test_launches_by_plane_on_the_card(card, method):
    r = YUV420Resizer(method, 96, 54, 48, 28, device=card)
    batch = planes(4, 96, 54, card)
    lone = planes(None, 96, 54, card)
    with tracing.record() as rec:
        r.resize_batch(*batch)
        r.resize(YUV420Frame(*lone))
        r._luma.resize(lone[0])
    torch.cuda.synchronize()
    assert rec.launch_planes().tolist() == [[1, 2], [1, 1], list(tracing.UNKNOWN_PLANE)]
    launches, calls = rec.spans("port.launch"), rec.spans("port.frame_call")
    assert launches[:, 2].tolist() == [1, 2, 3] and calls[:, 2].tolist() == [1, 2]
    assert (launches[:2, 0] >= calls[:, 0]).all() and (launches[:2, 1] <= calls[:, 1]).all()


@pytest.mark.cuda
def test_warm_window_creates_and_builds_nothing(card, fresh_cache):
    with tracing.record() as first:
        r = YUV420Resizer("area", 96, 54, 48, 28, device=card)
        r.resize_batch(*planes(4, 96, 54, card))
    assert len(first.spans("port.exec_create")) == first.counters.get("exec.create", 0) > 0
    batch = planes(4, 96, 54, card)
    with tracing.record() as warm:
        for _ in range(20):
            r.resize_batch(*batch)
        YUV420Resizer("area", 96, 54, 48, 28, device=card).resize_batch(*batch)
    torch.cuda.synchronize()
    assert warm.counters.get("exec.create", 0) == 0 == warm.counters.get("library.build", 0)
    assert warm.counters["exec_cache.hit"] == 2
    assert len(warm.spans("port.library")) == 0 and len(warm.spans("port.launch")) == 21


@pytest.mark.cuda
def test_a_launch_that_raises_closes_its_span(card, monkeypatch):
    from libiqo_tpu_torch.ops import executable
    r = YUV420Resizer("area", 96, 54, 48, 28, device=card)
    batch = planes(4, 96, 54, card)
    r.resize_batch(*batch)

    def no_stream(index):
        raise RuntimeError("no stream")
    with tracing.record() as rec:
        with monkeypatch.context() as m:
            m.setattr(executable, "_stream", no_stream)
            with pytest.raises(RuntimeError, match="no stream"):
                r.resize_batch(*batch)
        r.resize_batch(*batch)
    torch.cuda.synchronize()
    assert rec.launch_planes().tolist() == [[0, 0], [1, 2]]
    assert rec.spans("port.launch")[:, 2].tolist() == [1, 2]
    assert rec.spans("port.frame_call")[:, 2].tolist() == [1, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("method, src, dst, form", [
    ("lanczos3", (96, 54), (48, 28), "tiled.x_window"),   # 2:1
    ("area", (96, 54), (32, 18), "tiled.x_window"),       # 3:1
    ("lanczos3", (768, 64), (96, 8), "tiled.x_taps"),     # 8:1, 48 luma taps
    ("linear", (48, 28), (96, 54), "tiled.x_taps"),       # upscale: steps of 0 and 1
], ids=["lanczos2to1", "area3to1", "lanczos8to1", "linear_up"])
def test_x_form_counters_on_the_card(card, method, src, dst, form):
    """On the card the tiled launches of a batch and a lone frame (two of
    luma, three of chroma) are all counted under both planes' X form."""
    r = YUV420Resizer(method, *src, *dst, device=card)
    assert [ex.form for ex in r._executables(card.index)] == [form, form]
    r.resize_batch(*planes(4, *src, card))      # the handles made outside the recording
    with tracing.record() as rec:
        r.resize_batch(*planes(4, *src, card))
        r.resize(YUV420Frame(*planes(None, *src, card)))
    torch.cuda.synchronize()
    assert rec.counters == {form: 5}
    assert int(rec.launch_planes().sum()) == 5


@pytest.mark.cuda
def test_thumbnail_frame_call_counts_its_forms_on_the_card(card):
    """The 144p rung of a 4K ladder: luma on the wide-window kernel's s8 Y
    form, chroma on the tiled kernel's per-tap X pass; a batch call and a
    lone frame count one ``wide.y_s8`` each (``wide.y_whole`` none) and
    three ``tiled.x_taps`` between them."""
    r = YUV420Resizer("lanczos3", 3840, 2160, 256, 144, device=card)
    assert [ex.form for ex in r._executables(card.index)] == ["wide.y_s8", "tiled.x_taps"]
    r.resize_batch(*planes(4, 3840, 2160, card))     # the handles made outside the recording
    with tracing.record() as rec:
        r.resize_batch(*planes(4, 3840, 2160, card))
        r.resize(YUV420Frame(*planes(None, 3840, 2160, card)))
    torch.cuda.synchronize()
    assert rec.counters == {"wide.y_s8": 2, "tiled.x_taps": 3}
    assert rec.launch_planes().tolist() == [[1, 2], [1, 1]]


# the benchmark's two cells: (method, source, output, frames a call)
CELL_SHAPES = [("lanczos3", (3840, 2160), (1920, 1080), 16), ("area", (1920, 1080), (640, 360), 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("method, src, dst, batch", CELL_SHAPES, ids=["batch16", "batch64"])
def test_recording_cost_on_the_card(card, method, src, dst, batch):
    """Host ms a ``resize_batch`` call, recording off and on in turns, 6
    rounds each, two calls in flight as the benchmark's loop keeps them:
    printed (run with ``-s``).  Each recorded call is one frame call of one
    luma and two chroma launches."""
    import time
    r = YUV420Resizer(method, *src, *dst, device=card)
    pool = [planes(batch, *src, card) for _ in range(2)]
    events = [torch.cuda.Event() for _ in range(2)]
    calls = 1500

    def round_ms():
        took = 0
        for k in range(calls):
            if k >= 2:
                events[k % 2].synchronize()
            t = time.perf_counter_ns()
            r.resize_batch(*pool[k % 2])
            took += time.perf_counter_ns() - t
            events[k % 2].record()
        torch.cuda.synchronize()
        return took / calls / 1e6

    round_ms()
    ms = {"off": [], "on": []}
    for i in range(6):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if not on:
                ms["off"].append(round_ms())
                continue
            with tracing.record() as rec:
                ms["on"].append(round_ms())
            assert len(rec.spans("port.frame_call")) == calls == rec.calls
            assert rec.launch_planes().tolist() == [[1, 2]] * calls
    assert tracing.RECORDING is None
    off, on = (float(np.median(ms[k])) for k in ("off", "on"))
    print(f"\n{method} {src} -> {dst} x{batch} on {torch.cuda.get_device_name(card)}: host ms a "
          f"call, median of 6 rounds of {calls}: off {off:.6f}, on {on:.6f}, on - off "
          f"{on - off:.6f}; rounds off {[round(x, 6) for x in ms['off']]}, "
          f"on {[round(x, 6) for x in ms['on']]}")
