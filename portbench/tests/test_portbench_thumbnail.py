"""The 4K -> 144p rung (``lanczos3_4k_to_256x144.batch16``): a whole run of
the harness on the CPU at small sizes of the same 15:1 ratio against the
plain reference, sound and the relaxed control; and ``wide_roofline.batch``
over hand-made traces."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import port_trace, run, spec
from portbench.harness import Run, Spans, Window
from portbench.tests.conftest import HostEvent
from portbench.trace import Trace

CELL = "lanczos3_4k_to_256x144.batch16"
H100 = "NVIDIA H100 80GB HBM3"
THUMB = {"method": "lanczos3", "src_w": 3840, "src_h": 2160, "dst_w": 256, "dst_h": 144,
         "reference": "yuv420"}
WIDE = "void (anonymous namespace)::resize_wide_kernel<true, 16, false>(...)"
TILED = "void iqo_tiled::resize_tiled_kernel<true, true, 32, false, false>(...)"


@pytest.fixture(autouse=True)
def short_preroll(monkeypatch):
    monkeypatch.setattr(run, "PREROLL_S", 0.02)


def run_on_cpu(bench, trace=False, precision=None, backend="auto"):
    return run.run_cell(bench, spec.cell(bench, CELL), seed=2**31 + 28, seconds=0.2,
                        trace=trace, precision=precision, device="cpu", backend=backend,
                        event=HostEvent, synchronize=lambda: None, kind="cpu",
                        log=lambda line: None)


def test_the_cell_is_the_configurations_own():
    bench = spec.load()
    cfg = spec.config(bench, spec.cell(bench, CELL)["config"])
    assert {k: cfg[k] for k in THUMB} == THUMB and cfg["precision"] == "exact"
    assert spec.traffic(spec.cell(bench, CELL)["traffic"]) == spec.traffic("batch16")
    assert "wide_roofline.batch" in {m["name"] for m in spec.per_layer(bench, CELL)}


@pytest.mark.parametrize("geometry", [(960, 540, 64, 36), (480, 270, 32, 18)],
                         ids=lambda g: "x".join(map(str, g)))
def test_sound_run_is_correct(tiny, geometry):
    bench = tiny("lanczos3", *geometry)
    result = run_on_cpu(bench)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert result["check"] == {"max_lsb": {"value": 0, "limit": 0}}
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end(bench, CELL)}


def test_traced_run_reads_no_device_metric_off_the_card(tiny):
    result = run_on_cpu(tiny("lanczos3", 960, 540, 64, 36), trace=True)
    assert result["correct"] and set(result["metrics"]) == {"issue_ms.batch"}


def test_control_is_not_correct(tiny):
    result = run_on_cpu(tiny("lanczos3", 960, 540, 64, 36), precision="relaxed",
                        backend="cuda")
    assert not result["correct"]
    assert 1 <= result["check"]["max_lsb"]["value"] <= 2


def wide_reader():
    return spec.reader("wide_roofline.batch")


def make_run(kernels, names, calls, frames=32, cfg=THUMB, kind=H100):
    spans = Spans()
    for k in range(calls):
        spans.add("issue", k * 1000, k * 1000 + 10)
    trace = Trace(0.0, 1e6, frames, spans, np.asarray(kernels, float).reshape(-1, 2),
                  list(names), np.empty((0, 2)), [])
    w = Window(0, 1_000_000, calls=calls, frames=frames, attempted=frames, failed=0)
    return Run(cfg, kind, 1.0, w, spans, trace)


def test_luma_bound_is_its_bytes_at_the_h100s_rate():
    # 3840 x 2160 in, 256 x 144 out; 2 x 53,084,160 operations take 0.054 us
    assert port_trace.plane_bound_s(THUMB, H100, port_trace.LUMA) == pytest.approx(
        (3840 * 2160 + 256 * 144) / 3.35e12)
    assert port_trace.plane_ops(THUMB, port_trace.LUMA) == 2 * 53_084_160


def test_wide_roofline_reads_the_wide_kernels_union():
    # two calls: a wide luma launch each (the second overlapping the first's
    # end) and two chroma launches each, which the metric leaves out
    kernels = [(0, 100_000), (100_000, 120_000), (120_000, 130_000),
               (90_000, 200_000), (200_000, 220_000), (220_000, 230_000)]
    names = [WIDE, TILED, TILED, WIDE, TILED, TILED]
    bound = (3840 * 2160 + 256 * 144) / 3.35e12
    assert wide_reader()(make_run(kernels, names, calls=2)) == pytest.approx(
        100 * 32 * bound / 200e-6)


def test_a_lost_wide_kernel_leaves_its_frames_and_its_time():
    # two calls of 16 frames; the profiler lost the second call's luma
    kernels, names = [(0, 100_000), (100_000, 120_000)], [WIDE, TILED]
    bound = (3840 * 2160 + 256 * 144) / 3.35e12
    assert wide_reader()(make_run(kernels, names, calls=2)) == pytest.approx(
        100 * 16 * bound / 100e-6)


def test_wide_roofline_reads_nothing_where_it_cannot():
    read = wide_reader()
    kernels, names = [(0, 100_000), (100_000, 120_000)], [WIDE, TILED]
    assert read(make_run(kernels, names, calls=1)) is not None
    assert read(make_run(kernels + [(120_000, 200_000)], names + [WIDE],
                         calls=1)) is None                          # more wide kernels than calls
    assert read(make_run([(0, 100_000)], [TILED], calls=1)) is None  # no wide kernel
    assert read(make_run(kernels, names, calls=1, kind="some other card")) is None
    assert read(make_run([], [], calls=0)) is None
    r = make_run(kernels, names, calls=1)
    r.trace = None
    assert read(r) is None
