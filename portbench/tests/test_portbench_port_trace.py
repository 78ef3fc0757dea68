"""The port's spans read beside the device trace (``port_trace.py``) over
hand-made recordings, and ``port_run.measure`` on the CPU with and without
the port's ``tracing`` module."""

from __future__ import annotations

import sys

import numpy as np
import pytest

from libiqo_tpu_torch import tracing
from portbench import port_run, port_trace, readers, run, spec, work
from portbench.harness import Run, Spans
from portbench.tests.conftest import HostEvent
from portbench.tests.test_portbench_metrics import A1080, H100, L4K
from portbench.trace import Trace

A64 = "area_1080p_to_360p.batch64"
US = 1000.0      # the hand-made window in microseconds, as ns


class Recorded:
    """A recording as ``tracing.Recording`` reads out, from rows."""

    def __init__(self, spans: dict, planes):
        self._spans = {k: np.asarray(v, np.int64).reshape(-1, 3) for k, v in spans.items()}
        self._planes = np.asarray(planes, np.int64).reshape(-1, 2)

    def spans(self, name):
        return self._spans.get(name, np.empty((0, 3), np.int64))

    def launch_planes(self):
        return self._planes


def scene(drop_kernel=False, frames=32):
    """Two frame calls of (1 luma, 2 chroma) launches.  Kernels (us): call
    1's at 6.5-20, 20-22, 22.5-25 (issued at 6); call 2's at 40-50, 50-52,
    52-55 (issued at 36).  Host: issue 0-8 and 30-38, wait_event 8-30,
    wait_end 38-100; frame calls 1-7 and 31-37, launches 5-6 and 35-36."""
    kernels = [(52, 55), (6.5, 20), (50, 52), (22.5, 25), (40, 50), (20, 22)]
    if drop_kernel:
        kernels = kernels[:-1]
    spans = Spans()
    for label, rows in (("issue", [(0, 8), (30, 38)]), ("wait_event", [(8, 30)]),
                        ("wait_end", [(38, 100)])):
        for a, b in rows:
            spans.add(label, int(a * US), int(b * US))
    k = np.asarray(kernels, float) * US
    trace = Trace(0.0, 100 * US, frames, spans, k, ["resize_tiled_kernel"] * len(k),
                  np.empty((0, 2)), [])
    rec = Recorded({"port.frame_call": [(1 * US, 7 * US, 1), (31 * US, 37 * US, 2)],
                    "port.launch": [(5 * US, 6 * US, 1), (35 * US, 36 * US, 2),
                                    (150 * US, 151 * US, 3)]},       # after the window
                   [(1, 2), (1, 2), (1, 2)])
    return port_trace.PortTrace.of(trace, rec)


def test_kernels_map_to_planes_in_stream_order():
    pt = scene()
    assert len(pt.calls) == 2 and len(pt.launches) == 2
    kernels, plane, launch = pt.kernel_map()
    assert kernels[:, 0].tolist() == [x * US for x in (6.5, 20, 22.5, 40, 50, 52)]
    assert plane.tolist() == [0, 1, 1, 0, 1, 1] and launch.tolist() == [0, 0, 0, 1, 1, 1]
    assert pt.plane_s(port_trace.LUMA) == pytest.approx(23.5e-6)
    assert pt.plane_s(port_trace.CHROMA) == pytest.approx(9.5e-6)


def test_kernel_count_mismatch_reads_none():
    pt = scene(drop_kernel=True)
    assert pt.kernel_map() is None and pt.idle_split() is None and pt.idle_gaps() is None
    got = port_trace.metrics(pt, None, L4K, H100)
    assert set(got) == {"facade_ms.batch", "launch_ms.batch"}


def test_gap_splits_into_queued_and_starved():
    queued, starved = scene().idle_split()
    assert (queued / US).tolist() == [[6, 6.5], [22, 22.5], [36, 40]]
    assert (starved / US).tolist() == [[0, 6], [25, 36], [55, 100]]
    rows = dict(scene().idle_gaps())
    assert rows == pytest.approx({
        "queued": 5e-6, "port.launch": 2e-6, "port.frame_call": 8e-6, "issue": 2e-6,
        "wait_event": 5e-6, "wait_end": 45e-6, "longest:wait_end": 45e-6})
    t = scene().trace
    idle = t.window_s - t.busy_s
    assert sum(v for k, v in rows.items() if not k.startswith("longest:")) == pytest.approx(idle)
    assert port_trace.starved_pct(scene()) == pytest.approx(62.0)


def test_no_recording_leaves_todays_rows():
    pt = scene()
    before = pt.trace.idle_gaps()
    assert [r[0] for r in before] == ["wait_end", "issue", "wait_event", "none",
                                      "longest:wait_end"]
    assert port_trace.metrics(None, None, L4K, H100) == {}
    pt.idle_gaps()
    assert pt.trace.idle_gaps() == before


def test_facade_and_launch_time_per_call():
    pt = scene()
    assert port_trace.launch_ms(pt) == pytest.approx(1e-3)
    assert port_trace.facade_ms(pt) == pytest.approx(5e-3)     # (6 - 1) us a call


@pytest.mark.parametrize("cfg", [L4K, A1080], ids=["lanczos3_4k", "area_1080p"])
def test_plane_bounds_split_the_frame(cfg):
    planes = (port_trace.LUMA, port_trace.CHROMA)
    assert sum(port_trace.plane_bytes(cfg, p) for p in planes) == work.frame_bytes(cfg)
    assert sum(port_trace.plane_ops(cfg, p) for p in planes) == work.frame_ops(cfg)
    bounds = [port_trace.plane_bound_s(cfg, H100, p) for p in planes]
    assert sum(bounds) == pytest.approx(work.frame_bound_s(cfg, H100)[0])
    assert port_trace.plane_bound_s(cfg, "some other card", 0) is None


def test_plane_rooflines_combine_to_the_frames():
    pt = scene()
    got = port_trace.metrics(pt, None, L4K, H100)
    whole = readers.kernel_roofline_pct(Run(L4K, H100, 0.0, None, pt.trace.spans, pt.trace))
    bl, bc = (port_trace.plane_bound_s(L4K, H100, p) for p in (0, 1))
    combined = (bl + bc) / (bl / got["luma_roofline.batch"] + bc / got["chroma_roofline.batch"])
    assert combined == pytest.approx(whole)
    assert got["luma_roofline.batch"] == pytest.approx(100 * 32 * bl / 23.5e-6)


def test_setup_is_the_union_of_the_set_up_spans():
    rec = Recorded({"port.plan": [(0, 10, 1), (12, 20, 2)], "port.tables": [(30, 40, 3)],
                    "port.exec_create": [(35, 50, 3)], "port.library": [(36, 45, 3)],
                    "port.frame_call": [(25, 60, 3)]}, [])
    assert port_trace.port_setup_s(rec) == pytest.approx(38e-9)
    assert port_trace.port_setup_s(None) is None


def test_launch_of_an_unknown_plane_reads_none():
    pt = scene()
    pt.planes[1] = tracing.UNKNOWN_PLANE
    assert pt.kernel_map() is None and pt.idle_split() is None
    assert set(port_trace.metrics(pt, None, L4K, H100)) == {"facade_ms.batch", "launch_ms.batch"}


@pytest.mark.parametrize("seed", range(4))
def test_starved_rows_equal_the_grid(seed):
    """Each starved instant under its innermost host span, on a grid of
    random host spans: the launch inside the frame call inside ``issue``."""
    rng = np.random.default_rng(seed)
    pt = scene()
    issue = pt.trace.spans.array("issue")
    calls = np.stack([issue[:, 0] + rng.integers(0, 3, 2) * US,
                      issue[:, 1] - rng.integers(0, 3, 2) * US], axis=1)
    launches = np.stack([calls[:, 0] + rng.integers(1, 3, 2) * US,
                         calls[:, 1] - rng.integers(0, 2, 2) * US], axis=1)
    pt.calls[:, :2] = calls
    pt.launches[:, :2] = launches
    grid = (np.arange(0, 100, 0.25) + 0.125) * US
    queued, starved = pt.idle_split()

    def cover(iv):
        return ((grid[:, None] > iv[:, 0]) & (grid[:, None] < iv[:, 1])).any(axis=1)
    left = cover(starved)
    want = {"queued": cover(queued).sum() * 0.25e-6}
    for label, spans in pt.host_labels():
        inside = left & cover(spans)
        if inside.any():
            want[label] = inside.sum() * 0.25e-6
        left &= ~inside
    if left.any():
        want["none"] = left.sum() * 0.25e-6
    got = {k: v for k, v in pt.idle_gaps() if not k.startswith("longest:")}
    assert got == pytest.approx(want, abs=1e-12)


@pytest.fixture
def tiny_a64(tiny, monkeypatch):
    monkeypatch.setattr(run, "PREROLL_S", 0.02)
    return tiny("area", 90, 60, 30, 20)


def measure_on_cpu(bench):
    return port_run.measure(bench, spec.cell(bench, A64), seed=2**31 + 11, seconds=0.2,
                            device="cpu", backend="auto",
                            event=HostEvent, synchronize=lambda: None, kind="cpu",
                            log=lambda s: None)


def test_measure_on_the_cpu_reads_the_hosts_spans(tiny_a64):
    result = measure_on_cpu(tiny_a64)
    assert set(result["metrics"]) == {"facade_ms.batch", "port_setup_s"}   # no card
    assert result["metrics"]["facade_ms.batch"] <= result["existing"]["issue_ms.batch"]
    assert result["checks"]["frame_calls"] > 0 and result["idle_split"] is None
    assert "counters_setup" in result and tracing.RECORDING is None


def test_measure_without_the_ports_tracing(tiny_a64, monkeypatch):
    monkeypatch.setitem(sys.modules, "libiqo_tpu_torch.tracing", None)
    assert port_trace.port_tracing() is None
    result = measure_on_cpu(tiny_a64)
    assert result["metrics"] == {} and "issue_ms.batch" in result["existing"]
    assert "idle_split" not in result and "counters_setup" not in result
    assert [r[0] for r in result["idle_gaps"]][-1].startswith("longest:")

