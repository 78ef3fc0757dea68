"""The benchmark's arithmetic: quartile spreads, unions and gaps of intervals, the bytes and operations of a frame,
and the readers over a hand-made run."""

from __future__ import annotations

import statistics

import numpy as np
import pytest

from portbench import readers, work
from portbench.harness import Run, Spans, Window
from portbench.stats import gaps, merge, overlap, quartile_spread, union_length
from portbench.trace import Trace, Tracer

H100 = "NVIDIA H100 80GB HBM3"
L4K = {"method": "lanczos3", "src_w": 3840, "src_h": 2160, "dst_w": 1920, "dst_h": 1080,
       "reference": "yuv420"}
A1080 = {"method": "area", "src_w": 1920, "src_h": 1080, "dst_w": 640, "dst_h": 360,
         "reference": "yuv420"}


def loop_union(intervals) -> float:
    """The union as ``tools/profile_yuv.union_length`` takes it."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def test_quartile_spread_uses_statistics_quantiles():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.7]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert quartile_spread(v) == pytest.approx((q3 - q1) / q2)


@pytest.mark.parametrize("seed", range(5))
def test_union_equals_the_loop(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 100, 300)
    iv = np.stack([a, a + rng.exponential(2, 300)], axis=1)
    assert union_length(iv) == pytest.approx(loop_union(map(tuple, iv)))
    m = merge(iv)
    assert (m[1:, 0] > m[:-1, 1]).all()


def test_union_gaps_overlap():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 9)]
    assert union_length(iv) == 4
    np.testing.assert_array_equal(gaps(np.array(iv, float), 0, 10), [[3, 5], [6, 10]])
    assert overlap([(0, 4)], [(2, 6), (3, 5)]) == 2
    assert union_length([]) == 0


def test_bytes_a_frame_from_the_geometry():
    assert work.frame_bytes(L4K) == 15_552_000
    assert work.frame_bytes(A1080) == 3_456_000
    # odd sizes: luma at its true size, chroma at half the evened size
    assert work.frame_bytes({"src_w": 5, "src_h": 3, "dst_w": 3, "dst_h": 1}) == \
        15 + 2 * 3 * 2 + 4 * 2 + 2 * 2 * 1


def test_bounds_on_the_h100():
    t, by = work.frame_bound_s(L4K, H100)
    assert by == "bytes" and t == pytest.approx(4.642388e-6, rel=1e-6)
    t, by = work.frame_bound_s(A1080, H100)
    assert by == "bytes" and t == pytest.approx(1.0316418e-6, rel=1e-6)
    # Lanczos3 4K: 12 taps each way on luma, 4 on chroma, 2 operations a tap
    assert work.frame_ops(L4K) == 2 * (1080 * 3840 * 12 + 1080 * 1920 * 12
                                       + 2 * (540 * 1920 * 4 + 540 * 960 * 4))
    assert work.frame_bound_s(L4K, "some other card") is None


def make_run(kernels, copies=(), frames=10, t0=0.0, t1=1e6, spans=None):
    spans = spans or Spans()
    trace = Trace(t0, t1, frames, spans, np.asarray(kernels, float).reshape(-1, 2),
                  ["k"] * len(kernels), np.asarray(copies, float).reshape(-1, 2),
                  ["Memcpy HtoD"] * len(copies))
    w = Window(int(t0), int(t1), calls=frames, frames=frames, attempted=frames, failed=0)
    return Run(L4K, H100, 1.5, w, spans, trace)


def test_readers():
    spans = Spans()
    spans.add("issue", 0, 100_000)
    spans.add("issue", 200_000, 400_000)
    spans.add("wait_event", 400_000, 900_000)
    run = make_run([(100_000, 300_000), (250_000, 500_000)], [(600_000, 700_000)],
                   frames=20, spans=spans)
    assert readers.setup_s(run) == 1.5
    assert readers.frames_per_s(run) == 20 / 1e-3
    assert readers.issue_ms(run) == pytest.approx(0.15)
    assert readers.device_idle_pct(run) == pytest.approx(100 * (1 - 0.5))
    assert readers.kernel_roofline_pct(run) == pytest.approx(
        100 * 20 * 4.642388059701492e-6 / 400e-6)
    gaps_ = dict(run.trace.idle_gaps())
    assert gaps_["issue"] == pytest.approx(0.1e-3)
    assert gaps_["wait_event"] == pytest.approx(0.3e-3)
    assert gaps_["none"] == pytest.approx(0.1e-3)
    assert gaps_["longest:wait_event"] == pytest.approx(0.3e-3)
    assert run.trace.device_ops() == [["k", pytest.approx(450e-6)],
                                      ["Memcpy HtoD", pytest.approx(100e-6)]]


def test_readers_find_nothing_without_a_trace():
    run = make_run([])
    assert readers.kernel_roofline_pct(run) is None
    assert readers.device_idle_pct(run) is None
    run.trace = None
    assert readers.kernel_roofline_pct(run) is None and readers.issue_ms(run) is None


def test_anchors_carry_device_times_onto_the_host_clock():
    tracer = Tracer(False)
    tracer._prof, tracer._marks = object(), [5_000.0, 25_000.0]
    tracer._offsets = [-4_000.0, -4_000.0]
    events = [("at::cuda::spin_kernel(long)", 1_000, 1_010), ("resize", 2_000, 3_000),
              ("Memcpy DtoD", 4_000, 4_500), ("resize", 9_000, 12_000),
              ("at::cuda::spin_kernel(long)", 11_000, 11_010)]
    tracer._events = lambda: iter(events)
    window = Window(5_500, 22_000, calls=2, frames=32, attempted=32, failed=0)
    trace = tracer.read(window, Spans())
    # device 1,000 -> host 5,000 and device 11,000 -> host 25,000: twice as fast
    assert trace.kernels.tolist() == [[7_000.0, 9_000.0], [21_000.0, 22_000.0]]
    assert trace.copies.tolist() == [[11_000.0, 12_000.0]] and trace.frames == 32
    assert trace.placed_by.startswith("2 anchors")


def test_a_lost_anchor_leaves_the_profilers_unix_clock():
    tracer = Tracer(False)
    tracer._prof, tracer._marks = object(), [5_000.0, 25_000.0]
    # the profiler's clock reads Unix time: host perf_counter + 4,000
    tracer._offsets = [3_990.0, 4_010.0]
    events = [("at::cuda::spin_kernel(long)", 9_000, 9_010), ("resize", 10_000, 11_000),
              ("Memcpy DtoD", 12_000, 12_500), ("resize", 24_000, 30_000)]
    tracer._events = lambda: iter(events)
    window = Window(5_500, 22_000, calls=2, frames=32, attempted=32, failed=0)
    trace = tracer.read(window, Spans())
    assert trace.kernels.tolist() == [[6_000.0, 7_000.0], [20_000.0, 22_000.0]]
    assert trace.copies.tolist() == [[8_000.0, 8_500.0]]
    assert trace.placed_by.startswith("1 of the 2 anchors")
