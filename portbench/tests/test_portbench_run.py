"""A whole run of the harness on the CPU at a tiny geometry, past its look
for a card: the port's plain path is correct; its relaxed path (the
control) and the timed path broken underneath are not."""

from __future__ import annotations

import gc
import json
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from libiqo_tpu_torch.yuv import YUV420Resizer
from portbench import check, run, spec
from portbench.harness import GcPauses, Sampler, Spans
from portbench.tests.conftest import HostEvent

B16 = "lanczos3_4k_to_1080p.batch16"
A64 = "area_1080p_to_360p.batch64"


@pytest.fixture(autouse=True)
def short_preroll(monkeypatch):
    monkeypatch.setattr(run, "PREROLL_S", 0.02)


def run_on_cpu(bench, cell, seconds=0.2, trace=False, precision=None, backend="auto"):
    lines = []
    result = run.run_cell(bench, spec.cell(bench, cell), seed=2**31 + 11, seconds=seconds,
                          trace=trace, precision=precision, device="cpu", backend=backend,
                          event=HostEvent, synchronize=lambda: None, kind="cpu",
                          log=lines.append)
    return result, lines


@pytest.mark.parametrize("cell,geometry", [
    (B16, ("lanczos3", 96, 54, 48, 28)), (A64, ("area", 90, 60, 30, 20)),
    (B16, ("lanczos3", 97, 61, 31, 23))])
def test_sound_run_is_correct(tiny, cell, geometry):
    bench = tiny(*geometry)
    result, lines = run_on_cpu(bench, cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "check"
    assert result["check"] == {"max_lsb": {"value": 0, "limit": 0}}
    names = {m["name"] for m in spec.end_to_end(bench, cell)}
    assert set(result["metrics"]) == names
    assert any(line.startswith("setup s:") for line in lines)
    json.dumps(result)


def test_traced_run_reads_spans(tiny):
    result, lines = run_on_cpu(tiny("area", 90, 60, 30, 20), A64, trace=True)
    assert result["correct"]
    assert set(result["metrics"]) == {"issue_ms.batch"}      # no card: no device time
    assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
    # the window and the traced window both count their frames
    counted = [int(line.split(" calls, ")[1].split(" frames")[0]) for line in lines
               if line.startswith(("window ", "traced window "))]
    assert len(counted) == 2 and result["attempted"] == sum(counted)


def test_spans_leave_nothing_to_collect():
    spans = Spans()
    record = spans.recorder("issue")
    before = len(gc.get_objects())
    for i in range(20_000):
        record((i, i + 3))
    assert len(gc.get_objects()) - before < 10
    assert spans.count("issue") == 20_000 and spans.total_ns("issue") == 60_000
    assert spans.array("issue")[-1].tolist() == [19_999.0, 20_002.0]


def test_cycle_collections_are_timed():
    with GcPauses() as collections:
        gc.collect(2)
    count, total, longest = collections.pauses[2]
    assert count >= 1 and total >= longest > 0
    assert collections._note not in gc.callbacks
    assert collections.line().startswith("generation 0: ")


def test_failure_in_the_traced_window_is_counted(tiny, monkeypatch):
    real_resize, real_traced, tracing = YUV420Resizer.resize_batch, run.traced_window, []

    def resize_batch(self, y, u, v):
        if tracing:
            raise RuntimeError("launch failed")
        return real_resize(self, y, u, v)

    def traced_window(*args):
        tracing.append(True)
        return real_traced(*args)
    monkeypatch.setattr(YUV420Resizer, "resize_batch", resize_batch)
    monkeypatch.setattr(run, "traced_window", traced_window)
    result, _ = run_on_cpu(tiny("area", 90, 60, 30, 20), A64, trace=True)
    assert not result["correct"] and result["failed"] > 0
    assert result["check"]["max_lsb"]["value"] == 0       # the window's outputs are right


def test_control_is_not_correct(tiny):
    result, _ = run_on_cpu(tiny("lanczos3", 96, 54, 48, 28), B16, precision="relaxed",
                           backend="cuda")
    assert not result["correct"]
    assert 1 <= result["check"]["max_lsb"]["value"] <= 2


def stale(real):
    """A step that hands back the first call's outputs, unchanged."""
    kept = {}

    def resize_batch(self, y, u, v):
        if "out" not in kept:
            kept["out"] = real(self, y, u, v)
        return kept["out"]
    return resize_batch


def half_left_out(real):
    def resize_batch(self, y, u, v):
        n = y.shape[0] // 2
        oy, ou, ov = real(self, y[:n], u[:n], v[:n])
        pad = [torch.zeros((y.shape[0] - n,) + p.shape[1:], dtype=p.dtype) for p in (oy, ou, ov)]
        return tuple(torch.cat([p, q]) for p, q in zip((oy, ou, ov), pad))
    return resize_batch


def altered(real):
    def resize_batch(self, y, u, v):
        oy, ou, ov = real(self, y, u, v)
        oy = oy.clone()
        oy[:, -1, 0] += 1
        return oy, ou, ov
    return resize_batch


def shorter(real):
    def resize_batch(self, y, u, v):
        n = y.shape[0] // 2
        return real(self, y[:n], u[:n], v[:n])
    return resize_batch


@pytest.mark.parametrize("fault", [stale, half_left_out, altered, shorter],
                         ids=lambda f: f.__name__)
def test_broken_batch_path_is_not_correct(tiny, monkeypatch, fault):
    monkeypatch.setattr(YUV420Resizer, "resize_batch", fault(YUV420Resizer.resize_batch))
    result, _ = run_on_cpu(tiny("lanczos3", 96, 54, 48, 28), B16)
    assert not result["correct"]
    lsb = result["check"]["max_lsb"]["value"]
    assert lsb == check.MISSING if fault is shorter else 0 < lsb < check.MISSING


def test_failing_calls_are_counted(tiny, monkeypatch):
    def resize_batch(self, y, u, v):
        raise RuntimeError("launch failed")
    result, _ = run_on_cpu(tiny("area", 90, 60, 30, 20), A64)
    assert result["correct"]
    monkeypatch.setattr(YUV420Resizer, "resize_batch", resize_batch)
    with pytest.raises(RuntimeError):
        run_on_cpu(tiny("area", 90, 60, 30, 20), A64)   # the warm-up call raises


def test_sampler_is_uniform_seeded_and_stratified():
    def kept(seed, n=1000, size=4, strata=1):
        s = Sampler(strata, size, seed)
        for k in range(n):
            slot = s.slot(k % strata)
            if slot >= 0:
                s.put(k % strata, slot, k)
        return s.payloads()
    assert kept(5) == kept(5) and kept(5) != kept(6)
    assert kept(5, n=3) == [0, 1, 2]
    counts = np.bincount(np.concatenate([kept(s, n=10) for s in range(2000)]), minlength=10)
    assert counts.min() > 0.8 * counts.mean()
    assert [k % 4 for k in kept(7, n=100, size=1, strata=4)] == [0, 1, 2, 3]


def test_picks_cover_every_run_of_a_batch():
    rng = np.random.default_rng(3)
    for _ in range(50):
        p = check.picks(16, 4, rng)
        assert [k // 4 for k in p] == [0, 1, 2, 3]
    assert check.picks(1, 1, rng) == [0] and len(check.picks(3, 8, rng)) == 3


def test_forbidden_modules_compared_whole(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert run.forbidden_modules() == ["jaxlib"]
    assert "libiqo_tpu_torch" in {m.split(".")[0] for m in sys.modules}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", B16, "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
    assert 0 < run.process_age_s() < 1e6


def test_bare_checkout_exits_without_result(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", B16, "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.cuda
def test_cell_on_the_card(card, capsys):
    assert run.main(["--workload", B16, "--seed", "12345", "--seconds", "1"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
