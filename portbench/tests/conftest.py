"""Fixtures of the benchmark's tests: a host-clock stand-in for the card's
events, a cell of tiny geometry, and a fixture that skips without a card."""

from __future__ import annotations

import json
import time

import pytest

from portbench import spec


class HostEvent:
    """``torch.cuda.Event`` on the host's clock, for runs on the CPU."""

    def __init__(self, enable_timing: bool = False):
        self.t = None

    def record(self, stream=None) -> None:
        self.t = time.perf_counter_ns()

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) / 1e6


@pytest.fixture
def tiny(tmp_path):
    """A copy of ``BENCHMARK.json`` whose configurations are resized to the
    geometry given: ``tiny(method, sw, sh, dw, dh)``."""

    def make(method, sw, sh, dw, dh):
        bench = spec.load()
        for c in bench["configs"]:
            cfg = spec.config(bench, c["name"])
            cfg.update(method=method, src_w=sw, src_h=sh, dst_w=dw, dst_h=dh)
            path = tmp_path / f"{c['name']}.json"
            path.write_text(json.dumps(cfg))
            c["file"] = str(path)
        return bench

    return make


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, never
    at import)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    return torch.device("cuda", 0)
