"""Timing harness of the H100 probes, the port of ``scripts/exp_dma_ceiling.py``'s
``slope_time`` (``:82-119``) and of the scripts' timing loops.

Two forms, both timed by CUDA events with the card first held busy while the
host queues every launch (a ``torch.cuda._sleep`` spin measured against the
host's own enqueue time), so that the events time the device alone; an
L2-resident application is shorter than one launch from Python:

* :func:`chain_ms`, a **serial chain** on one stream: each launch's output
  is the next one's input (two buffers, ping-pong), and the chain's final
  checksum over every element is asserted against the arithmetic the chain
  must have done, so a fast number from skipped work is impossible;
* :func:`launches_ms`, back-to-back launches on inputs that each differ by
  one element (``scripts/exp_banded_dots.py:bench``, ``:116-145``), whose
  callers hold one output against the plain version; unprimed, for calls
  that synchronise (the plain versions), it times them at the host's pace.

Nothing here falls back to the CPU: :func:`require_card` raises without a
card, and every result line carries the card's name and power limit.
"""

from __future__ import annotations

import functools
import subprocess
import threading
import time
from typing import Callable, Iterable

import torch

from ..ops import _build

__all__ = ["BF16_OPS_PER_S", "FP32_OPS_PER_S", "HBM_BYTES_PER_S", "INT32_OPS_PER_S",
           "INT8_OPS_PER_S", "Launches", "TF32_OPS_PER_S", "card", "chain_ms", "check_rc",
           "checksum", "lib", "lib_with_setup", "launches_ms", "on_card", "perturbed",
           "require_card", "run_chain", "signed32", "turns_ms", "wrap"]

# the H100 SXM data sheet: memory rate, bytes/s, and dense tensor-core
# peaks, operations/s
HBM_BYTES_PER_S = 3.35e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
# CUDA cores: the data sheet's FP32 rate (two operations per FMA), and 32-bit
# integer operations (multiply-add, add, shift, logic, min/max) at 64 per
# clock per SM (the CUDA C++ Programming Guide's throughput table, compute
# capability 9.0) on 132 SMs at the 1,980 MHz boost clock that gives the
# data sheet's FP32 rate
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
_SPIN_MARGIN = 2.0              # spin this much longer than the host's enqueue
_MAX_RETRIES = 4                # repeats redone because the host outran the spin


class Launches(dict):
    """Kernel launches by variant, counted by a wrapper where it launches."""

    def __init__(self, variants: Iterable[str]):
        super().__init__(dict.fromkeys(variants, 0))
        self._lock = threading.Lock()

    def add(self, variant: str) -> None:
        with self._lock:
            self[variant] += 1

    def reset(self) -> None:
        with self._lock:
            for k in self:
                self[k] = 0

    def total(self) -> int:
        return sum(self.values())


def wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of int64 values to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def on_card(*tensors: torch.Tensor) -> bool:
    """True where a wrapper launches its kernel (every tensor on one CUDA
    device), False where it runs its plain version (every tensor on the
    CPU); raises for any other device or a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def lib():
    """The probes' kernel library (built on first use; raises without nvcc)."""
    return _build.load_experiments()


@functools.cache
def lib_with_setup(symbol: str, device: torch.device):
    """The probes' library with the setup ``symbol`` (a kernel's shared-memory
    opt-in) run once on ``device``."""
    lib_ = lib()
    with torch.cuda.device(device):
        check_rc(getattr(lib_, symbol)(), symbol)
    return lib_


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib().iqo_exp_error_string(rc).decode()} ({rc})")


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes measure the card and "
                           "have no CPU form")


def card() -> str:
    """``name, power.limit`` of card 0, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def signed32(total: int) -> int:
    """``total`` wrapped to 32 bits and read as int32."""
    return ((total % 2**32 + 2**31) % 2**32) - 2**31


def checksum(x: torch.Tensor) -> int:
    """The sum of every element viewed as uint32, wrapped and viewed as
    int32, as the TPU harness's ``jnp.sum(x.astype(jnp.uint32))``."""
    return signed32(int(x.to(torch.int64).sum().item()))


def run_chain(call: Callable[[torch.Tensor, torch.Tensor], object],
              x0: torch.Tensor, inner: int) -> torch.Tensor:
    """``inner`` applications of ``call(src, out)`` from ``x0``, each output
    the next input, through two buffers; returns the last output."""
    return _chain(call, (x0.clone(), torch.empty_like(x0)), inner)


def _chain(call, bufs, inner: int) -> torch.Tensor:
    a, b = bufs
    for _ in range(inner):
        call(a, b)
        a, b = b, a
    return a


def _device_ms(enqueue: Callable[[], object], launches: int, repeats: int,
               prepare: Callable[[], object] = lambda: None,
               after: Callable[[], object] = lambda: None,
               primed: bool = True) -> float:
    """Min over repeats of device ms per launch of ``enqueue()``, which
    queues ``launches`` launches, with the card spinning until the host has
    queued them all (unprimed: no spin, the host's pace).  ``prepare()`` is
    queued before the spin, and ``after()`` runs once each repeat has
    finished."""
    prepare()
    t0 = time.perf_counter()
    enqueue()                                       # warm-up, host-paced
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    after()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # the spin's rate in cycles per ms on this card, measured once
    cycles = 10_000_000
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    torch.cuda.synchronize()
    per_ms = cycles / start.elapsed_time(stop)
    best, done, tries = float("inf"), 0, 0
    while done < repeats:
        prepare()
        spin = int(per_ms * (_SPIN_MARGIN * host_s * 1e3 + 2.0)) if primed else 0
        if spin:
            torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        start.record()
        enqueue()
        stop.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        after()
        host_s = max(host_s, queued_ms * 1e-3)
        if primed and queued_ms > spin / per_ms:   # the card caught up with the host
            tries += 1
            # each retry doubles the spin; calls that block the host (a sync,
            # or more launches than the queue holds) never fit it
            if tries > _MAX_RETRIES:
                raise RuntimeError(f"the host took {queued_ms!r} ms to queue "
                                   f"{launches} launches, longer than the spin "
                                   f"of {spin / per_ms!r} ms: not a device time")
            continue
        best = min(best, start.elapsed_time(stop) / launches)
        done += 1
    return best


def chain_ms(call: Callable[[torch.Tensor, torch.Tensor], object],
             x0: torch.Tensor, inner: int, expect: Callable,
             repeats: int = 5) -> float:
    """Device ms per application of a serial chain of ``inner``
    applications from ``x0``; after every chain, timed or not, its checksum
    must equal ``expect(x0, inner)``."""
    bufs = (torch.empty_like(x0), torch.empty_like(x0))
    want = expect(x0, inner)
    last = [None]

    def enqueue():
        last[0] = _chain(call, bufs, inner)

    def after():
        if (got := checksum(last[0])) != want:
            raise AssertionError(f"chain checksum {got} != {want} after "
                                 f"{inner} applications")

    return _device_ms(enqueue, inner, repeats,
                      prepare=lambda: bufs[0].copy_(x0), after=after)


def launches_ms(fn: Callable[[torch.Tensor], object], inputs: list[torch.Tensor],
                repeats: int = 5, primed: bool = True) -> float:
    """Device ms per call of ``fn`` over back-to-back calls, one per input."""
    def enqueue():
        for x in inputs:
            fn(x)
    return _device_ms(enqueue, len(inputs), repeats, primed=primed)


def turns_ms(calls: dict) -> dict:
    """Each of ``calls`` (name: (fn, inputs)) timed by :func:`launches_ms`
    twice, in the order given and then reversed; {name: the min of its two}."""
    names = list(calls)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(launches_ms(*calls[n]))
    return {n: min(t) for n, t in times.items()}


def perturbed(base: torch.Tensor, n: int) -> list[torch.Tensor]:
    """n copies of base, copy i with its first element set to i (as the TPU
    loops' ``dynamic_update_slice`` of the loop index; mod 256 for uint8)."""
    out = []
    for i in range(n):
        x = base.clone()
        x.view(-1)[0] = i % 256 if x.dtype == torch.uint8 else i
        out.append(x)
    return out
