"""Device capability queries for the port: the CUDA counterpart of
``libiqo_tpu/utils/device.py`` (itself the analog of the reference's HWCap,
ref: src/IQOHWCap.hpp:6-57).

Reports the device's name, compute capability, SM count and memory, and
whether the hand-written kernels can run there: they are built for sm_90a
(Hopper) by ``nvcc``, so both must be present.  ``supports_kernels`` is for
reporting only; dispatch does not read it, so a CUDA tensor on a card
without them raises instead of running the plain path.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops import _build

__all__ = ["DeviceCaps", "caps", "describe", "resolve_device"]

KERNEL_CAPABILITY = (9, 0)


@dataclasses.dataclass(frozen=True)
class DeviceCaps:
    platform: str                    # "gpu" | "cpu"
    device_kind: str                 # e.g. "NVIDIA H100 80GB HBM3"
    num_devices: int
    memory_per_device: int | None    # bytes of device memory, if a GPU
    capability: tuple[int, int] | None
    sm_count: int | None
    supports_kernels: bool           # sm_90 and nvcc present

    @property
    def is_gpu(self) -> bool:
        return self.platform == "gpu"


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent:
    the port never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               "device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def caps(device="cuda") -> DeviceCaps:
    return _caps(resolve_device(device))


@functools.lru_cache(maxsize=None)
def _caps(dev: torch.device) -> DeviceCaps:
    if dev.type != "cuda":
        return DeviceCaps("cpu", "cpu", 1, None, None, None, False)
    p = torch.cuda.get_device_properties(dev)
    cap = (p.major, p.minor)
    return DeviceCaps(
        platform="gpu", device_kind=p.name,
        num_devices=torch.cuda.device_count(),
        memory_per_device=p.total_memory, capability=cap,
        sm_count=p.multi_processor_count,
        supports_kernels=cap == KERNEL_CAPABILITY
        and _build.find_nvcc() is not None)


def describe(device="cuda") -> str:
    c = caps(device)
    if not c.is_gpu:
        return "cpu (no CUDA kernels)"
    return (f"{c.num_devices}x {c.device_kind} (sm_{c.capability[0]}"
            f"{c.capability[1]}, {c.sm_count} SMs), "
            f"{c.memory_per_device / 2**30:.1f} GiB/device, "
            f"kernels={'yes' if c.supports_kernels else 'no'}")
