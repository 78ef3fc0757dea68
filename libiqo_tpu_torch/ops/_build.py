"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, bound with ctypes.

The library is built from ``libiqo_tpu_torch/csrc/*.cu`` on first use, into
``build/libiqo_tpu_torch/<hash of the sources>/`` beside the package, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Nothing is
built when this module is imported, and nothing is built from outside the
repository.  If ``nvcc`` is missing or fails, :func:`load` raises with its
output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["BuildError", "build_dir", "find_nvcc", "load", "nvcc_command"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of this process's build, if it built
build_log: str = ""                  # nvcc's output (ptxas register/smem report)


class BuildError(RuntimeError):
    """nvcc is missing or refused the kernel sources."""


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return _PKG.parent / "build" / "libiqo_tpu_torch" / _digest()


def find_nvcc() -> str | None:
    """nvcc on PATH, else under $CUDA_HOME or the default toolkit prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def nvcc_command(nvcc: str, out: Path) -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), *map(str, sources())]


def _build(so: Path) -> None:
    global build_seconds, build_log
    nvcc = find_nvcc()
    if nvcc is None:
        raise BuildError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                         "the CUDA kernels cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent process never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(nvcc, Path(tmp)), capture_output=True,
                          text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise BuildError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.iqo_resize_fused.argtypes = [
        i, i, i,                        # wrap16, relaxed, carry: which instantiation
        p, p, i, ll, ll, i, i,          # src, dst, frames, strides, dst shape
        p, p, p, i, i,                  # cy, iy, ydiv, taps_y, y_bias
        p, p, p, i,                     # cx, ix, xdiv, taps_x
        p, p,                           # cxr, cxd (relaxed planes; cxd may be NULL)
        p, i, i,                        # win, win_max, out_shift
        p, p, i, i, i,                  # rwin, iyr, ring_rows, ring_pitch, run (carry)
        p]                              # stream
    lib.iqo_resize_fused.restype = i
    lib.iqo_set_max_smem.argtypes = [i]
    lib.iqo_set_max_smem.restype = i
    lib.iqo_tile_shape.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.iqo_tile_shape.restype = i
    lib.iqo_error_string.argtypes = [i]
    lib.iqo_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Thread-safe."""
    global _lib
    with _lock:
        if _lib is None:
            so = build_dir() / "libiqo_tpu_torch.so"
            if not so.exists():
                _build(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        return _lib
