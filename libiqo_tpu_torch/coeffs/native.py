"""ctypes loader for the native C++ table builder (native/iqo_tables.cpp).

The port's copy of ``libiqo_tpu/coeffs/native.py``.  Compiled on first use
with g++ (strict IEEE: -O2 -fno-fast-math so the float32 quantization
matches the NumPy engine bit-for-bit) into
``build/libiqo_tpu_torch/native-<hash of the source>/`` beside the package
in a writable source checkout, else under ``$LIBIQO_TPU_CACHE`` or the
temporary directory (``utils/build_root.py``), the same tree as the CUDA
kernels; falls back to None when no toolchain is
available — callers then use the pure-Python engine.  Validated equal to
the engine in tests/test_torch_plan.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..utils.build_root import build_root

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "iqo_tables.cpp"
_lib = None
_checked = False


def _build_dir() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return build_root(_PKG) / f"native-{digest}"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent process never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-fno-fast-math", "-shared", "-fPIC",
             str(_SRC), "-o", tmp],
            check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        os.unlink(tmp)
        return False
    os.replace(tmp, so)
    return True


def _load():
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    so = _build_dir() / "iqo_tables.so"
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    i64 = ctypes.c_int64
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.iqo_lanczos_tables.argtypes = [ctypes.c_int, i64, i64, i64, i64, i64, p32]
    lib.iqo_area_tables.argtypes = [i64, i64, i64, i64, p32]
    lib.iqo_linear_tables.argtypes = [i64, i64, i64, p32]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _out(shape) -> np.ndarray:
    return np.zeros(shape, dtype=np.int32)


def lanczos_tables(degree, r_src, r_dst, px_scale, num_coefs, bias):
    lib = _load()
    if lib is None:
        return None
    out = _out((r_dst, num_coefs))
    rc = lib.iqo_lanczos_tables(degree, r_src, r_dst, px_scale, num_coefs,
                                bias, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out if rc == 0 else None


def area_tables(r_src, r_dst, num_coefs, bias):
    lib = _load()
    if lib is None:
        return None
    out = _out((r_dst, num_coefs))
    rc = lib.iqo_area_tables(r_src, r_dst, num_coefs, bias,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out if rc == 0 else None


def linear_tables(r_src, r_dst, bias):
    lib = _load()
    if lib is None:
        return None
    out = _out((r_dst, 2))
    rc = lib.iqo_linear_tables(r_src, r_dst, bias,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out if rc == 0 else None
