"""Build and load the port's CUDA kernels: nvcc into shared libraries with a
plain C interface, bound with ctypes.

Two libraries, each built on first use into
``build/libiqo_tpu_torch/<hash of its sources>/`` beside the package in a
writable source checkout, else under ``$LIBIQO_TPU_CACHE`` or the temporary
directory (:func:`..utils.build_root.build_root`), so an edited source is
rebuilt and an unchanged one is loaded as it is.  Each
source is compiled by its own ``nvcc -c``, all started together, and the
objects are linked by one ``nvcc -shared``:

* the resize kernels, ``resize_fused``, the four forms of
  ``resize_tiled`` (one source each, the kernel in ``resize_tiled.cuh``)
  and ``resize_wide``, from ``libiqo_tpu_torch/csrc/*.cu`` (:func:`load`);
* the measurement probes of ``libiqo_tpu_torch/experiments``, from
  ``libiqo_tpu_torch/csrc/exp/*.cu`` (:func:`load_experiments`).

Nothing is built when this module is imported, and nothing is built from
outside the repository.  If ``nvcc`` is missing or fails, loading raises with
its output: there is no fallback.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .. import tracing
from ..utils.build_root import build_root

__all__ = ["BuildError", "bind_tiled", "build_dir", "build_library",
           "compile_command", "exp_build_dir", "find_nvcc", "load",
           "load_experiments", "nvcc_command"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
EXP_CSRC = CSRC / "exp"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of this process's build, if it built
build_log: str = ""                  # nvcc's output (ptxas register/smem report)
_exp_lock = threading.Lock()
_exp_lib = None
exp_build_seconds: float | None = None   # the same for the probes' library
exp_build_log: str = ""


class BuildError(RuntimeError):
    """nvcc is missing or refused the kernel sources."""


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def exp_sources() -> list[Path]:
    return sorted(EXP_CSRC.glob("*.cu"))


def _digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return build_root(_PKG) / _digest()


def exp_build_dir() -> Path:
    return build_root(_PKG) / f"exp-{_digest(EXP_CSRC)}"


def find_nvcc() -> str | None:
    """nvcc on PATH, else under $CUDA_HOME or the default toolkit prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def nvcc_command(nvcc: str, out: Path, srcs: list[Path] | None = None) -> list[str]:
    """One ``nvcc -shared`` of ``srcs`` (the resize kernel's by default)."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), *map(str, sources() if srcs is None else srcs)]


def compile_command(nvcc: str, obj: Path, src: Path) -> list[str]:
    """One ``nvcc -c`` of ``src`` into the object ``obj``, for a shared
    library."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]


def _run(cmd: list[str], what: str) -> str:
    """Run one nvcc command; returns its output after a line with its wall
    time (``nvcc <what>: <seconds> s``)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    return f"nvcc {what}: {time.perf_counter() - t0!r} s\n{log}"


def build_library(so: Path, srcs: list[Path]) -> tuple[float, str]:
    """Build ``srcs`` into the shared library ``so``: one ``nvcc -c`` per
    source, all started together, then one link.  Returns the wall time
    and nvcc's output: for each source in the order of ``srcs`` a line
    ``nvcc -c <name>: <seconds> s`` and its ptxas report, then the
    link's."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise BuildError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                         "the CUDA kernels cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build under private names, then rename: a concurrent process never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs = [Path(tmp) / f"{i}-{src.stem}.o" for i, src in enumerate(srcs)]
        with ThreadPoolExecutor(max(1, len(srcs))) as pool:
            logs = list(pool.map(
                lambda job: _run(compile_command(nvcc, *job), f"-c {job[1].name}"),
                zip(objs, srcs)))
        lib = Path(tmp) / so.name
        logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                          *map(str, objs)], "-shared"))
        os.replace(lib, so)
    return time.perf_counter() - t0, "".join(logs)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.iqo_resize_fused.argtypes = [
        i, i, i,                        # wrap16, relaxed, carry: which instantiation
        p, p, i, ll, ll, i, i,          # src, dst, frames, strides, dst shape
        i,                              # tile_rows: output rows a block
        p, p, p, i, i,                  # cy, iy, ydiv, taps_y, y_bias
        p, p, p, i,                     # cx, ix, xdiv, taps_x
        p, p,                           # cxr, cxd (relaxed planes; cxd may be NULL)
        p, i, i,                        # win, win_max, out_shift
        p, p, i, i, i,                  # rwin, iyr, ring_rows, ring_pitch, run (carry)
        p]                              # stream
    lib.iqo_resize_fused.restype = i
    lib.iqo_resize_wide.argtypes = [
        i, i,                           # wrap16, relaxed: which instantiation
        p, p, i, ll, ll, i, i, i, i,    # src, dst, frames, strides, src, dst shape
        p, p, p, i, i,                  # cy, ys, ydiv, taps_y, y_bias
        p, p, p, i, i,                  # cx (or the relaxed planes' bits), xs, xdiv, taps_x, planes
        p, i, i, i, i, i, i,            # win, n_ct, tc, tr, ks, group, wp
        i, p]                           # out_shift, stream
    lib.iqo_resize_wide.restype = i
    lib.iqo_resize_wide_s8.argtypes = [
        i,                              # tw: which instantiation of the s8 form
        p, p, i, ll, ll, i, i, i,       # src, dst, frames, strides, src_w, dst shape
        p, i, p, i,                     # row records, words; column records, words
        i, i, i, i, i, i,               # taps_x, k_rows, pitch, margin, work_pitch, max_phases
        i, i, i,                        # y_bias, out_shift, stages
        p]                              # stream
    lib.iqo_resize_wide_s8.restype = i
    # the executables (csrc/exec.cuh): each create takes its iqo_resize_*
    # entry's arguments but the source, output, frames, strides and stream
    out = ctypes.POINTER(p)
    lib.iqo_resize_fused_exec_create.argtypes = [
        i, i, i, i, i, i, p, p, p, i, i, p, p, p, i, p, p, p, i, i, p, p, i, i, i, out]
    lib.iqo_resize_fused_exec_create.restype = i
    lib.iqo_resize_wide_exec_create.argtypes = [
        i, i, i, i, i, i, p, p, p, i, i, p, p, p, i, i, p, i, i, i, i, i, i, i, out]
    lib.iqo_resize_wide_exec_create.restype = i
    lib.iqo_resize_wide_s8_exec_create.argtypes = [
        i, i, i, i, p, i, p, i, i, i, i, i, i, i, i, i, i, out]
    lib.iqo_resize_wide_s8_exec_create.restype = i
    lib.iqo_exec_launch.argtypes = [p, p, p, i, ll, ll, p]   # exec, src, dst, frames, strides, stream
    lib.iqo_exec_launch.restype = i
    lib.iqo_exec_launch_frame.argtypes = [
        p, p, i,                        # luma, chroma executables, frames
        p, ll, ll, p,                   # y, its strides, oy
        p, ll, ll, p, ll, ll, p,        # u, its strides, v, its strides, ouv
        p]                              # stream
    lib.iqo_exec_launch_frame.restype = i
    lib.iqo_exec_destroy.argtypes = [p]
    lib.iqo_exec_destroy.restype = None
    lib.iqo_wide_set_max_smem.argtypes = [i]
    lib.iqo_wide_set_max_smem.restype = i
    lib.iqo_wide_shape.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.iqo_wide_shape.restype = i
    lib.iqo_wide_s8_shape.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.iqo_wide_s8_shape.restype = i
    lib.iqo_wide_load_bytes.argtypes = [p, i, ll, ll]   # src, frames, strides
    lib.iqo_wide_load_bytes.restype = i
    bind_tiled(lib)
    lib.iqo_set_max_smem.argtypes = [i]
    lib.iqo_set_max_smem.restype = i
    lib.iqo_tile_shape.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.iqo_tile_shape.restype = i
    lib.iqo_error_string.argtypes = [i]
    lib.iqo_error_string.restype = ctypes.c_char_p
    return lib


def bind_tiled(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of the tiled kernel's C entry points
    (``csrc/resize_tiled.cu``)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.iqo_resize_tiled.argtypes = [
        i, i, i, i, i,                  # wrap16, s8y, tw, relaxed, carry: which instantiation
        p, p, i, ll, ll, i, i, i,       # src, dst, frames, strides, src_w, dst shape
        p, i, p, i,                     # row records, words; column records, words
        i, i, i, i, i, i, i,            # taps_y, taps_x, k_rows, pitch, margin,
                                        # work_pitch, max_phases
        i, i,                           # y_bias, out_shift
        i, i, i,                        # planes (relaxed); run, slots (carry)
        i,                              # x_step (the X pass's window form; 0: per tap)
        p]                              # stream
    lib.iqo_resize_tiled.restype = i
    lib.iqo_resize_tiled_exec_create.argtypes = [
        i, i, i, i, i, i, i, i, p, i, p, i, i, i, i, i, i, i, i, i, i, i, i, i, i,
        ctypes.POINTER(p)]              # the same but src, dst, frames, strides, stream
    lib.iqo_resize_tiled_exec_create.restype = i
    lib.iqo_tiled_set_max_smem.argtypes = [i]
    lib.iqo_tiled_set_max_smem.restype = i
    lib.iqo_tiled_shape.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i), i]
    lib.iqo_tiled_shape.restype = i
    lib.iqo_tiled_x_window.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.iqo_tiled_x_window.restype = None
    lib.iqo_tiled_kernel_info.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(i)]
    lib.iqo_tiled_kernel_info.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Thread-safe.  While the
    port records, the first load is a ``port.library`` span and a build
    counts ``library.build``."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is None:
            with tracing.span("port.library"):
                so = build_dir() / "libiqo_tpu_torch.so"
                if not so.exists():
                    tracing.count("library.build")
                    build_seconds, build_log = build_library(so, sources())
                _lib = _bind(ctypes.CDLL(str(so)))
        return _lib


def _exp_signatures() -> tuple:
    """(symbol, argtypes) of every entry point of the probe library; each
    returns an int (a cudaError_t or a code of the entry point's own)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return (
        ("iqo_exp_stream_map", [i, p, p, ll, p]),    # op, src, dst, bytes, stream
        ("iqo_exp_readsum", [p, p, i, i, p]),        # src, dst, h, w, stream
        ("iqo_exp_readsum_warp", [p, p, i, i, p]),   # src, dst, h, w, stream
        # kind, a, b (K-major), out, steps, m, n, k, stream
        ("iqo_exp_mma_steps", [i, p, p, p, i, i, i, i, p]),
        # kind, a, b (K-major), out, steps, m, n, k, persistent blocks, stream
        ("iqo_exp_mma_wgmma", [i, p, p, p, i, i, i, i, i, p]),
        ("iqo_exp_mma_wgmma_setup", []),
        ("iqo_exp_mma_wgmma_shape", [ctypes.POINTER(i)]),
        # ymode, xmode, band, cy, cx0t, cx1t, cx2t, out, tiles, stream
        ("iqo_exp_banded", [i, i, p, p, p, p, p, p, i, p]),
        ("iqo_exp_banded_setup", []),
        ("iqo_exp_banded_shape", [ctypes.POINTER(i)] * 4),
        # ymode, xmode, band, cy, cxt0..2, work, out, tiles, Y blocks,
        # X blocks, stream
        ("iqo_exp_banded_wgmma", [i, i, p, p, p, p, p, p, p, i, i, i, p]),
        ("iqo_exp_banded_wgmma_setup", []),
        ("iqo_exp_banded_wgmma_shape", [ctypes.POINTER(i)]),
        # form, words, src, frame stride, frames, h, w, coef, out,
        # r0..r2, c0..c2, slab, scratch, slab bytes, stream
        ("iqo_exp_band_ydot", [i, i, p, ll, i, i, i, p, p, p, p, p, p, p, p, p, p,
                               ll, p]),
        # variant, P, src, h, w, coef, out, nd, n_ty, stream
        ("iqo_exp_overlap", [i, i, p, i, i, p, p, i, i, p]),
        ("iqo_exp_overlap_setup", []),
        # variant, a, b, out, w, n_t, step, halo, stream
        ("iqo_exp_band_colsum", [i, p, p, p, i, i, i, i, p]),
        # variant, a, b, out, w, n_t, step, halo, vec, cw, run, thread rows, stream
        ("iqo_exp_band_colsum_walk", [i, p, p, p, i, i, i, i, i, i, i, i, p]),
        ("iqo_exp_band_colsum_walk_setup", []),
        ("iqo_exp_band_colsum_walk_shape", [ctypes.POINTER(i)]),
        ("iqo_exp_band_shape", [ctypes.POINTER(i)]),
        # form, words, src, frames, h, w, coef, out, r0..r2, c0..c2, slab,
        # scratch, slab bytes, persistent blocks, stream
        ("iqo_exp_band_ydot_ring", [i, i, p, i, i, i, p, p, p, p, p, p, p, p, p, p, ll,
                                    i, p]),
        # blocked, P, src, h, w, coef, out, nd, n_ty, persistent blocks, stream
        ("iqo_exp_overlap_ring", [i, i, p, i, i, p, p, i, i, i, p]),
        ("iqo_exp_band_ring_setup", []),
        ("iqo_exp_band_ring_shape", [ctypes.POINTER(i)]),
        # variant, w, c0, c1, corr, out, reps, stream
        ("iqo_exp_xscheme", [i, p, p, p, p, p, i, p]),
        # variant, we, wo, wd, cxt, taps (host int[12]), out, reps, stream
        ("iqo_exp_vpu_xpass", [i, p, p, p, p, ctypes.POINTER(i), p, i, p]),
        ("iqo_exp_xpass_setup", []),
        # variant (0 corr_f32, 1 muls_f32), we, wo, taps (host int[12]), out,
        # reps, stream
        ("iqo_exp_vpu_f32_wide", [i, p, p, ctypes.POINTER(i), p, i, p]),
        ("iqo_exp_vpu_f32_shape", [ctypes.POINTER(i)]),
        # w / wd, c / cxt, out, reps, slices, steps per slice, stream
        ("iqo_exp_xscheme_gemm", [p, p, p, i, i, i, p]),
        ("iqo_exp_xscheme_bf16_gemm", [p, p, p, i, i, i, p]),
        ("iqo_exp_xscheme_s16_gemm", [p, p, p, i, i, i, p]),
        ("iqo_exp_vpu_gemm", [p, p, p, i, i, i, p]),
        ("iqo_exp_xpass_gemm_setup", []),
        ("iqo_exp_xpass_gemm_shape", [ctypes.POINTER(i)]),
        # w, ef_k, corr, out, reps, cat, blocks of the walk, stream
        ("iqo_exp_xscheme_s8_gemm", [p, p, p, p, i, i, i, p]),
        ("iqo_exp_xpass_s8_setup", []),
        ("iqo_exp_xpass_s8_shape", [ctypes.POINTER(i)]),
        # mix, P, src, out, n, stream
        ("iqo_exp_op_mix", [i, i, p, p, ll, p]),
        # align, kl, check, w, ct, out, steps, stream
        ("iqo_exp_slice_groups", [i, i, i, p, p, p, i, p]),
        ("iqo_exp_slice_setup", []),
        # align, kl, check, w, ct, out, steps, persistent blocks, stream
        ("iqo_exp_slice_wgmma", [i, i, i, p, p, p, i, i, p]),
        ("iqo_exp_slice_wgmma_setup", []),
        ("iqo_exp_slice_wgmma_shape", [ctypes.POINTER(i)]),
        ("iqo_exp_window_x1", [i, p, p, i, p]),      # form, src, out, planes, stream
        ("iqo_exp_window_x2", [i, p, p, p, p]),      # form, src, out, spill, stream
        ("iqo_exp_window_x3", [p, p, i, p]),         # var, out, steps, stream
        ("iqo_exp_window_x3_cluster", [p, p, p]),    # var, out, stream
        ("iqo_exp_window_setup", []))


def bind_experiments(lib: ctypes.CDLL, names: tuple[str, ...] | None = None) -> ctypes.CDLL:
    """Declare the probe entry points ``names`` (all of them if None) on
    ``lib``, which may be a library built from a part of the probe sources."""
    for name, args in _exp_signatures():
        if names is None or name in names:
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _bind_experiments(lib: ctypes.CDLL) -> ctypes.CDLL:
    bind_experiments(lib)
    lib.iqo_exp_error_string.argtypes = [ctypes.c_int]
    lib.iqo_exp_error_string.restype = ctypes.c_char_p
    return lib


def load_experiments() -> ctypes.CDLL:
    """The probes' kernel library, built on first use.  Thread-safe."""
    global _exp_lib, exp_build_seconds, exp_build_log
    with _exp_lock:
        if _exp_lib is None:
            so = exp_build_dir() / "libiqo_tpu_torch_exp.so"
            if not so.exists():
                exp_build_seconds, exp_build_log = build_library(so, exp_sources())
            _exp_lib = _bind_experiments(ctypes.CDLL(str(so)))
        return _exp_lib
