"""The port's packaging gate: the wheel builds offline, ships the kernels'
sources, installs, and its console entry points serve on the CPU and on
the card, building the kernels with nvcc from the installed sources.  The
port of ``scripts/check_wheel.py``.

    python -m libiqo_tpu_torch.tools.check_wheel [--out FILE]

Steps, each recorded in the result:

1. ``pip wheel --no-deps --no-build-isolation --no-index`` of a copy of
   the repository's packaged files, :data:`PACKAGED` (offline: the build
   backend, ``setuptools``, must come from
   the running interpreter's site-packages; where it is missing the result
   says so with ``ok: false``).
2. The wheel must ship every kernel source, :func:`required_sources`
   (``libiqo_tpu_torch/csrc/**/*.cu`` and ``*.cuh``, and
   ``native/iqo_tables.cpp``).
3. A scratch venv that sees the running interpreter's site-packages
   (``--system-site-packages`` and a ``.pth`` of its own site directories,
   for torch and numpy); the wheel installed with ``--no-deps --no-index``
   (it declares ``jax``, which the port does not need).
4. From a working directory outside the repository, with
   ``$LIBIQO_TPU_CACHE`` set to a scratch directory: the package must import
   from the venv, not from the checkout; ``iqo-tpu-torch-resize-yuv420p``
   on a generated YUV420 file with ``--device cpu``, and on the card (the
   CLI's default), each output == ``numpy_ref`` byte for byte; on the card
   first the CLI's ``main`` inside the venv's interpreter, which must build
   the kernel library with nvcc from the installed sources into
   ``$LIBIQO_TPU_CACHE`` and count a launch of the kernel, then the console
   script.
5. ``iqo-tpu-torch-benchmark`` for a short run on the card.

Writes ``libiqo_tpu_torch/tools/check_wheel_result.json`` (``--out``) with
the card's name and power limit, and exits 1 on any failure.  Without a
card it still runs steps 1-3 and the CPU half of step 4, records ``card:
null`` and ``ok: false``, and exits 2.  Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import zipfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "libiqo_tpu_torch"
RESULT = Path(__file__).with_name("check_wheel_result.json")
PACKAGED = ("pyproject.toml", "README.md", "libiqo_tpu", "libiqo_tpu_torch")
GEOMETRY = (320, 240, 160, 120)        # the JAX check's YUV420 file
FRAMES = 2
SEED = 7
# run inside the venv on the card: the CLI's main, then what it built and launched
_PROBE = """
import json, sys
from libiqo_tpu_torch.cli import resize_yuv420p
from libiqo_tpu_torch.ops import _build, cuda_resize
rc = resize_yuv420p.main(sys.argv[1:])
lib = _build.build_dir() / "libiqo_tpu_torch.so"
print(json.dumps({"rc": rc, "build_dir": str(_build.build_dir()),
                  "built_here_s": _build.build_seconds, "library": lib.is_file(),
                  "launches": {v: n for v, n in cuda_resize.LAUNCHES_BY_VARIANT.items() if n},
                  "package": str(cuda_resize.__file__)}))
"""


def required_sources(pkg: Path = PKG) -> list[str]:
    """The files the installed package builds from, as wheel paths: every
    ``csrc/**/*.cu`` and ``*.cuh`` and ``native/iqo_tables.cpp``."""
    found = [p for p in pkg.glob("csrc/**/*") if p.suffix in (".cu", ".cuh")]
    found.append(pkg / "native" / "iqo_tables.cpp")
    return sorted(str(p.relative_to(pkg.parent).as_posix()) for p in found)


def run(cmd, **kw) -> subprocess.CompletedProcess:
    print("+", " ".join(str(c) for c in cmd), flush=True)
    return subprocess.run([str(c) for c in cmd], check=True, capture_output=True,
                          text=True, **kw)


def _yuv_file(path: Path):
    """A seeded YUV420 file of FRAMES frames at GEOMETRY's source size, and
    ``numpy_ref``'s Lanczos3 output of it, as bytes."""
    from ..core.plan import build_plan
    from ..golden import numpy_ref

    sw, sh, dw, dh = GEOMETRY
    rng = np.random.default_rng(SEED)
    luma = build_plan("lanczos", sw, sh, dw, dh, degree=3)
    chroma = build_plan("lanczos", sw // 2, sh // 2, dw // 2, dh // 2, degree=3,
                        px_scale=2)
    src, want = [], []
    for _ in range(FRAMES):
        y = rng.integers(0, 256, (sh, sw), np.uint8)
        u, v = (rng.integers(0, 256, (sh // 2, sw // 2), np.uint8) for _ in range(2))
        src += [y, u, v]
        want += [numpy_ref.resize_u8(luma, y), numpy_ref.resize_u8(chroma, u),
                 numpy_ref.resize_u8(chroma, v)]
    path.write_bytes(b"".join(p.tobytes() for p in src))
    return b"".join(p.tobytes() for p in want)


def _in_work(path: str, work: Path) -> str:
    """``path`` with the scratch directory written as ``<work>``."""
    return "<work>/" + Path(path).relative_to(work).as_posix()


def _card() -> str | None:
    import torch

    if not torch.cuda.is_available():
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def check(results: dict, work: Path) -> bool:
    """Steps 1-5 into ``results``; True when every step ran and passed."""
    # 1. the wheel, offline
    try:
        import setuptools
        results["setuptools"] = setuptools.__version__
    except ImportError:
        results["setuptools"] = None
        results["error"] = ("setuptools is not installed: the wheel cannot be built "
                            "offline (pip wheel --no-build-isolation needs it)")
        return False
    # from a copy of what the wheel is made of, so that no build tree of the
    # checkout (setuptools' build/lib, a stale module in it) enters the wheel
    src = work / "src"
    src.mkdir()
    for name in PACKAGED:
        if (REPO / name).is_dir():
            shutil.copytree(REPO / name, src / name,
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(REPO / name, src / name)
    wheelhouse = work / "wheelhouse"
    run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "-w", wheelhouse, src])
    wheels = list(wheelhouse.glob("libiqo_tpu-*.whl"))
    assert len(wheels) == 1, f"expected one wheel, got {wheels}"
    results["wheel"] = wheels[0].name

    # 2. the kernels' sources inside
    names = set(zipfile.ZipFile(wheels[0]).namelist())
    missing = [s for s in required_sources() if s not in names]
    assert not missing, f"sources missing from the wheel: {missing}"
    results["sources_in_wheel"] = len(required_sources())

    # 3. a scratch venv that sees this interpreter's packages
    venv = work / "venv"
    run([sys.executable, "-m", "venv", "--system-site-packages", venv])
    vpy = venv / "bin" / "python"
    vsite = run([vpy, "-c", "import sysconfig; print(sysconfig.get_paths()['purelib'])"]
                ).stdout.strip()
    site = {sysconfig.get_paths()[k] for k in ("purelib", "platlib")}
    (Path(vsite) / "_host_site.pth").write_text("\n".join(sorted(site)) + "\n")
    run([vpy, "-m", "pip", "install", "--no-deps", "--no-index", wheels[0]])
    results["installed"] = True

    # 4. the entry points, from outside the checkout
    cache = work / "cache"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["LIBIQO_TPU_CACHE"] = str(cache)
    loc = run([vpy, "-c", "import libiqo_tpu_torch, os; "
               "print(os.path.dirname(libiqo_tpu_torch.__file__))"],
              env=env, cwd=work).stdout.strip()
    assert not Path(loc).is_relative_to(REPO), f"imported from the checkout: {loc}"
    results["import_path"] = _in_work(loc, work)
    want = _yuv_file(work / "in.yuv")
    sw, sh, dw, dh = GEOMETRY
    cli = [venv / "bin" / "iqo-tpu-torch-resize-yuv420p", "-m", "lanczos3",
           "-i", work / "in.yuv", "-iw", sw, "-ih", sh, "-ow", dw, "-oh", dh]
    run([*cli, "-o", work / "cpu.yuv", "--device", "cpu"], env=env, cwd=work)
    assert (work / "cpu.yuv").read_bytes() == want, "CLI on the CPU != numpy_ref"
    results["resize_cli_cpu_byte_exact"] = True
    if results["card"] is None:
        results["error"] = "no CUDA device: the card's half did not run"
        return False

    probe = json.loads(run([vpy, "-c", _PROBE, *map(str, cli[1:]), "-o", work / "probe.yuv"],
                           env=env, cwd=work).stdout.strip().splitlines()[-1])
    results["card_build"] = {**probe, "build_dir": _in_work(probe["build_dir"], work),
                             "package": _in_work(probe["package"], work)}
    assert probe["rc"] == 0 and probe["library"], f"the venv's CLI: {probe}"
    assert probe["built_here_s"] is not None, f"nvcc did not build the kernels: {probe}"
    assert Path(probe["build_dir"]).is_relative_to(cache), \
        f"built outside $LIBIQO_TPU_CACHE: {probe['build_dir']}"
    assert Path(probe["package"]).is_relative_to(loc), f"ran {probe['package']}"
    assert sum(probe["launches"].values()) > 0, f"no kernel launched: {probe}"
    assert (work / "probe.yuv").read_bytes() == want, "the venv's CLI != numpy_ref"
    results["kernels_built_from_wheel"] = True
    run([*cli, "-o", work / "card.yuv"], env=env, cwd=work)
    assert (work / "card.yuv").read_bytes() == want, "CLI on the card != numpy_ref"
    results["resize_cli_card_byte_exact"] = True

    # 5. the benchmark entry point, briefly
    out = run([venv / "bin" / "iqo-tpu-torch-benchmark", "-m", "linear", "-iw", 64,
               "-ih", 48, "-ow", 32, "-oh", 24, "--cycles", 3], env=env, cwd=work).stdout
    assert "elapsed time:" in out and "backend: cuda" in out, \
        f"benchmark entry point output: {out!r}"
    results["benchmark_cli_runs"] = True
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=RESULT)
    args = ap.parse_args(argv)
    card = _card()
    results = {"card": card}
    work = Path(tempfile.mkdtemp(prefix="iqo_torch_wheel_"))
    try:
        results["ok"] = check(results, work)
    except (AssertionError, subprocess.CalledProcessError) as e:
        if isinstance(e, subprocess.CalledProcessError):
            print(e.stdout, e.stderr, file=sys.stderr)
            results["stderr"] = (e.stderr or "")[-2000:]
        results["ok"] = False
        results["error"] = str(e)
    finally:
        args.out.write_text(json.dumps(results, indent=1) + "\n")
        print(json.dumps(results, indent=1))
        shutil.rmtree(work, ignore_errors=True)
    if card is None:
        return 2
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
