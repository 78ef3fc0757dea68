"""What the stage ablations (``tiled_ablate``, ``slice_ablate``) share: a
kernel source with text substitutions, its variants built side by side into
libraries of their own, loaded into one process, and timed in turns.

A tool supplies its source, its variants (``{name: [(text, replacement)]}``),
the files a variant's build needs beside the source, a loader and a launch.
"""

from __future__ import annotations

import ctypes
import hashlib
from collections.abc import Callable, Mapping, Sequence
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..experiments import _harness
from ..ops import _build

__all__ = ["build_variants", "load_variants", "names_of", "require_card", "time_in_turns",
           "variant_source"]

Variants = Mapping[str, Sequence[tuple[str, str]]]


def variant_source(variants: Variants, source: Path, name: str, text: str | None = None,
                   counts: Mapping[str, int] | None = None) -> str:
    """``source``'s text (or ``text``) with variant ``name``'s substitutions;
    raises ValueError if one of its texts is not in the source as often as
    ``counts`` says (once by default)."""
    text = source.read_text() if text is None else text
    for old, new in variants[name]:
        if text.count(old) != (counts or {}).get(old, 1):
            raise ValueError(f"variant {name}: {old!r} is not in the kernel source "
                             "where expected")
        text = text.replace(old, new)
    return text


def names_of(asked: Sequence[str], variants: Variants) -> list[str]:
    """The variants to build: ``kernel`` first, then those asked for (all of
    them if none); raises SystemExit on an unknown name."""
    names = ["kernel", *(v for v in (asked or variants) if v != "kernel")]
    unknown = sorted(set(names) - set(variants))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; choose from {sorted(variants)}")
    return names


def require_card(tool: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} needs a CUDA device")


def build_variants(tag: str, names: Sequence[str], source: Path,
                   make: Callable[[str], str], beside: Sequence[Path],
                   units: Sequence[str]) -> dict[str, tuple[Path, list[int]]]:
    """Build each variant into ``build/libiqo_tpu_torch/<tag>-<hash>/<name>/``,
    all at once: ``make(name)`` written as ``source``'s file, beside copies of
    ``beside``, and the translation units ``units`` (file names in that
    directory) linked into ``<name>.so``.  Returns each variant's library and
    the registers ptxas reports for its kernels."""
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in (source, *beside))
                            ).hexdigest()[:16]
    out = _build.build_dir().parent / f"{tag}-{digest}"

    def build(name: str) -> tuple[str, Path, list[int]]:
        where = out / name
        where.mkdir(parents=True, exist_ok=True)
        for f in beside:
            (where / f.name).write_text(f.read_text())
        (where / source.name).write_text(make(name))
        so = where / f"{name}.so"
        _, log = _build.build_library(so, [where / u for u in units])
        regs = [int(line.split("Used ")[1].split()[0])
                for line in log.splitlines() if "Used " in line]
        return name, so, regs

    with ThreadPoolExecutor(len(names)) as pool:
        return {name: (so, regs) for name, so, regs in pool.map(build, names)}


def load_variants(built: Mapping[str, tuple[Path, list[int]]],
                  load: Callable[[str, ctypes.CDLL], ctypes.CDLL]) -> dict[str, ctypes.CDLL]:
    """Load every variant's library on card 0, after torch has made the
    context they join; ``load(name, lib)`` binds it and raises its limits.
    Prints each variant's registers."""
    torch.zeros(1, device="cuda")
    with torch.cuda.device(0):
        libs = {name: load(name, ctypes.CDLL(str(so))) for name, (so, _) in built.items()}
    for name, (_, regs) in built.items():
        print(f"{name}: registers of its kernels {regs}")
    return libs


def time_in_turns(calls: Mapping[str, Callable[[torch.Tensor], object]],
                  inputs: list[torch.Tensor]) -> dict[str, float]:
    """Device ms a call of each of ``calls`` (``_harness.launches_ms`` over
    back-to-back calls, one per input), each timed twice, in order and then
    reversed; the min of its two."""
    return _harness.turns_ms({n: (f, inputs) for n, f in calls.items()})
