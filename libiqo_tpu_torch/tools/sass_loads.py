"""How deep each kernel of the probe library queues its global loads: for every
``LDG`` into a register in a kernel's SASS, how many further such loads issue
before its destination register is first read (``LDGSTS``, the copies of
``cp.async``, write shared memory and are not counted).  A run of
``[7, 6, ..., 0]`` is 8 loads in flight per thread; ``[1, 0, 1, 0]`` is 2.

Reads the probe library (``ops/_build.load_experiments()``, built first if
needed) with the CUDA toolkit's ``cuobjdump -sass``.  Run where the toolkit
is, from the repository root::

    python3 -m libiqo_tpu_torch.tools.sass_loads [name ...]

Each ``name`` is a substring of the kernels' mangled names (default: the
band-fetch kernels ``band_ydot_kernel``, ``overlap_kernel``,
``band_colsum_kernel``).
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

from ..ops import _build

__all__ = ["instruction_counts", "load_depths", "main"]

_PRED = re.compile(r"^@!?U?P\w+\s+")
_INSN = re.compile(r"/\*[0-9a-f]{4}\*/\s+(.*?);")
# a global load into a register; LDGSTS (cp.async) writes shared memory instead
_LOAD = re.compile(r"LDG(?!STS)\S*\s+(R\d+)")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")


def load_depths(sass: str) -> list[int]:
    """For each global load in ``sass`` (one function's listing), the number
    of global loads that issue after it before its destination register is
    first read as a source."""
    ins = [_PRED.sub("", m.group(1).strip()) for m in _INSN.finditer(sass)]
    depths = []
    for i, t in enumerate(ins):
        m = _LOAD.match(t)
        if m is None:
            continue
        dst = m.group(1)
        n = 0
        for t2 in ins[i + 1:]:
            op, _, operands = t2.partition(" ")
            # a store reads all its operands; anything else writes the first
            sources = operands if op.startswith(("ST", "RED", "ATOM")) else \
                operands.partition(",")[2]
            if re.search(rf"\b{dst}\b", sources):
                break
            n += _LOAD.match(t2) is not None
        depths.append(n)
    return depths


def _cuobjdump() -> str:
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("no CUDA toolkit: cuobjdump is not found")
    return str(Path(nvcc).with_name("cuobjdump"))


def _listings(names: list[str]) -> dict[str, str]:
    """The SASS of every probe-library kernel whose mangled name contains one
    of ``names``, from one ``cuobjdump -sass`` of the library."""
    _build.load_experiments()
    so = str(_build.exp_build_dir() / "libiqo_tpu_torch_exp.so")
    sass = subprocess.run([_cuobjdump(), "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    found, name = {}, None
    for line in sass.splitlines(keepends=True):
        if m := _FUNCTION.match(line):
            name = m.group(1) if any(n in m.group(1) for n in names) else None
            if name:
                found[name] = ""
        elif name:
            found[name] += line
    return found


def instruction_counts(names: list[str]) -> dict[str, int]:
    """SASS instructions (NOPs not counted) of each kernel whose mangled name
    contains one of ``names``; raises without ``cuobjdump``."""
    return {sym: sum(1 for m in _INSN.finditer(sass)
                     if not _PRED.sub("", m.group(1).strip()).startswith("NOP"))
            for sym, sass in _listings(names).items()}


def main(argv: list[str] | None = None) -> dict:
    names = (argv if argv is not None else sys.argv[1:]) or [
        "band_ydot_kernel", "overlap_kernel", "band_colsum_kernel"]
    found = {}
    for sym, sass in _listings(names).items():
        found[sym] = load_depths(sass)
        print(f"{sym}: {len(found[sym])} LDG; loads issued after each before its "
              f"first use: {found[sym]}", flush=True)
    return found


if __name__ == "__main__":
    main()
