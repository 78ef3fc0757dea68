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
``band_colsum_kernel``).  :func:`loop_counts` counts chosen opcodes inside
each loop of a kernel (a branch back to an earlier address), as
``tools/vpu_f32_ablate.py`` does for the conversions of kernel J's float32
forms.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

from ..ops import _build

__all__ = ["instruction_counts", "load_depths", "loop_counts", "loops", "main"]

_PRED = re.compile(r"^@!?U?P\w+\s+")
_INSN = re.compile(r"/\*[0-9a-f]{4}\*/\s+(.*?);")
# a global load into a register; LDGSTS (cp.async) writes shared memory instead
_LOAD = re.compile(r"LDG(?!STS)\S*\s+(R\d+)")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
# an instruction with its address, and a label line (in listings that name
# branch targets by label rather than by address)
_ADDR_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"BRA(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


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


def _instructions(sass: str) -> tuple[list[tuple[int, str]], dict[str, int]]:
    """(address, instruction without its predicate) of every instruction of
    one function's listing, and the address of each label."""
    insns, labels, pending = [], {}, []
    for line in sass.splitlines():
        if m := _LABEL.match(line):
            pending.append(m.group(1))
        elif m := _ADDR_INSN.search(line):
            addr = int(m.group(1), 16)
            labels.update(dict.fromkeys(pending, addr))
            pending = []
            insns.append((addr, _PRED.sub("", m.group(2).strip())))
    return insns, labels


def loops(sass: str) -> list[tuple[int, int]]:
    """(first, last) address of every loop of one function's listing: each
    branch to an earlier address (not the self-branch that closes a listing)."""
    insns, labels = _instructions(sass)
    found = []
    for addr, text in insns:
        if m := _BRA.match(text):
            target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            if target is not None and target < addr:
                found.append((target, addr))
    return found


def _loop_counts(sass: str, opcodes: tuple[str, ...]) -> list[dict[str, int]]:
    insns, _ = _instructions(sass)
    counts = []
    for first, last in loops(sass):
        body = [t.split()[0].split(".")[0] for a, t in insns if first <= a <= last]
        counts.append({"instructions": len(body), **{op: body.count(op) for op in opcodes}})
    return counts


def loop_counts(names: list[str], opcodes: tuple[str, ...]) -> dict[str, list[dict[str, int]]]:
    """For each kernel whose mangled name contains one of ``names``, one
    entry a loop: its instructions and how many of each opcode in
    ``opcodes`` (matched without their suffixes: ``I2F`` counts
    ``I2F.S64``).  Raises without ``cuobjdump``."""
    return {sym: _loop_counts(sass, opcodes) for sym, sass in _listings(names).items()}


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
