"""``BENCHMARK.json`` and the files its names lead to.

A cell ``<config>.<traffic>`` resolves its configuration through the
``configs`` entry's ``file``, its traffic mix as ``traffic/<traffic>.json``,
the loop that drives it as ``loops/<loop>.py`` (the traffic's ``loop``), the
reference as ``reference/<reference>.py`` (the configuration's
``reference``) and each metric as ``metrics/<metric>.py``, whose
``read(window)`` gives its value or None.  Adding a cell adds files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    return json.loads((ROOT / _named(bench["configs"], name, "config")["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path.relative_to(ROOT)}")
    module_name = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if module_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(module_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[module_name]


def loop(name: str):
    return _module("loops", name)


def reference(name: str):
    return _module("reference", name)


def reader(metric: str):
    """The ``read(window)`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those with no list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
