"""The port's own host layer (libiqo_tpu_torch.core, .coeffs, .native,
.golden) against the JAX package's, and the rule that the port imports
nothing of the JAX package.

* ``build_plan`` gives the JAX package's plan, field for field, on a seeded
  fuzz set of Lanczos (degree 1-9, px_scale 1-4), Area and Linear
  geometries, ``reference_oob`` cases included;
* the native C++ tables equal the pure-Python engine;
* ``plan_from_arrays`` carries a JAX plan over unchanged, and a resizer
  built from it gives the oracle's bytes;
* no module of ``libiqo_tpu_torch`` and not ``chip_smoke.py`` imports
  ``libiqo_tpu`` or ``jax``.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from libiqo_tpu.core import plan as jax_plan
from libiqo_tpu.golden import numpy_ref as jax_numpy_ref
from libiqo_tpu_torch import api
from libiqo_tpu_torch.coeffs import engine, native
from libiqo_tpu_torch.core import plan as port_plan
from libiqo_tpu_torch.golden import numpy_ref

ROOT = Path(__file__).resolve().parents[1]


def _fuzz_cases(n=30, seed=20261016):
    """(algorithm, kwargs, src_w, src_h, dst_w, dst_h), up and down, odd
    sizes, identity axes."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(n):
        algo = ("lanczos", "area", "linear")[i % 3]
        kw = (dict(degree=1 + (i // 3) % 9, px_scale=1 + (i // 2) % 4)
              if algo == "lanczos" else {})
        src = rng.integers(2, 500, 2)
        if i % 4 == 0:
            dst = src * rng.integers(2, 5, 2) + rng.integers(0, 9, 2)
        elif i % 4 == 1:
            dst = np.maximum(1, src // rng.integers(2, 9, 2))
        elif i % 4 == 2:
            dst = np.maximum(1, src + rng.integers(-40, 40, 2))
        else:
            dst = np.array([src[0], max(1, src[1] // 3)])   # identity X
        cases.append((algo, kw, *map(int, src), *map(int, dst)))
    cases += [
        ("linear", {}, 16, 12, 80, 60),          # reference_oob (> 3x up)
        ("linear", {}, 5, 3, 300, 200),
        ("linear", {}, 300, 200, 1, 1),          # one output per axis
        ("area", {}, 300, 200, 7, 5),            # 40/44 taps
        ("lanczos", dict(degree=3), 300, 40, 150, 3),   # stale-iterator rows
        ("lanczos", dict(degree=3, px_scale=2), 1920, 1080, 960, 540),
    ]
    return cases


CASES = _fuzz_cases()


def _ids(c):
    kw = "".join(f"-{k}{v}" for k, v in c[1].items())
    return f"{c[0]}{kw}-{c[2]}x{c[3]}-{c[4]}x{c[5]}"


def _assert_plans_equal(got, want):
    assert type(got) is port_plan.ResizePlan
    for f in dataclasses.fields(want):
        if f.name in ("y", "x"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for name in ("y", "x"):
        g, w = getattr(got, name), getattr(want, name)
        assert type(g) is port_plan.AxisPlan
        for f in dataclasses.fields(w):
            gv, wv = getattr(g, f.name), getattr(w, f.name)
            if isinstance(wv, np.ndarray):
                assert gv.dtype == wv.dtype, f"{name}.{f.name}"
                np.testing.assert_array_equal(gv, wv, err_msg=f"{name}.{f.name}")
            else:
                assert gv == wv, f"{name}.{f.name}"


def test_fuzz_set_covers_the_algorithms():
    plans = [jax_plan.build_plan(a, *g, **kw) for a, kw, *g in CASES]
    assert {p.algorithm for p in plans} == {"lanczos", "area", "linear"}
    assert {p.degree for p in plans if p.algorithm == "lanczos"} >= set(range(1, 10))
    assert {p.px_scale for p in plans} >= {1, 2, 3, 4}
    assert any(p.y.reference_oob or p.x.reference_oob for p in plans)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_build_plan_equals_jax(case):
    algo, kw, *geometry = case
    _assert_plans_equal(port_plan.build_plan(algo, *geometry, **kw),
                        jax_plan.build_plan(algo, *geometry, **kw))


def test_build_plan_rejects_what_jax_rejects():
    for args, kw in ((("lanczos", 0, 4, 2, 2), {}),
                     (("lanczos", 4, 4, 2, 2), dict(degree=0)),
                     (("lanczos", 4, 4, 2, 2), dict(px_scale=0)),
                     (("cubic", 4, 4, 2, 2), {})):
        with pytest.raises(ValueError):
            jax_plan.build_plan(*args, **kw)
        with pytest.raises(ValueError):
            port_plan.build_plan(*args, **kw)


@pytest.mark.parametrize("kind,args", [
    # lanczos: degree, r_src, r_dst, px_scale, bias; area: r_src, r_dst,
    # bias; linear: r_src, r_dst, bias (reduced lengths, as build_plan
    # passes them)
    ("lanczos", (3, 2, 1, 1, 64)),
    ("lanczos", (3, 1, 2, 2, 64)),
    ("lanczos", (5, 7, 3, 4, 16384)),
    ("lanczos", (9, 3, 5, 1, 16384)),
    ("area", (3, 1, 256)),
    ("area", (60, 1, 32768)),
    ("area", (7, 5, 256)),
    ("linear", (1, 2, 256)),
    ("linear", (97, 40, 32768)),
], ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v)))
def test_native_tables_equal_engine(kind, args):
    assert native.available()
    assert native._build_dir().parent == ROOT / "build" / "libiqo_tpu_torch"
    if kind == "lanczos":
        degree, r_src, r_dst, px, bias = args
        n = engine.calc_num_coefs_lanczos(degree, r_src, r_dst, px)
        want = np.stack([engine.adjust_coefs(
            *engine.set_lanczos_table(degree, r_src, r_dst, d, px, n), bias)
            for d in range(r_dst)])
        got = native.lanczos_tables(degree, r_src, r_dst, px, n, bias)
    elif kind == "area":
        r_src, r_dst, bias = args
        n = engine.calc_num_coefs_area(r_src, r_dst)
        want = np.stack([engine.adjust_coefs(
            *engine.set_area_table(r_src, r_dst, d, n), bias, signed=False)
            for d in range(r_dst)])
        got = native.area_tables(r_src, r_dst, n, bias)
    else:
        r_src, r_dst, bias = args
        want = engine.adjust_coefs_linear(engine.set_linear_table(r_src, r_dst), bias)
        got = native.linear_tables(r_src, r_dst, bias)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES[:6] + CASES[-6:-1], ids=_ids)
def test_plan_from_arrays_carries_a_jax_plan(case):
    algo, kw, *geometry = case
    jplan = jax_plan.build_plan(algo, *geometry, **kw)
    got = port_plan.plan_from_arrays(jplan)
    _assert_plans_equal(got, port_plan.build_plan(algo, *geometry, **kw))
    assert got.y.coef is not jplan.y.coef          # copied, not shared
    assert not np.shares_memory(got.x.start, jplan.x.start)

    sw, sh = geometry[:2]
    src = np.random.default_rng(sw + sh).integers(0, 256, (sh, sw), np.uint8)
    r = api.Resizer.from_plan(jplan, device="cpu")
    assert type(r.plan) is port_plan.ResizePlan
    want = jax_numpy_ref.resize_u8(jplan, src)
    np.testing.assert_array_equal(r.resize(src), want)
    np.testing.assert_array_equal(numpy_ref.resize_u8(got, src), want)
    port = port_plan.build_plan(algo, *geometry, **kw)
    assert api.Resizer.from_plan(port, device="cpu").plan is port


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_nothing_of_the_jax_package():
    files = sorted((ROOT / "libiqo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [(str(f.relative_to(ROOT)), m) for f in files
                 for m in _imported_modules(f)
                 if m.split(".")[0] in ("libiqo_tpu", "jax", "jaxlib")]
    assert offenders == []
