"""The host side of the port's on-card byte gate
(``libiqo_tpu_torch/tools/card_check.py``) and of the wide-window plans.

The gate's case lists are the JAX package's own (``scripts/tpu_check.py``,
``scripts/stress_geometries.py``); on every case of every list the port's
kernels take what the JAX package's kernel takes; Area 8192x4 -> 16x4 and
the other plans whose scope the wide-window walk opened are modelled as
``resize_wide.cu`` computes them (``test_torch_wide_kernel.route_model``)
and as ``resize_fused.cu``'s walk does (:func:`walk_model`, the
``wide=False`` form kept for the timing turns), against ``numpy_ref``; and
the committed result, where present, shows a passing run on an H100 with
every required case on a kernel.
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.ops import pallas_resize
from libiqo_tpu_torch.coeffs.engine import trunc_div
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize
from libiqo_tpu_torch.tools import card_check

from test_torch_wide_kernel import route_model

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"


def _tpu_check():
    spec = importlib.util.spec_from_file_location("tpu_check", SCRIPTS / "tpu_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # its top level imports only NumPy
    return mod


def _literal(node):
    """ast.literal_eval of a node whose ``dict(k=v)`` calls are first turned
    into dict displays."""
    class Dicts(ast.NodeTransformer):
        def visit_Call(self, call):
            self.generic_visit(call)
            if getattr(call.func, "id", None) == "dict" and not call.args:
                return ast.Dict(keys=[ast.Constant(k.arg) for k in call.keywords],
                                values=[k.value for k in call.keywords])
            return call
    return ast.literal_eval(Dicts().visit(node))


def _assigned(path: Path, name: str, inside: str | None = None):
    """The value assigned to ``name`` in a script (in function ``inside``),
    read with ast: importing stress_geometries.py runs it."""
    tree = ast.parse(path.read_text())
    if inside is not None:
        tree = next(n for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef) and n.name == inside)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return node.value
    raise KeyError(name)


def test_lists_equal_the_jax_scripts():
    tc = _tpu_check()
    assert card_check.GRADED == tc.GRADED
    assert card_check.STRESS == tc.STRESS
    assert card_check.fuzz_cases(20) == tc.fuzz_cases(20)
    assert card_check.fuzz_cases(*card_check.CARRY_FUZZ) == tc.fuzz_cases(6, seed=20260819)
    assert card_check.fuzz_cases(*card_check.RELAXED_FUZZ) == tc.fuzz_cases(8, seed=20260818)
    assert card_check.STRESS_GEOMETRIES == _literal(
        _assigned(SCRIPTS / "stress_geometries.py", "CASES"))
    # carry_sweep: cases = GRADED + [two more] + fuzz_cases(...)
    carry = _assigned(SCRIPTS / "tpu_check.py", "cases", "carry_sweep")
    assert card_check.CARRY_CASES == tc.GRADED + _literal(carry.left.right)
    assert card_check.RELAXED_PX2 == _literal(
        _assigned(SCRIPTS / "tpu_check.py", "px2", "relaxed_sweep"))
    assert card_check.SHARDED_CASES == _literal(
        _assigned(SCRIPTS / "tpu_check.py", "cases", "sharded_sweep"))
    assert card_check.RELAXED_RESIDUAL == tc.GRADED[3]


def _gate_lists():
    return {"GRADED": card_check.GRADED, "STRESS": card_check.STRESS,
            "STRESS_GEOMETRIES": card_check.STRESS_GEOMETRIES,
            "fuzz": card_check.fuzz_cases(20),
            "carry": card_check.CARRY_CASES + card_check.fuzz_cases(*card_check.CARRY_FUZZ),
            "relaxed": card_check.RELAXED_PX2 + card_check.fuzz_cases(*card_check.RELAXED_FUZZ),
            "sharded": [c for c, _, _ in card_check.SHARDED_CASES],
            "border_div": card_check.border_cases()}


@pytest.mark.parametrize("name", sorted(_gate_lists()))
def test_jax_kernel_scope_implies_the_ports(name):
    """JAX ``pallas_resize.supports_plan`` => the port's ``supports_plan``
    on every case: the JAX package's answer is needed only where the port
    refuses (its build is seconds on an 8K plan), and every required case
    (GRADED, STRESS, STRESS_GEOMETRIES, border_div) the port takes."""
    required = name in ("GRADED", "STRESS", "STRESS_GEOMETRIES", "border_div")
    for case in _gate_lists()[name]:
        alg, sw, sh, dw, dh, kw = case
        if cuda_resize.supports_plan(build_plan(alg, sw, sh, dw, dh, **kw)):
            continue
        assert not required, case
        assert not pallas_resize.supports_plan(jax_build_plan(alg, sw, sh, dw, dh, **kw)), case


WIDE = ("area", 8192, 4, 16, 4, {})


def test_area_8192x4_to_16x4_is_pinned():
    """STRESS's 512-tap row: the JAX package's kernel takes it, and so does
    the port's, on the wide-window kernel (the windowed kernel's 16-row
    tile does not fit; its walk of fewer rows stays for the timing turns),
    exact only."""
    assert card_check.STRESS[8] == WIDE
    plan = build_plan(*WIDE[:5])
    assert pallas_resize.supports_plan(jax_build_plan(*WIDE[:5]))
    assert cuda_resize.smem_bytes(plan) > cuda_resize.SMEM_BUDGET
    assert cuda_resize.supports_plan(plan)
    assert cuda_resize.MIN_WORK_ROWS <= cuda_resize.work_rows(plan) < cuda_resize.TILE_ROWS
    assert not cuda_resize.tiled_ok(plan)
    assert not cuda_resize.supports_plan(plan, relaxed=True)
    k = cuda_resize.kernel_tables(plan)
    assert isinstance(k, cuda_resize.WideTables) and cuda_resize.variant(k) == "u16_wide"
    assert k.layout.smem <= cuda_resize.SMEM_BUDGET
    walk = cuda_resize.kernel_tables(plan, wide=False)
    assert not walk.tiled and walk.rows == cuda_resize.work_rows(plan)
    assert walk.rows * walk.win_max * 4 <= cuda_resize.SMEM_BUDGET


def _wrap16(v):
    low = np.asarray(v).astype(np.int64) & 0xFFFF
    return (low - ((low & 0x8000) << 1)).astype(np.int32)


def walk_model(plan, k: cuda_resize.KernelTables, src):
    """What ``resize_fused.cu``'s exact instantiations compute, block by
    block: a block of ``k.rows`` output rows and one column tile runs the Y
    pass of its rows over its column window into a ``k.rows`` x window work
    tile (which must fit shared memory), then each output's X taps in order;
    uint32 sums, the wrap16 instantiation's int16 narrowing, truncating
    divides and arithmetic shift, the u16 one's unsigned shift."""
    cy, iy, ydiv, cx, ix, xdiv, win = (t.numpy() for t in (
        k.cy, k.iy, k.ydiv, k.cx, k.ix, k.xdiv, k.win))
    assert not k.relaxed and not k.carry
    assert 1 <= k.rows and k.rows * k.win_max * 4 <= cuda_resize.SMEM_BUDGET
    dst_h, dst_w = plan.y.n_dst, plan.x.n_dst
    half = np.uint32(1 << (plan.out_shift - 1))
    out = np.empty((dst_h, dst_w), np.uint8)
    for r0 in range(0, dst_h, k.rows):
        rows = slice(r0, min(dst_h, r0 + k.rows))
        for tile, (lo, hi) in enumerate(win):
            acc = np.zeros((rows.stop - r0, hi - lo), np.uint32)
            for c, i in zip(cy[:, rows], iy[:, rows]):
                acc += c.astype(np.uint32)[:, None] * src[i, lo:hi].astype(np.uint32)
            if k.wrap16:
                work = _wrap16(acc)
                b = ydiv[rows] != 0
                work[b] = _wrap16(trunc_div(work[b].astype(np.int64) * plan.y.bias,
                                            ydiv[rows][b, None].astype(np.int64)))
            else:
                work = acc.astype(np.int32)
            cols = slice(tile * cuda_resize.TILE_COLS,
                         min(dst_w, (tile + 1) * cuda_resize.TILE_COLS))
            sums = np.zeros((rows.stop - r0, cols.stop - cols.start), np.uint32)
            for c, i in zip(cx[:, cols], ix[:, cols]):
                sums += c.astype(np.uint32) * work[:, i - lo].astype(np.uint32)
            if k.wrap16:
                s = (sums + half).view(np.int32)
                d = xdiv[cols]
                v = _wrap16(np.where(d != 0, trunc_div(s.astype(np.int64),
                                                       np.where(d, d, 1)),
                                     s >> plan.out_shift))
            else:
                v = (sums + half) >> np.uint32(plan.out_shift)
            out[rows, cols] = np.clip(v, 0, 255)
    return out


# plans whose scope the wide-window walk opened: one partial column tile,
# a window too wide for 16 rows (kept small in rows: numpy_ref is dense)
WIDE_PLANS = [
    WIDE,
    ("area", 4096, 16, 8, 16, {}),           # 14 rows a block
    ("area", 12288, 16, 64, 16, {}),         # 4 rows: the least
    ("area", 8192, 40, 32, 20, {}),          # 2 taps in Y, 3 row tiles
    ("lanczos", 8192, 6, 16, 6, dict(degree=3)),   # wrap16, border divides
    ("linear", 9000, 8, 120, 8, {}),
]


@pytest.mark.parametrize("case", WIDE_PLANS, ids=card_check.case_name)
def test_wide_window_walk_model_matches_oracle(case):
    """The route's kernel (the wide-window kernel) and the windowed walk
    (``wide=False``), each modelled, == ``numpy_ref``."""
    alg, sw, sh, dw, dh, kw = case
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    assert cuda_resize.smem_bytes(plan) > cuda_resize.SMEM_BUDGET, case
    assert cuda_resize.supports_plan(plan), case
    k = cuda_resize.kernel_tables(plan)
    assert k.wide
    walk = cuda_resize.kernel_tables(plan, wide=False)
    assert walk.rows == cuda_resize.work_rows(plan) < cuda_resize.TILE_ROWS
    src = card_check.source(case, 0)
    want = numpy_ref.resize_u8(plan, src)
    np.testing.assert_array_equal(route_model(plan, k, src), want)
    np.testing.assert_array_equal(walk_model(plan, walk, src), want)
    ops = cuda_resize.pack_operands(plan)             # the CPU's plain route
    np.testing.assert_array_equal(
        cuda_resize.resize_fused(ops, torch.from_numpy(src)[None])[0].numpy(), want)


@pytest.mark.parametrize("algo,kw,sw,sh,dw,dh", [
    ("lanczos", dict(degree=3), 300, 40, 150, 3),
    ("area", {}, 123, 77, 41, 19),
    ("linear", {}, 97, 61, 40, 150),
])
def test_walk_model_at_sixteen_rows(algo, kw, sw, sh, dw, dh):
    """The same model at the 16-row tile, over every row tile: the plans
    the kernel took before the wide-window walk."""
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    k = cuda_resize.kernel_tables(plan, tiled=False)
    assert k.rows == cuda_resize.TILE_ROWS
    src = np.random.default_rng(sw).integers(0, 256, (sh, sw), np.uint8)
    np.testing.assert_array_equal(walk_model(plan, k, src), numpy_ref.resize_u8(plan, src))


def test_work_rows_bounds():
    """16 rows wherever they fit; fewer, on any number of column tiles,
    where the widest window does not, and never fewer than MIN_WORK_ROWS:
    the plans both packages refuse stay refused."""
    assert cuda_resize.work_rows(build_plan("lanczos", 3840, 2160, 1920, 1080,
                                            degree=3)) == cuda_resize.TILE_ROWS
    edge = cuda_resize.SMEM_BUDGET // (4 * cuda_resize.MIN_WORK_ROWS)   # 14528
    for sw, rows in ((edge, cuda_resize.MIN_WORK_ROWS), (edge + 16, 0)):
        assert cuda_resize.work_rows(build_plan("area", sw, 4, 16, 4)) == rows, sw
    # two column tiles of 4096 columns: 14 rows; five of 1280: 11
    assert cuda_resize.work_rows(build_plan("area", 8192, 2160, 256, 540)) == 14
    assert cuda_resize.work_rows(build_plan("area", 40960, 8, 1024, 8)) == 11
    for geometry in ((16384, 4, 16, 4), (32768, 16, 16, 16), (65536, 16, 16, 16)):
        plan = build_plan("area", *geometry)
        assert cuda_resize.work_rows(plan) == 0 and not cuda_resize.supports_plan(plan)
        assert not pallas_resize.supports_plan(jax_build_plan("area", *geometry))


def test_case_names_and_sources_are_stable():
    assert card_check.case_name(card_check.GRADED[4]) == "lanczos3 1920x1080->960x540 px2"
    assert card_check.case_name(WIDE) == "area 8192x4->16x4"
    a, b = card_check.source(WIDE, 0), card_check.source(WIDE, 0)
    assert a.shape == (4, 8192) and a.dtype == np.uint8 and np.array_equal(a, b)
    assert not np.array_equal(a, card_check.source(WIDE, 1))
    orc = card_check.Oracle()
    np.testing.assert_array_equal(orc.get(WIDE, 0),
                                  numpy_ref.resize_u8(build_plan(*WIDE[:5]), a))
    assert orc.get(WIDE, 0) is orc.get(WIDE, 0)


def test_border_cases_take_the_divide():
    cases = card_check.border_cases()
    assert {(c[5]["degree"], c[5]["px_scale"]) for c in cases} == {
        (d, p) for d in card_check.BORDER_DEGREES for p in card_check.BORDER_PX}
    for case in cases:
        plan = build_plan(*case[:5], **case[5])
        assert plan.wrap16 and cuda_resize.supports_plan(plan)
        assert min(plan.y.is_border.mean(), plan.x.is_border.mean()) >= card_check.BORDER_SHARE


def test_gate_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gate would run")
    assert card_check.main(["--out", "/nonexistent/never-written.json"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_gate_module_is_walked_for_jax_imports():
    """tests/test_torch_plan.py's ast walk covers libiqo_tpu_torch/tools/."""
    from test_torch_plan import _imported_modules

    mods = set(_imported_modules(ROOT / "libiqo_tpu_torch/tools/card_check.py"))
    assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib", "libiqo_tpu"}
    assert ROOT / "libiqo_tpu_torch/tools/card_check.py" in \
        set((ROOT / "libiqo_tpu_torch").rglob("*.py"))


def test_committed_result():
    """Where the committed result exists: a passing run on an H100, every
    GRADED, STRESS, STRESS_GEOMETRIES, WIDE_WINDOW and THUMBNAILS row on a
    kernel variant (WIDE_WINDOW's ``tiled=False`` rows, and the facade's
    where ``tiled_ok`` refuses, on the wide-window kernel), each with its
    twin; relaxed within 2 LSB of exact with flat fields exact, the
    thumbnails on the wide-window kernel's relaxed form."""
    if not card_check.RESULT.exists():
        pytest.skip("no committed card_check_result.json")
    res = json.loads(card_check.RESULT.read_text())
    assert res["n_fail"] == 0 and "H100" in res["card"] and " W" in res["card"]
    for key in ("n_cases", "n_skip", "results", "relaxed", "carry", "sharded",
                "border_div"):
        assert key in res
    assert res["n_cases"] == sum(len(res[k]) for k in
                                 ("results", "relaxed", "carry", "sharded", "border_div"))
    rows = {r["case"]: r for r in res["results"]}
    for case in card_check.REQUIRED:
        row = rows[card_check.case_name(case)]
        assert row["status"] == "ok" and row["route"] == "cuda", row
        assert row["variant"] in cuda_resize.VARIANTS and row["launches"] > 0, row
        assert row["oracle"] and row["vs_oracle"] == 0, row
        assert row["twin_variant"] in cuda_resize.VARIANTS and row["twin_vs_plain"] == 0, row
    for case in card_check.THUMBNAILS:
        row = rows[card_check.case_name(case)]
        tiled = cuda_resize.tiled_ok(build_plan(*case[:5], **case[5]))
        assert row["variant"].endswith(("_wide", "_wide_s8")) != tiled, row
        assert row["work_rows"] == 16, row
    wide = ("u16_wide", "wrap16_wide", "wrap16_wide_s8")
    for case in card_check.WIDE_WINDOW:
        row = rows[card_check.case_name(case)]
        assert row["windowed_variant"] in wide and row["work_rows"] < 16, row
        tiled = cuda_resize.tiled_ok(build_plan(*case[:5], **case[5]))
        assert (row["variant"] in wide) != tiled, row
    assert rows["area 8192x4->16x4"]["variant"] == "u16_wide"
    for r in res["relaxed"]:
        assert r["status"] == "ok" and r["max_lsb_vs_exact"] <= 2 and r["flat_ok"], r
        assert "relaxed" in r["twin_variant"], r
    relaxed = {r["case"]: r for r in res["relaxed"]}
    for case in card_check.RELAXED_THUMBNAILS[:-1]:
        assert relaxed[card_check.case_name(case)]["variant"].endswith("_relaxed_wide")
    assert all(r["status"] == "ok" for r in res["border_div"])
    assert all("card" in r for k in ("results", "relaxed", "carry", "sharded", "border_div")
               for r in res[k] if "run_s" in r)


@pytest.mark.parametrize("case", card_check.THUMBNAILS, ids=card_check.case_name)
def test_thumbnails_are_in_scope_on_their_routes(case):
    """THUMBNAILS: inside supports_plan with a 16-row work tile; the facade's
    kernel is the wide-window one where no tiled width fits, else the
    tiled one below its block-count width; the relaxed list is the ones
    inside the relaxed scope; each is required by the exact sweep."""
    plan = build_plan(*case[:5], **case[5])
    assert cuda_resize.supports_plan(plan) and cuda_resize.work_rows(plan) == 16
    k = cuda_resize.kernel_tables(plan)
    if cuda_resize.tiled_ok(plan):
        assert k.tiled and k.layout.tw < cuda_resize.tiled_width(plan)
    else:
        assert cuda_resize.variant(k).endswith(("_wide", "_wide_s8"))
    assert (case in card_check.RELAXED_THUMBNAILS) == cuda_resize.supports_plan(
        plan, relaxed=True)
    assert case in card_check.REQUIRED


def test_twin_is_the_other_kernel():
    """``twin`` of the ``tiled=False`` tables: the windowed kernel's beside
    the wide-window kernel's and the other way round, relaxed here on the
    CPU (relaxed tables build on any device)."""
    thumb = build_plan("lanczos", 960, 540, 64, 36, degree=3)
    main = build_plan("lanczos", 640, 360, 320, 180, degree=3)
    for plan, first, second in ((thumb, "wrap16_relaxed_wide", "wrap16_relaxed"),
                                (main, "wrap16_relaxed", "wrap16_relaxed_wide")):
        ops = cuda_resize.pack_operands(plan, relaxed=True, tiled=False)
        other = card_check.twin(plan, ops, relaxed=True)
        assert cuda_resize.variant(ops.tables) == first
        assert cuda_resize.variant(other.tables) == second
