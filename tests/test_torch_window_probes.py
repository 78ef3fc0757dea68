"""The window legality probes (``libiqo_tpu_torch/experiments/
exp_element_clamp``, kernel M) against ``scripts/exp_element_clamp.py``, on
the CPU at the script's own sizes.

The script is loaded from ``scripts/`` with ``importlib`` and its four runs
(``run_x1()``, ``run_x1(batch=3)``, ``run_x2()``, ``run_x3()``) run in
interpret mode (``pl.pallas_call`` patched with ``interpret=True`` inside
each test only); its ``jax.jit`` is wrapped so that each run's output array
is kept.  The port's wrappers on the same CPU sources run the plain
versions.  Tolerance 0: the probes copy values.  Tests that need the card
are ``cuda``-marked and skip without one.
"""

from __future__ import annotations

import ast
import functools
import importlib.util
import subprocess
import sys
from pathlib import Path
from types import ModuleType

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import exp_element_clamp as ec

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def script(monkeypatch):
    """The script, in interpret mode, with ``script.outputs`` collecting the
    output of every jitted call it makes."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "_tpu_exp_element_clamp", ROOT / "scripts" / "exp_element_clamp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    outputs = []

    def jit(fn):
        jitted = jax.jit(fn)

        def run(*args):
            out = jitted(*args)
            outputs.append(np.asarray(out))
            return out
        return run

    class Jax(ModuleType):                  # jax, with jit wrapped
        def __getattr__(self, name):
            return getattr(jax, name)

    recording = Jax("jax")
    recording.jit = jit
    monkeypatch.setattr(mod, "jax", recording)
    mod.outputs = outputs
    return mod


@pytest.mark.parametrize("batch", [None, 3])
def test_window_x1_equals_script(script, capsys, batch):
    assert script.run_x1(batch=batch)
    assert f"X1 batch={batch}: OK" in capsys.readouterr().out
    src = ec.inputs("cpu")["x1" if batch is None else "x1_batch"]
    got = ec.window_x1(src)
    want = script.outputs[-1]
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert want.shape == ((128, 512) if batch is None else (3, 128, 512))
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_x2_equals_script(script, capsys):
    script.run_x2()
    assert "X2 (OOB-high Element window): ran, in-bounds part OK" in capsys.readouterr().out
    src = ec.inputs("cpu")["x2"]
    got = ec.window_x2(src)
    np.testing.assert_array_equal(got.numpy(), script.outputs[-1])


def test_window_x2_copies_only_rows_inside_the_source():
    """The (64, 256) window starts at row 128 and runs to row 191, 32 rows
    past the 160-row source; the 32 rows it copies (128-159) all lie inside,
    so the output is fully defined."""
    src = ec.inputs("cpu")["x2"]
    r0 = (ec.H - 32) // 32 * 32
    assert r0 == 128 and r0 + ec.BAND_H - ec.H == 32 and r0 + 32 == ec.H
    np.testing.assert_array_equal(ec.window_x2(src).numpy(), src[128:160, :128].numpy())


def test_x2_boxes_cover_the_window_once():
    """X2's split form: 8 boxes of (64, 32), each at row 128 of the
    160-row source, so each holds 32 rows inside and 32 past the end; the
    boxes load every element of the (64, 256) window exactly once, and the
    first four write out's 128 columns."""
    sched = ec.x2_schedule()
    assert len(sched) == ec.X2_BOXES == 8 and ec.X2_BOX_W * ec.X2_BOXES == ec.BAND_W
    for blk in sched:
        assert blk["row"] == 128 and blk["shape"] == (ec.BAND_H, ec.X2_BOX_W)
        assert blk["rows_inside"] == 32 and blk["rows_past_end"] == 32
        assert blk["row"] + blk["rows_inside"] == ec.H
    assert sum(blk["rows_past_end"] * blk["shape"][1] for blk in sched) == 32 * ec.BAND_W
    _, _, loads = ec.x2_model(ec.inputs("cpu")["x2"].numpy())
    assert loads.shape == (ec.BAND_H, ec.BAND_W) and (loads == 1).all()
    cols = [c for blk in sched for c in blk["out_cols"]]
    assert sorted(cols) == list(range(ec.TW))


def test_x2_model_equals_plain_and_script(script, capsys):
    """The split form's model: out == the plain version == the script in
    interpret mode; spill rows 0-31 == src[128:160, :256], rows 32-63 zero."""
    script.run_x2()
    capsys.readouterr()
    src = ec.inputs("cpu")["x2"].numpy()
    out, spill, _ = ec.x2_model(src)
    np.testing.assert_array_equal(out, script.outputs[-1])
    np.testing.assert_array_equal(out, ec.window_x2_plain(torch.from_numpy(src)).numpy())
    np.testing.assert_array_equal(spill[:32], src[128:160, :256])
    assert (spill[32:] == 0).all()
    for form in (None, *ec.X2_FORMS):
        np.testing.assert_array_equal(ec.window_x2(torch.from_numpy(src), form=form).numpy(),
                                      out)


def test_x1_boxes_cover_each_tiles_window_once():
    """X1's split form: 8 boxes of (64, 32) a tile, 128 blocks (384 for a
    batch of 3), each box inside the 160 x 640 source at the tile's clamped
    window; the boxes load every element of each tile's (64, 256) window
    exactly once, and boxes 0-3 write the tile's (32, 128) corner."""
    for planes in (0, ec.BATCH):
        sched = ec.x1_schedule(planes)
        assert len(sched) == max(planes, 1) * ec.N_TY * ec.N_TX * ec.X2_BOXES
        for blk in sched:
            assert blk["shape"] == (ec.BAND_H, ec.X2_BOX_W)
            assert 0 <= blk["row"] and blk["row"] + ec.BAND_H <= ec.H
            assert 0 <= blk["col"] and blk["col"] + ec.X2_BOX_W <= ec.W
            assert len(blk["out_cols"]) == (ec.X2_BOX_W if blk["box"] < 4 else 0)
    src = ec.inputs("cpu")["x1_batch"].numpy()
    _, loads = ec.x1_model(src)
    assert loads.shape == (ec.BATCH, ec.N_TY, ec.N_TX, ec.BAND_H, ec.BAND_W)
    assert (loads == 1).all()
    sched = ec.x1_schedule()
    assert len(sched) == 128 and len(ec.x1_schedule(ec.BATCH)) == 384
    tile = [blk for blk in sched if (blk["ty"], blk["tx"]) == (0, 1)]
    assert [blk["col"] for blk in tile] == list(range(0, 256, 32))      # tx 1 clamps to 0
    assert {blk["row"] for blk in sched if blk["ty"] == 3} == {64}


@pytest.mark.parametrize("batch", [None, 3])
def test_x1_model_equals_plain_and_script(script, capsys, batch):
    """The split form's model == the plain version == the script's
    ``run_x1`` in interpret mode, 2-D and batch; both forms' wrappers give
    it on the CPU."""
    assert script.run_x1(batch=batch)
    capsys.readouterr()
    src = ec.inputs("cpu")["x1" if batch is None else "x1_batch"]
    out, _ = ec.x1_model(src.numpy())
    np.testing.assert_array_equal(out, script.outputs[-1])
    np.testing.assert_array_equal(out, ec.window_x1_plain(src).numpy())
    for form in (None, *ec.X1_FORMS):
        np.testing.assert_array_equal(ec.window_x1(src, form=form).numpy(), out)


def test_corner_index_is_the_plain_version():
    """The library call of X1's rows: one index of the flat source, over a
    batch one index a plane."""
    srcs = ec.inputs("cpu")
    flat = ec.corner_index("cpu")
    assert flat.shape == (128, 512)
    assert torch.equal(srcs["x1"].view(-1)[flat], ec.window_x1_plain(srcs["x1"]))
    b = srcs["x1_batch"]
    assert torch.equal(b.view(b.shape[0], -1)[:, flat], ec.window_x1_plain(b))


def test_window_x3_equals_script(script, capsys):
    script.run_x3()
    assert "X3 (dynamic scratch leading index): ran, OK" in capsys.readouterr().out
    var = ec.inputs("cpu")["x3"]
    got = ec.window_x3(var)
    assert got.dtype == torch.float32 and got.shape == (4, 64, 256)
    np.testing.assert_array_equal(got.numpy(), script.outputs[-1])


def test_inputs_reproduce_the_scripts_draws():
    srcs = ec.inputs("cpu")
    np.testing.assert_array_equal(srcs["x1"].numpy(), np.random.default_rng(0).integers(
        0, 1 << 20, (160, 640)).astype(np.int32))
    np.testing.assert_array_equal(srcs["x1_batch"].numpy(), np.random.default_rng(0).integers(
        0, 1 << 20, (3, 160, 640)).astype(np.int32))
    assert srcs["x2"].dtype == torch.int32 and int(srcs["x2"][159, 639]) == 160 * 640 - 1
    assert srcs["x3"].dtype == torch.float32 and float(srcs["x3"][2, 63, 255]) == 3 * 64 * 256 - 1


def test_window_offsets_clamp():
    """Tile 0 wants offset -32 / -128 and clamps to 0; the last tiles fit."""
    rows, cols = ec._corner_index("cpu")
    assert rows[:32].tolist() == list(range(32)) and rows[32:64].tolist() == list(range(32))
    assert rows[96:].tolist() == list(range(64, 96))
    assert cols[128:256].tolist() == list(range(128)) and int(cols[-1]) == 384 - 1


def test_bounds_give_the_bytes():
    assert ec.bound("x1")[1:] == ("bytes", 2 * 128 * 512 * 4)
    assert ec.bound("x1[boxes]") == ec.bound("x1")
    assert ec.bound("x1_batch[boxes]") == ec.bound("x1_batch")
    assert ec.bound("x1_batch")[2] == 3 * ec.bound("x1")[2]
    assert ec.bound("x2")[2] == 2 * 32 * 128 * 4
    assert ec.bound("x3")[2] == 7 * 64 * 256 * 4
    assert ec.bound("x1")[0] < 1e-3                      # well under a microsecond


def test_wrappers_refuse_other_devices_and_bad_calls():
    srcs = ec.inputs("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ec.window_x1(srcs["x1"].to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        ec.window_x2(srcs["x2"], torch.zeros((64, 256), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="must be"):
        ec.window_x1(srcs["x1"][:, :320])
    with pytest.raises(ValueError, match="var must be"):
        ec.window_x3(srcs["x3"].to(torch.float64))
    for bad in ("cluster", "", "Boxes", "serial"):
        with pytest.raises(ValueError, match="takes form"):
            ec.window_x1(srcs["x1"], form=bad)


def test_launches_stay_zero_on_cpu():
    ec.reset_launches()
    srcs = ec.inputs("cpu")
    for form in (None, *ec.X1_FORMS):
        ec.window_x1(srcs["x1"], form=form)
        ec.window_x1(srcs["x1_batch"], form=form)
    ec.window_x2(srcs["x2"])
    ec.window_x3(srcs["x3"])
    assert ec.LAUNCHES.total() == 0 and set(ec.LAUNCHES) == set(ec.ROWS)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec.main()


def test_module_entry_point_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "libiqo_tpu_torch.experiments.exp_element_clamp"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_module_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse(Path(ec.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "libiqo_tpu")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TMA has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_window_kernels_equal_plain_on_card(cuda_device):
    srcs = ec.inputs(cuda_device)
    for form in ec.X1_FORMS:
        for row in ("x1", "x1_batch"):
            assert torch.equal(ec.window_x1(srcs[row], form=form), ec.window_x1_plain(srcs[row]))
    for form in ec.X2_FORMS:
        assert torch.equal(ec.window_x2(srcs["x2"], form=form), ec.window_x2_plain(srcs["x2"]))
    assert torch.equal(ec.window_x3(srcs["x3"]), ec.window_x3_plain(srcs["x3"]))
