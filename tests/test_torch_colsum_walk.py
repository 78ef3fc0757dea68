"""Kernel H's walk (``band_colsum(..., form="walk")``, the default:
``libiqo_tpu_torch/csrc/exp/exp_band.cu`` ``band_colsum_walk_kernel``) on the
CPU: its launch (``exp_blocked_halo.colsum_walk``) and its NumPy model
(``colsum_model``: the kernel's blocks, phases, pieces, their slots and
the stores, in the kernel's order) against the plain
version and ``scripts/exp_blocked_halo.py``'s ``build`` in interpret mode
(``pl.pallas_call`` patched with ``interpret=True`` inside each test only).

The script's three configs run at full size; the edge shapes
(``EDGE_SHAPES``: halo past the step, one tile without a halo at w 4, an
odd step, a halo of many steps) at their own, blocked2 with a halo plane
unlike its first (the script builds blocked2 only where ``halo`` divides
``step``).  Tolerance 0: integer sums of integers.  Tests that need the card
are ``cuda``-marked and skip without one.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import exp_blocked_halo as bh

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_colsum_walk.cu"
SHAPES = bh.CONFIGS + bh.EDGE_SHAPES


@pytest.fixture
def script(monkeypatch):
    """``scripts/exp_blocked_halo.py`` with its Pallas kernels in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "_tpu_exp_blocked_halo", ROOT / "scripts" / "exp_blocked_halo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _planes(n_t, step, halo, w, seed):
    rng = np.random.default_rng(seed)
    shape = (n_t * step + halo, w)
    return rng.integers(0, 256, shape, np.uint8), rng.integers(0, 256, shape, np.uint8)


def _plain(x, variant, n_t, step, halo, y=None):
    return bh.band_colsum_plain(torch.from_numpy(x), variant, n_t, step, halo,
                                None if y is None else torch.from_numpy(y)).numpy()


def _vec(w):
    return 16 if w % 16 == 0 else 4


@pytest.mark.parametrize("variant", bh.VARIANTS)
@pytest.mark.parametrize("config", bh.CONFIGS, ids=[c[0] for c in bh.CONFIGS])
def test_model_equals_plain_and_script_on_the_configs(script, config, variant):
    name, n_t, step, halo, w = config
    call, n_rows = script.build(variant, n_t, step, halo, w)
    x, _ = _planes(n_t, step, halo, w, n_t + halo)
    assert x.shape[0] == n_rows
    got, stats = bh.colsum_model(x, variant, n_t, step, halo)
    want = np.asarray(call(x))
    assert got.dtype == np.int32 and got.shape == want.shape == (8 * n_t, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _plain(x, variant, n_t, step, halo))
    assert (stats["writes"] == 1).all()


@pytest.mark.parametrize("variant", bh.VARIANTS)
@pytest.mark.parametrize("shape", bh.EDGE_SHAPES, ids=[c[0] for c in bh.EDGE_SHAPES])
def test_model_equals_plain_and_script_on_edge_shapes(script, shape, variant):
    """Halo 0, halo past the step, one tile, w 4 and w not a multiple of 16
    or of the chunk; blocked2's halo from a plane of its own (== plain), and
    with both planes the same == the script where it builds blocked2."""
    name, n_t, step, halo, w = shape
    x, y = _planes(n_t, step, halo, w, n_t * step + w)
    got, stats = bh.colsum_model(x, variant, n_t, step, halo, y)
    np.testing.assert_array_equal(got, _plain(x, variant, n_t, step, halo, y))
    assert (stats["writes"] == 1).all()
    if variant == "blocked2" and (halo == 0 or step % halo):
        return                                  # the script asserts halo | step
    call, _ = script.build(variant, n_t, step, halo, w)
    np.testing.assert_array_equal(bh.colsum_model(x, variant, n_t, step, halo)[0],
                                  np.asarray(call(x)))


@pytest.mark.parametrize("cw", [16, 64, 512])
@pytest.mark.parametrize("run", [1, 3, None])
@pytest.mark.parametrize("shape", bh.EDGE_SHAPES, ids=[c[0] for c in bh.EDGE_SHAPES])
def test_model_of_every_chunk_and_run_equals_plain(shape, cw, run):
    """Walks the kernel takes with other chunks and runs (the ablation's):
    each == plain in every variant, every (tile, column) stored once."""
    name, n_t, step, halo, w = shape
    x, y = _planes(n_t, step, halo, w, 7)
    for variant in bh.VARIANTS:
        try:
            walk = bh.colsum_walk(variant, n_t, step, halo, w, _vec(w), cw=cw,
                                  run=n_t if run is None else min(run, n_t))
        except ValueError as e:      # a run whose slots do not fit shared memory
            assert "fits" in str(e)
            continue
        got, stats = bh.colsum_model(x, variant, n_t, step, halo, y, walk)
        np.testing.assert_array_equal(got, _plain(x, variant, n_t, step, halo, y))
        assert (stats["writes"] == 1).all()


@pytest.mark.parametrize("variant", bh.VARIANTS)
@pytest.mark.parametrize("config", SHAPES, ids=[c[0] for c in SHAPES])
def test_walk_covers_every_tile_and_column_once(config, variant):
    """Every (tile, column) is stored by exactly one block; the rows the
    model reads give the walk's re-read fraction, and its wave efficiency
    and summary are those ``main()`` prints."""
    name, n_t, step, halo, w = config
    walk = bh.colsum_walk(variant, n_t, step, halo, w, _vec(w))
    x, y = _planes(n_t, step, halo, w, 3)
    _, stats = bh.colsum_model(x, variant, n_t, step, halo, y, walk)
    assert stats["writes"].shape == (n_t, w) and (stats["writes"] == 1).all()
    assert stats["reread"] == pytest.approx(walk.reread, abs=1e-12)
    slots = 132 * walk.resident
    assert walk.wave_efficiency == walk.blocks / (slots * -(-walk.blocks // slots))
    summary = walk.summary()
    assert summary["reread"] == walk.reread and summary["blocks"] == walk.blocks
    assert summary["wave_efficiency"] == walk.wave_efficiency


@pytest.mark.parametrize("config", bh.CONFIGS, ids=[c[0] for c in bh.CONFIGS])
def test_walk_reads_each_row_once_inside_a_run_on_all_sms(config):
    """On the script's configs each block reads its run's rows once (the
    step rows of its tiles plus one halo past the run), 16 bytes a load,
    every thread one piece, and the grid covers every SM with blocks to
    spare."""
    name, n_t, step, halo, w = config
    for variant in bh.VARIANTS:
        walk = bh.colsum_walk(variant, n_t, step, halo, w)
        assert walk.vec == 16 and walk.phases() == bh.WALK_PHASES
        assert walk.blocks >= 2 * 132 and walk.resident >= 2
        extra = halo if variant == "element" else 0
        if variant == "blocked2":
            assert walk.rows_read(walk.run) == walk.run * step + walk.run * min(halo, step)
        else:
            assert walk.rows_read(walk.run) == walk.run * step + extra
        assert walk.reread <= (walk.runs - 1) * extra / (n_t * step + extra) + 1e-12


@pytest.mark.parametrize("config", SHAPES, ids=[c[0] for c in SHAPES])
def test_walk_stays_inside_the_kernels_limits(config):
    """What ``iqo_exp_band_colsum_walk`` refuses never comes out of the walk:
    a power-of-two chunk of 16-512 bytes, at most 640 threads (whole warps),
    shared memory within the budget, and a piece's column sums within the
    packed 16 bits."""
    name, n_t, step, halo, w = config
    for variant in bh.VARIANTS:
        walk = bh.colsum_walk(variant, n_t, step, halo, w, _vec(w))
        assert walk.cw in bh.WALK_CHUNKS and walk.cw >= walk.vec
        assert walk.threads <= bh.WALK_MAX_THREADS and walk.threads % 32 == 0
        assert walk.cw // walk.vec * walk.tps <= walk.threads
        assert walk.smem <= bh.WALK_SMEM and walk.rows_piece * 255 <= 0xFFFF
        assert walk.phases() == -(-walk.pieces() // walk.tps)


def test_walk_takes_four_byte_loads_where_w_is_not_a_multiple_of_16():
    walk = bh.colsum_walk("element", 37, 48, 100, 1000, 4)
    assert walk.vec == 4 and walk.rows_piece == 32
    with pytest.raises(ValueError, match="no walk"):
        bh.colsum_walk("element", 37, 48, 100, 1000, 16)
    with pytest.raises(ValueError, match="no walk"):
        bh.colsum_walk("element", 4, 64, 64, 512, 16, cw=8)


def test_model_refuses_a_store_before_its_step_blocks(monkeypatch):
    """A tile is stored only once every piece of its window is summed: a
    walk that forgets the windows' last step blocks (q taken as 0) stores
    tiles whose halo was never read, which the model catches."""
    name, n_t, step, halo, w = bh.CONFIGS[2]
    x, _ = _planes(n_t, step, halo, w, 1)
    walk = bh.colsum_walk("element", n_t, step, halo, w)
    monkeypatch.setattr(bh.ColsumWalk, "qmax", property(lambda self: 0))
    with pytest.raises(AssertionError, match="stored before"):
        bh.colsum_model(x, "element", n_t, step, halo, walk=walk)


def test_passes_of_each_variant():
    """A window of q step + h rows: element one pass of step + halo rows,
    blocked1 one of step, blocked2 the step rows of A and the halo of B
    from the next tile's first row; a window inside one step block has no
    tail pieces, an empty one no pieces."""
    e, = bh.walk_passes("element", 64, 64, 8)
    assert (e.plane, e.alpha, e.length, e.q, e.h, e.nh, e.nt) == (0, 0, 128, 2, 0, 0, 8)
    a, b = bh.walk_passes("blocked2", 64, 32, 8)
    assert (a.plane, a.alpha, a.q, a.h) == (0, 0, 1, 0)
    assert (b.plane, b.alpha, b.length, b.q, b.h, b.nh, b.nt) == (1, 64, 32, 0, 32, 4, 0)
    one, = bh.walk_passes("blocked1", 48, 100, 32)
    assert (one.length, one.q, one.h, one.nt) == (48, 1, 0, 2)
    _, empty = bh.walk_passes("blocked2", 64, 0, 8)
    assert (empty.nh, empty.nt, empty.length) == (0, 0, 0)
    long, = bh.walk_passes("element", 16, 300, 8)
    assert (long.q, long.h, long.nh, long.nt) == (19, 12, 2, 1)


def test_form_is_validated_and_grid_stays_reachable():
    x = torch.from_numpy(_planes(4, 64, 64, 128, 2)[0])
    want = bh.band_colsum_plain(x, "element", 4, 64, 64)
    for form in (None, *bh.FORMS):
        assert torch.equal(bh.band_colsum(x, "element", 4, 64, 64, form=form), want)
    for bad in ("ring", "", "Walk", "sync"):
        with pytest.raises(ValueError, match="takes form"):
            bh.band_colsum(x, "element", 4, 64, 64, form=bad)
    with pytest.raises(ValueError, match="another call"):
        bh.band_colsum(x, "element", 4, 64, 64,
                       walk=bh.colsum_walk("element", 4, 64, 32, 128))
    assert bh.FORMS == ("walk", "grid")
    assert [bh.launch_key(v, "grid") for v in bh.VARIANTS] == list(bh.VARIANTS)
    assert set(bh.LAUNCHES) == {bh.launch_key(v, f) for v in bh.VARIANTS for f in bh.FORMS}


def test_walk_constants_are_the_kernels():
    """The walk's Python constants equal ``exp_colsum_walk.cu``'s, the C
    entry sizes its slots and threads as the model does, and the grid form
    keeps its kernel in ``exp_band.cu``."""
    text = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (kWalk\w+) = (\d+)", text))
    assert int(consts["kWalkMaxThreads"]) == bh.WALK_MAX_THREADS
    assert int(consts["kWalkPieceBytes"]) == bh.WALK_PIECE_BYTES
    assert int(consts["kWalkSmemBytes"]) == bh.WALK_SMEM
    assert "const long long smem = 2ll * cw * (run + qmax) * nug;" in text
    assert "const long long threads = ((long long)cw / vec * tps + 31) / 32 * 32;" in text
    for form in ("<uint4>", "<uint32_t>"):
        assert f"band_colsum_walk_kernel{form}" in text
    grid = (ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_band.cu").read_text()
    assert "band_colsum_kernel<kElement>" in grid


def test_walk_of_a_fixed_launch_keeps_its_fields():
    walk = bh.colsum_walk("element", 256, 64, 64, 512, cw=128, run=8)
    assert (walk.cw, walk.run, walk.blocks, walk.chunks, walk.runs) == (128, 8, 128, 4, 32)
    assert walk.pieces() == (8 + 2) * 8 and walk.group_pieces == 8
    assert walk.phases() == -(-walk.pieces() // walk.tps) == 1
    assert walk.threads == 640 and walk.smem == 80 * 128 * 2 and walk.resident == 2
    assert dataclasses.replace(walk, run=16).runs == 16


def test_ablation_launches_are_walks_the_kernel_takes():
    """``tools/colsum_ablate.py``'s variants on its two rows: each a launch
    within the kernel's limits (the grid form aside), each == plain through
    the model at the narrow row; ``halo_twice`` re-reads every halo."""
    from libiqo_tpu_torch.tools import colsum_ablate

    for name, n_t, step, halo, w in (c for c in bh.CONFIGS if c[0] in colsum_ablate.ROWS):
        walks = colsum_ablate.walks(n_t, step, halo, w)
        assert set(walks) <= set(colsum_ablate.VARIANTS) and walks["grid"] is None
        assert (walks["walk"].vec, walks["load4"].vec) == (16, 4)
        assert (walks["load4"].cw, walks["load4"].run) == (walks["walk"].cw, walks["walk"].run)
        assert walks["halo_twice"].run == 1
        assert walks["halo_twice"].reread == pytest.approx((n_t - 1) * halo / (n_t * step + halo))
        assert walks["run_double"].run == 2 * walks["walk"].run
        assert walks["two_phases"].phases() == 2 > walks["walk"].phases()
        for v, walk in walks.items():
            if walk is not None:
                assert walk.smem <= bh.WALK_SMEM and walk.threads <= bh.WALK_MAX_THREADS, v
        if name == "narrow":
            x, _ = _planes(n_t, step, halo, w, 11)
            want = _plain(x, "element", n_t, step, halo)
            for v, walk in walks.items():
                if walk is not None:
                    np.testing.assert_array_equal(
                        bh.colsum_model(x, "element", n_t, step, halo, walk=walk)[0], want)


@pytest.mark.parametrize("stage", ["kernel", "no_store", "no_sum", "fetch_only", "no_loads"])
def test_ablation_stages_change_only_their_stage(stage):
    """Each stage variant's substitutions are found once in
    ``exp_colsum_walk.cu`` and keep every barrier, load and launch bound of
    the kernel."""
    from libiqo_tpu_torch.tools import colsum_ablate

    assert set(colsum_ablate.STAGES) >= {stage}
    text = colsum_ablate.variant_source(stage)
    source = SOURCE.read_text()
    for call in ("__syncthreads()", "__ldg(", "__launch_bounds__", "store(ph"):
        assert text.count(call) == source.count(call), (stage, call)
    assert (text == source) == (stage == "kernel")


def test_ablation_raises_without_a_card(monkeypatch):
    from libiqo_tpu_torch.tools import colsum_ablate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        colsum_ablate.main([])
    with pytest.raises(SystemExit, match="unknown variants"):
        colsum_ablate.main(["nope"])


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_walk_equals_plain_on_card(cuda_device):
    for name, n_t, step, halo, w in SHAPES:
        x, y = (torch.from_numpy(p).to(cuda_device) for p in _planes(n_t, step, halo, w, 5))
        for variant in bh.VARIANTS:
            want = bh.band_colsum_plain(x, variant, n_t, step, halo, y)
            for form in bh.FORMS:
                assert torch.equal(bh.band_colsum(x, variant, n_t, step, halo, y, form), want)
