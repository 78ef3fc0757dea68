"""The ring forms of kernels E and G (``libiqo_tpu_torch/csrc/exp/
exp_band_ring.cu``, ``impl="ring"`` of ``exp_band_shape.band_ydot`` and
``exp_overlap.overlap_dots``) on the CPU: the geometry against the source's
constants, the persistent walk, the ring of row slots, the barrier schedule,
the banks of the fragment reads, a NumPy model of the kernels
(``experiments/band_ring.py``) against the TPU scripts' Pallas kernels in
interpret mode, the library calls that rank the kernels, the wrappers'
``impl=``, launch keys and refusals, and the ablation tool's variants
(``tools/band_ablate.py``).

Tolerance 0, bit for bit: every result is an integer function of integer
inputs, the model's int64 dots are exact, and so are the kernels' s8 -> s32
dots.  The scripts run as ``tests/test_torch_band_fetch.py`` runs them: their
size constants shrunk, ``pl.pallas_call`` patched with ``interpret=True``.
The kernels themselves run only on the card: that test is ``cuda``-marked and
skips without one.
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

from libiqo_tpu_torch.experiments import _harness, band_ring as br
from libiqo_tpu_torch.experiments import exp_band_shape as bs
from libiqo_tpu_torch.experiments import exp_i32_band as ib
from libiqo_tpu_torch.experiments import exp_overlap as ov
from libiqo_tpu_torch.tools import band_ablate

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_band_ring.cu"
SMEM_LIMIT = 232_448        # bytes of shared memory one block may use (H100)
BAND_SHAPE = dict(H=320, W=256, N_T=(320 - 96) // 64 + 1, CLAMP_HI=320 - 96)
OVERLAP_SHAPE = dict(H=700, W=256, ND=128, N_TY=4, CLAMP_HI=(700 - 208) // 32 * 32)
E_FORMS = bs.FORMS + ("i32",)
# (what, work): E at full size, grid3 with 2 frames, 2100 rows; G's window
# function and blocked at full size and at 2100 rows (a short last run, a
# clamp that repeats the last window, blocks past the plane)
WORKS = {
    "E": br.ydot_work(2160, 3840),
    "E-2frames": br.ydot_work(2160, 3840, 2, True),
    "E-2100": br.ydot_work(2100, 3840),
    "G": br.overlap_work("elem", 2160, 1920, 12),
    "G-blocked": br.overlap_work("blocked", 2160, 1920, 12),
    "G-2100": br.overlap_work("elem", 2100, 1920, 12),
    "G-blocked-2100": br.overlap_work("blocked", 2100, 1920, 12),
}


# ---- geometry ------------------------------------------------------------------

def _constexprs() -> dict[str, int]:
    body = re.search(r"namespace rg {(.*?)}  // namespace rg", SOURCE.read_text(), re.S).group(1)
    out = {}
    for stmt in re.findall(r"constexpr int ([^;]+);", body):
        for part in re.split(r",(?![^(]*\))", stmt):
            name, expr = (x.strip() for x in part.split("=", 1))
            expr = " ".join(re.sub(r"//.*", "", expr).split())
            out[name] = eval(expr, {}, dict(out))   # noqa: S307
    return out


def test_ring_record_is_the_sources():
    """:data:`RING` is the geometry ``exp_band_ring.cu`` is compiled with (on
    the card, ``iqo_exp_band_ring_shape`` says the same)."""
    k, g = _constexprs(), br.RING
    assert (k["kChunk"], k["kGroupsE"], k["kGroupsG"], k["kStagesE"], k["kStagesG"]) == \
        (g.chunk, g.groups_e, g.groups_g, g.stages_e, g.stages_g)
    assert (k["kConsumers"], k["kThreads"]) == (g.consumers, g.threads)
    assert (k["kStageE"], k["kStageG"]) == (g.stage_e, g.stage_g)
    assert (k["kEPitch"], k["kOPitch"]) == (g.e_pitch, g.g_pitch)
    assert (k["kSmemE"], k["kSmemG"]) == (g.smem_e, g.smem_g)
    assert (k["kTH"], k["kStep"], k["kBand"]) == (bs.TH, bs.STEP, bs.BAND)
    assert (k["kOTH"], k["kOStep"], k["kOBand"], k["kKD"]) == (ov.TH, ov.STEP, ov.BAND_H, ov.KD)
    assert k["kChunk"] == bs.CHUNK == ov.CHUNK


@pytest.mark.parametrize("smem", ["smem_e", "smem_g"])
def test_shared_memory_fits(smem):
    assert getattr(br.RING, smem) <= SMEM_LIMIT
    # every stage 1024-aligned: the swizzle's period
    assert br.RING.stage_e % 1024 == 0 and br.RING.stage_g % 1024 == 0


def test_perm_row_is_a_permutation_that_keeps_8_row_blocks():
    rows = [br.perm_row(k) for k in range(32)]
    assert sorted(rows) == list(range(32))
    for k in range(32):
        h, q, j = k >> 4, (k >> 2) & 3, k & 3
        assert br.perm_row(k) == 16 * h + 8 * (j >> 1) + 2 * q + (j & 1)
    # a lane's rows j = 2 m + e lie in 8-row block 2 h + m at row 2 q + e
    assert all(br.perm_row(k) % 8 == 2 * ((k >> 2) & 3) + (k & 1) for k in range(32))


def test_coefficient_layout_is_a_byte_permutation_of_each_16_columns():
    """``load_coef``'s four ``__byte_perm`` of one 16-byte load equal the
    permuted layout the model reads (:func:`_permuted_coef`)."""
    coef = np.random.default_rng(3).integers(-128, 128, (5, 128), np.int8)
    cs = br._permuted_coef(coef, 144)[:, :128]

    def byte_perm(x, y, sel):
        b = list(x.to_bytes(4, "little")) + list(y.to_bytes(4, "little"))
        return bytes(b[(sel >> (4 * i)) & 7] for i in range(4))

    for r in range(5):
        for c in range(0, 128, 16):
            v = [int.from_bytes(coef[r, c + 4 * i:c + 4 * i + 4].tobytes(), "little")
                 for i in range(4)]
            got = (byte_perm(v[0], v[2], 0x5410) + byte_perm(v[0], v[2], 0x7632)
                   + byte_perm(v[1], v[3], 0x5410) + byte_perm(v[1], v[3], 0x7632))
            assert got == cs[r, c:c + 16].tobytes()


def test_source_names_what_it_replaces():
    text = SOURCE.read_text()
    for site in ("scripts/exp_band_shape.py", ":65", ":124", ":147", "scripts/exp_i32_band.py",
                 ":94", "scripts/exp_overlap.py", ":82"):
        assert site in text
    assert "cp.async.bulk.tensor" in (SOURCE.parent / "hopper.cuh").read_text()
    assert "tma_2d(" in text and "mma.sync.aligned.m16n8k32" in text and "exp_band.cu" in text


# ---- the walk ------------------------------------------------------------------

@pytest.mark.parametrize("sms", [132, 7, 1, 5000])
@pytest.mark.parametrize("form", E_FORMS)
def test_walk_visits_every_e_item_once_in_order(form, sms):
    for h, frames in ((2160, 1), (2100, 1), (2160, 2 if form in bs.FORMS[2:] else 1)):
        work = bs.ring_work(form, h, 3840, frames)
        runs = br.ring_walk(work, br.ring_ctas(work, sms))
        seen = [i for segs in runs for _, items in segs for i in items]
        assert seen == list(range(work.items))           # each once, in order
        assert work.items == frames * 30 * ((h - 96) // 64 + 1)
        for segs in runs:
            for grp, items in segs:                      # a segment: one (frame, chunk)
                assert {i // work.per_group for i in items} == {grp}
                tiles = [i % work.per_group for i in items]
                assert tiles == list(range(tiles[0], tiles[0] + len(tiles)))


@pytest.mark.parametrize("p", ov.PS)
@pytest.mark.parametrize("variant", ov.VARIANTS)
def test_walk_visits_every_g_item_once_in_order(variant, p):
    for h in (2160, 2100, 700):
        nd, n_ty = (128, 4) if h == 700 else (1920, 12)
        work = ov.ring_work(variant, h, nd, n_ty)
        for sms in (132, 3):
            runs = br.ring_walk(work, br.ring_ctas(work, sms))
            seen = [i for segs in runs for _, items in segs for i in items]
            assert seen == list(range(work.items)) and work.items == nd // 128 * 2 * n_ty
            for segs in runs:
                for grp, items in segs:
                    tiles = [(i % work.per_group) // 2 for i in items]
                    assert tiles == sorted(tiles) and tiles[-1] - tiles[0] <= len(items) // 2 + 1


@pytest.mark.parametrize("what, want", [("E", 0.9375), ("E-2frames", 1.0),
                                        ("E-2100", 960 / 132 / 8), ("G", 360 / 132 / 3),
                                        ("G-2100", 360 / 132 / 3)])
def test_wave_efficiency(what, want):
    """The mean run over the longest on 132 SMs: E 990 items in runs of 7 or
    8; 2 frames 1980 in runs of 15; E at 2100 rows 32 tiles, 960 items;
    G 360 items of a 64-column side in runs of 2 or 3 (whole chunks: 180 in
    runs of 1 or 2, 0.68)."""
    assert br.wave_efficiency(WORKS[what]) == pytest.approx(want)
    assert br.ring_ctas(WORKS[what]) == 132


def test_sides_balance_better_than_whole_chunks():
    side = WORKS["G"]
    whole = dataclasses.replace(side, per_group=12, offs=side.offs[::2])
    assert br.wave_efficiency(whole) == pytest.approx(180 / 132 / 2)
    assert br.wave_efficiency(side) > br.wave_efficiency(whole) + 0.2


# ---- the ring --------------------------------------------------------------------

@pytest.mark.parametrize("what", list(WORKS))
def test_ring_stages_cover_each_window_exactly(what):
    """Replaying each block's loads into the stages, the stage an item reads
    holds exactly its window's source rows (E 96 rows at 64 t; G 208 rows at
    the clamped offset, or 192 at 192 t), not yet overwritten."""
    work = WORKS[what]
    e_form = what.startswith("E")
    for segs in br.ring_walk(work, br.ring_ctas(work)):
        stages = [None] * work.stages
        for e in br.ring_events(work, segs):
            if e[0] == "load":
                stages[e[1] % work.stages] = (e[1], e[2], e[3])
            elif e[0] == "item":
                grp, j = divmod(e[1], work.per_group)
                if e_form:
                    off, n_rows = 64 * j, 96
                elif what.startswith("G-blocked"):
                    off, n_rows = 192 * (j // 2), 192
                else:
                    off, n_rows = max(0, min((work.height - 208) // 32 * 32, 192 * (j // 2))), 208
                assert stages[e[2] % work.stages] == (e[2], grp, off)
                assert work.rows == n_rows
                assert work.x[grp] == 128 * (grp % 30 if e_form else grp)
                frames = 2 if what == "E-2frames" else 1
                assert work.y[grp] == ((grp // 30) * work.height // frames if e_form else 0)


@pytest.mark.parametrize("what, want", [("G-blocked", {2112}), ("G-blocked-2100", {1920, 2112})])
def test_blocked_loads_past_the_plane(what, want):
    """The last blocks' boxes run past the plane's last row (at 2100 rows the
    last starts past it): TMA fills those rows with zeros, which the function
    defines rows >= H to be."""
    work = WORKS[what]
    past = {e[3] for segs in br.ring_walk(work, 132) for e in br.ring_events(work, segs)
            if e[0] == "load" and e[3] + work.rows > work.height}
    assert past == want


def test_clamped_windows_share_their_load():
    """At 2100 rows the clamp puts tiles 10 and 11 on one window (1888): a
    run holding both loads it once for their four items; at 2160 tile 11's
    window (1952) is its own."""
    for what, off11, shared in (("G-2100", 1888, True), ("G", 1952, False)):
        work = WORKS[what]
        assert work.window(22) == work.window(23) == (0, off11)
        assert (work.window(21) == work.window(22)) == shared
        events = br.ring_events(work, [(0, list(range(18, 24)))])
        assert sum(e[0] == "load" for e in events) == (2 if shared else 3)


@pytest.mark.parametrize("what, impl, want", [
    ("base", "ring", 12_165_120), ("base", "sync", 12_165_120), ("i32", "ring", 12_165_120)])
def test_issued_bytes_of_e(what, impl, want):
    """Both forms fetch every 96-row window whole, 1.48x the 2144 rows the
    function reads (the rows shared with the previous window come again,
    mostly from L2): the script's "MB band"."""
    assert bs.issued_bytes(what, impl) == want == bs.bound("base")[4]
    assert bs.issued_bytes("grid3", frames=2) == 2 * want


def test_issued_bytes_of_g():
    """G's ring: every window of each block's run at 128 columns (runs of 2
    or 3 sides: a tile whose sides two blocks take is loaded by both);
    sync: every window at nd = 1920 columns, rows past the plane not
    fetched."""
    assert ov.issued_bytes("elem") == 6_389_760
    assert ov.issued_bytes("blocked") == 5_898_240
    assert ov.issued_bytes("elem", "sync") == ov.bound("elem", 0)[4] == 4_792_320
    assert ov.issued_bytes("elem", h=2100) == br.issued_bytes(WORKS["G-2100"], 132)


# ---- barriers ----------------------------------------------------------------------

@pytest.mark.parametrize("what", list(WORKS))
def test_every_barrier_balances_for_every_run_length(what):
    """For each block of the walk, each stage's full barrier gets one
    producer arrival and one window of bytes per load and one wait from
    every consumer thread; its empty barrier every consumer thread's arrival
    and one producer wait per load."""
    work = WORKS[what]
    lengths = set()
    for segs in br.ring_walk(work, br.ring_ctas(work)):
        lengths.add(sum(len(items) for _, items in segs))
        for stage in br.barrier_schedule(work, segs).values():
            n = stage["loads"]
            assert stage["tx_bytes"] == n * work.rows * 128
            assert stage["full_arrivals"] == stage["empty_waits"] == n
            assert stage["full_waits"] == n                     # per consumer thread
            assert stage["empty_arrivals"] == br.RING.consumers * n
    assert len(lengths) >= 2 or what == "E-2frames"


@pytest.mark.parametrize("sms", [132, 61, 7])
@pytest.mark.parametrize("what", ["E", "G", "G-2100", "G-blocked-2100"])
def test_barriers_run_to_the_end_in_any_order(what, sms):
    """The producer and the eight consumer warps on model mbarriers, round
    robin and in two random orders: no deadlock, and no item reads a slot
    whose slab was replaced."""
    work = WORKS[what]
    runs = br.ring_walk(work, br.ring_ctas(work, sms))
    for segs in (runs[0], runs[len(runs) // 2], runs[-1]):
        for seed in (None, 1, 2):
            assert br.run_barriers(work, segs, seed) > 0


def test_barrier_model_catches_a_missing_release():
    work = WORKS["E"]
    segs = br.ring_walk(work, 7)[0]
    events = br.ring_events(work, segs)
    drop = next(e for e in events if e[0] == "release")
    original = br.ring_events
    try:
        br.ring_events = lambda w, s: [e for e in original(w, s) if e != drop]
        with pytest.raises(AssertionError, match="deadlock"):
            br.run_barriers(work, segs)
    finally:
        br.ring_events = original


# ---- banks ---------------------------------------------------------------------------

@pytest.mark.parametrize("wide", [False, True], ids=["packed", "wide"])
@pytest.mark.parametrize("warp", range(4))
def test_fragment_reads_hit_distinct_banks(warp, wide):
    """Each 4-byte B-fragment load of a warp (fixed h, j): lane (g, q) reads
    window row perm_row(16 h + 4 q + j) at chunk column 4 word_col(warp, g)
    of a 128-byte-swizzled window: one bank per lane, in both lane
    mappings.  Without the permutation (rows 16 h + 4 q + j) the same loads
    are 2-way."""
    for h in range(2):
        for j in range(4):
            for kb in (0, 8, 16, 24, 32, 88):            # G's K steps start at 8 i + 32 ks
                rows = [kb + br.perm_row(16 * h + 4 * (lane % 4) + j) for lane in range(32)]
                col = lambda lane: 4 * br.word_col(wide, warp, lane // 4)  # noqa: E731
                assert br.banks(128, rows, col) == 1
                plain = [kb + 16 * h + 4 * (lane % 4) + j for lane in range(32)]
                assert br.banks(128, plain, col) == 2


@pytest.mark.parametrize("wide", [False, True], ids=["packed", "wide"])
def test_word_columns_and_stores(wide):
    """Each warp's mma n indices take the 8 word columns of its 32 chunk
    columns once; a lane's sums for n = 2 q + ec land in 4 adjacent columns.
    A quad's store for one (row, ec) covers whole 32-byte sectors: with
    ``wide`` 16-byte i32 stores, 64 contiguous bytes; else 8-byte u8 stores
    of both ec, 32 contiguous bytes (the first mapping's i32 stores covered
    every other 16 bytes)."""
    for wl in range(4):
        assert sorted(br.word_col(wide, wl, n) for n in range(8)) == list(range(8 * wl, 8 * wl + 8))
        for ec in range(2):
            cols = sorted(4 * br.word_col(wide, wl, 2 * q + ec) + p for q in range(4)
                          for p in range(4))
            if wide:      # one int4 a lane: the quad's 16 columns side by side
                assert cols == list(range(cols[0], cols[0] + 16)) and (4 * cols[0]) % 64 == 0
        if not wide:      # one uint2 a lane: bytes of both ec, 32 side by side
            cols = sorted(4 * br.word_col(wide, wl, 2 * q + ec) + p for q in range(4)
                          for ec in range(2) for p in range(4))
            assert cols == list(range(32 * wl, 32 * wl + 32))
    # the first mapping with one int4 a lane: 16 bytes, then a gap of 16
    first = sorted(4 * br.word_col(False, 0, 2 * q) + p for q in range(4) for p in range(4))
    assert first == [c + 8 * q for q in range(4) for c in range(4)]


@pytest.mark.parametrize("pitch, rows", [(br.RING.e_pitch, 32), (br.RING.g_pitch, 96)])
def test_a_fragment_reads_hit_distinct_banks(pitch, rows):
    for base in range(0, rows - 16 + 1, 16):
        for i in range(4):
            for ks in range(3):
                r = [base + (lane // 4) + 8 * (i & 1) for lane in range(32)]
                assert br.banks(pitch, r, lambda lane: 32 * ks + 16 * (i >> 1) + 4 * (lane % 4),
                                swizzle=False) == 1


# ---- the model against the scripts -----------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shrunk(monkeypatch, name, port, shape):
    mod = _script(name)
    for k, v in shape.items():
        monkeypatch.setattr(mod, k, v)
        if hasattr(port, k):
            monkeypatch.setattr(port, k, v)
    return mod


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("form", E_FORMS)
def test_e_model_equals_the_script(monkeypatch, interpret, form, sms):
    """The ring form's model (walk, ring, permuted K steps) == the script's
    Pallas kernel in interpret mode, 320 x 256: 8 items, in runs that cross
    a chunk at 3 SMs."""
    if form == "i32":
        mod = _shrunk(monkeypatch, "exp_i32_band", ib,
                      {k: BAND_SHAPE[k] for k in ("H", "W", "N_T")})
        coef, src = ib.inputs("cpu")
        words = ib.to_words(src)
        want = np.asarray(mod.build_i32(coef.numpy())(coef.numpy(), words.numpy()))
    else:
        mod = _shrunk(monkeypatch, "exp_band_shape", bs, BAND_SHAPE)
        coef, src = bs.inputs("cpu")
        ops = bs.operands("cpu", BAND_SHAPE["N_T"], seed=7)
        call, ndim = mod.build(form, coef.numpy())
        x = src.numpy() if ndim == 2 else src.numpy()[None]
        extra = ([ops.slab.numpy()] if form == "vmem" else []) + \
            ([r.numpy() for r in ops.rows] + [c.numpy() for c in ops.cols]
             if form in ("streams", "vmem") else [])
        want = np.asarray(call(coef.numpy(), x, *extra))
    npops = (([r.numpy() for r in ops.rows], [c.numpy() for c in ops.cols], ops.slab.numpy())
             if form in ("streams", "vmem") else None)
    x = src.numpy() if form in ("base", "arb", "i32") else src.numpy()[None]
    got = br.ydot_model(coef.numpy(), x, form, npops, sms=sms)
    assert got.dtype == want.dtype and got.shape == want.shape
    if form == "vmem":
        want = want & 255                # the script's vmem: r & 255 in int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", ov.PS)
@pytest.mark.parametrize("variant", ov.VARIANTS)
def test_g_model_equals_the_script(monkeypatch, interpret, variant, p):
    """G's ring model == the script in interpret mode at 700 x 256, nd 128,
    4 tiles (blocked's last block runs 68 rows past the plane), on 3 SMs."""
    mod = _shrunk(monkeypatch, "exp_overlap", ov, OVERLAP_SHAPE)
    src, coef = ov.inputs("cpu")
    want = np.asarray(mod.build(variant, p)(src.numpy(), coef.numpy()))
    got = br.overlap_model(src.numpy(), coef.numpy(), variant, p, 128, 4, sms=3)
    np.testing.assert_array_equal(got, want)


def test_models_read_the_noise_of_a_wrong_row():
    """The model's stages start as noise and each read goes through the
    swizzle: reading the wrong rows changes the output (the check is not
    vacuous)."""
    coef, src = bs.inputs("cpu")
    x = src.numpy()[:320, :256]
    good = br.ydot_model(coef.numpy(), x, "base", sms=3)
    original = br._RingBytes.rows

    def shifted(self, n, wr):
        return original(self, n, (wr + 16) % 96)
    try:
        br._RingBytes.rows = shifted
        assert not np.array_equal(br.ydot_model(coef.numpy(), x, "base", sms=3), good)
    finally:
        br._RingBytes.rows = original


@pytest.mark.parametrize("h", [2100, 700])
@pytest.mark.parametrize("variant", ["elem", "blocked"])
def test_g_model_equals_plain_at_a_short_last_run(variant, h):
    src, coef = ov.inputs("cpu")
    s = src[:h, :256].contiguous()
    nd, n_ty = (128, 4) if h == 700 else (256, 12)
    got = br.overlap_model(s.numpy(), coef.numpy(), variant, 8, nd, n_ty, sms=5)
    np.testing.assert_array_equal(got, ov.overlap_dots_plain(s, coef, variant, 8, nd, n_ty).numpy())


def test_e_model_equals_plain_on_two_frames():
    coef, src = bs.inputs("cpu")
    two = torch.stack([src[:320, :256], src[:320, :256].flip(0)]).contiguous()
    got = br.ydot_model(coef.numpy(), two.numpy(), "grid3", sms=5)
    np.testing.assert_array_equal(got, bs.band_ydot_plain(coef, two, "grid3").numpy())


# ---- library calls -------------------------------------------------------------------

def test_e_library_equals_plain():
    coef, src = bs.inputs("cpu")
    s = src[:320, :256].contiguous()
    got = bs.library_rows(bs.library(coef, bs.library_operand(s)), 256)
    assert torch.equal(got, bs.band_ydot_plain(coef, s, "base"))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["elem", "blocked"])
def test_g_library_equals_plain(variant, p):
    src, coef = ov.inputs("cpu")
    s = src[:700, :256].contiguous()
    got = ov.library_rows(ov.library(coef, ov.library_operand(s, variant, p, 128, 4)), 128)
    assert torch.equal(got, ov.overlap_dots_plain(s, coef, variant, p, 128, 4))


# ---- wrappers --------------------------------------------------------------------------

def test_impls_and_launch_keys():
    assert bs.IMPLS == ov.IMPLS == ("ring", "sync")
    assert set(bs.LAUNCHES) == set(E_FORMS) | {f"{f}[ring]" for f in E_FORMS}
    assert set(ov.LAUNCHES) == {f"{v},P={p}{s}" for v in ov.VARIANTS for p in ov.PS
                                for s in ("", "[ring]")}
    assert bs.launch_key("vmem", "ring") == "vmem[ring]" and bs.launch_key("vmem", "sync") == "vmem"
    assert ov.launch_key("elem", 8, "ring") == "elem,P=8[ring]"


@pytest.mark.parametrize("impl", [None, "ring", "sync"])
def test_every_impl_runs_the_plain_version_on_cpu(impl):
    bs.reset_launches()
    ov.reset_launches()
    coef, src = bs.inputs("cpu")
    s = src[:160, :256].contiguous()
    assert torch.equal(bs.band_ydot(coef, s, "base", impl=impl),
                       bs.band_ydot_plain(coef, s, "base"))
    assert torch.equal(bs.band_ydot(coef, ib.to_words(s), "i32", impl=impl),
                       bs.band_ydot_plain(coef, ib.to_words(s), "i32"))
    osrc, ocoef = ov.inputs("cpu")
    o = osrc[:208].contiguous()
    assert torch.equal(ov.overlap_dots(o, ocoef, "parallel", 1, 128, 1, impl=impl),
                       ov.overlap_dots_plain(o, ocoef, "parallel", 1, 128, 1))
    assert bs.LAUNCHES.total() == ov.LAUNCHES.total() == 0


@pytest.mark.parametrize("impl", ["", "tma", "RING"])
def test_refuses_an_unknown_impl(impl):
    coef, src = bs.inputs("cpu")
    with pytest.raises(ValueError, match="impls are"):
        bs.band_ydot(coef, src[:160, :256], "base", impl=impl)
    osrc, ocoef = ov.inputs("cpu")
    with pytest.raises(ValueError, match="impls are"):
        ov.overlap_dots(osrc[:208], ocoef, "elem", 1, 128, 1, impl=impl)
    for issued in (lambda: bs.issued_bytes("base", impl), lambda: ov.issued_bytes("elem", impl)):
        with pytest.raises(ValueError, match="impls are"):
            issued()


def test_ring_library_checks_the_compiled_geometry(monkeypatch):
    """``ring_lib`` compares ``iqo_exp_band_ring_shape`` with :data:`RING`
    and refuses a library built with another geometry."""
    class Lib:
        def __init__(self, shape):
            self.shape = shape

        def iqo_exp_band_ring_shape(self, out):
            for i, v in enumerate(self.shape):
                out[i] = v
    g = br.RING
    good = [g.chunk, g.threads, g.groups_e, g.groups_g, g.stages_e, g.stages_g, g.smem_e,
            g.smem_g]
    for shape, ok in ((good, True), (good[:4] + [4] + good[5:], False)):
        bs.ring_lib.cache_clear()
        monkeypatch.setattr(_harness, "lib_with_setup", lambda sym, dev, s=shape: Lib(s))
        if ok:
            assert bs.ring_lib(torch.device("cpu")).shape == good
        else:
            with pytest.raises(RuntimeError, match="geometry"):
                bs.ring_lib(torch.device("cpu"))
    bs.ring_lib.cache_clear()


# ---- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ring kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ring_equals_plain_on_card(cuda_device):
    coef, src = (t.to(cuda_device) for t in bs.inputs("cpu"))
    ops = bs.operands(cuda_device, seed=7)
    for form in bs.FORMS:
        x = src[None] if form in bs.FORMS[2:] else src
        o = ops if form in ("streams", "vmem") else None
        assert torch.equal(bs.band_ydot(coef, x, form, o, impl="ring"),
                           bs.band_ydot_plain(coef, x, form, o)), form
    osrc, ocoef = (t.to(cuda_device) for t in ov.inputs("cpu"))
    for h in (2160, 2100):
        s = osrc[:h].contiguous()
        for variant in ov.VARIANTS:
            for p in ov.PS:
                assert torch.equal(ov.overlap_dots(s, ocoef, variant, p, impl="ring"),
                                   ov.overlap_dots_plain(s, ocoef, variant, p))


# ---- the ablation tool ------------------------------------------------------------

@pytest.mark.parametrize("variant", list(band_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_source(variant):
    """Each variant's texts are in the kernel source once, and none touches a
    barrier, a wait or a copy (every variant runs the whole schedule)."""
    text = band_ablate.variant_source(variant)
    for call in ("mbar_wait(", "mbar_arrive(", "mbar_expect(", "tma_2d(", "mbar_init("):
        assert text.count(call) == SOURCE.read_text().count(call), (variant, call)
    assert (text == SOURCE.read_text()) == (variant == "kernel")


def test_ablation_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        band_ablate.main([])
    with pytest.raises(SystemExit, match="unknown variants"):
        band_ablate.main(["no_such_stage"])
