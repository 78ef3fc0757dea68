"""Kernel D's ``wgmma`` form (``libiqo_tpu_torch/csrc/exp/exp_banded_wgmma.cu``,
``exp_banded_dots.banded_tile(..., form="wgmma")``) on the CPU: its geometry
against the source's constants, the shared-memory budget, both kernels'
walks, the X kernel's ring on model mbarriers (every block's walk run to its
end), the Y kernel's ``ldmatrix.trans`` fragments and K steps, a NumPy model
of both kernels against ``banded_tile_plain`` in all nine modes and against
the TPU script's Pallas kernel in interpret mode, and the wrapper's forms,
launch keys and refusals.

Tolerance 0, bit for bit: the inputs are integers and every f32 sum of
|products| stays below 2^24 (the plain version and the model assert it), so
any order of summation, the tensor cores' included, is exact.  The kernels
run only on the card: that test is ``cuda``-marked and skips without one.
The ablation tool (``tools/banded_ablate.py``) is checked for what it
changes in the source.
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import banded_wgmma as bw
from libiqo_tpu_torch.experiments import exp_banded_dots as bd
from libiqo_tpu_torch.ops import _build
from libiqo_tpu_torch.tools import banded_ablate

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_banded_wgmma.cu"
SMEM_LIMIT = 232_448        # bytes of shared memory one block may use (H100)
PAIR_IDS = [f"{y}-{x}" for y, x in bd.PAIRS]


@pytest.fixture(scope="module", params=[2, 3], ids=["grid2", "grid3"])
def inputs(request):
    """The script's draws at 2 and 3 tiles: 320 and 480 work rows, so the
    X kernel's last item is partly rows past the end."""
    band, cy, cxs = bd.inputs("cpu", request.param)
    ops = bd.pack(cy, *cxs)
    cxt = np.stack([c.to(torch.float32).numpy() for c in ops.cxt])
    return band, ops, cy.to(torch.float32).numpy(), cxt


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of this test in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# ---- geometry ------------------------------------------------------------------

def _constexprs() -> dict[str, int]:
    body = re.search(r"namespace gd {(.*?)}  // namespace gd", SOURCE.read_text(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = {}
    for stmt in re.findall(r"constexpr int (\w+ = [^;{]+);", body):
        for part in stmt.split(","):
            name, expr = (x.strip() for x in part.split("="))
            out[name] = eval(expr.replace("/", "//"), {}, dict(out))   # noqa: S307
    return out


def test_host_geometry_is_the_sources():
    """The host's :data:`banded_wgmma.GEOMETRY` is the one the source is
    compiled with (on the card, ``iqo_exp_banded_wgmma_shape`` says the
    same), and the source's shapes are the probe's."""
    k = _constexprs()
    g = bw.GEOMETRY
    assert (k["kTH"], k["kBH"], k["kBW"], k["kTW"]) == (bd.TH, bd.BH, bd.BW, bd.TW)
    assert (k["kYThreads"], k["kYCols"], k["kYChunk"], k["kYChunks"], k["kCyKBlocks"]) == \
        (g.y_threads, g.y_cols, g.y_chunk, g.y_chunks, g.cy_kblocks)
    assert (k["kStagePitch"], k["kOutPitch"], k["kYSmem"]) == (g.y_stage_pitch, g.y_out_pitch,
                                                                g.y_smem)
    assert (k["kXRows"], k["kXCols"], k["kXKC"], k["kXStages"], k["kXConsumers"]) == \
        (g.x_rows, g.x_cols, g.x_kc, g.x_stages, g.x_consumers)
    assert (k["kXThreads"], k["kXStage"], k["kXSmem"]) == (g.x_threads, g.x_stage, g.x_smem)
    assert (k["kYGroupRows"], k["kYGroupK"]) == (40, 96)


def test_shared_memory_fits():
    """Y: cy^T (6 K blocks of 160 x 128 bytes), two warpgroups' two bf16
    stages and item staging; X: 4 stages of 128 work rows and three 64-row
    coefficient boxes, their barriers: one block an SM each."""
    g = bw.GEOMETRY
    assert g.y_smem == 6 * 160 * 128 + 4 * 64 * 144 + 2 * 160 * 144 + 1024 == 206_848
    assert g.x_smem == 4 * (128 * 128 + 3 * 64 * 128) + 64 + 1024 == 164_928
    assert max(g.y_smem, g.x_smem) <= SMEM_LIMIT


@pytest.mark.parametrize("tiles", [1, 2, 3, 35])
@pytest.mark.parametrize("xskip", [False, True])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_y_walk_covers_every_item_once(tiles, xskip, sms):
    """Every (tile, 64-column block) Y item once, each warpgroup of each
    block with at least one (its first item waits for cy^T with the other
    warpgroup's)."""
    ctas = bw.y_ctas(tiles, xskip, sms)
    runs = bw.y_walk(tiles, xskip, ctas)
    assert len(runs) == 2 * ctas and all(runs)
    items = sorted(i for r in runs for i in r)
    cols = range(0, 384 if xskip else 896, 64)
    assert items == sorted((t, c) for t in range(tiles) for c in cols)


@pytest.mark.parametrize("tiles", [1, 2, 3, 35])
@pytest.mark.parametrize("sms", [1, 5, 132])
def test_x_walk_covers_every_item_once(tiles, sms):
    runs = bw.x_walk(tiles, bw.x_ctas(tiles, sms))
    items = [i for r in runs for i in r]
    assert items == bw.x_items(tiles) and all(runs)
    assert len(items) == 6 * -(-tiles * 160 // 128)


def test_the_x_walk_is_one_wave_at_35_tiles():
    assert len(bw.x_items(35)) == 264 and bw.x_ctas(35) == 132
    assert bw.wave_efficiency(35) == 1.0
    assert bw.y_ctas(35, False) == 132 and bw.y_items(35, False) == 490


@pytest.mark.parametrize("tiles", [2, 3, 35])
@pytest.mark.parametrize("grouped", [False, True], ids=["mono", "grouped"])
@pytest.mark.parametrize("seed", [None, 1, 2])
def test_every_blocks_ring_runs_to_its_end(tiles, grouped, seed):
    """The producer and the eight consumer warps of every block of the X
    walk on model mbarriers, round robin and at random: no deadlock, and
    every chunk read from the stage that holds it."""
    for run in bw.x_walk(tiles, bw.x_ctas(tiles)):
        assert bw.run_barriers(run, grouped, seed) > 0


def test_the_ring_model_catches_a_wrong_stage(monkeypatch):
    """A producer that loads the chunks in another order than the
    consumers read them is caught."""
    run = bw.x_walk(3, bw.x_ctas(3))[0]
    events = bw.x_ring_events(run, False)
    assert [e[0] for e in events].count("load") == 14
    loads = [e for e in events if e[0] == "load"]
    swapped = [(*loads[1][:2], *loads[0][2:]), (*loads[0][:2], *loads[1][2:])] + loads[2:]
    monkeypatch.setattr(bw, "x_ring_events", lambda r, g: swapped)
    with pytest.raises(AssertionError, match="read stage"):
        bw.run_barriers(run, False)


def test_x_chunks_are_the_windows():
    assert bw.x_chunks(0, False) == list(range(0, 896, 64))
    assert [bw.x_chunks(cb, True)[0] for cb in range(6)] == [0, 0, 128, 128, 384, 384]
    assert all(len(bw.x_chunks(cb, True)) == 6 for cb in range(6))
    for o0, ol, k0, kl in bd.XGRP:
        assert bw.x_chunks(o0 // 64, True) == list(range(k0, k0 + kl, 64))


def test_issued_bytes_from_the_walks():
    """Mono reads the work rows 6 times and each 64-column block of the
    coefficients once an item: 91 MB of coefficients against the sync
    form's 722 MB."""
    b = bw.issued_bytes(35, "mono")
    assert b["x_work"] == 6 * 44 * 14 * 128 * 128
    assert b["x_coefficients"] == 264 * 14 * 3 * 64 * 128 < 722e6 / 7
    assert b["y"] == 490 * 336 * 64 + 132 * 160 * 336 * 2
    assert bw.issued_bytes(35, "grouped")["x_coefficients"] == 264 * 6 * 3 * 64 * 128
    assert bw.issued_bytes(35, "skip")["x_work"] == 0


# ---- the Y kernel's fragments and K steps ------------------------------------------

@pytest.mark.parametrize("kl", range(4))
@pytest.mark.parametrize("m0", [0, 16, 32, 48])
def test_ldmatrix_trans_gives_the_fragments_of_band_transposed(kl, m0):
    """``ldmatrix.x4.trans`` on the stage (rows k, columns m) hands lane
    (g, q) the A fragment of band^T: registers (g, 2 q), (g + 8, 2 q),
    (g, 2 q + 8), (g + 8, 2 q + 8), each with its k + 1 neighbour."""
    stage = np.random.default_rng(kl).integers(0, 256, (64, 64))
    a = stage[16 * kl:16 * kl + 16, m0:m0 + 16].T             # A[m][k]
    frag = bw.a_fragment(stage, kl, m0)
    for lane in range(32):
        g, q = lane // 4, lane % 4
        want = [(a[g + 8 * (i & 1), 2 * q + 8 * (i >> 1)],
                 a[g + 8 * (i & 1), 2 * q + 8 * (i >> 1) + 1]) for i in range(4)]
        assert [tuple(frag[lane, i]) for i in range(4)] == want


@pytest.mark.parametrize("kl", range(4))
def test_ldmatrix_rows_hit_distinct_banks(kl):
    """Each 8 x 8 matrix's 8 row addresses (16 bytes each) at the stage's
    pitch of 144 bytes cover 32 distinct banks: no conflict."""
    g = bw.GEOMETRY
    for m0 in (0, 16, 32, 48):
        for i in range(4):
            banks = set()
            for r in range(8):
                k, c = bw.ldmatrix_trans_rows(8 * i + r, kl, m0)
                addr = k * g.y_stage_pitch + 2 * c
                banks |= {(addr // 4 + w) % 32 for w in range(4)}
            assert len(banks) == 32


def test_y_steps_mono_and_grouped():
    """Mono: one n160 a K step, 21 steps; grouped: each group of 40 rows on
    its window's 6 K steps only, 24 n40 products (the TPU's grouped work)."""
    mono = bw.y_steps("mono")
    assert [ks for _, ks, _, _ in mono] == list(range(21)) and {(n0, n) for *_, n0, n in mono} == \
        {(0, 160)}
    grouped = bw.y_steps("grouped")
    assert len(grouped) == 24
    for o0, ol, k0, kl in bd.YGRP:
        assert [ks for _, ks, n0, _ in grouped if n0 == o0] == list(range(k0 // 16,
                                                                          (k0 + kl) // 16))
    assert all(c == ks // 4 for c, ks, _, _ in mono + grouped)


# ---- the model -------------------------------------------------------------------

@pytest.mark.parametrize("ymode, xmode", bd.PAIRS, ids=PAIR_IDS)
def test_model_equals_plain(inputs, ymode, xmode):
    band, ops, cy, cxt = inputs
    np.testing.assert_array_equal(bw.model(band.numpy(), cy, cxt, ymode, xmode),
                                  bd.banded_tile_plain(ops, band, ymode, xmode).numpy())


@pytest.mark.parametrize("ymode, xmode", [("mono", "mono"), ("grouped", "grouped"),
                                          ("skip", "grouped")], ids=["mono-mono",
                                                                     "grouped-grouped",
                                                                     "skip-grouped"])
def test_model_equals_the_script(monkeypatch, interpret, ymode, xmode):
    spec = importlib.util.spec_from_file_location(
        "_tpu_exp_banded_dots", ROOT / "scripts" / "exp_banded_dots.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "GRID", 2)
    band, cy, cxs = bd.inputs("cpu", 2)
    jcy, *jcx = (jnp.asarray(t.float().numpy(), dtype=mod.BF) for t in (cy, *cxs))
    want = np.asarray(mod.make(ymode, xmode)(band.numpy(), jcy, *jcx))
    ops = bd.pack(cy, *cxs)
    cxt = np.stack([c.to(torch.float32).numpy() for c in ops.cxt])
    np.testing.assert_array_equal(bw.model(band.numpy(), cy.float().numpy(), cxt, ymode, xmode),
                                  want)


def test_model_refuses_sums_past_2_24():
    """w = 127 * 257 everywhere (a = b = 127): the a + b plane's X sums
    pass 2^24, where the tensor cores' order would matter."""
    band = np.ones((1, 336, 896), np.uint8)
    cy = np.zeros((160, 336))
    cy[:, :257] = 127
    cxt = np.full((3, 384, 896), -128.0)
    with pytest.raises(AssertionError, match="2\\^24"):
        bw.model(band, cy, cxt, "mono", "mono")


# ---- the wrapper -----------------------------------------------------------------

def test_forms_and_launch_keys():
    assert bd.FORMS == ("wgmma", "sync")
    assert bd.launch_key("mono", "mono", "wgmma") == "mono,mono[wgmma]"
    assert bd.launch_key("grouped", "skip", "sync") == "grouped,skip"
    assert set(bd.LAUNCHES) == {f"{y},{x}{s}" for y, x in bd.PAIRS for s in ("", "[wgmma]")}


@pytest.mark.parametrize("form", ["nope", "mma_sync", ""])
def test_banded_tile_refuses_a_bad_form(form):
    band, cy, cxs = bd.inputs("cpu", 1)
    with pytest.raises(ValueError, match="forms are"):
        bd.banded_tile(bd.pack(cy, *cxs), band, "mono", "mono", form)


@pytest.mark.parametrize("form", [None, "wgmma", "sync"])
def test_every_form_runs_the_plain_version_on_cpu(form):
    bd.reset_launches()
    band, cy, cxs = bd.inputs("cpu", 1)
    ops = bd.pack(cy, *cxs)
    assert torch.equal(bd.banded_tile(ops, band, "grouped", "mono", form),
                       bd.banded_tile_plain(ops, band, "grouped", "mono"))
    assert bd.LAUNCHES.total() == 0


def test_source_names_what_it_replaces():
    head = SOURCE.read_text().split("#include")[0]
    for ref in ("scripts/exp_banded_dots.py", "at :92", ":150-155", ":39-40", "exp_banded.cu",
                "wgmma", "722 MB", "two launches"):
        assert ref in head


# ---- the ablation tool ------------------------------------------------------------

@pytest.mark.parametrize("variant", list(banded_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_source(variant):
    """Each variant's texts are in the kernel source once, and none removes
    a barrier or a wait (every variant runs the whole schedule)."""
    text = banded_ablate.variant_source(variant)
    source = SOURCE.read_text()
    for call in ("mbar_wait(", "mbar_arrive(", "mbar_expect(", "tma_2d(", "wgmma_wait<",
                 "cp_wait<", "named_sync(", "__syncthreads()", "wg_sync()"):
        assert text.count(call) == source.count(call), (variant, call)
    assert (text == source) == (variant == "kernel")


def test_probe_signatures_cover_every_entry_point():
    """The ablation tool binds its variants through the probe library's one
    table of signatures, which names every entry point of the sources."""
    exported = {m for f in _build.exp_sources() if f.suffix == ".cu"
                for m in re.findall(r"^(?:int|const char\*) (iqo_exp_\w+)\(",
                                    f.read_text(), re.M)}
    assert {name for name, _ in _build._exp_signatures()} | {"iqo_exp_error_string"} == exported


def test_a_partial_bind_declares_only_what_it_names():
    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, type("Fn", (), {})())

    lib = Lib()
    _build.bind_experiments(lib, ("iqo_exp_banded_wgmma", "iqo_exp_banded_wgmma_setup"))
    assert set(lib.fns) == {"iqo_exp_banded_wgmma", "iqo_exp_banded_wgmma_setup"}
    assert len(lib.fns["iqo_exp_banded_wgmma"].argtypes) == 13
    assert lib.fns["iqo_exp_banded_wgmma_setup"].argtypes == []
    assert all(f.restype is ctypes.c_int for f in lib.fns.values())


def test_ablation_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        banded_ablate.main([])
    with pytest.raises(SystemExit, match="unknown variants"):
        banded_ablate.main(["no_such_stage"])


# ---- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the wgmma form's kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [3, bd.GRID])
def test_wgmma_equals_plain_on_card(cuda_device, tiles):
    band, cy, cxs = bd.inputs(cuda_device, tiles)
    ops = bd.pack(cy, *cxs)
    for y, x in bd.PAIRS:
        assert torch.equal(bd.banded_tile(ops, band, y, x, "wgmma"),
                           bd.banded_tile_plain(ops, band, y, x))
