"""Kernel L's wgmma form (``libiqo_tpu_torch/csrc/exp/exp_slice_wgmma.cu``,
``exp_slice_align.slice_groups(..., form="wgmma")``) on the CPU: its
geometry against the source's constants, the shared-memory budget, the
persistent walk over (window, M tile), the split's bit operations on every
int16, a NumPy model of the tile schedule against ``slice_groups_plain`` and
against the TPU script's Pallas kernel in interpret mode, the library calls
that rank it, and the forms, launch keys and refusals of the wrapper.

Tolerance 0, bit for bit: the inputs are integers and every f32 sum of
|products| stays below 2^24 (the plain version asserts it), so any order of
summation, the tensor cores' included, is exact.  The kernel itself runs
only on the card: that test is ``cuda``-marked and skips without one.  The
ablation tool (``tools/slice_ablate.py``) is checked for what it changes in
the source.
"""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import _harness
from libiqo_tpu_torch.experiments import exp_slice_align as sa
from libiqo_tpu_torch.tools import slice_ablate

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_slice_wgmma.cu"
SMEM_LIMIT = 232_448        # bytes of shared memory one block may use (H100)
CONFIG_IDS = [f"{a}-{kl}" for a, kl in sa.CONFIGS]


@pytest.fixture(scope="module")
def inputs3():
    """The script's draws at 3 steps: an odd step count, so the last M tile
    is half rows past the end."""
    w, ops = sa.inputs("cpu", grid=3)
    c = np.stack([x.to(torch.float32).numpy().astype(np.float64) for x in ops.c])
    return w, ops, c


# ---- geometry ------------------------------------------------------------------

def _constexprs() -> dict[str, int]:
    body = re.search(r"namespace gl {(.*?)}  // namespace gl", SOURCE.read_text(), re.S).group(1)
    out = {}
    for stmt in re.findall(r"constexpr int ([^;]+);", body):
        for part in stmt.split(","):
            name, expr = (x.strip() for x in part.split("="))
            expr = " ".join(re.sub(r"//.*", "", expr).split())
            out[name] = eval(expr, {}, dict(out))   # noqa: S307
    return out


def test_host_geometry_is_the_sources():
    """The host's :data:`WGMMA` is the geometry ``exp_slice_wgmma.cu`` is
    compiled with (on the card, ``iqo_exp_slice_wgmma_shape`` says the
    same), and the source's shapes are the module's."""
    k = _constexprs()
    g = sa.WGMMA
    assert (k["kBM"], k["kBN"], k["kKC"], k["kMaxChunks"], k["kStages"], k["kConsumers"]) == \
        (g.bm, g.bn, g.kc, g.max_chunks, g.stages, g.consumers)
    assert (k["kThreads"], k["kTileBytes"], k["kWinBytes"], k["kStageBytes"], k["kBarriers"],
            k["kSmem"]) == (g.threads, g.tile_bytes, g.window_bytes, g.stage_bytes, g.barriers,
                            g.smem)
    assert (k["kTH"], k["kBW"], k["kTWF"], k["kGN"], k["kGroups"], k["kWindows"]) == \
        (sa.TH, sa.BW, sa.TWF, sa.GN, sa.N_GROUPS, g.windows)


@pytest.mark.parametrize("kl", sorted({kl for _, kl in sa.CONFIGS}))
def test_shared_memory_fits(kl):
    """The window at kl (196,608 bytes at 512, 147,456 at 384), the two
    consumers' rings of 2 stages of 8 KB, the barriers and the 1024-byte
    alignment slack fit one block's 232,448 bytes; every swizzled tile
    starts 1024-aligned."""
    g = sa.WGMMA
    window = 3 * g.bn * kl * 2
    assert window == {512: 196_608, 384: 147_456}[kl]
    assert kl % g.kc == 0 and kl // g.kc <= g.max_chunks
    assert window <= g.window_bytes
    assert g.smem == 196_608 + 2 * 2 * 8_192 + 24 * 8 + 1024 == 230_592 <= SMEM_LIMIT
    assert g.tile_bytes % 1024 == 0 and g.stage_bytes % 1024 == 0 and g.window_bytes % 1024 == 0
    assert g.threads == 320


@pytest.mark.parametrize("steps, sms", [(34, 132), (35, 132), (2, 132), (34, 2), (35, 7),
                                        (1, 132), (34, 510)])
def test_persistent_walk_covers_every_tile_once(steps, sms):
    ctas = sa.wgmma_ctas(steps, sms)
    mt = -(-steps // 2)
    assert sa.wgmma_tiles(steps) == 30 * mt and ctas == min(sms, 30 * mt)
    walk = sa.wgmma_walk(steps, ctas)
    seen = [t for run in walk for t in run]
    assert len(seen) == len(set(seen)) == 30 * mt
    assert set(seen) == {(win, m) for win in range(30) for m in range(mt)}
    runs = [len(r) for r in walk]
    assert max(runs) - min(runs) <= 1 and min(runs) >= 1
    # contiguous runs of the window-major order
    order = [win * mt + m for run in walk for win, m in run]
    assert order == list(range(30 * mt))


@pytest.mark.parametrize("steps, sms, want", [
    (34, 132, 510 / 132 / 4),       # runs of 3 and 4: one wave, 0.966
    (35, 132, 540 / 132 / 5),       # runs of 4 and 5: the partial last wave, 0.818
    (2, 132, 1.0),                  # 30 tiles, 30 blocks of one
    (34, 2, 1.0)])                  # 255 tiles a block
def test_wave_efficiency(steps, sms, want):
    assert sa.wave_efficiency(steps, sms) == pytest.approx(want)


@pytest.mark.parametrize("steps", [34, 35])
def test_a_block_loads_at_most_two_windows(steps):
    walk = sa.wgmma_walk(steps, sa.wgmma_ctas(steps, 132))
    assert max(len({win for win, _ in run}) for run in walk) == 2


def test_issued_bytes_of_the_wgmma_form():
    """At 34 steps on 132 SMs: 150 window loads (132 blocks, 18 of them
    crossing into a second window) and every M tile's rows once per
    window; about 73 % of the mma_sync form's copies."""
    per_window = 3 * 64 * 512 * 2
    rows = 34 * 32 * 30 * 512 * 2
    assert sa.issued_bytes(512, form="wgmma") == 150 * per_window + rows == 62_914_560
    assert sa.issued_bytes(512) == 86_507_520
    assert sa.issued_bytes(384, form="wgmma") == 150 * 3 * 64 * 384 * 2 + 34 * 32 * 30 * 384 * 2
    # rows past the last step are not read
    assert sa.issued_bytes(512, steps=35, form="wgmma") % (512 * 2) == 0


# ---- the split ------------------------------------------------------------------

def test_split_is_exact_on_every_int16():
    """The kernel's masks and bf16x2 arithmetic give a, b and a + b of every
    int16 exactly, as the plain version's integer split."""
    w = np.arange(-2**15, 2**15, dtype=np.int64).astype(np.int16)
    bits = sa.split_bf16(w)
    for got, want in zip(bits, sa.split(torch.from_numpy(w))):
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(sa._bf16_value(got), want.numpy().astype(np.float64))


def test_split_reaches_the_ends_of_bf16s_exact_range():
    """a reaches 128 (0x4300) and a + b 254: the largest values the split
    forms, both exact in bf16."""
    a, _, s = sa.split_bf16(np.array([32767, 32639, -32768], np.int16))
    assert sa._bf16_value(a).tolist() == [128.0, 127.0, -128.0]
    assert sa._bf16_value(s).tolist() == [127.0, 254.0, -128.0]


# ---- the model against the plain version and the script --------------------------

@pytest.mark.parametrize("check", [False, True], ids=["u8", "check"])
@pytest.mark.parametrize("config", sa.CONFIGS, ids=CONFIG_IDS)
def test_wgmma_model_equals_plain(inputs3, config, check):
    w, ops, c = inputs3
    want = sa.slice_groups_plain(w, ops, *config, check=check).numpy()
    got = sa.wgmma_model(w.numpy(), c, *config, check=check)
    assert got.dtype == want.dtype and got.shape == (3, 32, 1920)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sms", [1, 2, 7, 45])
def test_wgmma_model_over_walks_of_several_windows(inputs3, sms):
    """Blocks whose runs cross one or many windows (the window reloaded in
    the middle of a run), the last run shorter."""
    w, ops, c = inputs3
    want = sa.slice_groups_plain(w, ops, 64, 384, check=True).numpy()
    np.testing.assert_array_equal(sa.wgmma_model(w.numpy(), c, 64, 384, True, sms), want)


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of this test in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("config", sa.CONFIGS, ids=CONFIG_IDS)
def test_wgmma_model_equals_the_script(monkeypatch, interpret, config):
    """The model == ``scripts/exp_slice_align.py``'s own kernel (interpret
    mode, GRID 2, full widths)."""
    spec = importlib.util.spec_from_file_location(
        "_tpu_exp_slice_align", ROOT / "scripts" / "exp_slice_align.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "GRID", 2)
    w, ops = sa.inputs("cpu", grid=2)
    want = np.asarray(mod.make(*config)(jnp.asarray(w.numpy()),
                                        *(jnp.asarray(x.to(torch.float32).numpy(), jnp.bfloat16)
                                          for x in ops.c)))
    c = np.stack([x.to(torch.float32).numpy().astype(np.float64) for x in ops.c])
    np.testing.assert_array_equal(sa.wgmma_model(w.numpy(), c, *config), want)


def test_wgmma_model_refuses_sums_past_2_24(inputs3):
    w, _, c = inputs3
    with pytest.raises(AssertionError, match="2\\^24"):
        sa.wgmma_model(w.numpy(), c * 20, 128, 512)


# ---- the library yardsticks ------------------------------------------------------

@pytest.mark.parametrize("calls", [1, 3])
@pytest.mark.parametrize("check", [False, True], ids=["u8", "check"])
@pytest.mark.parametrize("config", sa.CONFIGS, ids=CONFIG_IDS)
def test_library_sums_equal_plain_on_cpu(inputs3, config, check, calls):
    """The dots as one ``bmm`` over the 45 windows (or three, one a plane),
    met as the kernel meets them, == the plain version (the CUDA call's
    ``out_dtype=float32`` is replaced on the CPU by a float32 ``bmm`` of the
    same bf16 values)."""
    w, ops, _ = inputs3
    lhs, rhs = sa.library_lhs(w, *config), sa.library_rhs(ops, *config)
    assert tuple(lhs.shape) == (45, 3 * 32, config[1]) and lhs.dtype == torch.bfloat16
    assert tuple(rhs.shape) == (45, config[1], 128) and rhs.dtype == torch.bfloat16
    d = sa.library(lhs, rhs, calls)
    assert len(d) == calls and sum(x.shape[0] for x in d) == 45
    assert torch.equal(sa.library_sums(d, 3, check),
                       sa.slice_groups_plain(w, ops, *config, check=check))


# ---- the wrapper ----------------------------------------------------------------

def test_forms_and_launch_keys():
    assert sa.FORMS == ("wgmma", "mma_sync")
    assert set(sa.LAUNCHES) == {f"{a},{kl}" for a, kl in sa.CONFIGS} | \
        {f"{a},{kl}[wgmma]" for a, kl in sa.CONFIGS}
    assert sa.launch_key(128, 512, "mma_sync") == "128,512"
    assert sa.launch_key(64, 384, "wgmma") == "64,384[wgmma]"


@pytest.mark.parametrize("form", [None, "wgmma", "mma_sync"])
def test_every_form_runs_the_plain_version_on_cpu(inputs3, form):
    w, ops, _ = inputs3
    sa.reset_launches()
    for check in (False, True):
        assert torch.equal(sa.slice_groups(w[:1], ops, 32, 384, check, form),
                           sa.slice_groups_plain(w[:1], ops, 32, 384, check))
    assert sa.LAUNCHES.total() == 0


@pytest.mark.parametrize("form", ["wmma", "gemm", ""])
def test_refuses_a_bad_form(inputs3, form):
    w, ops, _ = inputs3
    with pytest.raises(ValueError, match="takes form"):
        sa.slice_groups(w[:1], ops, 128, 512, form=form)


def test_refuses_other_devices(inputs3):
    w, ops, _ = inputs3
    with pytest.raises(ValueError, match="unsupported device"):
        sa.slice_groups(w.to("meta"), sa.SliceOperands(tuple(x.to("meta") for x in ops.c),
                                                       ops.ct.to("meta")), 128, 512, form="wgmma")
    with pytest.raises(ValueError, match="several devices"):
        sa.slice_groups(w.to("meta"), ops, 128, 512, form="wgmma")


@pytest.fixture
def as_if_on_card(monkeypatch):
    """The wrapper's checks as on a card (``on_card`` true), with any launch
    refused: a test reaches them on CPU tensors, and nothing runs."""
    monkeypatch.setattr(_harness, "on_card", lambda *t: True)

    def no_launch(*_):
        raise AssertionError("a refused call reached the kernel")
    monkeypatch.setattr(sa, "_wgmma_lib", no_launch)
    monkeypatch.setattr(_harness, "lib", no_launch)
    monkeypatch.setattr(_harness, "lib_with_setup", no_launch)


@pytest.mark.parametrize("form", sa.FORMS)
def test_refuses_non_contiguous_or_misaligned_tensors(as_if_on_card, inputs3, form):
    w, ops, _ = inputs3
    strided = torch.empty((1, 32, 2 * 3840), dtype=torch.int16)[..., ::2]
    strided.copy_(w[:1])
    with pytest.raises(ValueError, match="contiguous"):
        sa.slice_groups(strided, ops, 128, 512, form=form)
    shifted = torch.empty(32 * 3840 + 1, dtype=torch.int16)[1:].view(1, 32, 3840)
    shifted.copy_(w[:1])
    with pytest.raises(ValueError, match="16-byte aligned"):
        sa.slice_groups(shifted, ops, 128, 512, form=form)


@pytest.mark.parametrize("shape, dtype", [((2, 32, 1920), torch.int16),
                                          ((2, 16, 3840), torch.int16),
                                          ((2, 32, 3840), torch.int32),
                                          ((32, 3840), torch.int16)])
def test_refuses_bad_shapes(as_if_on_card, inputs3, shape, dtype):
    _, ops, _ = inputs3
    with pytest.raises(ValueError, match="int16"):
        sa.slice_groups(torch.zeros(shape, dtype=dtype), ops, 128, 512, form="wgmma")


def test_source_names_what_it_replaces():
    text = SOURCE.read_text()
    assert "scripts/exp_slice_align.py" in text and "at :56" in text
    assert "wgmma.mma_async" in text and "exp_slice.cu" in text


# ---- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the wgmma form's kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 3, 34, 35])
def test_wgmma_equals_plain_on_card(cuda_device, steps):
    w, ops = sa.inputs(cuda_device)
    w = torch.cat([w, w[:1].flip(2)])[:steps].contiguous()
    for align, kl in sa.CONFIGS:
        for check in (False, True):
            assert torch.equal(sa.slice_groups(w, ops, align, kl, check, "wgmma"),
                               sa.slice_groups_plain(w, ops, align, kl, check))


# ---- the ablation tool ------------------------------------------------------------

@pytest.mark.parametrize("variant", list(slice_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_source(variant):
    """Each variant's texts are in the kernel source once, and none touches
    a barrier, a wait or a copy (every variant runs the whole schedule)."""
    text = slice_ablate.variant_source(variant)
    for call in ("mbar_wait(", "mbar_arrive(", "mbar_expect(", "tma_2d(", "wgmma_wait<"):
        assert text.count(call) == SOURCE.read_text().count(call), (variant, call)
    assert (text == SOURCE.read_text()) == (variant == "kernel")


def test_ablation_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        slice_ablate.main([])
    with pytest.raises(SystemExit, match="unknown variants"):
        slice_ablate.main(["no_such_stage"])
