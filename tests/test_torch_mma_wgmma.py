"""Kernel C's wgmma form (``libiqo_tpu_torch/csrc/exp/exp_mma_wgmma.cu``,
``exp_int8_mxu.mma_steps(..., form="wgmma")``) on the CPU: its geometry
against the source's constants, the persistent walk over the output tiles,
a NumPy model of the tile schedule against ``mma_steps_plain`` (and so the
TPU script, which ``tests/test_torch_experiments.py`` holds the plain
version to), the forms, launch keys and refusals of the wrapper.

Tolerance 0, bit for bit: the inputs are integers and every f32 sum of
|terms| stays below 2^24 (the plain version asserts it), so any order of
summation, the tensor cores' included, is exact.  The kernel itself runs
only on the card: those tests are ``cuda``-marked and skip without one.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from libiqo_tpu_torch.experiments import _harness
from libiqo_tpu_torch.experiments import exp_int8_mxu as mxu

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_mma_wgmma.cu"
SMEM_LIMIT = 232_448        # bytes of shared memory one block may use (H100)
# (steps, M, N, K) small enough for the float64 plain version on the CPU:
# one tile, several tiles each way, several K chunks of every kind
SMALL = [(1, 128, 256, 128), (2, 256, 512, 256), (3, 128, 256, 384)]


def _ints(rng, shape, lo=-100, hi=100):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _inputs(shape, in_dtype, seed=0):
    steps, m, n, k = shape
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(_ints(rng, (steps, m, k))).to(in_dtype)
    b = torch.from_numpy(_ints(rng, (k, n))).to(in_dtype)
    return a, mxu.k_major(b)


# ---- geometry ------------------------------------------------------------------

def _constexprs() -> dict[str, int]:
    body = re.search(r"namespace gc {(.*?)}  // namespace gc", SOURCE.read_text(), re.S).group(1)
    out = {}
    for stmt in re.findall(r"constexpr int ([^;]+);", body):
        for part in stmt.split(","):
            name, expr = (x.strip() for x in part.split("="))
            expr = " ".join(re.sub(r"//.*", "", expr).split())
            out[name] = eval(expr, {}, dict(out))   # noqa: S307
    return out


def test_host_geometry_is_the_sources():
    """The host's :data:`WGMMA` is the geometry ``exp_mma_wgmma.cu`` is
    compiled with (on the card, ``iqo_exp_mma_wgmma_shape`` says the same)."""
    k = _constexprs()
    g = mxu.WGMMA
    assert (k["kBM"], k["kBN"], k["kKC"], k["kStages"], k["kConsumers"]) == \
        (g.bm, g.bn, g.kc, g.stages, g.consumers)
    assert (k["kThreads"], k["kStageBytes"], k["kSmem"]) == (g.threads, g.stage_bytes, g.smem)
    assert (k["kOutCols"], k["kOutBytes"]) == (g.out_cols, g.out_bytes)


def test_shared_memory_ring_fits():
    """The ring of stages, the two warpgroups' output staging, the barriers
    and the alignment slack fit one block's 232,448 bytes, and every stage,
    A half and staging box starts 1024-aligned (the 128-byte swizzle's
    tiles)."""
    g = mxu.WGMMA
    assert g.smem == 4 * 49_152 + 2 * 16_384 + 64 + 1024 == 230_464
    assert g.smem <= SMEM_LIMIT
    assert g.stage_bytes % 1024 == 0 and (g.bm * g.kc) % 1024 == 0 and (64 * g.kc) % 1024 == 0
    assert g.out_bytes % 2048 == 0 and g.out_cols * 4 == 2 * 128   # two boxes of 128 bytes a row
    assert g.threads == 288


@pytest.mark.parametrize("shape, sms", [
    ((64, 256, 512), 132),          # the script's: 256 tiles, the second wave 124 blocks
    ((36, 384, 768), 132),          # chip_smoke's second shape: 324 tiles, 2.45 per SM
    ((5, 128, 512), 3),             # 10 tiles over 3 blocks: the last wave 1
    ((1, 128, 256), 132)])          # one tile, one block
def test_persistent_walk_covers_every_tile_once(shape, sms):
    steps, m, n = shape
    ctas = mxu.wgmma_ctas(steps, m, n, sms)
    tiles = steps * (m // 128) * (n // 256)
    assert ctas == min(sms, tiles)
    walk = mxu.tile_walk(steps, m, n, ctas)
    seen = [t for block in walk for t in block]
    assert len(seen) == len(set(seen)) == tiles
    assert set(seen) == {(s, i, j) for s in range(steps) for i in range(m // 128)
                         for j in range(n // 256)}
    per = [len(b) for b in walk]
    assert max(per) - min(per) <= 1 and max(per) == -(-tiles // ctas)


def test_the_walk_keeps_neighbouring_blocks_on_the_same_rows():
    """N tiles innermost: blocks 2i and 2i + 1 take the two column tiles of
    one row tile at once, so `a`'s rows are read from L2 together."""
    walk = mxu.tile_walk(64, 256, 512, 132)
    for b in range(0, 132, 2):
        (s0, m0, n0), (s1, m1, n1) = walk[b][0], walk[b + 1][0]
        assert (s0, m0) == (s1, m1) and (n0, n1) == (0, 1)


# ---- the model against the plain version --------------------------------------

@pytest.mark.parametrize("row", list(mxu.ROWS))
@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_model_equals_plain(row, shape):
    in_dt, acc = mxu.ROWS[row]
    a, bt = _inputs(shape, in_dt)
    want = mxu.mma_steps_plain(a, bt, acc)
    got = mxu.wgmma_model(a.to(torch.float32).numpy(), bt.to(torch.float32).numpy(), in_dt, acc)
    assert got.dtype == {torch.int32: np.int32, torch.float32: np.float32}[acc]
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("sms", [1, 2, 5])
def test_wgmma_model_over_partial_waves(sms):
    """Blocks walking several tiles each, the last wave partial."""
    a, bt = _inputs((3, 256, 512, 128), torch.int8, seed=3)
    want = mxu.mma_steps_plain(a, bt, torch.int32)
    np.testing.assert_array_equal(
        mxu.wgmma_model(a.numpy(), bt.numpy(), torch.int8, torch.int32, sms), want.numpy())


def test_wgmma_model_sums_and_converts_like_the_card():
    """The largest s8 sums (every product 2^14, K = 1024: 2^24) in int32,
    and converted to f32 at the store."""
    a = torch.full((1, 128, 1024), -128, dtype=torch.int8)
    bt = torch.full((256, 1024), -128, dtype=torch.int8)
    s32 = mxu.wgmma_model(a.numpy(), bt.numpy(), torch.int8, torch.int32)
    assert int(s32[0, 0, 0]) == 2**24
    assert np.array_equal(s32, mxu.mma_steps_plain(a, bt, torch.int32).numpy())
    f32 = mxu.wgmma_model(a.numpy(), bt.numpy(), torch.int8, torch.float32)
    assert np.array_equal(f32, mxu.mma_steps_plain(a, bt, torch.float32).numpy())


@pytest.mark.parametrize("row", ["s8xs8->i32", "s8xs8->f32", "f32xf32->f32"])
def test_library_calls_equal_plain_on_cpu(row):
    """The rows' library yardsticks compute the plain version's function
    (the bf16 row's ``torch.mm(out_dtype=)`` exists on CUDA only)."""
    in_dt, acc = mxu.ROWS[row]
    a, bt = _inputs(SMALL[1], in_dt, seed=5)
    fn, what, one_call = mxu.library(row, bt.t().contiguous())
    assert torch.equal(fn(a), mxu.mma_steps_plain(a, bt, acc))
    assert one_call == (row != "s8xs8->f32") and what


# ---- the wrapper ----------------------------------------------------------------

def test_forms_and_launch_keys():
    assert mxu.FORMS == ("wgmma", "mma_sync")
    assert set(mxu.LAUNCHES) == {*mxu.ROWS, *(f"{r}[wgmma]" for r in mxu.ROWS)}
    assert mxu.launch_key("s8xs8->i32", "mma_sync") == "s8xs8->i32"
    assert mxu.launch_key("s8xs8->i32", "wgmma") == "s8xs8->i32[wgmma]"


@pytest.mark.parametrize("form", [None, "wgmma", "mma_sync"])
def test_every_form_runs_the_plain_version_on_cpu(form):
    mxu.reset_launches()
    a, bt = _inputs(SMALL[0], torch.int8)
    assert torch.equal(mxu.mma_steps(a, bt, torch.int32, form),
                       mxu.mma_steps_plain(a, bt, torch.int32))
    assert mxu.LAUNCHES.total() == 0


@pytest.mark.parametrize("form", ["wmma", "gemm", ""])
def test_refuses_a_bad_form(form):
    a, bt = _inputs(SMALL[0], torch.int8)
    with pytest.raises(ValueError, match="takes form"):
        mxu.mma_steps(a, bt, torch.int32, form)


def test_refuses_other_devices():
    a = torch.empty((1, 128, 128), dtype=torch.int8, device="meta")
    bt = torch.empty((256, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mxu.mma_steps(a, bt, torch.int32, "wgmma")
    with pytest.raises(ValueError, match="several devices"):
        mxu.mma_steps(a, torch.zeros((256, 128), dtype=torch.int8), torch.int32, "wgmma")


@pytest.fixture
def as_if_on_card(monkeypatch):
    """The wrapper's checks as on a card (``on_card`` true), with any launch
    refused: a test reaches them on CPU tensors, and nothing runs."""
    monkeypatch.setattr(_harness, "on_card", lambda *t: True)

    def no_launch(*_):
        raise AssertionError("a refused call reached the kernel")
    monkeypatch.setattr(mxu, "_wgmma_lib", no_launch)
    monkeypatch.setattr(_harness, "lib", no_launch)


@pytest.mark.parametrize("shape", [(1, 64, 256, 128), (1, 128, 128, 128), (1, 128, 256, 96),
                                   (1, 192, 512, 256)], ids=lambda s: "x".join(map(str, s)))
def test_refuses_shapes_off_the_tile(as_if_on_card, shape):
    """M not a multiple of 128, N of 256, K of 128 bytes: refused, no
    fallback."""
    a, bt = _inputs(shape, torch.int8)
    with pytest.raises(ValueError, match="wgmma form takes"):
        mxu.mma_steps(a, bt, torch.int32, "wgmma")


def test_refuses_non_contiguous_tensors(as_if_on_card):
    a, bt = _inputs(SMALL[0], torch.int8)
    strided = torch.empty((1, 128, 256), dtype=torch.int8)[..., ::2]
    strided.copy_(a)
    with pytest.raises(ValueError, match="contiguous"):
        mxu.mma_steps(strided, bt, torch.int32, "wgmma")
    with pytest.raises(ValueError, match="contiguous"):
        mxu.mma_steps(a, torch.empty((128, 256), dtype=torch.int8).t(), torch.int32, "wgmma")


# ---- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the wgmma form's kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SMALL + [(64, 256, 512, 1024), (36, 384, 768, 640)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wgmma_equals_plain_on_card(cuda_device, shape):
    for row, (in_dt, acc) in mxu.ROWS.items():
        a, bt = _inputs(shape, in_dt, seed=7)
        a, bt = a.to(cuda_device), bt.to(cuda_device)
        assert torch.equal(mxu.mma_steps(a, bt, acc, "wgmma"),
                           mxu.mma_steps_plain(a, bt, acc)), row
