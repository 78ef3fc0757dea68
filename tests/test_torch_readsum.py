"""Kernel B's forms (``libiqo_tpu_torch/csrc/exp/exp_stream.cu``,
``exp_dma_ceiling.readsum(x, form)``: ``warp`` and the first form,
``rows8``) on the CPU: their geometry against the source's constants, a
NumPy model of each form's walk and fold (the lane-to-group map, the rounds
of loads and the shuffle order) against ``readsum_plain`` and against the
TPU script's ``make_readsum`` in interpret mode, at ragged heights and at
W = 128 and 3840, the library fold, and the forms, launch keys and refusals
of the wrapper.

Tolerance 0: per-byte sums modulo 256 are exact in any order.  The kernels
run only on the card: that test is ``cuda``-marked and skips without one.
"""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libiqo_tpu_torch.experiments import _harness
from libiqo_tpu_torch.experiments import exp_dma_ceiling as dma

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "libiqo_tpu_torch" / "csrc" / "exp" / "exp_stream.cu"
SHAPES = [(17, 3840), (16, 3840), (33, 128), (3, 8192), (9, 4224), (1, 128)]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---- geometry ------------------------------------------------------------------

def _constexprs() -> dict[str, int]:
    out = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", SOURCE.read_text()):
        expr = " ".join(re.sub(r"//.*", "", expr).split())
        out[name] = eval(expr, {}, dict(out))   # noqa: S307
    return out


def test_host_geometry_is_the_sources():
    """The host's lanes and the warp form's loads a round are the constants
    ``exp_stream.cu`` is compiled with."""
    k = _constexprs()
    assert (k["kReadsumLanes"], k["kWarpLoads"]) == (dma.LANES, dma.WARP_LOADS) == (128, 8)


# ---- the models against the plain version and the script --------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("form", dma.FORMS_READSUM)
def test_readsum_model_equals_plain(form, shape):
    x = _u8(shape, seed=sum(shape))
    got = dma.readsum_model(x, form)
    assert got.dtype == np.uint8 and got.shape == (shape[0], 128)
    np.testing.assert_array_equal(got, dma.readsum_plain(torch.from_numpy(x)).numpy())


def test_the_fold_wraps_every_byte():
    """All 255s: each lane's sum wraps modulo 256 many times over."""
    x = np.full((3, 3840), 255, np.uint8)
    want = np.full((3, 128), (30 * 255) & 255, np.uint8)
    for form in dma.FORMS_READSUM:
        np.testing.assert_array_equal(dma.readsum_model(x, form), want)


@pytest.mark.parametrize("p", [0, 7, 8, 31, 32, 255, 256, 479])
def test_warp_lanes_fold_over_their_lane_group(p):
    """A single 1 in piece p of a row lands on output lane 16 (p % 8) + its
    byte, whichever of the 32 lanes and of the rounds of loads took it
    (pieces 255 and 256 end and start a round of 8 x 32 at W = 7680)."""
    x = np.zeros((1, 7680), np.uint8)
    x[0, 16 * p + 5] = 1
    for form in dma.FORMS_READSUM:
        got = dma.readsum_model(x, form)
        assert got.sum() == 1 and got[0, 16 * (p % 8) + 5] == 1, form


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of this test in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("h, w", [(17, 3840), (16, 3840), (33, 128)],
                         ids=["ragged-3840", "16-3840", "ragged-128"])
@pytest.mark.parametrize("form", dma.FORMS_READSUM)
def test_readsum_model_equals_the_script(monkeypatch, interpret, form, h, w):
    """Each form's model == ``scripts/exp_dma_ceiling.py``'s ``make_readsum``
    (interpret mode; its row tile set to the whole height, so a height that
    no tile of 8 divides runs too)."""
    spec = importlib.util.spec_from_file_location(
        "_tpu_exp_dma_ceiling", ROOT / "scripts" / "exp_dma_ceiling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in (("H", h), ("W", w), ("TH", h)):
        monkeypatch.setattr(mod, k, v)
    x = _u8((h, w), seed=h + w)
    want = np.asarray(mod.make_readsum()(x))
    np.testing.assert_array_equal(dma.readsum_model(x, form), want)


def test_library_fold_equals_plain_on_cpu():
    for shape in SHAPES:
        x = torch.from_numpy(_u8(shape, seed=1))
        assert torch.equal(dma.library_fold(x), dma.readsum_plain(x))


# ---- the wrapper ----------------------------------------------------------------

def test_forms_and_launch_keys():
    assert dma.FORMS_READSUM == ("warp", "rows8")
    assert dma.readsum_key("rows8") == "readsum"
    assert dma.readsum_key("warp") == "readsum[warp]"
    assert {k for k in dma.LAUNCHES if k.startswith("readsum")} == \
        {"readsum", "readsum[warp]"}


@pytest.mark.parametrize("form", [None, *dma.FORMS_READSUM])
def test_every_form_runs_the_plain_version_on_cpu(form):
    dma.reset_launches()
    x = torch.from_numpy(_u8((17, 3840)))
    assert torch.equal(dma.readsum(x, form), dma.readsum_plain(x))
    assert dma.LAUNCHES.total() == 0


@pytest.mark.parametrize("form", ["rows", "bulk", ""])
def test_refuses_a_bad_form(form):
    with pytest.raises(ValueError, match="takes form"):
        dma.readsum(torch.zeros((4, 128), dtype=torch.uint8), form)


@pytest.fixture
def as_if_on_card(monkeypatch):
    """The wrapper's checks as on a card (``on_card`` true), with any launch
    refused: a test reaches them on CPU tensors, and nothing runs."""
    monkeypatch.setattr(_harness, "on_card", lambda *t: True)

    def no_launch(*_):
        raise AssertionError("a refused call reached the kernel")
    monkeypatch.setattr(_harness, "lib", no_launch)


@pytest.mark.parametrize("form", dma.FORMS_READSUM)
def test_refuses_non_contiguous_or_misaligned_planes(as_if_on_card, form):
    with pytest.raises(ValueError, match="contiguous"):
        dma.readsum(torch.zeros((8, 256), dtype=torch.uint8)[:, :128], form)
    shifted = torch.zeros(4 * 128 + 1, dtype=torch.uint8)[1:].view(4, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dma.readsum(shifted, form)


@pytest.mark.parametrize("shape, dtype", [((4, 200), torch.uint8), ((4, 128), torch.int8),
                                          ((2, 4, 128), torch.uint8), ((512,), torch.uint8)])
@pytest.mark.parametrize("form", dma.FORMS_READSUM)
def test_refuses_bad_shapes(as_if_on_card, form, shape, dtype):
    with pytest.raises(ValueError, match="readsum takes"):
        dma.readsum(torch.zeros(shape, dtype=dtype), form)


def test_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        dma.readsum(torch.empty((4, 128), dtype=torch.uint8, device="meta"), "warp")


def test_source_names_what_it_replaces():
    text = SOURCE.read_text()
    assert "make_readsum (:73" in text
    assert "readsum_warp_kernel" in text and "__shfl_xor_sync" in text


# ---- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the readsum kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2160, 3840), (2161, 3840), (2160, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_readsum_forms_equal_plain_on_card(cuda_device, shape):
    x = torch.from_numpy(_u8(shape, seed=7)).to(cuda_device)
    for form in dma.FORMS_READSUM:
        assert torch.equal(dma.readsum(x, form), dma.readsum_plain(x)), form
