"""Kernel M's X3 in its cluster form (``window_x3(var, form="cluster")``,
``libiqo_tpu_torch/csrc/exp/exp_clamp.cu``, ``window_x3_cluster_kernel``)
against ``scripts/exp_element_clamp.py``'s ``run_x3``, on the CPU.

The script is loaded from ``scripts/`` with ``importlib`` and run in
interpret mode (``pl.pallas_call`` patched with ``interpret=True`` inside
each test only), its ``jax.jit`` wrapped to keep the output, as
``tests/test_torch_window_probes.py`` runs it.  The port's wrapper on the
same CPU source runs the plain version; a NumPy model of the cluster
schedule (``exp_element_clamp.x3_model``) holds the schedule to it.
Tolerance 0: the probe copies values, so the card test compares int32
views (every bit, NaN payloads and -0.0 included).  Tests that need the
card are ``cuda``-marked and skip without one.
"""

from __future__ import annotations

import functools
import importlib.util
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
        "_tpu_exp_element_clamp_cluster", ROOT / "scripts" / "exp_element_clamp.py")
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


def random_bits(seed: int = 16) -> torch.Tensor:
    """(3, 64, 256) float32 from random int32 bits, with quiet and
    signalling NaNs carrying payloads and -0.0 among them."""
    bits = torch.from_numpy(np.random.default_rng(seed).integers(
        -2**31, 2**31, (ec.N_VAR, ec.A, ec.B)).astype(np.int32))
    bits.view(-1)[::97] = 0x7FC00001
    bits.view(-1)[5::89] = -2**31
    bits.view(-1)[7::101] = 0x7F800001
    return bits.view(torch.float32)


@pytest.mark.parametrize("form", [None, "cluster", "serial"])
def test_window_x3_forms_equal_script(script, capsys, form):
    script.run_x3()
    assert "X3 (dynamic scratch leading index): ran, OK" in capsys.readouterr().out
    var = ec.inputs("cpu")["x3"]
    got = ec.window_x3(var, form)
    assert got.dtype == torch.float32 and got.shape == (4, 64, 256)
    np.testing.assert_array_equal(got.numpy(), script.outputs[-1])


@pytest.mark.parametrize("form", ["wide", "gemm", "Cluster", "", "x1"])
def test_window_x3_refuses_a_bad_form(form):
    """X3 alone takes a form, ``"cluster"`` (the default) or ``"serial"``."""
    with pytest.raises(ValueError, match="takes form"):
        ec.window_x3(ec.inputs("cpu")["x3"], form)


@pytest.mark.parametrize("wrapper", [ec.window_x1, ec.window_x2])
def test_x1_and_x2_take_no_form(wrapper):
    """X1 and X2 take none of X3's forms: each takes its own two
    (``"boxes"``, ``"single"``) and refuses ``"cluster"``."""
    src = ec.inputs("cpu")["x2"]
    with pytest.raises(ValueError, match="takes form"):
        wrapper(src, form="cluster")
    assert ec.X1_FORMS == ec.X2_FORMS == ("boxes", "single")


@pytest.mark.parametrize("rank", range(4))
def test_cluster_schedule_reads_each_slice_from_rank_0(rank):
    """Rank 0 of every row chunk copies all three variant slices into its
    own shared memory; rank t reads variant v(t) from it; no other rank
    copies; each of the 16 clusters takes its 4 rows."""
    sched = ec.x3_schedule()
    assert len(sched) == ec.X3_CHUNKS * ec.X3_STEPS == 64
    mine = [blk for blk in sched if blk["rank"] == rank]
    assert [blk["chunk"] for blk in mine] == list(range(16))
    for blk in mine:
        assert blk["reads"] == [0, 1, 1, 2][rank]
        assert blk["copies"] == ([0, 1, 2] if rank == 0 else [])
        assert list(blk["rows"]) == list(range(4 * blk["chunk"], 4 * blk["chunk"] + 4))


@pytest.mark.parametrize("fault", ["copies on rank 1", "variant 2 not copied"])
def test_cluster_model_refuses_a_read_of_an_unfilled_slice(monkeypatch, fault):
    """The model checks the schedule: a read of rank 0's slice that rank 0
    never copied is an error."""
    real = ec.x3_schedule

    def planted():
        if fault == "copies on rank 1":
            return [{**b, "copies": real()[b["chunk"] * 4]["copies"] if b["rank"] == 1 else []}
                    for b in real()]
        return [{**b, "copies": [v for v in b["copies"] if v != 2]} for b in real()]

    monkeypatch.setattr(ec, "x3_schedule", planted)
    with pytest.raises(AssertionError, match="no copy filled"):
        ec.x3_model(ec.inputs("cpu")["x3"].numpy())


@pytest.mark.parametrize("source", ["arange", "random bits", "other bits", "all -0.0"])
def test_cluster_model_writes_every_output_once_and_equals_plain(source):
    var = {"arange": lambda: ec.inputs("cpu")["x3"], "random bits": random_bits,
           "other bits": lambda: random_bits(17),
           "all -0.0": lambda: torch.full((ec.N_VAR, ec.A, ec.B), -0.0)}[source]()
    out, writes = ec.x3_model(var.numpy())
    assert (writes == 1).all()
    want = ec.window_x3_plain(var).numpy()
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(want.view(np.int32), var.numpy()[[0, 1, 1, 2]].view(np.int32))


def test_cluster_chunks_cover_the_rows():
    """16 clusters of 4 rows: 4 KB of one variant a block, 64 blocks."""
    assert ec.X3_CHUNKS * ec.X3_ROWS == ec.A == 64
    assert ec.X3_ROWS * ec.B * 4 == 4096
    assert ec.X3_CHUNKS * ec.X3_STEPS == 64


def test_launch_keys_stay_zero_on_cpu():
    ec.reset_launches()
    var = ec.inputs("cpu")["x3"]
    for form in (None, *ec.FORMS):
        ec.window_x3(var, form)
    assert ec.LAUNCHES.total() == 0
    assert set(ec.LAUNCHES) == {"x1", "x1_batch", "x1[boxes]", "x1_batch[boxes]", "x2",
                                "x2[boxes]", "x3", "x3[cluster]"} == set(ec.ROWS)


def test_bound_of_the_cluster_row_is_x3s():
    assert ec.bound("x3[cluster]") == ec.bound("x3")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a cluster launch has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["cluster", "serial"])
def test_window_x3_equals_plain_bit_for_bit_on_card(cuda_device, form):
    for var in (ec.inputs(cuda_device)["x3"], random_bits().to(cuda_device)):
        got = ec.window_x3(var, form).view(torch.int32)
        assert torch.equal(got, ec.window_x3_plain(var).view(torch.int32))
