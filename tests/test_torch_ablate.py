"""The stage ablations' shared helpers (``libiqo_tpu_torch/tools/_ablate.py``)
on the CPU: substitutions and their counts, the variant names, and the order
and minimum of timing in turns.  Building and loading need ``nvcc`` and a
card; ``tests/test_torch_tiled.py`` and ``tests/test_torch_slice_wgmma.py``
hold each tool's variants to its current source."""

from __future__ import annotations

import pytest

from libiqo_tpu_torch.experiments import _harness
from libiqo_tpu_torch.tools import _ablate

VARIANTS = {"kernel": [], "no_a": [("a();", "")], "no_ab": [("a();", ""), ("b();", "c();")]}
TEXT = "a(); b(); d(); d();"


@pytest.mark.parametrize("name, want", [("kernel", TEXT), ("no_a", " b(); d(); d();"),
                                        ("no_ab", " c(); d(); d();")])
def test_variant_source_substitutes(tmp_path, name, want):
    src = tmp_path / "k.cu"
    src.write_text(TEXT)
    assert _ablate.variant_source(VARIANTS, src, name) == want
    assert _ablate.variant_source(VARIANTS, src, name, text=TEXT) == want


@pytest.mark.parametrize("counts, ok", [(None, False), ({"d();": 2}, True), ({"d();": 3}, False)])
def test_variant_source_counts(tmp_path, counts, ok):
    """A text must be in the source as often as ``counts`` says (once by
    default), or the variant would change more or less than it claims."""
    variants = {"no_d": [("d();", "")]}
    if ok:
        assert _ablate.variant_source(variants, tmp_path, "no_d", TEXT, counts) == "a(); b();  "
    else:
        with pytest.raises(ValueError, match="where expected"):
            _ablate.variant_source(variants, tmp_path, "no_d", TEXT, counts)


@pytest.mark.parametrize("asked, want", [([], ["kernel", "no_a", "no_ab"]),
                                         (["no_ab"], ["kernel", "no_ab"]),
                                         (["no_a", "kernel"], ["kernel", "no_a"])])
def test_names_put_the_kernel_first(asked, want):
    assert _ablate.names_of(asked, VARIANTS) == want


def test_names_refuse_unknown_variants():
    with pytest.raises(SystemExit, match=r"unknown variants \['no_z'\]"):
        _ablate.names_of(["no_z"], VARIANTS)


def test_time_in_turns_order_and_min(monkeypatch):
    """Each call is timed twice, in order and then reversed, and keeps the
    lesser of its two times."""
    order, clock = [], iter([5.0, 3.0, 4.0, 1.0, 2.0, 6.0])

    def fake_ms(fn, inputs):
        order.append(fn.__name__)
        return next(clock)

    monkeypatch.setattr(_harness, "launches_ms", fake_ms)
    calls = {n: type("f", (), {"__name__": n})() for n in ("kernel", "no_a", "empty")}
    ms = _ablate.time_in_turns(calls, [])
    assert order == ["kernel", "no_a", "empty", "empty", "no_a", "kernel"]
    assert ms == {"kernel": 5.0, "no_a": 2.0, "empty": 1.0}
