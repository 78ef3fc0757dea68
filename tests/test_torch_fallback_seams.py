"""The port's route ladder and kernel scope: the port's form of the JAX
package's ``test_fallback_seams.py`` and ``test_supports_plan.py``.

The port's ladder is ``api.Resizer._backend_for``: on a CUDA device the
relaxed kernel where ``supports_plan(plan, relaxed=True)``, else the exact
kernel where ``supports_plan(plan)``, else the exact ``torch`` path.  Its
scope is one predicate, a pure function of the plan: where it holds, the
kernel's tables build and the kernel's model computes the oracle's bytes in
shared memory that fits; where it refuses, the relaxed ``pack_operands`` is
loud (ValueError) and the model cannot fit its work tile, as the JAX
package's ``make_resize_fn`` raises where its ``supports_plan`` refuses.
"""

import numpy as np
import pytest
import torch

from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.golden import numpy_ref as jax_numpy_ref
from libiqo_tpu.ops import pallas_resize
from libiqo_tpu_torch import api
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize

from test_torch_card_check import walk_model
from test_torch_tiled import _model as tiled_model
from test_torch_wide_kernel import wide_model

CARD = torch.device("cuda")
RNG = np.random.default_rng(41)


def _resizer(algo, sw, sh, dw, dh, precision="exact", **kw):
    return api.Resizer(build_plan(algo, sw, sh, dw, dh, **kw), precision=precision,
                       device="cpu")


def test_relaxed_refusal_lands_on_the_exact_kernel():
    """Seam (a): the relaxed form refuses Area 8192x4 -> 16x4 (its
    wide-window walk is exact only), so the ladder's next rung is the exact
    kernel, not the plain path; the JAX package's kernel takes the plan
    too."""
    r = _resizer("area", 8192, 4, 16, 4, precision="relaxed")
    assert not cuda_resize.supports_plan(r.plan, relaxed=True)
    assert cuda_resize.supports_plan(r.plan)
    assert r._backend_for(CARD) == "cuda"
    assert pallas_resize.supports_plan(jax_build_plan("area", 8192, 4, 16, 4))
    with pytest.raises(ValueError):
        cuda_resize.pack_operands(r.plan, relaxed=True)
    src = RNG.integers(0, 256, (4, 8192), np.uint8)
    np.testing.assert_array_equal(
        r.resize(src), jax_numpy_ref.resize_u8(jax_build_plan("area", 8192, 4, 16, 4), src))


def test_simulated_relaxed_refusal(monkeypatch):
    """A relaxed refusal of a plan the relaxed form takes (simulated at the
    predicate, as the JAX package's seam simulates it at its build) also
    lands on the exact kernel."""
    real = cuda_resize.supports_plan
    monkeypatch.setattr(cuda_resize, "supports_plan",
                        lambda plan, relaxed=False: False if relaxed else real(plan))
    r = _resizer("lanczos", 352, 96, 176, 48, precision="relaxed", degree=3)
    assert r._backend_for(CARD) == "cuda"
    assert r._backend_for(torch.device("cpu")) == "torch"


@pytest.mark.parametrize("geometry", [(16384, 4, 16, 4), (32768, 16, 16, 16),
                                      (65536, 16, 16, 16)])
def test_refused_by_both_lands_on_torch(geometry):
    """Seam (b): the envelope busters, refused by both packages' kernels,
    relaxed and exact, land on the exact plain path on the card."""
    r = _resizer("area", *geometry, precision="relaxed")
    assert not cuda_resize.supports_plan(r.plan, relaxed=True)
    assert not cuda_resize.supports_plan(r.plan)
    assert r._backend_for(CARD) == "torch"
    assert _resizer("area", *geometry)._backend_for(CARD) == "torch"
    assert not pallas_resize.supports_plan(jax_build_plan("area", *geometry))


def test_relaxed_taken_where_the_relaxed_form_fits():
    r = _resizer("lanczos", 352, 96, 176, 48, precision="relaxed", degree=3)
    assert r._backend_for(CARD) == "cuda-relaxed"
    assert r._backend_for(torch.device("cpu")) == "torch"


def _fuzz_cases(n, seed=20260819):
    """test_supports_plan.py's seeded draws, px2 chroma among them."""
    rng = np.random.default_rng(seed)
    cases = []
    while len(cases) < n:
        alg = rng.choice(["lanczos", "area", "linear"])
        sw, sh = int(rng.integers(16, 700)), int(rng.integers(16, 500))
        if alg == "area":
            dw = int(rng.integers(4, max(5, sw)))
            dh = int(rng.integers(4, max(5, sh)))
        elif alg == "linear":
            dw = int(rng.integers(max(4, sw // 3 + 1), sw * 3))
            dh = int(rng.integers(max(4, sh // 3 + 1), sh * 3))
        else:
            dw, dh = int(rng.integers(4, sw * 2)), int(rng.integers(4, sh * 2))
        kw = {}
        if alg == "lanczos":
            kw = dict(degree=int(rng.integers(1, 10)))
            if rng.integers(0, 3) == 0:
                kw["px_scale"] = 2
        cases.append((str(alg), sw, sh, dw, dh, kw))
    return cases


CASES = _fuzz_cases(24) + [
    ("area", 65536, 16, 16, 16, {}),       # the JAX package's envelope buster
    ("area", 4096, 4096, 128, 128, {}),    # JAX refuses; the wide-window walk
    ("area", 8192, 4, 16, 4, {}),          # the wide-window walk
    ("lanczos", 3840, 2160, 1920, 1080, dict(degree=3)),
    ("lanczos", 1920, 1080, 960, 540, dict(degree=3, px_scale=2)),
    ("area", 1920, 1080, 480, 270, {}),
    ("linear", 640, 480, 320, 240, {}),
]
GRADED = CASES[-4:]


def _ids(c):
    return (f"{c[0]}{c[5].get('degree', '')}-{c[1]}x{c[2]}-{c[3]}x{c[4]}"
            + ("-px2" if c[5].get("px_scale") else ""))


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_supports_plan_equals_buildable(case):
    """supports_plan holds exactly when the kernel's tables build and its
    model runs within shared memory: the model equals the oracle there
    (the tiled kernel's where ``tiled_ok`` holds, the wide-window kernel's
    where the windowed kernel's 16-row tile does not fit, else the windowed
    one's), and cannot fit its work tile where the predicate refuses."""
    alg, sw, sh, dw, dh, kw = case
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    sup = cuda_resize.supports_plan(plan)
    k = cuda_resize.kernel_tables(plan, tiled=False)
    if not sup:
        assert cuda_resize.work_rows(plan) == 0
        with pytest.raises(AssertionError):
            walk_model(plan, k, np.zeros((sh, sw), np.uint8))
        return
    wide = isinstance(k, cuda_resize.WideTables)
    if sw * sh > 1e6:                       # the full-size frames: tables only
        assert (k.layout.smem if wide else k.rows * k.win_max * 4) <= cuda_resize.SMEM_BUDGET
        return
    src = RNG.integers(0, 256, (sh, sw), np.uint8)
    want = numpy_ref.resize_u8(plan, src)
    model = (tiled_model(plan, src) if cuda_resize.tiled_ok(plan) else
             wide_model(plan, k.layout, src) if wide else walk_model(plan, k, src))
    np.testing.assert_array_equal(model, want)
    relaxed = cuda_resize.supports_plan(plan, relaxed=True)
    try:
        ops = cuda_resize.pack_operands(plan, relaxed=True)
        assert relaxed
        assert ops.tables.relaxed
    except ValueError:
        assert not relaxed


def test_graded_configs_accepted():
    for alg, sw, sh, dw, dh, kw in GRADED:
        plan = build_plan(alg, sw, sh, dw, dh, **kw)
        assert cuda_resize.supports_plan(plan) and cuda_resize.tiled_ok(plan)
        assert cuda_resize.supports_plan(plan, relaxed=True)


def test_operand_cache_serves_repeat_calls():
    """Repeat calls, and a fresh resizer of the same geometry, are served
    the same operands from the operand cache."""
    api.clear_operand_cache()
    a = api.LinearResizer(320, 240, 160, 120, device="cpu")
    src = RNG.integers(0, 256, (240, 320), np.uint8)
    out = a.resize(src)
    ops = a._operands(torch.device("cpu"))
    assert a._operands(torch.device("cpu")) is ops
    b = api.LinearResizer(320, 240, 160, 120, device="cpu")
    assert b._operands(torch.device("cpu")) is ops
    np.testing.assert_array_equal(b.resize(src), out)
    assert a._operands(torch.device("cpu"), relaxed=True) is not ops
    api.clear_operand_cache()
