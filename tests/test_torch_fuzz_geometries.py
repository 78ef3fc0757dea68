"""Seeded geometry fuzz on the port: ``test_fuzz_geometries.py``'s classes.

The JAX package's file holds ``numpy_ref`` to the reference C++ build and
skips without it.  Here the same seeded draws (RNG 2024, in that file's
order, ``LIBIQO_FUZZ_N`` per algorithm, 40 by default) hold the port's
``torch`` path to the port's and the JAX package's ``numpy_ref``.  Where the
reference would crash (``_lanczos_crash``, ``reference_oob``), the outputs
are ours to define and five implementations must agree on them
(:func:`assert_defined_divergence`).  Twenty draws also go through the JAX
package's XLA path, as ``test_fuzz_xla_path`` does.
"""

import os

import jax
import numpy as np
import pytest
import torch

from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.golden import numpy_ref as jax_numpy_ref
from libiqo_tpu.ops import pallas_resize, xla_resize
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize, torch_resize

from test_torch_tiled import _model as tiled_model

N = int(os.environ.get("LIBIQO_FUZZ_N", "40"))
N_XLA = min(N, 20)


def _draws():
    """The JAX file's draws from RNG 2024, in the order its tests run:
    ({"lanczos", "area", "linear", "xla"}: [(algo, kw, geometry, src)])."""
    rng = np.random.default_rng(2024)

    def geom():
        return tuple(int(rng.integers(lo, hi)) for lo, hi in
                     ((8, 700), (8, 500), (4, 700), (4, 500)))

    out = {k: [] for k in ("lanczos", "area", "linear", "xla")}
    for _ in range(N):
        g = geom()
        kw = dict(degree=int(rng.integers(1, 5)), px_scale=int(rng.integers(1, 3)))
        out["lanczos"].append(("lanczos", kw, g, rng.integers(0, 256, g[1::-1], np.uint8)))
    for algo in ("area", "linear"):
        for _ in range(N):
            g = geom()
            out[algo].append((algo, {}, g, rng.integers(0, 256, g[1::-1], np.uint8)))
    for i in range(N_XLA):
        g = geom()
        algo = ("lanczos", "area", "linear")[i % 3]
        kw = {"degree": int(rng.integers(1, 4))} if algo == "lanczos" else {}
        out["xla"].append((algo, kw, g, rng.integers(0, 256, g[1::-1], np.uint8)))
    return out


DRAWS = _draws()


def _lanczos_crash(plan) -> bool:
    """test_fuzz_geometries.py's predicate: the reference would crash."""
    if plan.y.main_begin > plan.y.n_dst:
        return True
    return any((ax.deno[ax.is_border] == 0).any() for ax in (plan.y, plan.x))


def _torch_path(plan, src):
    return torch_resize.resize(torch_resize.pack_operands(plan, "cpu"),
                               torch.from_numpy(src)).numpy()


def assert_defined_divergence(algo, kw, geometry, src, msg=""):
    """The port's ``tests/helpers.py:assert_defined_divergence``: where the
    reference hits undefined behaviour, five implementations agree on the
    defined output: the JAX package's ``numpy_ref``, its XLA path, its
    Pallas kernel in interpret mode (where it takes the plan), the port's
    ``torch`` path and the port's tiled kernel model (where the port's
    kernel takes the plan)."""
    jplan = jax_build_plan(algo, *geometry, **kw)
    plan = build_plan(algo, *geometry, **kw)
    golden = jax_numpy_ref.resize_u8(jplan, src)
    fn, ops = xla_resize.make_resize_fn(jplan)
    np.testing.assert_array_equal(np.asarray(jax.jit(fn)(*ops, src)), golden,
                                  err_msg=f"xla {msg}")
    if pallas_resize.supports_plan(jplan):
        fn, ops = pallas_resize.make_resize_fn(jplan, interpret=True)
        np.testing.assert_array_equal(np.asarray(jax.jit(fn)(*ops, src)), golden,
                                      err_msg=f"pallas {msg}")
    np.testing.assert_array_equal(_torch_path(plan, src), golden,
                                  err_msg=f"port torch {msg}")
    if cuda_resize.tiled_ok(plan):
        np.testing.assert_array_equal(tiled_model(plan, src), golden,
                                      err_msg=f"port tiled model {msg}")


def _check(algo, kw, geometry, src, undefined):
    msg = f"{algo} {kw} {'x'.join(map(str, geometry[:2]))}->" \
          f"{'x'.join(map(str, geometry[2:]))}"
    if undefined:
        assert_defined_divergence(algo, kw, geometry, src, msg)
        return
    plan = build_plan(algo, *geometry, **kw)
    want = numpy_ref.resize_u8(plan, src)
    np.testing.assert_array_equal(_torch_path(plan, src), want, err_msg=msg)
    np.testing.assert_array_equal(
        jax_numpy_ref.resize_u8(jax_build_plan(algo, *geometry, **kw), src), want,
        err_msg=f"JAX numpy_ref {msg}")


@pytest.mark.parametrize("i", range(N))
def test_fuzz_lanczos(i):
    algo, kw, geometry, src = DRAWS["lanczos"][i]
    _check(algo, kw, geometry, src,
           _lanczos_crash(build_plan(algo, *geometry, **kw)))


@pytest.mark.parametrize("i", range(N))
def test_fuzz_area(i):
    _check(*DRAWS["area"][i], undefined=False)


@pytest.mark.parametrize("i", range(N))
def test_fuzz_linear(i):
    algo, kw, geometry, src = DRAWS["linear"][i]
    plan = build_plan(algo, *geometry, **kw)
    _check(algo, kw, geometry, src, plan.y.reference_oob or plan.x.reference_oob)


@pytest.mark.parametrize("i", range(N_XLA))
def test_fuzz_xla_path(i):
    """The port's torch path == the JAX package's XLA path == numpy_ref."""
    algo, kw, geometry, src = DRAWS["xla"][i]
    jplan = jax_build_plan(algo, *geometry, **kw)
    fn, ops = xla_resize.make_resize_fn(jplan)
    got = np.asarray(jax.jit(fn)(*ops, src))
    plan = build_plan(algo, *geometry, **kw)
    want = numpy_ref.resize_u8(plan, src)
    msg = f"{algo} {kw} {geometry}"
    np.testing.assert_array_equal(got, want, err_msg=f"xla {msg}")
    np.testing.assert_array_equal(_torch_path(plan, src), want, err_msg=f"torch {msg}")


def test_draws_follow_the_jax_files_classes():
    """The draws cover the JAX file's classes: Lanczos degree 1-4 at
    px_scale 1-2, with some undefined (crash) plans; Linear with some
    reference_oob plans; sizes up to 699 x 499."""
    lz = DRAWS["lanczos"]
    assert {kw["degree"] for _, kw, _, _ in lz} <= {1, 2, 3, 4}
    assert {kw["px_scale"] for _, kw, _, _ in lz} == {1, 2}
    geoms = [g for k in DRAWS for _, _, g, _ in DRAWS[k]]
    assert max(g[0] for g in geoms) < 700 and max(g[1] for g in geoms) < 500
    assert all(src.shape == g[1::-1] for k in DRAWS for _, _, g, src in DRAWS[k])
