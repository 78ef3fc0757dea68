"""The port's truncating divides against the JAX package's reference.

``test_exact_div.py`` holds the TPU kernel's float lowering of the divide
(``_exact_trunc_div``) to ``jax.lax.div``.  The port has no such lowering:
its kernels divide with C++ ``/``, which truncates toward zero by language
rule; its plain path divides int64 tensors with ``torch.div(...,
rounding_mode="trunc")`` (``torch_resize._y_pass``, ``_epilogue``); its
kernel models use ``coeffs.engine.trunc_div``.  The same vector classes
(random over every divisor magnitude class, exact multiples and their
neighbours, extremes including ``INT32_MIN``, small divisors at their
quotient edges, the plans' own denominators) hold both to ``jax.lax.div``.
Then, over the gate's fuzz and stress plans, every divide the kernels do is
shown defined in C++: a nonzero divisor, a numerator inside int32, and never
``INT32_MIN / -1``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libiqo_tpu_torch.coeffs.engine import trunc_div
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.ops import cuda_resize
from libiqo_tpu_torch.tools import card_check

RNG = np.random.default_rng(17)
I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _wrap32(v: np.ndarray) -> np.ndarray:
    return ((v + 2**31) & (2**32 - 1)) - 2**31


def _check(n: np.ndarray, d: np.ndarray):
    """torch's trunc divide (int64, as the plain path) and trunc_div ==
    jax.lax.div in int32, modulo 2^32 (the plain path wraps after it)."""
    n, d = n.astype(np.int32), d.astype(np.int32)
    want = np.asarray(jax.lax.div(jnp.asarray(n), jnp.asarray(d))).astype(np.int64)
    n64, d64 = n.astype(np.int64), d.astype(np.int64)
    got = torch.div(torch.from_numpy(n64), torch.from_numpy(d64),
                    rounding_mode="trunc").numpy()
    for name, v in (("torch.div", got), ("trunc_div", trunc_div(n64, d64))):
        bad = _wrap32(v) != want
        assert not bad.any(), (
            f"{name}: {bad.sum()} mismatches, first: n={n[bad][0]} d={d[bad][0]} "
            f"got={v[bad][0]} want={want[bad][0]}")


def test_random_full_range():
    n = RNG.integers(I32_MIN, I32_MAX + 1, 1 << 16, dtype=np.int64)
    mag = np.unique(np.concatenate([
        RNG.integers(1, 1 << 8, 1 << 14),
        RNG.integers(1, 1 << 16, 1 << 14),
        RNG.integers(1, 1 << 22, 1 << 14),
        RNG.integers(1, 1 << 29, 1 << 13),
    ]))
    d = RNG.choice(mag, n.size) * RNG.choice([-1, 1], n.size)
    _check(n, d)


def test_exact_multiples_and_neighbors():
    for _ in range(8):
        d = RNG.integers(2, 1 << 21, 1 << 12, dtype=np.int64) \
            * RNG.choice([-1, 1], 1 << 12)
        k = RNG.integers(-(1 << 20), 1 << 20, d.size, dtype=np.int64)
        base = np.clip(k * d, I32_MIN + 1, I32_MAX - 1)
        for off in (-1, 0, 1):
            _check(base + off, d)


def test_extreme_dividends():
    n = np.array([I32_MIN, I32_MIN + 1, I32_MAX, I32_MAX - 1,
                  0, 1, -1, 2**30, -2**30, 2**19, -2**19] * 9)
    d = np.repeat([1, -1, 2, -2, 3, 64, -64, 65535, 2**21 - 1], 11)
    _check(n, d)


def test_small_divisors_exhaustive_quotient_edges():
    ds = np.arange(1, 513, dtype=np.int64)
    for sign in (1, -1):
        d = np.repeat(ds * sign, 9)
        k = np.tile(np.array([-3, -2, -1, 0, 1, 2, 3, 1000, -1000]), ds.size)
        for off in (-1, 0, 1):
            _check(k * np.abs(d) + off, d)


def test_plan_denominator_population():
    """Every denominator of a set of pathological plans, and the X border
    divisors the kernels use (``deno_x * y_bias``), against dividends near
    their multiples."""
    plans = [
        build_plan("lanczos", 1920, 1080, 960, 540, degree=3, px_scale=2),
        build_plan("lanczos", 256, 70, 256, 5, degree=3),
        build_plan("lanczos", 363, 614, 364, 18, degree=4),
        build_plan("lanczos", 1280, 720, 1920, 1080, degree=2),
    ]
    denos = set()
    for p in plans:
        denos.update(int(v) for v in np.unique(p.y.coef.sum(axis=1)))
        denos.update(int(v) for v in np.unique(p.y.deno))
        denos.update(int(v) * 64 for v in np.unique(p.x.deno))
        denos.update(int(v) for v in np.unique(cuda_resize._x_divisors(p)))
    denos.discard(0)
    d = np.repeat(np.array(sorted(denos), np.int64), 12)
    k = np.tile(np.array([-5000, -1, 0, 1, 5000, 32767] * 2), d.size // 12)
    for off in (-1, 0, 1):
        _check(np.clip(k * np.abs(d) + off, I32_MIN + 1, I32_MAX - 1), d)


GATE_PLANS = (card_check.GRADED + card_check.STRESS + card_check.STRESS_GEOMETRIES
              + card_check.fuzz_cases(20) + card_check.border_cases())


@pytest.mark.parametrize("case", GATE_PLANS, ids=card_check.case_name)
def test_every_kernel_divide_is_defined(case):
    """The divides of both kernels, from the divisors they are handed:

    * Y border rows: ``(w * y_bias) / ydiv`` with ``w`` an int16, so the
      numerator lies in [-32768 y_bias, 32767 y_bias], which must lie
      strictly inside int32: it is then never ``INT32_MIN``, and a divisor
      of -1 (px_scale 4 plans have them) is defined;
    * X border columns: ``s / xdiv`` with ``s`` the int32 rounded sum, which
      may be ``INT32_MIN``, so ``xdiv`` must fit int32 and never be -1.

    Every divisor a border output takes is nonzero.  Main outputs take no
    divide (their divisor word is 0 and the kernels test it)."""
    alg, sw, sh, dw, dh, kw = case
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    assert cuda_resize.supports_plan(plan)
    if not plan.wrap16:       # Area, Linear: no border outputs, no divide
        assert not plan.y.is_border.any() and not plan.x.is_border.any()
        return
    bias = plan.y.bias
    assert -32768 * bias > I32_MIN and 32767 * bias <= I32_MAX
    ydiv = np.where(plan.y.is_border, np.where(plan.y.deno == 0, 1, plan.y.deno), 0)
    xdiv = cuda_resize._x_divisors(plan)
    lay = cuda_resize.tiled_layout(plan)
    rdiv = lay.rrec[:, 4 + 16:4 + 32].ravel()[:plan.y.n_dst]
    cdiv = lay.crec[:, 4 + 2 * lay.tw:4 + 3 * lay.tw].ravel()[:plan.x.n_dst]
    np.testing.assert_array_equal(rdiv, ydiv)       # the tiled kernel's records
    np.testing.assert_array_equal(cdiv, xdiv)
    for div, border in ((ydiv, plan.y.is_border), (xdiv, plan.x.is_border)):
        assert ((div != 0) == border).all()
        assert (np.abs(div) <= I32_MAX).all()
    assert not (xdiv == -1).any()
