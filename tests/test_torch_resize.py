"""The port's kernel module (libiqo_tpu_torch.ops.cuda_resize) against the
JAX package, on the CPU, where the wrapper runs the kernel's plain version.

Every geometry goes through four implementations that must agree byte for
byte (tolerance 0 LSB: the contract is byte-exact):

1. ``cuda_resize.resize_fused`` on CPU tensors (-> ``resize_plain``), over
   the port's own plan;
2. the NumPy oracle ``numpy_ref.resize_u8`` of the JAX package;
3. ``xla_resize.make_resize_fn`` under ``jax.jit`` on the CPU;
4. where ``pallas_resize.supports_plan``, the Pallas kernel in interpret
   mode, as tests/test_pallas.py runs it.
"""

import jax
import numpy as np
import pytest
import torch

from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.golden import numpy_ref
from libiqo_tpu.ops import pallas_resize, xla_resize
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.ops import cuda_resize, torch_resize

CASES = [
    # algo, kwargs, sw, sh, dw, dh
    ("lanczos", dict(degree=3), 960, 540, 480, 270),       # luma-like 2:1
    ("lanczos", dict(degree=3, px_scale=2), 480, 270, 240, 135),  # chroma
    ("lanczos", dict(degree=2), 160, 90, 240, 135),        # upsample deg 2
    ("lanczos", dict(degree=4), 96, 64, 200, 150),         # upsample deg 4
    ("lanczos", dict(degree=9), 64, 48, 150, 100),         # upsample deg 9
    ("lanczos", dict(degree=3), 255, 143, 127, 71),        # odd sizes
    ("lanczos", dict(degree=3), 480, 512, 480, 256),       # X identity
    ("lanczos", dict(degree=3), 512, 270, 256, 270),       # Y identity
    ("linear", {}, 16, 12, 80, 60),                        # reference_oob
]


def _ids(c):
    kw = "".join(f"-{k}{v}" for k, v in c[1].items())
    return f"{c[0]}{kw}-{c[2]}x{c[3]}-{c[4]}x{c[5]}"


def _src(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _oracle(plan, src):
    return np.stack([numpy_ref.resize_u8(plan, f) for f in src])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_port_matches_jax_and_oracle(case):
    algo, kw, sw, sh, dw, dh = case
    plan = jax_build_plan(algo, sw, sh, dw, dh, **kw)
    src = _src(sw * sh + dw, (2, sh, sw))
    want = _oracle(plan, src)

    ops = cuda_resize.pack_operands(build_plan(algo, sw, sh, dw, dh, **kw))
    got = cuda_resize.resize_fused(ops, torch.from_numpy(src))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want, err_msg="port")

    fn, xops = xla_resize.make_resize_fn(plan)
    np.testing.assert_array_equal(np.asarray(jax.jit(fn)(*xops, src)), want,
                                  err_msg="xla")
    if pallas_resize.supports_plan(plan):
        fn, pops = pallas_resize.make_resize_fn(plan, interpret=True)
        np.testing.assert_array_equal(np.asarray(jax.jit(fn)(*pops, src)),
                                      want, err_msg="pallas")


def test_reference_oob_case_is_one():
    algo, kw, *geometry = CASES[-1]
    plan = build_plan(algo, *geometry, **kw)
    assert plan.y.reference_oob or plan.x.reference_oob


@pytest.mark.parametrize("algo,sw,sh,dw,dh", [
    ("area", 960, 540, 240, 135),
    ("area", 400, 300, 80, 60),            # 5:1
    ("area", 123, 77, 41, 19),             # odd, non-integer ratio
    ("linear", 640, 480, 320, 240),
    ("linear", 64, 48, 128, 96),           # upsample
    ("linear", 97, 61, 40, 150),           # mixed, odd
])
def test_area_linear_plain_path(algo, sw, sh, dw, dh):
    """Area and Linear plans are inside the kernel's scope (its u16
    instantiation); on CPU tensors the wrapper runs the kernel's plain
    version, byte-equal to the JAX package's oracle."""
    plan = build_plan(algo, sw, sh, dw, dh)
    assert cuda_resize.supports_plan(plan)
    assert cuda_resize.variant(plan) == "u16"
    src = _src(sw + sh, (2, sh, sw))
    ops = cuda_resize.pack_operands(plan)
    assert ops.tables is None           # the kernel's tables are CUDA-only
    got = cuda_resize.resize_fused(ops, torch.from_numpy(src))
    want = _oracle(jax_build_plan(algo, sw, sh, dw, dh), src)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_path_strided_and_leading_dims():
    """torch_resize takes strided views and any leading dimensions."""
    plan = build_plan("lanczos", 101, 67, 50, 33, degree=3)
    big = _src(5, (2, 3, 70, 104))
    view = torch.from_numpy(big)[..., 1:68, 2:103]
    got = torch_resize.resize(torch_resize.pack_operands(plan), view)
    assert got.shape == (2, 3, 33, 50)
    want = _oracle(plan, big[..., 1:68, 2:103].reshape(6, 67, 101))
    np.testing.assert_array_equal(got.reshape(6, 33, 50).numpy(), want)


def test_plain_path_rejects_bad_input():
    ops = torch_resize.pack_operands(build_plan("lanczos", 32, 24, 16, 12))
    with pytest.raises(ValueError):
        torch_resize.resize(ops, torch.zeros((24, 31), dtype=torch.uint8))
    with pytest.raises(TypeError):
        torch_resize.resize(ops, torch.zeros((24, 32), dtype=torch.int32))
