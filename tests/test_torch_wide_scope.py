"""The port's kernel scope on wide windows against the JAX package's.

``cuda_resize.work_rows`` gives the plans whose windows are too wide for
16 rows of the windowed kernel 4-15 rows a block on any number of column
tiles, so every plan that the JAX package's kernel takes runs on a kernel
of the port: the wide-window kernel (``csrc/resize_wide.cu``) by default,
the windowed kernel's walk at those rows with ``wide=False``.  Over a grid
of large Area and Lanczos3 downscales, JAX ``supports_plan`` implies the
port's (the JAX plan is built only where the port refuses, which keeps the
grid cheap); the wide-window plans resolve to ``cuda``, Area 65536x16 ->
16x16 (windows past 4 rows of shared memory) to ``torch``; the relaxed form
keeps 16 rows, so a relaxed resizer takes the exact kernel there; and both
kernels' NumPy models (``test_torch_wide_kernel.wide_model``,
``test_torch_card_check.walk_model``) equal ``numpy_ref`` on small plans
with several column tiles and fewer than 16 rows a block.
"""

import numpy as np
import pytest
import torch

from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.ops import pallas_resize
from libiqo_tpu_torch import api
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize
from libiqo_tpu_torch.tools import card_check

from test_torch_card_check import walk_model
from test_torch_wide_kernel import wide_model

CARD = torch.device("cuda", 0)
SOURCES = {"8K": (7680, 4320), "4K": (3840, 2160), "4096sq": (4096, 4096)}
FACTORS = (2, 4, 8, 16, 32, 64)
GRID = [(alg, src, f) for alg in ("area", "lanczos3") for src in SOURCES for f in FACTORS]


def _plan(build, alg, sw, sh, dw, dh):
    if alg == "lanczos3":
        return build("lanczos", sw, sh, dw, dh, degree=3)
    return build(alg, sw, sh, dw, dh)


@pytest.mark.parametrize("alg,src,factor", GRID, ids=[f"{a}-{s}-by{f}" for a, s, f in GRID])
def test_jax_scope_implies_port_scope(alg, src, factor):
    sw, sh = SOURCES[src]
    geometry = (sw, sh, sw // factor, sh // factor)
    plan = _plan(build_plan, alg, *geometry)
    if cuda_resize.supports_plan(plan):
        assert cuda_resize.work_rows(plan) >= cuda_resize.MIN_WORK_ROWS
        return
    assert not pallas_resize.supports_plan(_plan(jax_build_plan, alg, *geometry))


@pytest.mark.parametrize("case", card_check.WIDE_WINDOW, ids=card_check.case_name)
def test_wide_window_plans_resolve_to_the_kernel(case):
    alg, sw, sh, dw, dh, kw = case
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    assert cuda_resize.smem_bytes(plan) > cuda_resize.SMEM_BUDGET
    rows = cuda_resize.work_rows(plan)
    assert cuda_resize.MIN_WORK_ROWS <= rows < cuda_resize.TILE_ROWS
    assert -(-dw // cuda_resize.TILE_COLS) >= 1
    r = api.Resizer.from_plan(plan, device="cpu")
    assert r._backend_for(CARD) == "cuda"
    # the relaxed form keeps its 16 rows: the ladder takes the exact kernel
    assert not cuda_resize.supports_plan(plan, relaxed=True)
    rr = api.Resizer.from_plan(plan, precision="relaxed", device="cpu")
    assert rr._backend_for(CARD) == "cuda"
    k = cuda_resize.kernel_tables(plan, tiled=False)
    assert isinstance(k, cuda_resize.WideTables) and k.layout.smem <= cuda_resize.SMEM_BUDGET
    walk = cuda_resize.kernel_tables(plan, tiled=False, wide=False)
    assert not walk.tiled and walk.rows == rows
    assert walk.rows * walk.win_max * 4 <= cuda_resize.SMEM_BUDGET


def test_wide_window_rows_and_grids():
    """The two plans the JAX package's kernel takes, on the windowed walk:
    14 rows a block, 2 and 1 column tiles of 4096 columns, 39 row tiles."""
    for case, tiles in zip(card_check.WIDE_WINDOW[:2], (2, 1)):
        plan = build_plan(*case[:5])
        assert pallas_resize.supports_plan(jax_build_plan(*case[:5]))
        k = cuda_resize.kernel_tables(plan, tiled=False, wide=False)
        assert (k.rows, k.win_max, len(k.win)) == (14, 4096, tiles)
        assert -(-plan.y.n_dst // k.rows) == 39


@pytest.mark.parametrize("geometry", [(65536, 16, 16, 16), (16384, 4, 16, 4)])
def test_past_four_rows_stays_on_torch(geometry):
    plan = build_plan("area", *geometry)
    assert cuda_resize.work_rows(plan) == 0 and not cuda_resize.supports_plan(plan)
    assert api.AreaResizer(*geometry, device="cpu")._backend_for(CARD) == "torch"
    assert not pallas_resize.supports_plan(jax_build_plan("area", *geometry))


# small plans with several column tiles whose windows are too wide for 16
# rows: the walk's rows and tiles, modelled block by block
MODEL_PLANS = [
    ("area", 8192, 40, 256, 20, {}),                    # 2 tiles, 14 rows, 2 row tiles
    ("area", 12288, 33, 384, 33, {}),                   # 3 tiles, 14 rows, a partial tile
    ("lanczos", 7680, 60, 240, 30, dict(degree=3)),     # wrap16, 13 rows, border divides
    ("area", 40960, 8, 1024, 8, {}),                    # 8 tiles, 11 rows
]


@pytest.mark.parametrize("case", MODEL_PLANS, ids=card_check.case_name)
def test_walk_model_on_several_column_tiles(case):
    alg, sw, sh, dw, dh, kw = case
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    k = cuda_resize.kernel_tables(plan, tiled=False, wide=False)
    assert len(k.win) > 1 and k.rows == cuda_resize.work_rows(plan) < cuda_resize.TILE_ROWS
    src = card_check.source(case, 0)
    want = numpy_ref.resize_u8(plan, src)
    np.testing.assert_array_equal(walk_model(plan, k, src), want)
    wide = cuda_resize.kernel_tables(plan, tiled=False)
    assert isinstance(wide, cuda_resize.WideTables)
    np.testing.assert_array_equal(wide_model(plan, wide.layout, src), want)
    ops = cuda_resize.pack_operands(plan)             # the CPU's plain route
    np.testing.assert_array_equal(
        cuda_resize.resize_fused(ops, torch.from_numpy(src)[None])[0].numpy(), want)
