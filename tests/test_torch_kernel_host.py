"""Host side of the port's CUDA kernel (libiqo_tpu_torch.ops.cuda_resize).

The kernel itself compiles and runs only on an NVIDIA card; here the tests
pin what surrounds it: the column windows and shared-memory size at the
main path's full size, the scope predicate, the nvcc command, the launch
counter, importing without nvcc or JAX, and a NumPy model of the kernel's
tile loop over the very tables it is handed.  Tests marked ``cuda`` run the
kernel and skip without a card.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libiqo_tpu.coeffs.engine import trunc_div
from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import numpy_ref
from libiqo_tpu_torch.ops import _build, cuda_resize, torch_resize

ROOT = Path(__file__).resolve().parents[1]

MAIN_PLANS = {
    "luma": dict(algorithm="lanczos", src_w=3840, src_h=2160, dst_w=1920,
                 dst_h=1080, degree=3),
    "chroma": dict(algorithm="lanczos", src_w=1920, src_h=1080, dst_w=960,
                   dst_h=540, degree=3, px_scale=2),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(MAIN_PLANS))
def test_windows_cover_every_tap(name):
    plan = build_plan(**MAIN_PLANS[name])
    ax = plan.x
    win = cuda_resize.tile_windows(ax)
    assert win.shape == (-(-ax.n_dst // cuda_resize.TILE_COLS), 2)
    assert (win[:, 0] >= 0).all() and (win[:, 1] <= ax.n_src).all()
    assert (win[:, 0] < win[:, 1]).all()
    tile = np.arange(ax.n_dst) // cuda_resize.TILE_COLS
    lo, hi = win[tile, 0][:, None], win[tile, 1][:, None]
    taps = ax.start[:, None] + np.arange(ax.num_coefs)
    nonzero = ax.coef != 0
    assert ((taps >= lo) & (taps < hi))[nonzero].all()
    clamped = torch_resize.clamped_taps(ax)      # what the kernel reads
    assert ((clamped >= lo) & (clamped < hi)).all()


@pytest.mark.parametrize("name", sorted(MAIN_PLANS))
def test_smem_within_budget(name):
    plan = build_plan(**MAIN_PLANS[name])
    tables = cuda_resize.kernel_tables(plan)
    nbytes = cuda_resize.smem_bytes(plan)
    assert nbytes == cuda_resize.TILE_ROWS * tables.win_max * 4
    assert nbytes <= cuda_resize.SMEM_BUDGET
    # a 2:1 tile reads about 2 * TILE_COLS + taps columns
    assert tables.win_max <= 2 * cuda_resize.TILE_COLS + plan.x.num_coefs


def test_supports_plan_scope():
    for kw in MAIN_PLANS.values():
        assert cuda_resize.supports_plan(build_plan(**kw))
    assert not cuda_resize.supports_plan(build_plan("area", 3840, 2160, 1920, 1080))
    assert not cuda_resize.supports_plan(build_plan("linear", 3840, 2160, 1920, 1080))
    assert not cuda_resize.supports_plan(
        build_plan("lanczos", 64, 48, 32, 24, degree=3, px_scale=3))
    # a 40:1 downscale needs a work tile wider than shared memory holds
    assert not cuda_resize.supports_plan(
        build_plan("lanczos", 40960, 8, 1024, 8, degree=3))


def test_nvcc_command_targets_sm90a():
    cmd = _build.nvcc_command("nvcc", Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    assert [str(p) for p in _build.sources()] == cmd[-len(_build.sources()):]
    assert any(p.name == "resize_fused.cu" for p in _build.sources())


def test_import_needs_no_nvcc():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    code = ("from libiqo_tpu_torch.ops import cuda_resize, _build; "
            "print(cuda_resize.LAUNCHES, _build._lib is None)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "True"]


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the kernel library cannot be built, and loading it
    raises: nothing falls back to the plain path."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "lib")
    monkeypatch.setattr(_build, "_lib", None)
    cuda_resize._lib.cache_clear()
    try:
        with pytest.raises(_build.BuildError, match="nvcc not found"):
            cuda_resize._lib()
    finally:
        cuda_resize._lib.cache_clear()


def test_launches_stay_zero_on_cpu():
    plan = build_plan(**MAIN_PLANS["chroma"])
    ops = cuda_resize.pack_operands(plan)
    assert ops.tables is None           # the kernel's tables are CUDA-only
    src = torch.zeros((2, 1080, 1920), dtype=torch.uint8)
    before = cuda_resize.LAUNCHES
    out = cuda_resize.resize_fused(ops, src)
    assert out.shape == (2, 540, 960)
    assert cuda_resize.LAUNCHES == before == 0


def test_port_runs_without_jax():
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
import numpy as np
import libiqo_tpu_torch
from libiqo_tpu_torch.yuv import YUV420Frame, YUV420Resizer
from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import numpy_ref
rng = np.random.default_rng(3)
f = YUV420Frame(rng.integers(0, 256, (48, 64), np.uint8),
                rng.integers(0, 256, (24, 32), np.uint8),
                rng.integers(0, 256, (24, 32), np.uint8))
out = YUV420Resizer("lanczos3", 64, 48, 32, 24).resize(f)
want = numpy_ref.resize_u8(build_plan("lanczos", 64, 48, 32, 24), f.y)
assert np.array_equal(out.y, want)
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith("jax.")]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# -- a NumPy model of the kernel's arithmetic over its own tables ----------

def _wrap16(v):
    """int16_t narrowing of the low 16 bits, as the kernel's wrap16."""
    low = np.asarray(v).astype(np.int64) & 0xFFFF
    return (low - ((low & 0x8000) << 1)).astype(np.int32)


def _kernel_model(plan, k: cuda_resize.KernelTables, src):
    """What resize_fused.cu computes for one frame, column tile by column
    tile: uint32 accumulation, int16 narrowing, C truncating divides, the
    arithmetic shift, and reads confined to each tile's window."""
    cy, iy, ydiv, cx, ix, xdiv, win = (
        t.numpy() for t in (k.cy, k.iy, k.ydiv, k.cx, k.ix, k.xdiv, k.win))
    dst_h, dst_w = plan.y.n_dst, plan.x.n_dst
    half = np.uint32(1 << (plan.out_shift - 1))
    out = np.empty((dst_h, dst_w), np.uint8)
    for tile, (lo, hi) in enumerate(win):
        assert hi - lo <= k.win_max
        acc = np.zeros((dst_h, hi - lo), np.uint32)
        for c, i in zip(cy, iy):
            acc += c.astype(np.uint32)[:, None] * src[i, lo:hi].astype(np.uint32)
        work = _wrap16(acc)
        b = ydiv != 0
        work[b] = _wrap16(trunc_div(work[b].astype(np.int64) * plan.y.bias,
                                    ydiv[b, None].astype(np.int64)))
        cols = slice(tile * cuda_resize.TILE_COLS,
                     min(dst_w, (tile + 1) * cuda_resize.TILE_COLS))
        sums = np.zeros((dst_h, cols.stop - cols.start), np.uint32)
        for c, i in zip(cx[:, cols], ix[:, cols]):
            j = i - lo
            assert ((j >= 0) & (j < hi - lo)).all()
            sums += c.astype(np.uint32) * work[:, j].astype(np.uint32)
        s = (sums + half).view(np.int32)
        d = xdiv[cols]
        v = np.where(d != 0, trunc_div(s.astype(np.int64), np.where(d, d, 1)),
                     s >> plan.out_shift)
        out[:, cols] = np.clip(_wrap16(v), 0, 255)
    return out


@pytest.mark.parametrize("kw,sw,sh,dw,dh", [
    (dict(degree=3), 480, 270, 240, 135),
    (dict(degree=3, px_scale=2), 240, 135, 120, 67),
    (dict(degree=2), 75, 41, 300, 97),
    (dict(degree=5, px_scale=2), 333, 91, 61, 200),
    (dict(degree=3), 300, 40, 150, 3),    # Y stale-iterator rows
])
def test_kernel_model_matches_oracle(kw, sw, sh, dw, dh):
    plan = build_plan("lanczos", sw, sh, dw, dh, **kw)
    assert cuda_resize.supports_plan(plan)
    tables = cuda_resize.kernel_tables(plan)
    src = np.random.default_rng(sw * dh).integers(0, 256, (sh, sw), np.uint8)
    np.testing.assert_array_equal(_kernel_model(plan, tables, src),
                                  numpy_ref.resize_u8(plan, src))


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MAIN_PLANS))
def test_kernel_matches_plain_on_card(cuda_device, name):
    plan = build_plan(**MAIN_PLANS[name])
    ops = cuda_resize.pack_operands(plan, cuda_device)
    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.integers(0, 256, (2, plan.y.n_src, plan.x.n_src),
                                        np.uint8)).to(cuda_device)
    before = cuda_resize.LAUNCHES
    got = cuda_resize.resize_fused(ops, src)
    assert cuda_resize.LAUNCHES == before + 1
    assert torch.equal(got, cuda_resize.resize_plain(ops, src))


@pytest.mark.cuda
def test_kernel_refuses_unsupported_plan_on_card(cuda_device):
    plan = build_plan("area", 64, 48, 32, 24)
    ops = cuda_resize.pack_operands(plan, cuda_device)
    with pytest.raises(ValueError):
        cuda_resize.resize_fused(ops, torch.zeros((1, 48, 64), dtype=torch.uint8,
                                                  device=cuda_device))
