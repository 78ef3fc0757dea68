"""Host side of the port's CUDA kernel (libiqo_tpu_torch.ops.cuda_resize).

The kernel itself compiles and runs only on an NVIDIA card; here the tests
pin what surrounds it: the column windows and shared-memory size at the
main path's full size, the scope predicate, the nvcc command, the launch
counters, importing without nvcc, JAX or the JAX package, and a NumPy model
of the kernel's tile loop over the very tables it is handed, in both
instantiations (wrap16 for Lanczos, u16 for Area and Linear) and in the
relaxed form of each.  Tests marked ``cuda`` run the kernel and skip
without a card.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libiqo_tpu_torch.coeffs.engine import trunc_div
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import _build, cuda_resize, torch_resize

ROOT = Path(__file__).resolve().parents[1]

MAIN_PLANS = {
    "luma": dict(algorithm="lanczos", src_w=3840, src_h=2160, dst_w=1920,
                 dst_h=1080, degree=3),
    "chroma": dict(algorithm="lanczos", src_w=1920, src_h=1080, dst_w=960,
                   dst_h=540, degree=3, px_scale=2),
}
# the u16 instantiation's full-width planes (luma, and chroma at half size)
U16_PLANS = {
    "area360p_luma": dict(algorithm="area", src_w=1920, src_h=1080, dst_w=640,
                          dst_h=360),
    "area360p_chroma": dict(algorithm="area", src_w=960, src_h=540, dst_w=320,
                            dst_h=180),
    "area1080p": dict(algorithm="area", src_w=3840, src_h=2160, dst_w=1920,
                      dst_h=1080),
    "linear4k_luma": dict(algorithm="linear", src_w=1920, src_h=1080,
                          dst_w=3840, dst_h=2160),
    "linear4k_chroma": dict(algorithm="linear", src_w=960, src_h=540,
                            dst_w=1920, dst_h=1080),
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
    tables = cuda_resize.kernel_tables(plan, tiled=False)
    nbytes = cuda_resize.smem_bytes(plan)
    assert nbytes == cuda_resize.TILE_ROWS * tables.win_max * 4
    assert nbytes <= cuda_resize.SMEM_BUDGET
    # a 2:1 tile reads about 2 * TILE_COLS + taps columns
    assert tables.win_max <= 2 * cuda_resize.TILE_COLS + plan.x.num_coefs


def _with_axis(plan, axis, **fields):
    """plan with some fields of one axis replaced."""
    ax = dataclasses.replace(getattr(plan, axis), **fields)
    return dataclasses.replace(plan, **{axis: ax})


def test_supports_plan_scope():
    for kw in (*MAIN_PLANS.values(), *U16_PLANS.values()):
        plan = build_plan(**kw)
        assert cuda_resize.supports_plan(plan), kw
        assert cuda_resize.variant(plan) == ("wrap16" if plan.wrap16 else "u16")
    for kw in (dict(degree=3, px_scale=3), dict(degree=5, px_scale=4)):
        assert cuda_resize.supports_plan(build_plan("lanczos", 64, 48, 32, 24, **kw))
    # an extreme Area ratio (40/44 taps) whose windows still fit
    assert cuda_resize.supports_plan(build_plan("area", 300, 200, 7, 5))

    area = build_plan("area", 123, 77, 41, 19)
    border = area.y.is_border.copy()
    border[0] = True
    assert not cuda_resize.supports_plan(_with_axis(area, "y", is_border=border))
    border = area.x.is_border.copy()
    border[-1] = True
    assert not cuda_resize.supports_plan(_with_axis(area, "x", is_border=border))
    neg = area.y.coef.copy()
    neg[3, 0], neg[3, 1] = -1, neg[3, 1] + 1       # row sum unchanged
    assert not cuda_resize.supports_plan(_with_axis(area, "y", coef=neg))
    # Y rows summing to 256 and X rows to 33000: 255*256*33000 + 2^22 >= 2^31
    wide = area.x.coef.copy()
    wide[0, 0] += 33000 - wide[0].sum()
    assert not cuda_resize.supports_plan(_with_axis(area, "x", coef=wide))
    # a 4096:1 downscale needs a window wider than 4 rows of shared memory
    assert not cuda_resize.supports_plan(
        build_plan("lanczos", 65536, 16, 16, 16, degree=3))
    assert not cuda_resize.supports_plan(build_plan("area", 65536, 16, 16, 16))


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
    """The port's YUV path and its numpy backend run with both ``jax`` and
    the JAX package blocked: every import of either fails."""
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["libiqo_tpu"] = None   # and any import of the JAX package
import numpy as np
import libiqo_tpu_torch
from libiqo_tpu_torch import AreaResizer, build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.yuv import YUV420Frame, YUV420Resizer
rng = np.random.default_rng(3)
f = YUV420Frame(rng.integers(0, 256, (48, 64), np.uint8),
                rng.integers(0, 256, (24, 32), np.uint8),
                rng.integers(0, 256, (24, 32), np.uint8))
for m, algo in (("lanczos3", "lanczos"), ("area", "area"), ("linear", "linear")):
    out = YUV420Resizer(m, 64, 48, 32, 24, device="cpu").resize(f)
    want = numpy_ref.resize_u8(build_plan(algo, 64, 48, 32, 24), f.y)
    assert np.array_equal(out.y, want), m
oracle = AreaResizer(64, 48, 32, 24, backend="numpy", device="cpu").resize(f.y)
assert np.array_equal(oracle, numpy_ref.resize_u8(build_plan("area", 64, 48, 32, 24), f.y))
assert sys.modules["jax"] is None and sys.modules["libiqo_tpu"] is None
assert not [m for m in sys.modules if m.startswith(("jax.", "libiqo_tpu."))]
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


def _bf16(a):
    """float32 values rounded to bfloat16 (to nearest even), as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _float_taps(plane, ix, wf, lo):
    """The relaxed kernel's float_taps: sum_t plane[t] * wf[:, ix[t] - lo] in
    float32, tap by tap in order, truncated toward zero, as uint32."""
    acc = np.zeros((wf.shape[0], plane.shape[1]), np.float32)
    for c, i in zip(plane, ix):
        acc = acc + c * wf[:, i - lo]          # float32 product, float32 add
    return acc.astype(np.int32).astype(np.uint32)


def _kernel_model(plan, k: cuda_resize.KernelTables, src):
    """What resize_fused.cu computes for one frame, column tile by column
    tile: uint32 accumulation and reads confined to each tile's window; in
    the wrap16 instantiation int16 narrowing, C truncating divides and the
    arithmetic shift; in the u16 one unwrapped work rows and an unsigned
    shift of sums + half.  Relaxed: the work rows rounded to bf16, the X
    sums in float32 over the plane (and the residual plane) truncated to
    int32, then the wrap16 instantiation's signed epilogue."""
    cy, iy, ydiv, cx, ix, xdiv, win, cxr, cxd = (
        t.numpy() for t in (k.cy, k.iy, k.ydiv, k.cx, k.ix, k.xdiv, k.win,
                            k.cxr, k.cxd))
    dst_h, dst_w = plan.y.n_dst, plan.x.n_dst
    half = np.uint32(1 << (plan.out_shift - 1))
    out = np.empty((dst_h, dst_w), np.uint8)
    for tile, (lo, hi) in enumerate(win):
        assert hi - lo <= k.win_max
        acc = np.zeros((dst_h, hi - lo), np.uint32)
        for c, i in zip(cy, iy):
            acc += c.astype(np.uint32)[:, None] * src[i, lo:hi].astype(np.uint32)
        if k.wrap16:
            work = _wrap16(acc)
            b = ydiv != 0
            work[b] = _wrap16(trunc_div(work[b].astype(np.int64) * plan.y.bias,
                                        ydiv[b, None].astype(np.int64)))
        else:
            assert acc.max(initial=0) <= 65280        # u16 work rows
            work = acc.astype(np.int32)
        cols = slice(tile * cuda_resize.TILE_COLS,
                     min(dst_w, (tile + 1) * cuda_resize.TILE_COLS))
        sums = np.zeros((dst_h, cols.stop - cols.start), np.uint32)
        if k.relaxed:
            wf = _bf16(work.astype(np.float32))
            for plane in (cxr, cxd) if cxd.size else (cxr,):
                sums += _float_taps(plane[:, cols], ix[:, cols], wf, lo)
        else:
            for c, i in zip(cx[:, cols], ix[:, cols]):
                j = i - lo
                assert ((j >= 0) & (j < hi - lo)).all()
                sums += c.astype(np.uint32) * work[:, j].astype(np.uint32)
        if k.wrap16 or k.relaxed:
            s = (sums + half).view(np.int32)
            d = xdiv[cols]
            v = _wrap16(np.where(d != 0, trunc_div(s.astype(np.int64),
                                                   np.where(d, d, 1)),
                                 s >> plan.out_shift))
        else:
            assert (sums.astype(np.int64) + int(half)).max(initial=0) < 2**31
            v = (sums + half) >> np.uint32(plan.out_shift)
        out[:, cols] = np.clip(v, 0, 255)
    return out


MODEL_PLANS = [
    ("lanczos", dict(degree=3), 480, 270, 240, 135),
    ("lanczos", dict(degree=3, px_scale=2), 240, 135, 120, 67),
    ("lanczos", dict(degree=2), 75, 41, 300, 97),
    ("lanczos", dict(degree=5, px_scale=2), 333, 91, 61, 200),
    ("lanczos", dict(degree=3), 300, 40, 150, 3),    # Y stale-iterator rows
    # K5's plans: taps outside the s8 gate, at px_scale 3 and 4
    ("lanczos", dict(degree=3, px_scale=3), 64, 48, 32, 24),
    ("lanczos", dict(degree=5, px_scale=4), 100, 70, 37, 90),
    ("lanczos", dict(degree=2, px_scale=3), 90, 60, 200, 130),
    ("lanczos", dict(degree=9, px_scale=4), 75, 41, 30, 100),
    # the u16 instantiation (K3+K4)
    ("area", {}, 480, 270, 160, 90),            # 3:1, as 1080p -> 360p
    ("area", {}, 960, 540, 480, 270),           # 2:1, as 4K -> 1080p
    ("linear", {}, 240, 135, 480, 270),         # 1:2, as 1080p -> 4K
    ("area", {}, 300, 200, 7, 5),               # 40/44 taps
    ("linear", {}, 16, 12, 80, 60),             # reference_oob
    ("linear", {}, 5, 3, 300, 200),             # reference_oob, 60x
    ("area", {}, 123, 77, 41, 19),              # odd, non-integer ratio
    ("linear", {}, 97, 61, 40, 150),            # mixed, odd
    ("area", {}, 400, 300, 80, 60),             # 5:1
]


@pytest.mark.parametrize("algo,kw,sw,sh,dw,dh", MODEL_PLANS)
def test_kernel_model_matches_oracle(algo, kw, sw, sh, dw, dh):
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    assert cuda_resize.supports_plan(plan)
    tables = cuda_resize.kernel_tables(plan, tiled=False)
    assert tables.wrap16 == (algo == "lanczos")
    src = np.random.default_rng(sw * dh).integers(0, 256, (sh, sw), np.uint8)
    np.testing.assert_array_equal(_kernel_model(plan, tables, src),
                                  numpy_ref.resize_u8(plan, src))


@pytest.mark.parametrize("algo,kw,sw,sh,dw,dh", MODEL_PLANS)
def test_relaxed_kernel_model_matches_plain(algo, kw, sw, sh, dw, dh):
    """The relaxed kernel's model, over its own tables, is byte-equal to the
    relaxed plain version (``torch_resize.resize_relaxed``): the equality
    the CUDA kernel is held to on the card."""
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    assert cuda_resize.supports_plan(plan, relaxed=True)
    ops = cuda_resize.pack_operands(plan, relaxed=True, tiled=False)
    assert ops.tables.relaxed
    assert cuda_resize.variant(ops.tables) == (
        "wrap16_relaxed" if algo == "lanczos" else "u16_relaxed")
    src = np.random.default_rng(sw + dh).integers(0, 256, (sh, sw), np.uint8)
    got = _kernel_model(plan, ops.tables, src)
    np.testing.assert_array_equal(
        got, cuda_resize.resize_plain(ops, torch.from_numpy(src)).numpy())
    want = numpy_ref.resize_u8(plan, src)
    assert np.abs(got.astype(int) - want).max() <= 2


@pytest.mark.parametrize("algo,kw,sw,sh,dw,dh", [
    ("lanczos", dict(degree=3), 320, 96, 160, 48),
    ("area", {}, 123, 77, 41, 19),
    ("linear", {}, 97, 61, 200, 150),
])
def test_relaxed_kernel_model_residual_plane(monkeypatch, algo, kw, sw, sh,
                                             dw, dh):
    """With the column-sum repair stubbed to plain rounding, the tables get
    a residual plane, and the model with it is still byte-equal to the
    relaxed plain version."""
    monkeypatch.setattr(cuda_resize, "_repaired_bf16", cuda_resize._bf16)
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    ops = cuda_resize.pack_operands(plan, relaxed=True, tiled=False)
    assert ops.tables.cxd.shape == ops.tables.cxr.shape
    src = np.random.default_rng(5).integers(0, 256, (sh, sw), np.uint8)
    np.testing.assert_array_equal(
        _kernel_model(plan, ops.tables, src),
        cuda_resize.resize_plain(ops, torch.from_numpy(src)).numpy())


def test_launch_counts_by_variant_reset():
    cuda_resize.reset_launches()
    assert cuda_resize.LAUNCHES == 0
    assert cuda_resize.LAUNCHES_BY_VARIANT == {
        "wrap16": 0, "u16": 0, "wrap16_relaxed": 0, "u16_relaxed": 0,
        "wrap16_carry": 0, "u16_carry": 0, "wrap16_relaxed_carry": 0,
        "u16_relaxed_carry": 0, "wrap16_tiled": 0, "u16_tiled": 0,
        "wrap16_relaxed_tiled": 0, "u16_relaxed_tiled": 0,
        "wrap16_carry_tiled": 0, "u16_carry_tiled": 0,
        "wrap16_relaxed_carry_tiled": 0, "u16_relaxed_carry_tiled": 0,
        "wrap16_wide": 0, "u16_wide": 0}


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
@pytest.mark.parametrize("name", sorted(U16_PLANS))
def test_u16_kernel_matches_plain_on_card(cuda_device, name):
    plan = build_plan(**U16_PLANS[name])
    ops = cuda_resize.pack_operands(plan, cuda_device, tiled=False)
    rng = np.random.default_rng(8)
    src = torch.from_numpy(rng.integers(0, 256, (2, plan.y.n_src, plan.x.n_src),
                                        np.uint8)).to(cuda_device)
    before = cuda_resize.LAUNCHES_BY_VARIANT["u16"]
    got = cuda_resize.resize_fused(ops, src)
    assert cuda_resize.LAUNCHES_BY_VARIANT["u16"] == before + 1
    assert torch.equal(got, cuda_resize.resize_plain(ops, src))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MAIN_PLANS) + sorted(U16_PLANS))
def test_relaxed_kernel_matches_plain_on_card(cuda_device, name):
    plan = build_plan(**{**MAIN_PLANS, **U16_PLANS}[name])
    ops = cuda_resize.pack_operands(plan, cuda_device, relaxed=True)
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.integers(0, 256, (2, plan.y.n_src, plan.x.n_src),
                                        np.uint8)).to(cuda_device)
    v = cuda_resize.variant(ops.tables)
    before = cuda_resize.LAUNCHES_BY_VARIANT[v]
    got = cuda_resize.resize_fused(ops, src)
    assert cuda_resize.LAUNCHES_BY_VARIANT[v] == before + 1
    assert torch.equal(got, cuda_resize.resize_plain(ops, src))


@pytest.mark.cuda
def test_kernel_refuses_unsupported_plan_on_card(cuda_device):
    plan = build_plan("area", 65536, 16, 16, 16)     # work tile > shared memory
    ops = cuda_resize.pack_operands(plan, cuda_device)
    with pytest.raises(ValueError):
        cuda_resize.resize_fused(ops, torch.zeros((1, 16, 65536), dtype=torch.uint8,
                                                  device=cuda_device))
