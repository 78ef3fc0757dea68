"""The row-halo carry form of the port's windowed kernel (``kCarry`` in
``libiqo_tpu_torch/csrc/resize_fused.cu``), on the CPU.  The tiled kernel's
carry form, which takes every plan whose ring fits, has its own tests in
``tests/test_torch_tiled_opt_ins.py``.

The kernel runs only on a card; here the tests pin its host side: a NumPy
model of the ring schedule over the very tables the kernel is handed
(every ring read must return the source row the windowed kernel reads),
``carry_ok`` against the re-read figures of the full-size planes, the
operand cache's keys, and the carry route on the CPU, which runs the plain
version.  Tests marked ``cuda`` hold the kernel to its windowed form on a
card and skip without one.
"""

import numpy as np
import pytest
import torch

from libiqo_tpu_torch import api, yuv
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize

TILE = cuda_resize.TILE_ROWS

# full-size planes: (name, algorithm, kwargs, src_w, src_h, dst_w, dst_h)
FULL = {
    "lanczos3 4K->1080p luma": ("lanczos", dict(degree=3), 3840, 2160, 1920, 1080),
    "lanczos3 4K->1080p px2 chroma": ("lanczos", dict(degree=3, px_scale=2),
                                      1920, 1080, 960, 540),
    "lanczos3 8K->1080p": ("lanczos", dict(degree=3), 7680, 4320, 1920, 1080),
    "lanczos2 720p->1080p": ("lanczos", dict(degree=2), 1280, 720, 1920, 1080),
    "linear 1080p->4K luma": ("linear", {}, 1920, 1080, 3840, 2160),
    "linear 1080p->4K chroma": ("linear", {}, 960, 540, 1920, 1080),
    "area 1080p->360p luma": ("area", {}, 1920, 1080, 640, 360),
    "area 4K->1080p luma": ("area", {}, 3840, 2160, 1920, 1080),
}
# re-read of the windowed form (sum of the row tiles' windows over the rows
# they cover) and whether carry engages
REREAD = {
    "lanczos3 4K->1080p luma": (1.31, True),
    "lanczos3 4K->1080p px2 chroma": (1.06, False),
    "lanczos3 8K->1080p": (1.31, True),
    "lanczos2 720p->1080p": (1.31, True),
    "linear 1080p->4K luma": (1.25, True),
    "linear 1080p->4K chroma": (1.25, True),
    "area 1080p->360p luma": (1.0, False),
    "area 4K->1080p luma": (1.0, False),
}

# small geometries: the JAX carry tests' set (tests/test_carry.py) and more
SMALL = [
    ("lanczos", dict(degree=3), 960, 540, 480, 270),
    ("lanczos", dict(degree=2), 640, 360, 960, 540),
    ("lanczos", dict(degree=3, px_scale=2), 482, 270, 240, 134),
    ("lanczos", dict(degree=4), 512, 520, 256, 130),      # clamped tail tiles
    ("area", {}, 640, 720, 160, 240),
    ("linear", {}, 160, 480, 321, 960),
    ("lanczos", dict(degree=5), 300, 411, 130, 97),
    ("linear", {}, 97, 61, 200, 150),
    ("lanczos", dict(degree=3), 300, 40, 150, 3),         # stale-iterator rows
]


def _plan(case):
    algo, kw, sw, sh, dw, dh = case
    return build_plan(algo, sw, sh, dw, dh, **kw)


def _ids(case):
    algo, kw, sw, sh, dw, dh = case
    return f"{algo}{kw.get('degree', '')}-{sw}x{sh}-{dw}x{dh}-px{kw.get('px_scale', 1)}"


@pytest.fixture
def carry_env(monkeypatch):
    monkeypatch.setenv("LIBIQO_TPU_CARRY", "1")
    api.clear_operand_cache()
    yield
    api.clear_operand_cache()


# -- a NumPy model of the ring schedule ------------------------------------

def _ring_reads(k: cuda_resize.KernelTables, src: np.ndarray, dst_h: int):
    """What the carry kernel's Y pass reads, block by block, following its
    schedule over the tables it is handed: per (frame, column tile, run),
    load the run's first row tile's source rows into ring slot s %
    ring_rows, then for each row tile t first load tile t+1's fresh rows,
    then read tile t's taps through ``iyr``.  Returns the values read,
    indexed like the windowed kernel's reads src[f, iy, lo:hi], and
    checks that no read finds a slot holding another row."""
    iy, iyr, win, rwin = (x.numpy() for x in (k.iy, k.iyr, k.win, k.rwin))
    n_rt = len(rwin)
    reads = {}
    for f in range(src.shape[0]):
        for ct, (lo, hi) in enumerate(win):
            for t0 in range(0, n_rt, k.run):
                ring = np.zeros((k.ring_rows, hi - lo), np.uint8)
                held = np.full(k.ring_rows, -1)

                def load(s0, s1):
                    for s in range(s0, s1):
                        ring[s % k.ring_rows] = src[f, s, lo:hi]
                        held[s % k.ring_rows] = s

                load(*rwin[t0])
                t1 = min(t0 + k.run, n_rt)
                for t in range(t0, t1):
                    if t + 1 < t1:
                        load(max(rwin[t, 1], rwin[t + 1, 0]), rwin[t + 1, 1])
                    rows = slice(t * TILE, min(dst_h, (t + 1) * TILE))
                    slots = iyr[:, rows]
                    assert (held[slots] == iy[:, rows]).all(), (f, ct, t)
                    reads[f, ct, t] = ring[slots]
    return reads


def _windowed_reads(k: cuda_resize.KernelTables, src: np.ndarray, dst_h: int):
    iy, win = k.iy.numpy(), k.win.numpy()
    n_rt = -(-dst_h // TILE)
    return {(f, ct, t): src[f][iy[:, t * TILE:min(dst_h, (t + 1) * TILE)], lo:hi]
            for f in range(src.shape[0]) for ct, (lo, hi) in enumerate(win)
            for t in range(n_rt)}


@pytest.mark.parametrize("blocks", [cuda_resize.CARRY_BLOCKS, 12, 1])
@pytest.mark.parametrize("case", SMALL, ids=_ids)
def test_ring_schedule_rebuilds_windowed_band(monkeypatch, case, blocks):
    """Runs of 2 row tiles up to one run per column tile (``blocks`` sets
    how many blocks the layout aims for), with runs that do not divide the
    row-tile count and a batch of 3 frames: the ring reads equal the
    windowed kernel's reads everywhere."""
    monkeypatch.setattr(cuda_resize, "CARRY_BLOCKS", blocks)
    plan = _plan(case)
    layout = cuda_resize.carry_layout(plan)
    if layout is None:      # the windowed tables, which the other tests hold
        assert not cuda_resize.kernel_tables(plan, carry=True, tiled=False).carry
        return
    k = cuda_resize.kernel_tables(plan, carry=True, tiled=False)
    assert k.carry and k.run == layout.run and k.ring_rows == layout.ring_rows
    src = np.random.default_rng(plan.y.n_src).integers(
        0, 256, (3, plan.y.n_src, plan.x.n_src), np.uint8)
    got = _ring_reads(k, src, plan.y.n_dst)
    want = _windowed_reads(k, src, plan.y.n_dst)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


def test_ring_schedule_covers_ragged_runs(monkeypatch):
    """The fuzz set above really has runs that do not divide the row-tile
    count, and runs longer than 2."""
    runs = []
    for blocks in (cuda_resize.CARRY_BLOCKS, 12, 1):
        monkeypatch.setattr(cuda_resize, "CARRY_BLOCKS", blocks)
        for case in SMALL:
            layout = cuda_resize.carry_layout(_plan(case))
            if layout is not None:
                runs.append((len(layout.rwin), layout.run))
    assert any(n % r for n, r in runs)
    assert any(r > 2 for _, r in runs)
    assert len(runs) >= 10


def test_ring_bound():
    """The ring holds tile t's rows and tile t+1's together, and fits the
    shared-memory budget beside the work tile, on every engaging plane."""
    for name, case in FULL.items():
        plan = _plan(case)
        layout = cuda_resize.carry_layout(plan)
        if layout is None:
            continue
        lo, hi = layout.rwin[:, 0].astype(int), layout.rwin[:, 1].astype(int)
        for t in range(len(lo) - 1):
            if (t + 1) % layout.run:
                assert hi[t + 1] - lo[t] <= layout.ring_rows, name
        assert layout.ring_pitch % cuda_resize.RING_ALIGN == 0
        assert (cuda_resize.smem_bytes(plan) + layout.ring_rows * layout.ring_pitch
                <= cuda_resize.SMEM_BUDGET)


# -- carry_ok against the re-read figures -----------------------------------

@pytest.mark.parametrize("name", sorted(FULL))
def test_carry_ok_matches_reread(name):
    plan = _plan(FULL[name])
    reread, engages = REREAD[name]
    rwin = cuda_resize.tile_windows(plan.y, TILE).astype(int)
    band = (rwin[:, 1] - rwin[:, 0]).sum()
    assert band / (rwin[-1, 1] - rwin[0, 0]) == pytest.approx(reread, abs=0.01)
    assert cuda_resize.supports_plan(plan)
    assert cuda_resize.carry_ok(plan) is engages
    layout = cuda_resize.carry_layout(plan)
    if engages:
        assert layout.band == band
        assert 0.76 <= layout.fetch / band < 1 - cuda_resize.CARRY_MIN_SAVING
        # the grid still holds about two blocks per SM of an H100
        n_ct = -(-plan.x.n_dst // cuda_resize.TILE_COLS)
        assert n_ct * -(-len(rwin) // layout.run) >= 2 * 132


def test_carry_refuses_non_monotone_rows():
    """A plan whose row windows step back inside a run is refused."""
    import dataclasses

    plan = _plan(SMALL[0])
    start = plan.y.start.copy()
    start[TILE:2 * TILE] -= 40          # tile 1 reads rows above tile 0's
    bad = dataclasses.replace(plan, y=dataclasses.replace(plan.y, start=start))
    assert cuda_resize.carry_ok(plan) and not cuda_resize.carry_ok(bad)


def test_variants_and_tables():
    """The carry route: the tiled kernel's carry form where its ring fits
    (4K luma), the windowed carry form with ``tiled=False``, and where
    carry_ok refuses the form without carry."""
    plan = _plan(FULL["lanczos3 4K->1080p luma"])
    tiled = cuda_resize.kernel_tables(plan, carry=True)
    assert cuda_resize.variant(tiled) == "wrap16_carry_tiled"
    k = cuda_resize.kernel_tables(plan, carry=True, tiled=False)
    assert cuda_resize.variant(k) == "wrap16_carry"
    assert k.iyr.shape == k.iy.shape and int(k.iyr.max()) < k.ring_rows
    windowed = cuda_resize.kernel_tables(plan, tiled=False)
    assert not windowed.carry and cuda_resize.variant(windowed) == "wrap16"
    assert windowed.rwin.numel() == windowed.iyr.numel() == 0
    # where carry_ok refuses, carry=True builds the windowed tables
    chroma = _plan(FULL["lanczos3 4K->1080p px2 chroma"])
    assert not cuda_resize.kernel_tables(chroma, carry=True, tiled=False).carry
    area = _plan(SMALL[4])
    rel = cuda_resize.kernel_tables(area, relaxed=True, carry=True, tiled=False)
    assert cuda_resize.variant(rel) == ("u16_relaxed_carry" if rel.carry
                                        else "u16_relaxed")
    assert set(cuda_resize.VARIANTS) == set(cuda_resize.LAUNCHES_BY_VARIANT)
    assert len(cuda_resize.VARIANTS) == 18     # 8 windowed, 8 tiled, 2 wide-window


def test_opt_in_is_the_jax_packages(monkeypatch):
    for value, on in (("1", True), ("2", True), ("", False), ("0", False)):
        monkeypatch.setenv("LIBIQO_TPU_CARRY", value)
        assert cuda_resize.carry_requested() is on
    monkeypatch.delenv("LIBIQO_TPU_CARRY")
    assert not cuda_resize.carry_requested()


# -- the operand cache ------------------------------------------------------

@pytest.mark.parametrize("first", ["windowed", "carry"])
def test_operand_cache_never_shares_carry_and_windowed(monkeypatch, first):
    """One geometry, packed with and without the opt-in in either order:
    separate cache entries, and the relaxed tables (built on any device)
    are the carry form's only under the opt-in."""
    api.clear_operand_cache()
    plan = _plan(SMALL[0])
    r = api.Resizer.from_plan(plan, backend="cuda", precision="relaxed",
                              device="cpu")
    order = [first, "carry" if first == "windowed" else "windowed"]
    ops = {}
    for mode in order:
        if mode == "carry":
            monkeypatch.setenv("LIBIQO_TPU_CARRY", "1")
        else:
            monkeypatch.delenv("LIBIQO_TPU_CARRY", raising=False)
        ops[mode] = r._operands(r.device, relaxed=True)
        assert r._operands(r.device, relaxed=True) is ops[mode]
        ops[mode, "exact"] = r._operands(r.device)
    assert ops["carry"] is not ops["windowed"]
    assert ops["carry", "exact"] is not ops["windowed", "exact"]
    assert ops["carry"].tables.carry and not ops["windowed"].tables.carry
    api.clear_operand_cache()


# -- the carry route on the CPU ---------------------------------------------

@pytest.mark.parametrize("case", SMALL[:6], ids=_ids)
def test_carry_route_on_cpu_equals_oracle(carry_env, case):
    """With the opt-in, ``backend="cuda"`` on the CPU runs the kernel's
    plain version, exact and relaxed, and launches nothing."""
    plan = _plan(case)
    src = np.random.default_rng(plan.x.n_src).integers(
        0, 256, (2, plan.y.n_src, plan.x.n_src), np.uint8)
    before = cuda_resize.LAUNCHES
    exact = api.Resizer.from_plan(plan, backend="cuda", device="cpu")
    got = exact.resize(src)
    for f in range(2):
        np.testing.assert_array_equal(got[f], numpy_ref.resize_u8(plan, src[f]))
    relaxed = api.Resizer.from_plan(plan, backend="cuda", precision="relaxed",
                                    device="cpu")
    ops = relaxed._operands(relaxed.device, relaxed=True)
    assert ops.tables.carry is cuda_resize.carry_ok(plan)
    np.testing.assert_array_equal(
        relaxed.resize(src),
        cuda_resize.resize_plain(ops, torch.from_numpy(src)).numpy())
    assert cuda_resize.LAUNCHES == before


def test_carry_yuv_path_on_cpu(carry_env):
    r = yuv.YUV420Resizer("lanczos3", 640, 360, 320, 180, backend="cuda",
                          device="cpu")
    rng = np.random.default_rng(4)
    f = yuv.YUV420Frame(rng.integers(0, 256, (360, 640), np.uint8),
                        rng.integers(0, 256, (180, 320), np.uint8),
                        rng.integers(0, 256, (180, 320), np.uint8))
    out = r.resize(f)
    np.testing.assert_array_equal(
        out.y, numpy_ref.resize_u8(build_plan("lanczos", 640, 360, 320, 180), f.y))
    chroma = build_plan("lanczos", 320, 180, 160, 90, px_scale=2)
    np.testing.assert_array_equal(out.u, numpy_ref.resize_u8(chroma, f.u))
    np.testing.assert_array_equal(out.v, numpy_ref.resize_u8(chroma, f.v))


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("case", SMALL, ids=_ids)
def test_carry_kernel_matches_windowed_on_card(cuda_device, case, relaxed):
    plan = _plan(case)
    if not cuda_resize.carry_ok(plan):
        pytest.skip("carry_ok refuses this plan")
    carry = cuda_resize.pack_operands(plan, cuda_device, relaxed, carry=True)
    windowed = cuda_resize.pack_operands(plan, cuda_device, relaxed)
    src = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, plan.y.n_src, plan.x.n_src), np.uint8)).to(cuda_device)
    v = cuda_resize.variant(carry.tables)
    before = cuda_resize.LAUNCHES_BY_VARIANT[v]
    got = cuda_resize.resize_fused(carry, src)
    assert cuda_resize.LAUNCHES_BY_VARIANT[v] == before + 1
    assert torch.equal(got, cuda_resize.resize_fused(windowed, src))
