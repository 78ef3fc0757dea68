"""The port's multi-device sharding (``libiqo_tpu_torch.parallel.sharding``)
on meshes of repeated CPU devices.

Each case of ``tests/test_sharding.py`` has a counterpart here, built from
the same seeded inputs, held byte for byte against ``numpy_ref`` and
against the JAX package's function of the same name on the conftest's
virtual 8-device CPU mesh (``backend="xla"``, and once ``"pallas"`` in
interpret mode).  ``backend="cuda"`` asks for the kernel's route, which on
the CPU runs its plain version; ``"auto"`` on the CPU runs the plain path.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from libiqo_tpu.core import plan as jax_plan
from libiqo_tpu.parallel import sharding as jax_sharding
from libiqo_tpu_torch import yuv
from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize
from libiqo_tpu_torch.parallel import sharding

RNG_SEED = 11


def _rng():
    return np.random.default_rng(RNG_SEED)


def _mesh(shape, names):
    return sharding.Mesh(np.full(shape, "cpu", dtype=object), names)


def _jax_mesh(shape, names):
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return JaxMesh(devs, names)


def _plans(algo, sw, sh, dw, dh, **kw):
    return (build_plan(algo, sw, sh, dw, dh, **kw),
            jax_plan.build_plan(algo, sw, sh, dw, dh, **kw))


def _oracle(plan, frames):
    return np.stack([numpy_ref.resize_u8(plan, f) for f in frames])


def _np(out):
    return sharding.gather(out).numpy()


# -- counterparts of tests/test_sharding.py ---------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_batch_dp_matches_oracle(backend):
    plan, jplan = _plans("lanczos", 128, 96, 64, 48, degree=3)
    frames = _rng().integers(0, 256, (16, 96, 128), np.uint8)
    out = sharding.resize_batch_dp(plan, frames, _mesh((8,), ("data",)),
                                   backend=backend)
    assert out.shape == (16, 48, 64)
    assert [b.shape[0] for b in out.blocks] == [2] * 8
    got = _np(out)
    np.testing.assert_array_equal(got, _oracle(plan, frames))
    want = jax_sharding.resize_batch_dp(jplan, frames, _jax_mesh((8,), ("data",)),
                                        backend="xla")
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("algo,degree", [("lanczos", 3), ("area", 0), ("linear", 0)])
def test_row_sharded_matches_oracle(algo, degree):
    kw = {"degree": degree} if algo == "lanczos" else {}
    plan, jplan = _plans(algo, 320, 240, 160, 120, **kw)
    src = _rng().integers(0, 256, (240, 320), np.uint8)
    fn, operands = sharding.make_row_sharded_fn(plan, _mesh((8,), ("row",)),
                                                backend="cuda")
    assert fn.routes == ("cuda",) * 8
    got = _np(fn(*operands, src))
    np.testing.assert_array_equal(got, numpy_ref.resize_u8(plan, src))
    jfn, jops = jax_sharding.make_row_sharded_fn(
        jplan, _jax_mesh((8,), ("row",)), backend="xla")
    np.testing.assert_array_equal(got, np.asarray(jfn(*jops, src)))


def test_row_sharded_upsample():
    plan, jplan = _plans("lanczos", 64, 64, 128, 128, degree=2)
    src = _rng().integers(0, 256, (64, 64), np.uint8)
    fn, operands = sharding.make_row_sharded_fn(plan, _mesh((4,), ("row",)),
                                                backend="cuda")
    got = _np(fn(*operands, src))
    np.testing.assert_array_equal(got, numpy_ref.resize_u8(plan, src))
    jfn, jops = jax_sharding.make_row_sharded_fn(
        jplan, _jax_mesh((4,), ("row",)), backend="xla")
    np.testing.assert_array_equal(got, np.asarray(jfn(*jops, src)))


def _check_yuv_step(shape, names, sw, sh, dw, dh, b):
    rng = _rng()
    y = rng.integers(0, 256, (b, sh, sw), np.uint8)
    u = rng.integers(0, 256, (b, (sh + 1) // 2, (sw + 1) // 2), np.uint8)
    v = rng.integers(0, 256, (b, (sh + 1) // 2, (sw + 1) // 2), np.uint8)
    step, operands = sharding.make_yuv_step_fn(_mesh(shape, names), sw, sh,
                                               dw, dh, degree=3, backend="cuda")
    got = sharding.gather(step(*operands, y, u, v))
    jstep, jops = jax_sharding.make_yuv_step_fn(_jax_mesh(shape, names), sw, sh,
                                                dw, dh, degree=3)
    want = jstep(*jops, y, u, v)
    pl = build_plan("lanczos", sw, sh, dw, dh, degree=3)
    pc = build_plan("lanczos", (sw + 1) // 2, (sh + 1) // 2, (dw + 1) // 2,
                    (dh + 1) // 2, degree=3, px_scale=2)
    for g, w, plan, frames in zip(got, want, (pl, pc, pc), (y, u, v)):
        np.testing.assert_array_equal(g.numpy(), _oracle(plan, frames))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_yuv_step_dp():
    _check_yuv_step((4, 2), ("data", "row"), 64, 48, 32, 24, 8)


def test_row_sharded_kernel_path_taken():
    """The kernel's route is every shard's body for a normal geometry (with
    ``"cuda"``, its plain version on the CPU); equal to the JAX package's
    row-sharded Pallas kernel in interpret mode, and to ``backend="torch"``."""
    plan, jplan = _plans("lanczos", 320, 240, 160, 120, degree=3)
    src = _rng().integers(0, 256, (240, 320), np.uint8)
    mesh = _mesh((8,), ("row",))
    fn, operands = sharding.make_row_sharded_fn(plan, mesh, backend="cuda")
    assert fn.routes == ("cuda",) * 8
    got = _np(fn(*operands, src))
    gold = numpy_ref.resize_u8(plan, src)
    np.testing.assert_array_equal(got, gold)
    built = jax_sharding._make_row_sharded_pallas(
        jplan, _jax_mesh((8,), ("row",)), "row", interpret=True)
    assert built is not None
    jfn, jops = built
    np.testing.assert_array_equal(got, np.asarray(jfn(*jops, src)))
    fn_t, ops_t = sharding.make_row_sharded_fn(plan, mesh, backend="torch")
    assert fn_t.routes == ("torch",) * 8
    np.testing.assert_array_equal(_np(fn_t(*ops_t, src)), gold)


def test_batch_dp_kernel_vs_torch():
    plan, jplan = _plans("area", 256, 192, 64, 48)
    frames = _rng().integers(0, 256, (8, 192, 256), np.uint8)
    mesh = _mesh((8,), ("data",))
    out_k = _np(sharding.resize_batch_dp(plan, frames, mesh, backend="cuda"))
    out_t = _np(sharding.resize_batch_dp(plan, frames, mesh, backend="torch"))
    gold = _oracle(plan, frames)
    np.testing.assert_array_equal(out_k, gold)
    np.testing.assert_array_equal(out_t, gold)
    want = jax_sharding.resize_batch_dp(jplan, frames, _jax_mesh((8,), ("data",)),
                                        backend="xla")
    np.testing.assert_array_equal(out_k, np.asarray(want))


def test_yuv_step_odd_dims():
    """Luma at its true odd size, chroma at the halves of the evened
    size."""
    _check_yuv_step((2,), ("data",), 63, 47, 31, 23, 2)


def _check_row_sharded(n, algo, sw, sh, dw, dh, **kw):
    plan, jplan = _plans(algo, sw, sh, dw, dh, **kw)
    src = _rng().integers(0, 256, (sh, sw), np.uint8)
    fn, operands = sharding.make_row_sharded_fn(plan, _mesh((n,), ("row",)),
                                                backend="cuda")
    assert fn.routes == ("cuda",) * n
    out = fn(*operands, src)
    assert out.shape == (dh, dw)
    got = _np(out)
    np.testing.assert_array_equal(got, numpy_ref.resize_u8(plan, src))
    jfn, jops = jax_sharding.make_row_sharded_fn(
        jplan, _jax_mesh((n,), ("row",)), backend="xla")
    np.testing.assert_array_equal(got, np.asarray(jfn(*jops, src)))
    return plan, out


def test_row_sharded_odd_height_pads():
    """237 source rows and 119 output rows over 8 shards (neither divides):
    the padded local plans stay inside ``supports_plan``, so every shard
    still takes the kernel's route, and the padded rows are cut off the
    last shard."""
    plan, out = _check_row_sharded(8, "lanczos", 320, 237, 160, 119, degree=3)
    padded, src_pad, dst_pad = sharding._pad_rows_plan(plan, 8)
    assert (src_pad, dst_pad) == (3, 1)
    lay = sharding._row_shard_layout(padded, 8)
    for d in range(8):
        assert cuda_resize.supports_plan(sharding._local_plan(padded, lay, d))
    assert [b.shape[0] for b in out.blocks] == [15] * 7 + [14]


def test_row_sharded_multi_hop_halo():
    """Area 512 -> 16 rows on 8 shards: 32-tap windows over 64-row
    shards."""
    plan, _ = _check_row_sharded(8, "area", 128, 512, 64, 16)
    assert plan.y.num_coefs >= 512 // 8 // 2


def test_row_sharded_halo_taller_than_shard():
    """Area 256 -> 4 rows on 8 shards: one output row's window covers more
    source rows than a shard, so halos chain hops both ways."""
    plan, _ = _check_row_sharded(8, "area", 64, 256, 32, 4)
    lay = sharding._row_shard_layout(sharding._pad_rows_plan(plan, 8)[0], 8)
    assert lay.halo_up >= lay.hs and lay.halo_dn > 2 * lay.hs


def test_batch_dp_non_divisible_batch():
    plan, jplan = _plans("lanczos", 128, 96, 64, 48, degree=3)
    frames = _rng().integers(0, 256, (13, 96, 128), np.uint8)
    out = sharding.resize_batch_dp(plan, frames, _mesh((8,), ("data",)),
                                   backend="cuda")
    assert out.shape[0] == 13
    assert [b.shape[0] for b in out.blocks] == [2] * 6 + [1, 0]
    got = _np(out)
    np.testing.assert_array_equal(got, _oracle(plan, frames))
    want = jax_sharding.resize_batch_dp(jplan, frames, _jax_mesh((8,), ("data",)),
                                        backend="xla")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_padded_resize_batch_preserves_tensors():
    """``YUV420Resizer.resize_batch`` with odd destination dims keeps
    tensors as tensors (the zero pad stays on the tensors' device)."""
    r = yuv.YUV420Resizer("area", 64, 48, 31, 23, backend="torch", device="cpu")
    rng = _rng()
    y = torch.from_numpy(rng.integers(0, 256, (2, 48, 64), np.uint8))
    u = torch.from_numpy(rng.integers(0, 256, (2, 24, 32), np.uint8))
    v = torch.from_numpy(rng.integers(0, 256, (2, 24, 32), np.uint8))
    oy, ou, ov = r.resize_batch(y, u, v)
    assert all(isinstance(o, torch.Tensor) for o in (oy, ou, ov))
    assert oy.shape == (2, 24, 32)
    assert (oy[:, 23:, :] == 0).all() and (oy[:, :, 31:] == 0).all()
    plan = build_plan("area", 64, 48, 31, 23)
    np.testing.assert_array_equal(oy[:, :23, :31].numpy(), _oracle(plan, y.numpy()))


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_batch_row_sharded_2d_mesh(backend):
    """dp x sp on a 2x4 mesh; odd batch (3 pads to 4) and 50 output rows
    over 4 shards (pads to 52)."""
    plan, jplan = _plans("lanczos", 128, 96, 96, 50, degree=3)
    fn, operands = sharding.make_batch_row_sharded_fn(
        plan, _mesh((2, 4), ("data", "row")), backend=backend)
    assert fn.routes == ("cuda" if backend == "cuda" else "torch",) * 8
    frames = _rng().integers(0, 256, (3, 96, 128), np.uint8)
    out = fn(*operands, frames)
    assert out.shape == (3, 50, 96)
    got = _np(out)
    np.testing.assert_array_equal(got, _oracle(plan, frames))
    jfn, jops = jax_sharding.make_batch_row_sharded_fn(
        jplan, _jax_mesh((2, 4), ("data", "row")), backend="xla")
    np.testing.assert_array_equal(got, np.asarray(jfn(*jops, frames)))


def test_batch_row_sharded_torch_body():
    """The plain body over local frames on the 2-D mesh."""
    plan, jplan = _plans("area", 160, 120, 40, 32)
    fn, operands = sharding.make_batch_row_sharded_fn(
        plan, _mesh((2, 4), ("data", "row")), backend="torch")
    frames = _rng().integers(0, 256, (4, 120, 160), np.uint8)
    got = _np(fn(*operands, frames))
    np.testing.assert_array_equal(got, _oracle(plan, frames))
    jfn, jops = jax_sharding.make_batch_row_sharded_fn(
        jplan, _jax_mesh((2, 4), ("data", "row")), backend="xla")
    np.testing.assert_array_equal(got, np.asarray(jfn(*jops, frames)))


# -- the host layer, field for field ----------------------------------------

LAYOUT_CASES = [
    (8, "lanczos", dict(degree=3), 320, 240, 160, 120),
    (8, "area", {}, 320, 240, 160, 120),
    (8, "linear", {}, 320, 240, 160, 120),
    (4, "lanczos", dict(degree=2), 64, 64, 128, 128),
    (8, "lanczos", dict(degree=3), 320, 237, 160, 119),
    (8, "area", {}, 128, 512, 64, 16),
    (8, "area", {}, 64, 256, 32, 4),
    (4, "lanczos", dict(degree=3, px_scale=2), 96, 70, 48, 35),
]


@pytest.mark.parametrize("case", LAYOUT_CASES,
                         ids=lambda c: f"{c[1]}-{c[3]}x{c[4]}-{c[5]}x{c[6]}-n{c[0]}")
def test_pad_and_layout_match_jax(case):
    """``_pad_rows_plan`` and ``_row_shard_layout`` equal the JAX package's
    field for field, and each shard's local plan, made dense over its
    band, equals JAX's per-device Y block."""
    n, algo, kw, sw, sh, dw, dh = case
    plan, jplan = _plans(algo, sw, sh, dw, dh, **kw)
    padded, sp, dp = sharding._pad_rows_plan(plan, n)
    jpadded, jsp, jdp = jax_sharding._pad_rows_plan(jplan, n)
    assert (sp, dp) == (jsp, jdp)
    for f in ("n_src", "n_dst", "num_coefs", "bias_bit"):
        assert getattr(padded.y, f) == getattr(jpadded.y, f), f
    for f in ("coef", "start", "deno", "is_border"):
        np.testing.assert_array_equal(getattr(padded.y, f), getattr(jpadded.y, f))
    lay = sharding._row_shard_layout(padded, n)
    hs, hd, up, dn, cy_blocks = jax_sharding._row_shard_layout(jpadded, n)
    assert (lay.hs, lay.hd, lay.halo_up, lay.halo_dn) == (hs, hd, up, dn)
    for d in range(n):
        local = sharding._local_plan(padded, lay, d)
        assert local.y.n_src == lay.band and local.y.n_dst == hd
        np.testing.assert_array_equal(local.y.dense(np.int64), cy_blocks[d])


def test_layout_requires_divisible_heights():
    plan = build_plan("area", 64, 50, 32, 25)
    with pytest.raises(ValueError):
        sharding._row_shard_layout(plan, 4)
    assert sharding._pad_rows_plan(plan, 5)[1:] == (0, 0)


def test_halo_rows_at_mesh_edges_are_zeros():
    """Shards of ones, (b, rows, w): the first shard's upward halo and the
    last shard's downward halo are real zeros, over several hops; inner
    halos carry the neighbours' rows, in order."""
    hs, w = 3, 5
    shards = [torch.full((2, hs, w), d + 1, dtype=torch.uint8) for d in range(4)]
    bands = sharding._halo_exchange(shards, halo_up=5, halo_dn=4)
    assert all(b.shape == (2, 5 + hs + 4, w) for b in bands)
    rows = [b[0, :, 0].tolist() for b in bands]
    assert rows[0] == [0] * 5 + [1] * 3 + [2] * 3 + [3]
    assert rows[1] == [0] * 2 + [1] * 3 + [2] * 3 + [3] * 3 + [4]
    assert rows[3] == [2] * 2 + [3] * 3 + [4] * 3 + [0] * 4
    assert (bands[0][:, :5] == 0).all() and (bands[3][:, -4:] == 0).all()
    # no halo: the shard itself
    assert sharding._halo_exchange(shards, 0, 0)[2] is shards[2]


def test_mesh_and_gather():
    mesh = _mesh((2, 4), ("data", "row"))
    assert mesh.shape == {"data": 2, "row": 4}
    assert mesh.shape["row"] == 4
    assert mesh.grid("row", "data").shape == (4, 2)
    assert mesh.grid("data").shape == (2,)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError):
        sharding.Mesh(np.full((2, 4), "cpu", dtype=object), ("data",))
    with pytest.raises(ValueError):
        sharding.make_row_sharded_fn(build_plan("area", 8, 8, 4, 4),
                                     _mesh((2,), ("row",)), backend="xla")


def test_dryrun_cpu():
    assert sharding.dryrun(8, "cpu") == {
        "yuv_step": 8, "row_sharded": 1, "batch_row_sharded": 5}


def test_parallel_is_not_reexported():
    import libiqo_tpu_torch

    assert not hasattr(libiqo_tpu_torch, "parallel") or \
        "parallel" not in libiqo_tpu_torch.__all__
    assert sharding.__name__ == "libiqo_tpu_torch.parallel.sharding"


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_row_sharded_kernel_on_card(cuda_device):
    plan = build_plan("lanczos", 320, 237, 160, 119, degree=3)
    mesh = sharding.Mesh([cuda_device] * 4, ("row",))
    fn, operands = sharding.make_row_sharded_fn(plan, mesh)
    src = torch.from_numpy(_rng().integers(0, 256, (237, 320), np.uint8))
    cuda_resize.reset_launches()
    got = sharding.gather(fn(*operands, src.to(cuda_device)))
    assert cuda_resize.LAUNCHES == 4
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  numpy_ref.resize_u8(plan, src.numpy()))
