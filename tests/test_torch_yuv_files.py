"""The YUV file cases of ``test_cache_and_video.py`` and ``test_yuv_cli.py``
on the port: the 64-frame pipeline through the port's YUV file helpers,
strided views, a file round trip, and the resize CLI's bad method and bad
input (which must leave the output file untouched).  Every output is held
to the JAX package's.  ``tests/test_torch_api.py`` already holds the CLI's
bytes to the JAX CLI's (``test_cli_matches_jax_cli``).
"""

import numpy as np
import pytest
import torch

from libiqo_tpu.core.plan import build_plan as jax_build_plan
from libiqo_tpu.golden import numpy_ref as jax_numpy_ref
from libiqo_tpu.yuv import YUV420Resizer as JaxYUV420Resizer
from libiqo_tpu_torch import LanczosResizer
from libiqo_tpu_torch.cli import resize_yuv420p
from libiqo_tpu_torch.yuv import (YUV420Frame, YUV420Resizer, iter_yuv420,
                                  read_yuv420, write_yuv420)

RNG = np.random.default_rng(44)


def _frame(w, h):
    return YUV420Frame(y=RNG.integers(0, 256, (h, w), np.uint8),
                       u=RNG.integers(0, 256, (h // 2, w // 2), np.uint8),
                       v=RNG.integers(0, 256, (h // 2, w // 2), np.uint8))


def test_64_frame_video_pipeline(tmp_path):
    """64 frames written, streamed back through ``iter_yuv420``, resized one
    by one and as one batch: equal to each other and to the JAX package's
    XLA pipeline on the same batch."""
    sw, sh, dw, dh, n = 128, 96, 64, 48, 64
    frames = [_frame(sw, sh) for _ in range(n)]
    path = tmp_path / "video.yuv"
    write_yuv420(path, frames)
    r = YUV420Resizer("lanczos3", sw, sh, dw, dh, device="cpu")
    streamed = [r.resize(f) for f in iter_yuv420(path, sw, sh)]
    assert len(streamed) == n
    y, u, v = (np.stack([getattr(f, p) for f in frames]) for p in "yuv")
    oy, ou, ov = r.resize_batch(y, u, v)
    assert oy.shape == (n, dh, dw) and ou.shape == ov.shape == (n, dh // 2, dw // 2)
    jy, ju, jv = (np.asarray(p) for p in JaxYUV420Resizer(
        "lanczos3", sw, sh, dw, dh, backend="xla").resize_batch(y, u, v))
    for got, want in ((oy, jy), (ou, ju), (ov, jv)):
        np.testing.assert_array_equal(got, want)
    for i, f in enumerate(streamed):
        for p, batch in zip("yuv", (oy, ou, ov)):
            np.testing.assert_array_equal(getattr(f, p), batch[i], err_msg=f"{p} {i}")


def test_strided_views_accepted():
    """A non-contiguous region, as a NumPy view and as a tensor view."""
    big = RNG.integers(0, 256, (100, 200), np.uint8)
    roi = big[10:58, 20:84]
    want = jax_numpy_ref.resize_u8(jax_build_plan("lanczos", 64, 48, 32, 24, degree=3),
                                   np.ascontiguousarray(roi))
    r = LanczosResizer(3, 64, 48, 32, 24, device="cpu")
    np.testing.assert_array_equal(r.resize(roi), want)
    view = torch.from_numpy(big)[10:58, 20:84]
    assert not view.is_contiguous()
    np.testing.assert_array_equal(r.resize(view).numpy(), want)


def test_yuv_file_roundtrip(tmp_path):
    f = _frame(64, 48)
    p = tmp_path / "a.yuv"
    write_yuv420(p, [f, f])
    frames = read_yuv420(str(p), 64, 48)
    assert len(frames) == 2
    np.testing.assert_array_equal(frames[0].y, f.y)
    np.testing.assert_array_equal(frames[1].v, f.v)
    assert len(read_yuv420(str(p), 64, 48, frames=1)) == 1


def _cli(*args):
    return resize_yuv420p.main([str(a) for a in args])


def test_cli_resize_yuv420p(tmp_path):
    f = _frame(64, 48)
    src, dst = tmp_path / "in.yuv", tmp_path / "out.yuv"
    write_yuv420(src, [f])
    assert _cli("-m", "lanczos3", "-i", src, "-iw", 64, "-ih", 48, "-o", dst,
                "-ow", 32, "-oh", 24, "--backend", "numpy", "--device", "cpu") == 0
    out = read_yuv420(str(dst), 32, 24)[0]
    np.testing.assert_array_equal(out.y, jax_numpy_ref.resize_u8(
        jax_build_plan("lanczos", 64, 48, 32, 24, degree=3), f.y))


def test_cli_bad_method(tmp_path, capsys):
    src = tmp_path / "in.yuv"
    write_yuv420(src, [_frame(16, 16)])
    assert _cli("-m", "cubic", "-i", src, "-iw", 16, "-ih", 16,
                "-o", tmp_path / "o.yuv", "-ow", 8, "-oh", 8, "--device", "cpu") == 2
    assert "unknown method" in capsys.readouterr().err
    assert not (tmp_path / "o.yuv").exists()


@pytest.mark.parametrize("name,data,message", [
    ("missing.yuv", None, "could not read"),
    ("short.yuv", b"\x00" * 100, "no complete frames"),
])
def test_cli_bad_input_preserves_output(tmp_path, capsys, name, data, message):
    """A missing or short input must not create or truncate the output."""
    dst = tmp_path / "out.yuv"
    dst.write_bytes(b"PRECIOUS")
    src = tmp_path / name
    if data is not None:
        src.write_bytes(data)
    assert _cli("-m", "area", "-i", src, "-iw", 64, "-ih", 48, "-o", dst,
                "-ow", 32, "-oh", 24, "--backend", "numpy", "--device", "cpu") == 1
    assert message in capsys.readouterr().err
    assert dst.read_bytes() == b"PRECIOUS"
