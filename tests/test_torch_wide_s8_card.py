"""The wide-window kernel's s8 Y form (``resize_wide_kernel_s8y`` in
``libiqo_tpu_torch/csrc/resize_wide.cu``) on the card: byte for byte
against the plain path, ``numpy_ref`` and the scalar form it replaces.

Its NumPy model and routes are tested on the CPU in
``tests/test_torch_wide_kernel.py``.  Every test here needs a CUDA card and
skips without one; none imports JAX, so on a machine without it they run
with ``python -m pytest --noconftest tests/test_torch_wide_s8_card.py -m
cuda``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.golden import numpy_ref
from libiqo_tpu_torch.ops import cuda_resize as cr
from libiqo_tpu_torch.tools import card_check, wide_ablate

# small plans the s8 form takes at its widest width (numpy_ref is dense; the
# route keeps them on the scalar form, their grids small): the 144p rung's
# 15:1 cut down, a 29-slab band, degree 4, TW 16
SMALL = [
    ("lanczos", 960, 540, 64, 36, dict(degree=3)),
    ("lanczos", 640, 2000, 40, 50, dict(degree=4)),
    ("lanczos", 363, 614, 30, 18, dict(degree=4)),
    ("lanczos", 1500, 1000, 50, 40, dict(degree=3)),
]
# (bytes into the row, row pitch past the width): aligned; 5 in at an odd
# pitch (byte loads); 3 in at a pitch of a multiple of 16
PLACES = [(0, 0), (5, 11), (3, 16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _plan(case):
    return build_plan(*case[:5], **case[5])


def _placed(frames: np.ndarray, off: int, pad: int, dev) -> torch.Tensor:
    """(B, h, w) frames on the card, ``off`` bytes into rows ``w + pad`` apart."""
    b, h, w = frames.shape
    buf = torch.randint(0, 256, (b, h, w + pad + off), dtype=torch.uint8, device=dev)
    x = buf[:, :, off:off + w]
    x.copy_(torch.from_numpy(frames))
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMALL, ids=card_check.case_name)
def test_s8_form_equals_oracle_on_card(card, case):
    """== plain == numpy_ref from each placement, and at the byte
    extremes (flat 0 and 255, checkerboard)."""
    plan = _plan(case)
    form = next(f for w in cr.WIDE_S8_WIDTHS if (f := cr.wide_s8_form(plan, w)) is not None)
    ops = cr.KernelOperands(plain=cr.pack_operands(plan, card).plain,
                            tables=cr.wide_s8_tables(plan, card, form))
    assert cr.launch_form(ops.tables) == "wide.y_s8"
    sh, sw = case[2], case[1]
    checker = ((np.arange(sh)[:, None] + np.arange(sw)[None]) % 2 * 255).astype(np.uint8)
    frames = np.stack([card_check.source(case, 0), card_check.source(case, 1),
                       np.zeros((sh, sw), np.uint8), np.full((sh, sw), 255, np.uint8), checker])
    want = np.stack([numpy_ref.resize_u8(plan, f) for f in frames])
    for off, pad in PLACES:
        x = _placed(frames, off, pad, card)
        got = cr.resize_fused(ops, x)
        assert torch.equal(got, cr.resize_plain(ops, x)), (off, pad)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", wide_ablate.s8_plans(), ids=card_check.case_name)
def test_s8_form_equals_plain_and_scalar_form_on_card(card, case):
    """Every plan of the card's lists that the s8 form takes, at its size,
    two frames a launch, 5 bytes into an odd pitch: == plain == the scalar
    form; the ablation's rings and widths too.  Each launch is counted
    under its own variant: ``wrap16_wide_s8``, the scalar form's
    ``wrap16_wide``."""
    plan = _plan(case)
    ops = cr.pack_operands(plan, card, tiled=False)
    assert isinstance(ops.tables, cr.WideS8Tables)
    frames = np.stack([card_check.source(case, f) for f in range(2)])
    x = _placed(frames, 5, 11, card)
    got, counts = card_check.launched(cr, lambda: cr.resize_fused(ops, x))
    assert counts == {"wrap16_wide_s8": 1}
    assert torch.equal(got, cr.resize_plain(ops, x))
    scalar = cr.KernelOperands(plain=ops.plain, tables=cr.wide_tables(plan, card))
    assert cr.launch_form(scalar.tables) in ("wide.y_whole", "wide.y_sliced")
    sgot, counts = card_check.launched(cr, lambda: cr.resize_fused(scalar, x))
    assert counts == {"wrap16_wide": 1} and torch.equal(sgot, got)
    for name, v in wide_ablate.s8_variants(plan, ops.tables.layout).items():
        vops = cr.KernelOperands(plain=ops.plain, tables=cr.wide_s8_tables(plan, card, v))
        assert torch.equal(cr.resize_fused(vops, x), got), name
