"""The routes of the thumbnails and the 8K proxies, on the CPU.

Plans are built at full size and only the routing functions run
(``supports_plan``, ``tiled_width``, ``tiled_layout``, ``tiled_ok``,
``work_rows``, ``wide_layout``, ``kernel_tables``); nothing is resized.
The tiled kernel's width walks down from ``tiled_width`` to the first width
whose layout fits shared memory (Lanczos3 7680x4320 -> 960x540 at TW 64);
every plan that no width takes runs on the wide-window kernel, exact and
relaxed (the Lanczos3 thumbnails, the 4K -> 1920x16 strips); the main paths
keep their routes and widths.
"""

from __future__ import annotations

import pytest

from libiqo_tpu_torch.core.plan import build_plan
from libiqo_tpu_torch.ops import cuda_resize as cr
from libiqo_tpu_torch.tools import card_check

L3 = dict(degree=3)
# (case, exact variant, relaxed variant or None where supports_plan refuses):
# the exact Lanczos3 thumbnails take the s8 Y form but the strips (their
# bands) and 1920x1080 -> 128x72 (its grid)
WIDE_ROUTES = [
    (("lanczos", 3840, 2160, 256, 144, L3), "wrap16_wide_s8", "wrap16_relaxed_wide"),
    (("lanczos", 1920, 1080, 128, 72, L3), "wrap16_wide", "wrap16_relaxed_wide"),
    (("lanczos", 7680, 4320, 480, 270, L3), "wrap16_wide_s8", "wrap16_relaxed_wide"),
    (("lanczos", 7680, 4320, 320, 180, L3), "wrap16_wide_s8", "wrap16_relaxed_wide"),
    (("lanczos", 3840, 2160, 1920, 16, L3), "wrap16_wide", None),     # 810 Y taps
    (("area", 3840, 2160, 1920, 16, {}), "u16_wide", "u16_relaxed_wide"),
    (("linear", 3840, 2160, 256, 144, {}), "u16_wide", "u16_relaxed_wide"),
    (("lanczos", 7680, 4320, 480, 270, dict(degree=2)), "wrap16_wide",
     "wrap16_relaxed_wide"),
]
# (case, width tiled_width picks, width the walk takes)
TILED_ROUTES = [
    (("lanczos", 7680, 4320, 960, 540, L3), 128, 64),     # the walk moves it
    (("lanczos", 7680, 4320, 1280, 720, L3), 128, 128),
    (("lanczos", 3840, 2160, 320, 180, L3), 32, 32),
    (("lanczos", 3840, 2160, 1920, 1080, L3), 128, 128),  # the Lanczos main path
    (("lanczos", 1920, 1080, 960, 540, dict(degree=3, px_scale=2)), 128, 128),
    (("area", 1920, 1080, 640, 360, {}), 32, 32),         # the Area main path
    (("area", 960, 540, 320, 180, {}), 32, 32),
    # the chroma of the slice's frames: unchanged, tiled at TW 32
    (("lanczos", 1920, 1080, 128, 72, dict(degree=3, px_scale=2)), 32, 32),
    (("lanczos", 3840, 2160, 480, 270, dict(degree=3, px_scale=2)), 32, 32),
]


def _plan(case):
    alg, sw, sh, dw, dh, kw = case
    return build_plan(alg, sw, sh, dw, dh, **kw)


@pytest.mark.parametrize("case,exact,relaxed", WIDE_ROUTES,
                         ids=[card_check.case_name(c) for c, _, _ in WIDE_ROUTES])
def test_plans_no_tiled_width_takes_run_wide(case, exact, relaxed):
    """16 rows of the windowed kernel fit, no tiled width fits, and the
    wide-window kernel takes the plan, exact and relaxed, with
    ``tiled=False`` as well; ``wide=False`` keeps the windowed kernel for
    the timing turns."""
    plan = _plan(case)
    assert cr.work_rows(plan) == cr.TILE_ROWS
    for rel, want in ((False, exact), (True, relaxed)):
        if want is None:
            assert not cr.supports_plan(plan, relaxed=True)
            continue
        assert cr.supports_plan(plan, rel) and not cr.tiled_ok(plan, rel)
        assert all(cr.tiled_layout(plan, rel, tw).smem > cr.SMEM_BUDGET
                   for tw in cr.TILED_WIDTHS)
        lay = cr.wide_layout(plan, relaxed=rel)
        assert lay is not None and lay.smem <= cr.SMEM_BUDGET and lay.tr <= cr.TILE_ROWS
        k = cr.kernel_tables(plan, relaxed=rel)
        assert k.wide and cr.variant(k) == want
        assert cr.variant(cr.kernel_tables(plan, relaxed=rel, tiled=False)) == want
        walk = cr.kernel_tables(plan, relaxed=rel, wide=False)
        assert isinstance(walk, cr.KernelTables)
        assert cr.variant(walk) == want.split("_wide")[0]


@pytest.mark.parametrize("case,picked,walked", TILED_ROUTES,
                         ids=[card_check.case_name(c) for c, _, _ in TILED_ROUTES])
def test_tiled_width_walks_down_to_the_first_that_fits(case, picked, walked):
    """``tiled_width`` counts blocks; ``tiled_layout`` walks down from it to
    the first width whose layout fits, exact and relaxed alike, and the
    tables and ``tiled_ok`` follow it."""
    plan = _plan(case)
    assert cr.tiled_width(plan) == picked
    for rel in (False, True):
        lay = cr.tiled_layout(plan, rel)
        assert lay.tw == walked and lay.smem <= cr.SMEM_BUDGET
        wider = cr.TILED_WIDTHS[cr.TILED_WIDTHS.index(picked):cr.TILED_WIDTHS.index(walked)]
        assert all(cr.tiled_layout(plan, rel, w).smem > cr.SMEM_BUDGET for w in wider)
        assert cr.tiled_ok(plan, rel)
        k = cr.kernel_tables(plan, relaxed=rel)
        assert isinstance(k, cr.TiledTables) and k.layout.tw == walked
        assert cr.variant(k) == ("wrap16" if plan.wrap16 else "u16") + (
            "_relaxed" if rel else "") + "_tiled"


def test_the_walk_ends_at_the_narrowest_width():
    """Where no width fits, the layout returned is the narrowest's, which
    does not fit; a width given is taken as it is."""
    plan = _plan(WIDE_ROUTES[0][0])
    assert cr.tiled_layout(plan).tw == cr.TILED_WIDTHS[-1]
    assert cr.tiled_layout(plan, tw=128).tw == 128
    proxy = _plan(TILED_ROUTES[0][0])
    assert cr.tiled_layout(proxy, tw=128).smem > cr.SMEM_BUDGET
    assert cr.tiled_tables(proxy).layout.tw == 64


def test_carry_keeps_its_own_search():
    """The carry form's (TW, run) search is unchanged: it takes the 8K
    proxy where its ring fits, and the windowed carry form's column
    thumbnails keep it."""
    proxy = _plan(TILED_ROUTES[0][0])
    lay = cr.tiled_carry_layout(proxy)
    k = cr.kernel_tables(proxy, carry=True)
    if lay is None:
        assert cr.variant(k) in ("wrap16_tiled", "wrap16_carry")
    else:
        assert cr.variant(k) == "wrap16_carry_tiled" and k.layout.tw == lay.tw
    column = build_plan("lanczos", 640, 2160, 32, 270, degree=3)
    assert cr.tiled_carry_layout(column) is None and cr.carry_ok(column)
    assert cr.variant(cr.kernel_tables(column, carry=True)) == "wrap16_carry"
    assert cr.variant(cr.kernel_tables(column, relaxed=True, carry=True)) == \
        "wrap16_relaxed_carry"


def test_the_relaxed_scope_is_unchanged():
    """A relaxed plan still needs a 16-row tile: the wide plans whose
    window is too wide for 16 rows stay exact only; the relaxed wide
    layout runs one thread an output."""
    for case in card_check.WIDE_FACADE:
        plan = _plan(case)
        assert cr.work_rows(plan) < cr.TILE_ROWS
        assert not cr.supports_plan(plan, relaxed=True)
    plan = _plan(WIDE_ROUTES[0][0])
    exact, relaxed = cr.wide_layout(plan), cr.wide_layout(plan, relaxed=True)
    assert (exact.tc, exact.tr, exact.ks) == (relaxed.tc, relaxed.tr, relaxed.ks)
    assert exact.group > 1 and relaxed.group == 1 and relaxed.planes == 1


def test_wide_variants_are_counted():
    assert {"wrap16_relaxed_wide", "u16_relaxed_wide"} <= set(cr.VARIANTS)
    assert set(cr.VARIANTS) == set(cr.LAUNCHES_BY_VARIANT)
