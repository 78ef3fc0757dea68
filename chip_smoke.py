#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Two main paths, each through the entry points a user calls:

* Lanczos: one YUV420 frame, 3840x2160 -> 1920x1080, Lanczos3, exact; luma
  at px_scale 1, U and V at px_scale 2, through the executables' one frame
  call (``ops/executable.py``: luma one launch, U and V one launch of a lone
  frame and two of a batch, where they lie).  It runs the tiled kernel
  (``csrc/resize_tiled.cu``) in its ``wrap16_tiled`` form.
* Area: ``YUV420Resizer("area", 1920, 1080, 640, 360)``, the benchmark
  CLI's default (``python -m libiqo_tpu_torch.cli.benchmark``).  It runs
  the tiled kernel's ``u16_tiled`` form, as Linear does.
* Both again with ``precision="relaxed"`` (<= 2 LSB, flat fields exact):
  the tiled kernel's relaxed form, ``wrap16_relaxed_tiled`` and
  ``u16_relaxed_tiled``; and with ``LIBIQO_TPU_CARRY=1`` its row-halo
  carry form (``*_carry_tiled``, ``*_relaxed_carry_tiled``) where the ring
  fits.  The tiled kernel's width walks down to the first that fits (the
  8K proxy, Lanczos3 7680x4320 -> 960x540, at TW 64).  Plans whose band
  fits no tiled width take the wide-window kernel (``csrc/resize_wide.cu``),
  exact and relaxed (phase 5b: the Lanczos3 4K -> 256x144 thumbnail, the
  4K -> 1920x16 strips, 8K -> 480x270); column thumbnails whose ring does
  not fit keep the windowed ``resize_fused``'s carry forms (phase 12).

Phases:

1. Device: ``nvidia-smi`` name and power limit, capability, and the build of
   the kernel library from ``libiqo_tpu_torch/csrc`` (one nvcc per source,
   all started together, sm_90a), with each tiled form's instantiation
   count and ptxas's registers, spills and static shared memory of each
   ``resize_tiled_kernel`` instantiation.
2. Kernels vs plain, wrap16: the tiled kernel and the windowed
   ``resize_fused`` (``pack_operands(..., tiled=False)``) against
   ``resize_plain`` on the card at the Lanczos main path's plane shapes,
   byte for byte, from an aligned source and from a strided one whose rows
   start 5 bytes into an odd-pitched buffer; then a seeded fuzz set of
   Lanczos geometries at px_scale 1-2 and a set at px_scale 3-4, each also
   against the NumPy oracle.
3. The same for u16: Area 1080p -> 360p, Area 4K -> 1080p and Linear
   1080p -> 4K (the tiled kernel's IMAD Y pass), luma and chroma at full
   size; then a seeded fuzz set of 20 Area/Linear geometries, each also
   against the NumPy oracle; then scripts/tpu_check.py's default fuzz set.
   3b. The on-card gate's exact sweep (``libiqo_tpu_torch/tools/
   card_check.py``, whose whole run is ``python -m
   libiqo_tpu_torch.tools.card_check``) over its GRADED, STRESS and
   STRESS_GEOMETRIES lists and the port's own WIDE_WINDOW, batch 4 and 2
   on three graded configs: each through its facade on the card and the
   kernel of ``tiled=False`` and its twin (the windowed kernel beside the
   wide-window one) == the plain path, == the NumPy oracle on sources of
   at most ORACLE_MAX_PIXELS pixels; every case on a kernel; THUMBNAILS
   too (the bands that fit no tiled width, and the 8K proxy).
   Then the wide-window kernel's path (``csrc/resize_wide.cu``, the plans
   whose window is too wide for 16 rows of the windowed kernel): the facade
   on WIDE_FACADE (Area 8192x4 -> 16x4, the thumbnails Area 4096x4096 ->
   128x128, 3840x2160 -> 128x72, Area and Lanczos3 7680x4320 -> 240x135)
   with every count set to 0 just before, one launch a call: ``u16_wide``,
   and ``wrap16_wide_s8`` (the kernel's s8 Y form) for Lanczos3.
   WIDE_PITCHED (widths not a multiple of 16, from rows that start 16-byte
   aligned in a wider pitch) on the kernel's 16-byte loads, which run past
   each row's end: == plain, == the walk, == the oracle on the small one,
   == the scalar Y form where the route takes the s8 one.
   WIDE_TIMED (those five and Area 8192x2160 -> 256x540, 4096x2160 ->
   128x540, whose facade takes the tiled kernel) on the wide-window kernel
   == plain, == the windowed walk, also from a source 5 bytes into wider
   rows, each timed in turns with the windowed kernel's wide-window
   walk (``wide=False``), the facade's route and the plain path (and the
   scalar Y form, ``cuda_resize.wide_tables``, where the kernel takes the
   s8 one), beside its bound.  Then REFUSED_WIDE (Area 4096x232448 -> 16x4, a 952 MB source,
   whose 58112 Y taps an output ``wide_layout`` refuses) through its facade
   on the windowed kernel's walk, one launch, == the plain path byte for
   byte, the kernel's and the plain path's times; the phase's seconds.
4. The Lanczos main path: ``YUV420Resizer(..., device="cuda")``, ``resize``
   on 4 frames and ``resize_batch`` on 4; the wrap16_tiled launch count
   over that run must be the frame calls' (2 a frame: luma, U and V as one
   launch; 3 a batch: U and V one launch each), with no other launch; every
   plane must equal the plain path; the resize CLI on a 3-frame file must
   write the API's bytes.
5. The Area main path: ``YUV420Resizer("area", ...)`` with no ``device``
   argument must resolve to the kernel on the card; over 4 frames and one
   ``resize_batch(4)`` the u16_tiled launch count must be 2 a frame and 3
   a batch; every plane must equal the plain path; the benchmark CLI's
   default mode, run in this process, must launch the u16_tiled kernel
   twice per cycle.
   5b. The thumbnail route (THUMB_FRAMES): ``YUV420Resizer`` on the
   Lanczos3 4K -> 256x144 thumbnail exact and relaxed, the 4K -> 1920x16
   strips (Lanczos3 exact, Area exact and relaxed) and Lanczos3 8K ->
   480x270, whose luma band fits no tiled width: luma launches
   ``wrap16_wide_s8`` (the 256x144 and 480x270 thumbnails), ``wrap16_wide``
   (the strips), ``wrap16_relaxed_wide``, ``u16_wide`` and
   ``u16_relaxed_wide``, chroma the tiled kernel; and the 8K proxy,
   Lanczos3 8K -> 960x540, luma ``wrap16_tiled`` at TW 64.  Launch counts
   as phase 4, every plane == plain, relaxed luma within 2 LSB of exact;
   the windowed twin (``tiled=False, wide=False``) on each frame's luma ==
   the facade, one launch, with every count set to 0 just before; each
   frame's luma timed in turns on its route, the windowed twin and plain
   (the proxy also on the wide-window kernel and at TW 32, the s8 Y form's
   frames also on the scalar Y form), chroma on its route, beside the
   bound.
   5c. The executable layer (``ops/executable.py``, the counterpart of the
   JAX package's compiled executables): on every facade route, the main
   paths exact and relaxed, the carry main paths with ``LIBIQO_TPU_CARRY=1``,
   5b's 4K thumbnails and WIDE_FACADE, each plane's executable == ``resize_fused``
   on its operands == the plain path, byte for byte, one launch of its
   variant, from an aligned source and one 5 bytes into an odd pitch; each
   frame's ``resize_batch(3)`` and ``resize`` with U and V in place,
   stacked and pitched: one frame call, 3 and 2 launches, == the per-plane
   path == plain.  Then the Lanczos main frame at batch 1 and 16: the
   frame call against the per-plane path (``resize_fused`` on luma and on
   U and V stacked) and the per-plane executables in place (three
   launches), in turns: card ms a frame, host-paced ms a frame and host ms
   to issue a call.
6. The benchmark CLI as a user runs it: default mode, ``--amortized``,
   ``--batch 16`` and ``--stream 64 --batch 16``, each must exit 0 and
   print its elapsed time.
7. Times (the probes' timer, ``experiments/_harness.py``: ``launches_ms``
   on ``perturbed`` inputs): CUDA events, minimum over repeats of the mean
   over back-to-back calls on inputs that each differ by one byte, for the
   tiled kernel and
   the windowed ``resize_fused`` in turns (windowed, tiled, tiled,
   windowed), the plain version and, for Area/Linear,
   ``torch.nn.functional.interpolate`` on a float32 copy as a yardstick
   (not the same function: not byte-equal); per plane and per frame,
   beside each instantiation's memory bound.
   Device times are taken with the card first held busy while the host
   queues every call; the kernel's and the frame's times are also given
   unprimed, at the pace the host issues them.
8. The three relaxed kernels (the tiled kernel's relaxed form, the windowed
   ``resize_fused``'s and the wide-window kernel's) == relaxed plain, byte
   for byte, on the full-width
   planes of both main paths and of every ``U16_FRAMES`` frame, then on
   fuzz sets like phases 2-3 (every plan the relaxed form takes) and a plan
   with a residual plane, each also within 3 LSB of the NumPy oracle;
   within 2 LSB of the exact kernel on the full-width planes and on the
   five configs of ``scripts/check_relaxed_tpu.py`` (Lanczos2 720p -> 1080p,
   whose relaxed plane has nonzero taps outside the plane, among them),
   whose max and mean error are printed beside the TPU's
   (``scripts/check_relaxed_result.json``); flat fields 0/128/255 equal to
   the exact output.
9. The relaxed main paths: ``YUV420Resizer(..., precision="relaxed")`` with
   no ``device`` argument, Lanczos 4K and Area 360p, as phases 4-5, with
   the launch counts all of ``wrap16_relaxed_tiled`` / ``u16_relaxed_tiled``;
   the resize CLI with ``--precision relaxed`` must write the API's bytes;
   the benchmark CLI with ``--precision relaxed`` in its default and
   ``--batch 16`` modes.
10. Times of the tiled relaxed kernel, the windowed relaxed kernel
   (``tiled=False``) and the exact tiled kernel in turns, beside the
   relaxed plain version and the bound, per plane and per frame, on both
   main paths; and the exact kernel on a px_scale-4 plane (Lanczos3
   960x540 -> 480x270, the chroma of a 4K -> 1080p YUV410 frame).
   10b. The measurement modules, ``libiqo_tpu_torch/tools/bench.py``,
   ``bench_configs``, ``bench_video64``, ``bench_fallback``,
   ``bench_decomp`` and ``tile_sweep`` (the ports of ``bench.py`` and the
   JAX package's bench scripts) and ``host_split`` (the host's cost of each
   step of a frame call), each through its ``main`` in its short
   form (``--quick``: fewer counts, the same shapes, checks and guards);
   each must exit 0, and the run must launch the tiled kernel.
11. Sharding (``libiqo_tpu_torch.parallel.sharding``) on the one card, over
   meshes that name ``cuda:0`` several times: the sharded main path, with
   every count set to 0 just before, is Lanczos3 4K -> 1080p luma, its px2
   chroma and Area 1080p -> 360p luma, each row-sharded over 4 shards,
   ``make_yuv_step_fn`` at 4K -> 1080p on 4 frames over dp 4, and
   ``make_batch_row_sharded_fn`` on a 2x2 mesh with 3 frames and 1081
   output rows; one launch of the tiled kernel per shard per plane call,
   and per shard's frame call of the YUV step 2 (luma, U and V as one).  Each output equals
   the unsharded kernel or the plain path byte for byte; then small
   row-sharded geometries (tests/test_sharding.py's, the multi-hop Area
   cases and 237 -> 119 rows among them, and a seeded fuzz set) equal
   ``numpy_ref``, and ``dryrun(8, "cuda")`` passes.  Times: the 4-shard call
   against the unsharded call, device-only and host-paced, beside the
   bound; one card running 4 shards, not a multi-card figure.
12. The row-halo carry form (``LIBIQO_TPU_CARRY=1``): the tiled kernel's
   carry form == its form without carry == the windowed ``resize_fused``
   carry form, byte for byte, exact and relaxed, on every full-width plane
   where carry applies (Lanczos3 4K luma, Linear 1080p -> 4K luma and
   chroma, Lanczos3 8K -> 1080p, Lanczos2 720p -> 1080p), on
   scripts/tpu_check.py's carry_sweep cases and on a small fuzz set, batch
   4, also == ``numpy_ref`` at small sizes; ``YUV420Resizer`` with no device
   argument and the opt-in, Lanczos3 4K (carry on luma, tiled on chroma,
   where carry refuses) and Linear 1080p -> 4K (carry on both), exact and
   relaxed, with launch counts by variant (``*_carry_tiled``), then the
   column thumbnails whose tiled ring does not fit (``WINDOWED_CARRY_PATHS``:
   the windowed ``*_carry`` forms on luma); times of the tiled carry form,
   the tiled form and the windowed carry form in turns, and on 4K luma
   against the run and the width (``CARRY_TILED_SWEEP``).
13. The probes (``libiqo_tpu_torch/experiments``, the H100 ports of
   ``scripts/exp_dma_ceiling.py``, ``exp_int8_mxu.py`` and
   ``exp_banded_dots.py``): each of their four kernels == its plain version
   bit for bit at the TPU scripts' full shapes in every variant (the
   ``stream_map`` rows and ``readsum`` in its two forms, ``warp`` and
   ``rows8``, also at a ragged height and at W = 128,
   the four ``mma_steps`` rows at
   STEPS 64, the nine ``banded_tile`` modes at GRID 35 and on 3 tiles in
   both forms, ``sync`` and ``wgmma``, ``csrc/exp/exp_banded_wgmma.cu``);
   then each script's
   ``main()``, with every count set to 0 just before, which asserts every
   chain checksum and holds one output of each other row to the plain
   version; every variant must have launched.  Times beside the bound and
   the library call, timed under the kernel's own protocol
   (``torch.add(out=)`` and ``Tensor.copy_`` in the same chain for kernel
   A, a ``uint8`` ``sum`` fold for B, timed in turns with B's two forms
   inside ``main()``, ``torch._int_mm`` for C, with bf16
   ``torch.matmul`` as a yardstick; none for D, which no one call computes:
   its two products alone as two bf16 ``torch.bmm`` with ``out_dtype=
   torch.float32``, rebuilt into D's function and held equal to its plain
   version first, timed in turns with D's two forms in mono/mono and
   grouped/grouped), and the measured streaming ceilings beside the data
   sheet's.
14. The band-fetch probes (the H100 ports of ``scripts/exp_band_shape.py``,
   ``exp_i32_band.py``, ``exp_overlap.py`` and ``exp_blocked_halo.py``):
   kernels E, G and H == their plain versions bit for bit at the scripts'
   full shapes in every form and variant (the seven ``band_ydot`` forms with
   nonzero streamed operands and its word-load form, whose output must be the
   byte form's permuted; ``overlap_dots`` in 4 variants x P in 0, 1, 2, 4, 8;
   ``band_colsum`` in 3 configs x 3 variants, in both forms, ``walk`` and
   ``grid``, also on EDGE_SHAPES (halo past the step, one tile, no halo, w
   not a multiple of 16 or of the chunk) from planes 0 and 4 bytes into
   their buffers, blocked2's halo from a plane of its own), E and G in both
   implementations, ``ring`` (``csrc/exp/exp_band_ring.cu``) and ``sync``,
   the ring also on a 2-frame ``grid3`` source and G's at 2100 rows (a short
   last run, blocks past the plane); then the four scripts' ``main()``, with
   every count set to 0 just before; every variant of both implementations
   must have launched.  E's and G's ``main()`` time both implementations and
   the library call in turns: ``torch._int_mm`` of the dots alone, over
   operands laid out outside the timed region (G at every P >= 1); H's times
   both forms and a strided-view ``sum`` (its 8-row broadcast left as an
   ``expand``) in turns.  Plain times at the host's pace.
15. The X-pass and legality probes (the H100 ports of
   ``scripts/exp_x_schemes.py``, ``exp_vpu_xpass.py``, ``exp_vpu_rate.py``,
   ``exp_slice_align.py`` and ``exp_element_clamp.py``): kernels I-M == their
   plain versions at the scripts' full shapes and repeat counts in every
   variant, bit for bit except ``bf16_1dot``, which is held within the f32
   summation bound ``(K + 1) 2^-24 sum |a c|`` per application (its LSB
   error against the exact product printed beside the script's);
   ``slice_groups`` in its u8 form and its int32-sum check form, in both
   forms, ``mma_sync`` and ``wgmma``, the latter also at 35 steps (a partial
   M tile and a partial last wave); the TMA
   window probes X1 (2-D and batch 3), X2 and X3.  Then the five scripts'
   ``main()``, with every count set to 0 just before; every variant must
   have launched, the window probes must be OK, and the exactness checks
   must give the scripts' answers.  Plain times at the host's pace and
   library yardsticks under the kernels' own protocol (``torch._int_mm`` of
   the s8 dots alone, ``torch.bmm`` in f32 with TF32 off, bf16 ``torch.bmm``
   with ``out_dtype=torch.float32``, an int32 chain of elementwise calls, one
   corner-gathering index; for L one such ``bmm`` over its 45 windows, and
   three, one a plane, both timed in turns with L's two forms inside
   ``main()``).  Then the redesigned forms of ``f32_2dot``, ``s16_1dot`` and
   ``dense4`` (``csrc/exp/exp_xpass_gemm.cu``, ``form="gemm"``): == plain
   bit for bit at 1, 3, R/8 and R repeats and a partial last step (s16 also
   at the int16 extremes), == gold (I) and == the library products (I and J)
   at one application, their launches counted apart in ``main()``; timed in
   turns with PR 7's forms at R and R/8 (µs per application as the slope and
   as t(R)/R), beside the bound and the library call (for ``s16_1dot`` a
   float64 ``torch.bmm`` of the int16 planes, held equal to plain first, and
   ``torch._int_mm`` of four s8 byte-plane products).  The gemm forms of
   ``s8_4dot`` and ``s8_2dot_cat`` (``csrc/exp/exp_xpass_s8.cu``) == plain on
   the persistent walk at the same repeats, with the script's zero ``corr`` and a nonzero one, at the byte extremes
   and on a walk of 7 blocks; timed in turns with their serial forms,
   ``s16_1dot[gemm]`` and ``torch._int_mm`` of their dots (four calls of N =
   128 a group, two of N = 256), each held equal to plain first.  J's
   ``corr_f32`` and ``muls_f32`` in their wide form
   (``csrc/exp/exp_vpu_f32.cu``: int -> float by the exponent trick, the
   repeats in thirds over 1440 warps) == plain bit for bit at R 1, 3, 24 and
   25, at the int16 extremes and on work values past 2^22 (their warps take
   ``I2F``), timed in turns with their serial forms at R and R/8; X3's
   cluster form (one thread block cluster of 4 a row chunk, the scratch in
   distributed shared memory) == plain bit for bit on ``arange`` and on random
   float bits with NaN and -0.0, compared as int32 views, timed in turns with
   its serial form and ``var.index_select(0, idx)`` inside ``main()``; X2's
   split form (8 TMA boxes of (64, 32) on 8 blocks, each from row 128 past
   the source's end) == plain, its spill == its model (rows past the end
   zeros), timed in turns with its single-box form and
   ``src[128:160, :128].clone()`` inside ``main()``; X1's split form (8 TMA
   boxes of (64, 32) a tile, 128 blocks, 384 for the batch) == plain and its
   model, 2-D and batch, timed in turns with its single-box form and the
   corner-gathering index inside ``main()``.

Any failure raises and exits non-zero.  Without a CUDA device it exits 2
and prints no result.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.modules["jax"] = None         # the port must not need JAX; any import fails
sys.modules["libiqo_tpu"] = None  # nor the JAX package

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
# the probes' timer (launches_ms, perturbed), which every phase times with,
# and the H100 SXM data sheet's rates, kept in one place
from libiqo_tpu_torch.experiments import _harness  # noqa: E402
from libiqo_tpu_torch.experiments._harness import (  # noqa: E402
    BF16_OPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S)
# the on-card gate's case lists and sweeps (python -m libiqo_tpu_torch.tools.card_check)
from libiqo_tpu_torch.tools import card_check  # noqa: E402

SRC_W, SRC_H, DST_W, DST_H = 3840, 2160, 1920, 1080     # the Lanczos main path
AREA_MAIN = ("area", 1920, 1080, 640, 360)             # the Area main path
U16_FRAMES = {                    # name: (method, src_w, src_h, dst_w, dst_h)
    "area 1080p->360p": AREA_MAIN,
    "area 4K->1080p": ("area", 3840, 2160, 1920, 1080),
    "linear 1080p->4K": ("linear", 1920, 1080, 3840, 2160),
}
SEED = 20261016
FUZZ_CASES = 20
TOLERANCE = 0          # LSB: the contract is byte-exact
RELAXED_LSB = 2        # relaxed vs the exact output: the relaxed contract
RELAXED_ORACLE_LSB = 3  # relaxed vs numpy_ref on fuzz sets, as tests/test_relaxed.py
# scripts/check_relaxed_tpu.py's configs (name: method, kwargs, geometry)
RELAXED_GRADED = {
    "lanczos3 3840x2160->1920x1080": ("lanczos", dict(degree=3), 3840, 2160, 1920, 1080),
    "lanczos3 1920x1080->960x540 px2": ("lanczos", dict(degree=3, px_scale=2),
                                        1920, 1080, 960, 540),
    "lanczos2 1280x720->1920x1080": ("lanczos", dict(degree=2), 1280, 720, 1920, 1080),
    "area 1920x1080->480x270": ("area", {}, 1920, 1080, 480, 270),
    "linear 640x480->320x240": ("linear", {}, 640, 480, 320, 240),
}
PX4_PLANE = ("lanczos", dict(degree=3, px_scale=4), 960, 540, 480, 270)
CLI_RUNS = (["--cycles", "32"], ["--amortized"], ["--batch", "16"],
            ["--stream", "64", "--batch", "16"])
SHARDS = 4                      # row (or data) shards, all on the one card
SHARDED_PLANES = {              # name: (algo, kwargs, sw, sh, dw, dh, batch)
    "lanczos3 4K->1080p luma": ("lanczos", dict(degree=3), 3840, 2160, 1920, 1080, 1),
    "lanczos3 4K->1080p px2 chroma": ("lanczos", dict(degree=3, px_scale=2),
                                      1920, 1080, 960, 540, 2),
    "area 1080p->360p luma": ("area", {}, 1920, 1080, 640, 360, 1),
}
# dp x sp on a 2x2 mesh: 3 frames, 1081 output rows over 2 row shards
DP_SP_FRAME = ("lanczos", dict(degree=3), 3840, 2160, 1920, 1081, 3)
SHARDED_SMALL = (               # (shards, algo, kwargs, (sw, sh), (dw, dh))
    (8, "lanczos", dict(degree=3), (320, 240), (160, 120)),
    (8, "area", {}, (320, 240), (160, 120)),
    (8, "linear", {}, (320, 240), (160, 120)),
    (4, "lanczos", dict(degree=2), (64, 64), (128, 128)),
    (8, "lanczos", dict(degree=3), (320, 237), (160, 119)),   # odd heights
    (8, "area", {}, (128, 512), (64, 16)),                    # multi-hop Area
    (8, "area", {}, (64, 256), (32, 4)),      # halo taller than a shard
)
SHARDED_FUZZ = 8
CARRY_PLANES = {                # full-width planes where carry_ok holds
    "lanczos3 4K->1080p luma": ("lanczos", dict(degree=3), 3840, 2160, 1920, 1080, 1),
    "linear 1080p->4K luma": ("linear", {}, 1920, 1080, 3840, 2160, 1),
    "linear 1080p->4K chroma": ("linear", {}, 960, 540, 1920, 1080, 2),
    "lanczos3 8K->1080p": ("lanczos", dict(degree=3), 7680, 4320, 1920, 1080, 1),
    "lanczos2 720p->1080p": ("lanczos", dict(degree=2), 1280, 720, 1920, 1080, 1),
}
CARRY_FUZZ = 10
# CARRY_BLOCKS values for the windowed carry form's run-length sweep on 4K
# luma: runs of 2, 3, 7, 13, 34 and 68 row tiles (510 down to 15 blocks)
CARRY_RUN_SWEEP = (1020, 264, 132, 66, 16, 1)
# (TW, run) of the tiled carry form's sweep on 4K luma: 510 down to 15
# blocks at TW 128, and the narrower widths
CARRY_TILED_SWEEP = ((128, 2), (128, 3), (128, 7), (128, 17), (128, 68),
                     (64, 3), (64, 7), (32, 7), (32, 13))
ORACLE_MAX_PIXELS = 400_000     # numpy_ref only on sources this small
# (frame, luma variant, chroma variant, precision): the thumbnail route,
# YUV420 frames whose luma band fits no tiled width (outside tiled_ok, exact
# or relaxed), so luma takes the wide-window kernel at 16 rows (its s8 Y form
# where cuda_resize.wide_s8 takes the exact plan), while chroma fits the
# tiled one; and the 8K proxy, whose luma fits the tiled kernel only once its
# width walks down to TW 64
THUMB_FRAMES = (
    (("lanczos3", 3840, 2160, 256, 144), "wrap16_wide_s8", "wrap16_tiled", "exact"),
    (("lanczos3", 3840, 2160, 256, 144), "wrap16_relaxed_wide", "wrap16_relaxed_tiled",
     "relaxed"),
    (("lanczos3", 3840, 2160, 1920, 16), "wrap16_wide", "wrap16_tiled", "exact"),
    (("area", 3840, 2160, 1920, 16), "u16_wide", "u16_tiled", "exact"),
    (("area", 3840, 2160, 1920, 16), "u16_relaxed_wide", "u16_relaxed_tiled", "relaxed"),
    (("lanczos3", 7680, 4320, 480, 270), "wrap16_wide_s8", "wrap16_tiled", "exact"),
    (("lanczos3", 7680, 4320, 960, 540), "wrap16_tiled", "wrap16_tiled", "exact"),
)
PROXY_TW = 64                   # the 8K proxy's luma width after the walk
CARRY_PATHS = (                 # (frame, luma variant, chroma variant, precision)
    (("lanczos3", 3840, 2160, 1920, 1080), "wrap16_carry_tiled", "wrap16_tiled",
     "exact"),
    (("linear", 1920, 1080, 3840, 2160), "u16_carry_tiled", "u16_carry_tiled",
     "exact"),
    (("lanczos3", 3840, 2160, 1920, 1080), "wrap16_relaxed_carry_tiled",
     "wrap16_relaxed_tiled", "relaxed"),
    (("linear", 1920, 1080, 3840, 2160), "u16_relaxed_carry_tiled",
     "u16_relaxed_carry_tiled", "relaxed"),
)
# column thumbnails whose luma ring does not fit the tiled kernel's shared
# memory (tiled_carry_layout refuses) while the windowed carry form's does
# (carry_ok): luma keeps resize_fused's carry forms, chroma the tiled kernel
WINDOWED_CARRY_PATHS = (
    (("lanczos3", 640, 2160, 32, 270), "wrap16_carry", "wrap16_tiled", "exact"),
    (("linear", 2712, 428, 54, 1712), "u16_carry", "u16_carry_tiled", "exact"),
    (("lanczos3", 640, 2160, 32, 270), "wrap16_relaxed_carry", "wrap16_relaxed_tiled",
     "relaxed"),
    (("linear", 2712, 428, 54, 1712), "u16_relaxed_carry", "u16_relaxed_carry_tiled",
     "relaxed"),
)
# a px2 plan whose relaxed column-sum repair does not converge: the relaxed
# forms add the residual plane's sums
RELAXED_RESIDUAL = ("lanczos", dict(degree=4, px_scale=2), 552, 40, 15, 30)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def first_diff(a: torch.Tensor, b: torch.Tensor) -> str:
    idx = torch.nonzero(a != b)[0].tolist()
    return (f"first differing pixel at {idx}: kernel {a[tuple(idx)].item()}"
            f" plain {b[tuple(idx)].item()}")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            tol: int = TOLERANCE) -> int:
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    err = int((got.int() - want.int()).abs().max().item()) if got.numel() else 0
    if err > tol:
        raise SmokeFailure(f"{name}: max abs err {err} > {tol}; "
                           + first_diff(got, want))
    return err


def random_u8(rng, shape) -> np.ndarray:
    return rng.integers(0, 256, shape, dtype=np.uint8)


def yuv_planes(build_plan, method, sw, sh, dw, dh):
    """[(plane, plan, batch)] of one YUV420 frame, as ``YUV420Resizer``
    builds them for even sizes: luma at full size, U and V as one batch-of-2
    call at half size (Lanczos chroma at px_scale 2)."""
    if method.startswith("lanczos"):
        degree = int(method[len("lanczos"):] or 3)
        kw, ckw = dict(degree=degree), dict(degree=degree, px_scale=2)
        algo = "lanczos"
    else:
        kw, ckw, algo = {}, {}, method
    return [("luma", build_plan(algo, sw, sh, dw, dh, **kw), 1),
            ("chroma", build_plan(algo, sw // 2, sh // 2, dw // 2, dh // 2,
                                  **ckw), 2)]


def lanczos_fuzz(rng):
    """Lanczos degree 2-5, px_scale 1 and 2, up and down, odd sizes."""
    for i in range(FUZZ_CASES):
        degree, px = 2 + i % 4, 1 + (i // 4) % 2
        src = rng.integers(9, 400, 2) | (i % 3 == 0)    # every third odd
        if i % 2:
            dst = src * rng.integers(1, 3, 2) + rng.integers(1, 7, 2)
        else:
            dst = np.maximum(1, src // rng.integers(2, 6, 2))
        yield "lanczos", dict(degree=degree, px_scale=px), src, dst


def lanczos_px34(rng):
    """K5's plans: Lanczos degree 2-9 at px_scale 3 and 4, whose X taps
    fall outside the s8 gate; up and down, odd sizes."""
    for i in range(8):
        src = rng.integers(9, 300, 2) | (i % 3 == 0)
        if i % 2:
            dst = np.maximum(1, src // rng.integers(2, 5, 2))
        else:
            dst = src * rng.integers(1, 3, 2) + rng.integers(1, 7, 2)
        yield "lanczos", dict(degree=2 + i, px_scale=3 + i % 2), src, dst


def area_linear_fuzz(rng):
    """Area and Linear, up and down, odd sizes, and three extremes: an
    Area ratio with 40/44 taps and two reference_oob Linear upscales."""
    for i in range(FUZZ_CASES - 3):
        src = rng.integers(9, 400, 2) | (i % 3 == 0)
        if i % 4 < 2:
            dst = np.maximum(1, src // rng.integers(2, 9, 2))
        else:
            dst = src * rng.integers(1, 3, 2) + rng.integers(1, 7, 2)
        yield ("area", "linear")[i % 2], {}, src, dst
    yield "area", {}, (300, 200), (7, 5)
    yield "linear", {}, (16, 12), (80, 60)
    yield "linear", {}, (5, 3), (300, 200)


MAX_ERR: dict = {}     # variant: largest error against plain and numpy_ref
LSB_VS_EXACT: dict = {}   # relaxed variant: largest error against the exact output


def hold(cr, tag: str, plan, host, oracle=None) -> int:
    """Kernel == plain on the card, byte for byte, for one plan and a
    (B, h, w) source (a NumPy array, or a CUDA tensor, which may be a
    strided view): the plan's own route (the tiled kernel where
    ``tiled_ok`` holds) and the windowed ``resize_fused``
    (``tiled=False``); also == the NumPy oracle when one is given.  Errors
    are noted by variant in MAX_ERR."""
    check(cr.supports_plan(plan), f"{tag}: kernel refuses the plan")
    src = host if isinstance(host, torch.Tensor) else torch.from_numpy(host).cuda()
    want = None
    if oracle is not None:
        want = torch.from_numpy(np.stack([oracle.resize_u8(plan, f)
                                          for f in src.cpu().numpy()]))
    err = 0
    for tiled in (True, False):
        ops = cr.pack_operands(plan, "cuda", tiled=tiled)
        v = cr.variant(ops.tables)
        got = cr.resize_fused(ops, src)
        e = compare(f"{tag} {v}", got, cr.resize_plain(ops, src))
        if want is not None:
            e = max(e, compare(f"{tag} {v} vs numpy_ref", got.cpu(), want))
        MAX_ERR[v] = max(MAX_ERR.get(v, 0), e)
        err = max(err, e)
    return err


TILED_FORMS = {(False, False): "exact", (True, False): "relaxed",
               (False, True): "carry", (True, True): "relaxed carry"}


def tiled_ptxas(log: str) -> list[str]:
    """ptxas -v's report for each instantiation of the tiled kernel, per
    tap (resize_tiled_kernel) and of the X window
    (resize_tiled_window_kernel, the exact and carry forms): registers,
    spills and static shared memory (its band or ring, work tile and
    records are dynamic shared memory, sized per plan at launch); then, per
    form, its instantiation count, its source's nvcc wall time and the range
    of registers and spills."""
    out, name, forms = [], None, {}
    secs = dict(re.findall(r"nvcc -c (\S+): (\S+) s", log))
    for line in log.splitlines():
        m = (re.search(r"resize_tiled_kernelILb(\d)ELb(\d)ELi(\d+)ELb(\d)ELb(\d)E", line)
             or re.search(r"resize_tiled_window_kernelILb(\d)ELb(\d)ELi(\d+)E()Lb(\d)E", line))
        if "Compiling entry function" in line:
            name = m and (*(int(v or 0) for v in m.groups()), "window_kernel" in line)
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line)[1])
            smem = re.search(r"(\d+) bytes smem", line)
            w16, s8, tw, rel, car, window = name
            form = TILED_FORMS[bool(rel), bool(car)]
            if window:
                kernel = (f"resize_tiled_window_kernel<{bool(w16)}, {bool(s8)}, {tw}, "
                          f"{bool(car)}> (kWrap16, kS8Y, TW, kCarry; {form}, X window)")
            else:
                kernel = (f"resize_tiled_kernel<{bool(w16)}, {bool(s8)}, {tw}, {bool(rel)}, "
                          f"{bool(car)}> (kWrap16, kS8Y, TW, kRelaxed, kCarry; {form})")
            out.append(f"ptxas {kernel}: {regs} registers, {spill}, "
                       f"{smem[1] if smem else 0} bytes static smem")
            forms.setdefault(form, []).append((regs, spill))
            name = None
    source = {"exact": "resize_tiled.cu", "relaxed": "resize_tiled_relaxed.cu",
              "carry": "resize_tiled_carry.cu",
              "relaxed carry": "resize_tiled_relaxed_carry.cu"}
    for form, rows in forms.items():
        regs = [r for r, _ in rows]
        spills = sorted({sp for _, sp in rows})
        out.append(f"tiled form {form}: {len(rows)} instantiations, nvcc -c "
                   f"{source[form]} {secs.get(source[form])} s, registers "
                   f"{min(regs)}-{max(regs)}, {' / '.join(spills)}")
    return out


def phase_device(build, device):
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}, capability {torch.cuda.get_device_capability(0)},"
          f" torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{device.describe()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # the two libraries' nvcc run together
        list(pool.map(lambda load: load(), (build.load, build.load_experiments)))
    print(f"kernel libraries built or loaded in {time.perf_counter() - t0!r} s")
    for what, where, secs, log in (
            ("kernel library", build.build_dir(), build.build_seconds, build.build_log),
            ("probe library", build.exp_build_dir(), build.exp_build_seconds,
             build.exp_build_log)):
        print(f"{what}: {where} built in {secs!r} s (None = already built)")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")
    for line in tiled_ptxas(build.build_log):
        print(line)
    return smi, name


def phase_kernel_vs_plain(cr, build_plan, numpy_ref, rng, variant, frames,
                          fuzz_sets):
    """Both kernels == plain at full-size planes, from an aligned source and
    from a strided one whose rows start 5 bytes into an odd-pitched buffer
    (the tiled kernel's byte-load route), then == plain == numpy_ref on each
    fuzz set; every plan must take ``variant`` (and ``variant_tiled`` where
    ``tiled_ok`` holds; the full-size planes must)."""
    max_err = 0
    for frame in frames:
        for plane, plan, batch in yuv_planes(build_plan, *frame):
            check(cr.variant(plan) == variant, f"{frame} {plane}: variant "
                  f"{cr.variant(plan)}, expected {variant}")
            check(cr.tiled_ok(plan), f"{frame} {plane}: tiled_ok refuses")
            host = random_u8(rng, (batch, plan.y.n_src, plan.x.n_src))
            tag = f"{frame[0]} {plane} {tuple(host.shape)}"
            max_err = max(max_err, hold(cr, tag, plan, host))
            h, w = plan.y.n_src, plan.x.n_src
            wide = torch.from_numpy(random_u8(rng, (batch, h, w + 11))).cuda()
            max_err = max(max_err, hold(cr, f"{tag} strided +5", plan,
                                        wide[:, :, 5:5 + w]))
            lay = cr.tiled_layout(plan)
            print(f"kernel[{variant}] and kernel[{variant}_tiled] (TW {lay.tw},"
                  f" {'s8 mma' if lay.s8y else 'IMAD'} Y pass, {lay.smem} B of "
                  f"shared memory) == plain: {tag} -> ({batch}, {plan.y.n_dst}, "
                  f"{plan.x.n_dst}), aligned and strided at +5 bytes, max abs "
                  "err 0")
    for name, cases in fuzz_sets:
        n = tiled = 0
        for algo, kw, src, dst in cases:
            (sw, sh), (dw, dh) = map(int, src), map(int, dst)
            plan = build_plan(algo, sw, sh, dw, dh, **kw)
            check(cr.variant(plan) == variant, f"{name}: variant mismatch")
            tag = f"{name} {algo}{kw or ''} {sw}x{sh}->{dw}x{dh}"
            max_err = max(max_err, hold(cr, tag, plan,
                                        random_u8(rng, (2, sh, sw)), numpy_ref))
            n += 1
            tiled += cr.tiled_ok(plan)
        print(f"kernel[{variant}] == plain == numpy_ref on {n} {name} "
              f"geometries, {tiled} of them on kernel[{variant}_tiled] too "
              "(the rest: tiled_ok refuses)")
    return max_err


def phase_tpu_fuzz(cr, build_plan, numpy_ref, rng, n: int = 20,
                   seed: int = 20260816) -> int:
    """scripts/tpu_check.py's default fuzz set (``fuzz_cases(20)``): both
    kernels == plain on every case inside ``supports_plan``, and ==
    numpy_ref where the source is small."""
    max_err = done = tiled = 0
    for algo, sw, sh, dw, dh, kw in card_check.fuzz_cases(n, seed):
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        if not cr.supports_plan(plan):
            continue
        small = sw * sh <= ORACLE_MAX_PIXELS
        max_err = max(max_err, hold(
            cr, f"tpu_check fuzz {algo}{kw or ''} {sw}x{sh}->{dw}x{dh}", plan,
            random_u8(rng, (2 if small else 1, sh, sw)),
            numpy_ref if small else None))
        done += 1
        tiled += cr.tiled_ok(plan)
    print(f"both kernels == plain (== numpy_ref on sources <= "
          f"{ORACLE_MAX_PIXELS} pixels) on {done} of scripts/tpu_check.py's "
          f"{n} fuzz cases (seed {seed}; {tiled} on the tiled kernel, the rest "
          "outside tiled_ok; the others outside supports_plan)")
    return max_err


# the wide-window plans (cuda_resize.work_rows < 16): card_check.WIDE_FACADE,
# the five the facade sends to the wide-window kernel, and WIDE_TIMED, those
# and the two the facade sends to the tiled kernel, timed here on the
# wide-window kernel with tiled=False
WIDE_INPUTS = 64                               # most distinct sources timed
WIDE_STRIDED = (5, 11)          # (offset, pad) of a source the byte loads take
# widths that are not a multiple of 16, from rows that start 16-byte aligned
# in a wider pitch: each row's last 16-byte load runs past its end into the
# pitch's noise, in columns the X pass never reads
WIDE_PITCHED = (("area", 8191, 4, 16, 4, {}), ("area", 3839, 2160, 128, 72, {}),
                ("lanczos", 7679, 4319, 240, 135, dict(degree=3)))
# the windowed kernel's wide-window walk on its last route: an exact plan
# whose 16-row tile does not fit and which wide_layout refuses (one output's
# 58112 Y taps do not fit shared memory), so the facade keeps it on the walk;
# its 952 MB source is held to the plain path (numpy_ref's int64 copy of it
# takes minutes on the host)
REFUSED_WIDE = ("area", 4096, 232448, 16, 4, {})
REFUSED_PLAIN_CALLS = 2         # the plain path loops over 58112 taps: seconds a call


def phase_card_check(cr, build_plan, card: str) -> dict:
    """Phase 3b: the on-card gate's exact sweep (``card_check.exact_sweep``)
    over GRADED, STRESS, STRESS_GEOMETRIES and the port's WIDE_WINDOW and
    THUMBNAILS: each through its facade on the card, the kernel of
    ``tiled=False`` and its twin (``card_check.twin``), == the plain path on
    the card, == numpy_ref on sources of at most
    ORACLE_MAX_PIXELS pixels; every case must run a kernel.  Then the
    wide-window kernel's path: the facade on each WIDE_FACADE plan with
    every count set to 0 just before, one launch a call: ``u16_wide`` for
    Area, ``wrap16_wide_s8`` (the s8 Y form) for Lanczos3.  Then
    WIDE_PITCHED on its 16-byte loads past each row's end (:func:`hold_pitched`).
    Then WIDE_TIMED, each on the wide-window kernel == plain (== numpy_ref on a
    small source, == the windowed walk), also from a source 5 bytes into
    wider rows (byte loads), timed in turns with the
    windowed kernel's wide-window walk (``wide=False``), the facade's route
    and the plain path, beside its bound.  Returns {"rows": one dict a
    plan, "launches": the path's launches by variant}."""
    t_phase = time.perf_counter()
    rows, fails, skips = card_check.exact_sweep(
        card_check.Oracle(), card, cases=card_check.REQUIRED,
        oracle_max_pixels=ORACLE_MAX_PIXELS)
    bad = [r for r in rows if r["status"] != "ok"]
    check(not bad and not fails and not skips, f"card_check exact sweep: {bad}")
    print(f"card_check exact sweep: {len(rows)} rows (GRADED, STRESS, "
          f"STRESS_GEOMETRIES, WIDE_WINDOW, THUMBNAILS, batch 4 and 2 on three graded "
          f"configs) ok on their kernels: {sorted({r['variant'] for r in rows})}; "
          f"tiled=False {sorted({r['windowed_variant'] for r in rows if 'windowed_variant' in r})}"
          f"; their twins {sorted({r['twin_variant'] for r in rows if 'twin_variant' in r})}; "
          f"numpy_ref on {sum(r['oracle'] for r in rows)} of them")
    facades = [(case, card_check.facade(case)) for case in card_check.WIDE_FACADE]
    srcs = [torch.from_numpy(card_check.source(case, 1)).cuda()
            for case in card_check.WIDE_FACADE]
    for (case, r), x in zip(facades, srcs):
        r.resize(x)                            # operands built and cached
    torch.cuda.synchronize()
    cr.reset_launches()
    for (case, r), x in zip(facades, srcs):
        n = dict(cr.LAUNCHES_BY_VARIANT)
        r.resize(x)
        got = {v: c - n[v] for v, c in cr.LAUNCHES_BY_VARIANT.items() if c != n[v]}
        want = "wrap16_wide_s8" if case[0] == "lanczos" else "u16_wide"
        check(got == {want: 1}, f"{card_check.case_name(case)}: the facade launched {got}")
    torch.cuda.synchronize()
    launches = {v: cr.LAUNCHES_BY_VARIANT[v]
                for v in ("u16_wide", "wrap16_wide", "wrap16_wide_s8")}
    check(sum(cr.LAUNCHES_BY_VARIANT.values()) == len(card_check.WIDE_FACADE),
          f"wide-window path: {cr.LAUNCHES_BY_VARIANT}")
    print(f"wide-window path: the facade on {len(card_check.WIDE_FACADE)} plans -> "
          f"launches {launches}")
    for case in WIDE_PITCHED:
        hold_pitched(cr, build_plan, case)
    wide = [time_wide(cr, build_plan, case, card) for case in card_check.WIDE_TIMED]
    refused = hold_refused(cr, build_plan, card)
    print(f"phase card_check: {time.perf_counter() - t_phase!r} s")
    return {"rows": wide, "launches": launches, "refused": refused}


def hold_refused(cr, build_plan, card: str) -> dict:
    """REFUSED_WIDE through its facade on the card: the route (in
    ``supports_plan``, ``work_rows`` < 16, refused by ``wide_layout``, on
    ``KernelTables``), one launch of the windowed kernel's walk, == the
    plain path byte for byte; the kernel's time (CUDA events, one source of
    952 MB, far past the L2) and the plain path's (host clock, synchronised),
    beside the bound."""
    t0 = time.perf_counter()
    alg, sw, sh, dw, dh, kw = REFUSED_WIDE
    name = card_check.case_name(REFUSED_WIDE)
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    tables = cr.kernel_tables(plan)
    check(cr.supports_plan(plan) and cr.work_rows(plan) < cr.TILE_ROWS
          and cr.wide_layout(plan) is None and isinstance(tables, cr.KernelTables),
          f"{name}: not on the walk's refused-layout route")
    r = card_check.facade(REFUSED_WIDE)
    check(r.resolved_backend() == "cuda", f"{name}: resolves to {r.resolved_backend()}")
    ops = cr.pack_operands(plan, "cuda")
    v = cr.variant(ops.tables)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    x = torch.randint(0, 256, (1, sh, sw), dtype=torch.uint8, device="cuda", generator=gen)
    got, counts = card_check.launched(cr, lambda: r.resize(x))
    check(counts == {v: 1} and v == "u16", f"{name}: the facade launched {counts}")
    plain_s = []
    for _ in range(REFUSED_PLAIN_CALLS):
        t1 = time.perf_counter()
        want = cr.resize_plain(ops, x)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t1)
    err = compare(f"{name} facade vs plain", got, want)
    err = max(err, compare(f"{name} kernel vs plain", cr.resize_fused(ops, x), want))
    ms = _harness.launches_ms(lambda t: cr.resize_fused(ops, t), [x], repeats=2, primed=False)
    bytes_ms, ops_ms = bound([(plan, 1)])
    row = {"plan": name, "variant": v, "route": "the windowed walk (wide_layout refuses)",
           "rows_per_block": ops.tables.rows, "source_bytes": sw * sh, "max_abs_err": err,
           "ms": ms, "plain_ms": min(plain_s) * 1e3, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "seconds": time.perf_counter() - t0}
    print(f"{name} ({sw * sh / 1e6!r} MB): the facade's route {v}, the windowed kernel's "
          f"walk at {row['rows_per_block']} rows a block (wide_layout refuses: "
          f"{plan.y.num_coefs} Y taps an output), one launch, == plain byte for byte; "
          f"kernel {ms!r} ms, plain {row['plain_ms']!r} ms (host clock, synchronised, min of "
          f"{REFUSED_PLAIN_CALLS}), bound {row['bound_ms']!r} ms ({row['bound_by']}); this "
          f"step {row['seconds']!r} s ({card})")
    del x, got, want
    torch.cuda.empty_cache()
    return row


def hold_pitched(cr, build_plan, case) -> int:
    """One WIDE_PITCHED plan from the first ``src_w`` columns of rows of a
    16-byte aligned pitch 16 past ``src_w`` rounded up to 16, the pitch's
    tail noise: the wide-window kernel's scalar Y form takes 16-byte loads
    there (``cuda_resize.wide_load_bytes``), its window reaches the row's
    end, and it == plain (both routes, :func:`hold`; == numpy_ref on a small
    source) == the windowed walk; where the route takes the s8 Y form
    (byte loads at the row's end), the scalar form == it too."""
    from libiqo_tpu_torch.golden import numpy_ref

    alg, sw, sh, dw, dh, kw = case
    name = card_check.case_name(case)
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    ops = cr.pack_operands(plan, "cuda", tiled=False)
    walk = cr.pack_operands(plan, "cuda", tiled=False, wide=False)
    scalar = cr.KernelOperands(plain=ops.plain, tables=cr.wide_tables(plan, "cuda"))
    v = cr.variant(ops.tables)
    pitch = -(-sw // 16) * 16 + 16
    buf = torch.from_numpy(random_u8(np.random.default_rng(sw * sh), (1, sh, pitch))).cuda()
    x = buf[:, :, :sw]
    end = int(scalar.tables.layout.win[:, 1].max())
    check(v in ("u16_wide", "wrap16_wide", "wrap16_wide_s8") and not cr.tiled_ok(plan)
          and sw % 16 and end == sw, f"{name}: {v}, window ends at {end}")
    check(cr.wide_load_bytes(x) == 16, f"{name}: pitch {pitch} takes "
          f"{cr.wide_load_bytes(x)}-byte loads")
    got, counts = card_check.launched(cr, lambda: cr.resize_fused(ops, x))
    check(counts == {v: 1}, f"{name}: launched {counts}")
    small = sw * sh <= ORACLE_MAX_PIXELS
    err = hold(cr, f"{name} pitch {pitch}", plan, x, numpy_ref if small else None)
    err = max(err, compare(f"{name} pitch {pitch} walk vs kernel",
                           cr.resize_fused(walk, x), got))
    if ops.tables.y_s8:
        err = max(err, compare(f"{name} pitch {pitch} scalar form vs kernel",
                               cr.resize_fused(scalar, x), got))
    loads = ("the scalar Y form's 16-byte loads past the row's end == kernel"
             if ops.tables.y_s8 else "16-byte loads past the row's end, kernel")
    print(f"{name} from a pitch of {pitch} bytes: {loads}[{v}] == plain == the walk"
          f"{' == numpy_ref' if small else ''}")
    return err


def wide_shape(cr, k) -> dict:
    """The layout that the wide-window kernel's tables ``k`` launch: the s8
    Y form's width, ring, blocks a frame and shared memory, or the scalar
    form's tile, Y slices, lanes an output, blocks and shared memory."""
    lay = k.layout
    if k.y_s8:
        return {"form": cr.launch_form(k), "tw": lay.tw, "stages": lay.stages,
                "blocks": lay.blocks, "smem": lay.smem}
    return {"form": cr.launch_form(k), "tc": lay.tc, "tr": lay.tr, "ks": lay.ks,
            "group": lay.group, "blocks": lay.blocks, "smem": lay.smem}


def time_wide(cr, build_plan, case, card: str) -> dict:
    """One wide-window plan on the wide-window kernel (``tiled=False``) ==
    plain (== numpy_ref on a small source), == the windowed walk, from an
    aligned source and from one 5 bytes into wider rows (byte loads); the
    facade's route (one launch, of this kernel where ``tiled_ok`` refuses);
    timed in turns with the walk, the route and the plain path, and where
    the kernel takes its s8 Y form, with the scalar Y form at its layout
    (``cuda_resize.wide_tables``)."""
    alg, sw, sh, dw, dh, kw = case
    name = card_check.case_name(case)
    plan = build_plan(alg, sw, sh, dw, dh, **kw)
    r = card_check.facade(case)
    check(r.resolved_backend() == "cuda", f"{name}: resolves to {r.resolved_backend()}")
    ops = cr.pack_operands(plan, "cuda", tiled=False)
    walk = cr.pack_operands(plan, "cuda", tiled=False, wide=False)
    v, shape = cr.variant(ops.tables), wide_shape(cr, ops.tables)
    check(ops.tables.wide and walk.tables.rows == cr.work_rows(plan) < cr.TILE_ROWS,
          f"{name}: {v}, the walk at {walk.tables.rows} rows")
    x = torch.from_numpy(card_check.source(case, 0)).cuda()[None]
    got, counts = card_check.launched(cr, lambda: cr.resize_fused(ops, x))
    check(counts == {v: 1}, f"{name}: launched {counts}")
    err = compare(f"{name} vs plain", got, cr.resize_plain(ops, x))
    if sw * sh <= ORACLE_MAX_PIXELS:
        err = max(err, compare(f"{name} vs numpy_ref", got.cpu(),
                               torch.from_numpy(card_check.oracle(case, 0))[None]))
    wgot, wcounts = card_check.launched(cr, lambda: cr.resize_fused(walk, x))
    check(wcounts == {cr.variant(walk.tables): 1}, f"{name}: the walk launched {wcounts}")
    err = max(err, compare(f"{name} walk vs kernel", wgot, got))
    off, pad = WIDE_STRIDED
    buf = torch.from_numpy(random_u8(np.random.default_rng(sw * sh), (1, sh, sw + pad))).cuda()
    view = buf[:, :, off:off + sw]
    check(cr.wide_load_bytes(view) == 1, f"{name}: +{off} bytes takes "
          f"{cr.wide_load_bytes(view)}-byte loads")
    err = max(err, compare(f"{name} +{off} bytes, pitch {sw + pad}",
                           cr.resize_fused(ops, view), cr.resize_plain(ops, view)))
    route, route_counts = card_check.launched(cr, lambda: r.resize(x))
    err = max(err, compare(f"{name} facade vs kernel", route, got))
    facade = not cr.tiled_ok(plan)
    check(len(route_counts) == 1 and sum(route_counts.values()) == 1
          and (v in route_counts) == facade, f"{name}: the facade launched {route_counts}")
    fns = {"kernel": lambda t: cr.resize_fused(ops, t),
           "walk": lambda t: cr.resize_fused(walk, t),
           "route": lambda t: r.resize(t)}
    scalar = None
    if ops.tables.y_s8:
        scalar = cr.KernelOperands(plain=ops.plain, tables=cr.wide_tables(plan, "cuda"))
        sgot, scounts = card_check.launched(cr, lambda: cr.resize_fused(scalar, x))
        check(scounts == {cr.variant(scalar.tables): 1}, f"{name}: the scalar form "
              f"launched {scounts}")
        err = max(err, compare(f"{name} scalar form vs kernel", sgot, got))
        fns["scalar"] = lambda t: cr.resize_fused(scalar, t)
    fns["plain"] = lambda t: cr.resize_plain(ops, t)
    xs = _harness.perturbed(x, min(WIDE_INPUTS, n_inputs(x.numel())))
    ms = in_turns(fns, xs, primed={"plain": False})
    bytes_ms, ops_ms = bound([(plan, 1)])
    row = {"plan": name, "variant": v, "facade": facade, "layout": shape,
           **({} if scalar is None else {
               "scalar_variant": cr.variant(scalar.tables), "scalar_ms": ms["scalar"],
               "scalar_layout": wide_shape(cr, scalar.tables)}),
           "launches": counts[v], "route_variant": "/".join(route_counts),
           "max_abs_err": err, "ms": ms["kernel"], "walk_ms": ms["walk"],
           "walk_rows": walk.tables.rows, "route_ms": ms["route"],
           "plain_ms": ms["plain"], "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"{name} == plain == the walk{' == numpy_ref' if sw * sh <= ORACLE_MAX_PIXELS else ''}"
          f"{'' if scalar is None else ' == the scalar Y form'}, aligned and at +{off} "
          f"bytes, on kernel[{v}] ({shape}): kernel "
          f"{ms['kernel']!r} ms, walk ({walk.tables.rows} rows) {ms['walk']!r}, route "
          f"{row['route_variant']} {ms['route']!r}, "
          + ("" if scalar is None else f"scalar form {row['scalar_layout']} "
             f"{ms['scalar']!r}, ")
          + f"plain {ms['plain']!r} (in turns, "
          f"{len(xs)} inputs), bound {row['bound_ms']!r} ms ({row['bound_by']}) ({card})")
    return row


def drive_yuv(cr, yuv, build_plan, rng, frame, variant, chroma_variant=None,
              **kwargs):
    """``YUV420Resizer(*frame, **kwargs)`` on 4 frames and one
    ``resize_batch(4)`` with every launch count set to 0 just before; each
    call is one frame call of the executables (``ops/executable.py``): a
    frame launches luma once and U and V as one launch, the batch luma once
    and U and V once each.  The launch counts must be those, all of
    ``variant``, or of ``variant`` (luma) and ``chroma_variant``; every
    plane must equal the plain path (the relaxed one for a relaxed
    variant).  Returns (launches by variant, max_err, frames, outs)."""
    method, sw, sh, dw, dh = frame
    relaxed = "_relaxed" in variant
    route = "cuda-relaxed" if relaxed else "cuda"
    r = yuv.YUV420Resizer(method, sw, sh, dw, dh, **kwargs)
    check(r.resolved_backend() == route,
          f"{method} path resolved to {r.resolved_backend()!r}, not {route!r}")
    frames = [yuv.YUV420Frame(random_u8(rng, (sh, sw)),
                              random_u8(rng, (sh // 2, sw // 2)),
                              random_u8(rng, (sh // 2, sw // 2)))
              for _ in range(4)]
    batch = [random_u8(rng, (4, sh, sw)), random_u8(rng, (4, sh // 2, sw // 2)),
             random_u8(rng, (4, sh // 2, sw // 2))]

    cr.reset_launches()
    outs = [r.resize(f) for f in frames]
    bout = r.resize_batch(*batch)
    torch.cuda.synchronize()
    launches, by_variant = cr.LAUNCHES, dict(cr.LAUNCHES_BY_VARIANT)
    luma_n, chroma_n = len(frames) + 1, len(frames) + 2
    want = ({variant: luma_n + chroma_n} if chroma_variant in (None, variant)
            else {variant: luma_n, chroma_variant: chroma_n})
    check(launches == luma_n + chroma_n
          and all(by_variant[v] == n for v, n in want.items()),
          f"{method} path: {launches} kernel launches {by_variant}, expected "
          f"{want} (2 per resize, 3 per batch)")
    print(f"{method} path ({r.resolved_backend()} on {r._luma.device}): "
          f"{len(frames)} x resize + 1 x resize_batch(4) -> launches "
          f"{ {v: n for v, n in by_variant.items() if n} } (expected {want})")

    (_, luma, _), (_, chroma, _) = yuv_planes(build_plan, *frame)
    luma, chroma = (cr.pack_operands(p, "cuda", relaxed=relaxed)
                    for p in (luma, chroma))

    def plain(ops, planes):
        return cr.resize_plain(ops, torch.from_numpy(planes).cuda()).cpu()

    max_err = 0
    for i, (f, o) in enumerate(zip(frames, outs)):
        check(o.y.shape == (dh, dw) and o.u.shape == (dh // 2, dw // 2),
              f"frame {i}: output shapes {o.y.shape} {o.u.shape}")
        uv = plain(chroma, np.stack([f.u, f.v]))
        for name, got, want in (("y", o.y, plain(luma, f.y[None])[0]),
                                ("u", o.u, uv[0]), ("v", o.v, uv[1])):
            max_err = max(max_err, compare(f"{method} frame {i} {name}",
                                           torch.from_numpy(got), want))
    buv = plain(chroma, np.concatenate(batch[1:]))
    for name, got, want in (("y", bout[0], plain(luma, batch[0])),
                            ("u", bout[1], buv[:4]), ("v", bout[2], buv[4:])):
        max_err = max(max_err, compare(f"{method} batch {name}",
                                       torch.from_numpy(got), want))
    print(f"{method} path == plain path on every plane of every frame")
    return by_variant, max_err, frames, outs


def phase_lanczos_path(cr, yuv, build_plan, rng, tmp: Path,
                       variant="wrap16_tiled", **kwargs):
    frame = ("lanczos3", SRC_W, SRC_H, DST_W, DST_H)
    precision = "relaxed" if "_relaxed" in variant else "exact"
    by_variant, max_err, frames, outs = drive_yuv(
        cr, yuv, build_plan, rng, frame, variant, precision=precision,
        **kwargs)
    launches = by_variant[variant]

    src_file, dst_file = tmp / "in.yuv", tmp / "out.yuv"
    yuv.write_yuv420(src_file, frames[:3])
    proc = subprocess.run(
        [sys.executable, "-m", "libiqo_tpu_torch.cli.resize_yuv420p",
         "-m", "lanczos3", "-i", str(src_file), "-iw", str(SRC_W),
         "-ih", str(SRC_H), "-o", str(dst_file), "-ow", str(DST_W),
         "-oh", str(DST_H), "--precision", precision],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    check(proc.returncode == 0, f"CLI failed ({proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    print(f"CLI: {proc.stdout.strip()}")
    cli_frames = yuv.read_yuv420(dst_file, DST_W, DST_H)
    check(len(cli_frames) == 3, f"CLI wrote {len(cli_frames)} frames, not 3")
    for i, (c, o) in enumerate(zip(cli_frames, outs)):
        for name in "yuv":
            check(np.array_equal(getattr(c, name), getattr(o, name)),
                  f"CLI frame {i} plane {name} differs from the API's")
    print(f"CLI --precision {precision} output == API output on 3 frames")
    return launches, max_err


def phase_area_path(cr, yuv, build_plan, benchmark, rng, variant="u16_tiled"):
    # no device argument: the user's default, which is the card
    precision = "relaxed" if "_relaxed" in variant else "exact"
    by_variant, max_err, _, _ = drive_yuv(cr, yuv, build_plan, rng, AREA_MAIN,
                                          variant, precision=precision)
    launches = by_variant[variant]
    cycles = 8
    cr.reset_launches()
    check(benchmark.main(["--cycles", str(cycles), "--precision", precision]) == 0,
          "benchmark CLI failed")
    torch.cuda.synchronize()
    by_variant = dict(cr.LAUNCHES_BY_VARIANT)
    want = {**dict.fromkeys(by_variant, 0), variant: 2 * cycles}
    check(by_variant == want,
          f"benchmark CLI launched {by_variant}, expected {2 * cycles} {variant}")
    print(f"benchmark CLI --precision {precision} in process, {cycles} cycles "
          f"-> launches {by_variant}")
    return launches, max_err


def phase_thumbnail_path(cr, yuv, build_plan, rng, card: str) -> dict:
    """Phase 5b, the thumbnail route on a user path: YUV420Resizer on
    THUMB_FRAMES, exact and relaxed, through ``resize`` and
    ``resize_batch`` with every count set to 0 just before each
    (:func:`drive_yuv`): luma on the wide-window kernel where no tiled
    width takes its band, on the tiled kernel at PROXY_TW for the 8K proxy,
    chroma tiled; each plane == plain; relaxed luma within RELAXED_LSB of
    the exact plain output.  Then the windowed twin (``tiled=False,
    wide=False``) on the frames' luma planes, with every count set to 0 just
    before, == the facade's output.  Then each frame timed
    (:func:`time_thumbnail`).  Returns {"launches": the route's launches by
    variant, "twin": the twin's, "rows": the timed rows}."""
    launches, twin, rows = {}, {}, []
    for frame, luma_v, chroma_v, precision in THUMB_FRAMES:
        relaxed = precision == "relaxed"
        (_, luma, _), (_, chroma, _) = yuv_planes(build_plan, *frame)
        k, kc = (cr.kernel_tables(p, relaxed=relaxed) for p in (luma, chroma))
        check((cr.variant(k), cr.variant(kc)) == (luma_v, chroma_v)
              and cr.work_rows(luma) == cr.TILE_ROWS
              and (k.wide or k.layout.tw == PROXY_TW < cr.tiled_width(luma)),
              f"{frame} {precision}: luma {cr.variant(k)}, chroma {cr.variant(kc)}")
        by_variant, err, frames, outs = drive_yuv(cr, yuv, build_plan, rng, frame, luma_v,
                                                  chroma_v, precision=precision)
        launches[luma_v] = launches.get(luma_v, 0) + by_variant[luma_v]
        MAX_ERR[luma_v] = max(MAX_ERR.get(luma_v, 0), err)
        y = torch.from_numpy(np.stack([f.y for f in frames])).cuda()
        got = torch.from_numpy(np.stack([o.y for o in outs])).cuda()
        if relaxed:
            lsb = compare(f"{frame} relaxed luma vs exact plain", got,
                          cr.resize_plain(cr.pack_operands(luma, "cuda"), y), RELAXED_LSB)
            LSB_VS_EXACT[luma_v] = max(LSB_VS_EXACT.get(luma_v, 0), lsb)
        walk = cr.pack_operands(luma, "cuda", relaxed=relaxed, tiled=False, wide=False)
        wgot, counts = card_check.launched(cr, lambda: cr.resize_fused(walk, y))
        v = cr.variant(walk.tables)
        check(counts == {v: 1}, f"{frame} {precision}: the twin launched {counts}")
        MAX_ERR[v] = max(MAX_ERR.get(v, 0), compare(f"{frame} {precision} twin vs facade",
                                                    wgot, got))
        twin[v] = twin.get(v, 0) + 1
        rows.append(time_thumbnail(cr, build_plan, rng, card, frame, relaxed))
    print(f"thumbnail route: launches {launches}; the windowed twin {twin}")
    return {"launches": launches, "twin": twin, "rows": rows}



def time_thumbnail(cr, build_plan, rng, card: str, frame, relaxed: bool) -> dict:
    """One THUMB_FRAMES frame's planes on the card, in turns: luma on the
    facade's route, on the windowed twin (``tiled=False, wide=False``) and
    on the plain path (host-paced); for the 8K proxy also the wide-window
    kernel and the tiled kernel one width narrower; where luma takes the
    wide-window kernel's s8 Y form, also its scalar Y form (``scalar``);
    chroma on its route.  Beside the luma plane's and the frame's bound."""
    method, sw, sh, dw, dh = frame
    tag = f"{method} {sw}x{sh}->{dw}x{dh} {'relaxed' if relaxed else 'exact'}"
    ms, planes, variants = {}, [], {}
    for name, plan, batch in yuv_planes(build_plan, *frame):
        planes.append((plan, batch))
        ops = cr.pack_operands(plan, "cuda", relaxed=relaxed)
        shape = (batch, plan.y.n_src, plan.x.n_src)
        xs = _harness.perturbed(torch.from_numpy(random_u8(rng, shape)).cuda(),
                                n_inputs(math.prod(shape)))
        fns = {"route": lambda t, o=ops: cr.resize_fused(o, t)}
        variants[name] = cr.variant(ops.tables)
        if name == "luma":
            walk = cr.pack_operands(plan, "cuda", relaxed=relaxed, tiled=False, wide=False)
            fns["windowed"] = lambda t, o=walk: cr.resize_fused(o, t)
            others = []
            if ops.tables.tiled:
                wide = cr.KernelOperands(plain=ops.plain, tables=cr.wide_tables(
                    plan, "cuda", relaxed=relaxed))
                tw = cr.TILED_WIDTHS[cr.TILED_WIDTHS.index(ops.tables.layout.tw) + 1]
                narrow = cr.KernelOperands(plain=ops.plain, tables=cr.tiled_tables(
                    plan, "cuda", cr.tiled_layout(plan, relaxed, tw)))
                others = [("wide", wide), (f"tw{tw}", narrow)]
            elif getattr(ops.tables, "y_s8", False):
                others = [("scalar", cr.KernelOperands(plain=ops.plain,
                                                       tables=cr.wide_tables(plan, "cuda")))]
            want = cr.resize_plain(ops, xs[0]) if others else None
            for label, o in others:
                compare(f"{tag} luma {label} vs plain", cr.resize_fused(o, xs[0]), want)
                fns[label] = lambda t, o=o: cr.resize_fused(o, t)
            fns["plain"] = lambda t, o=ops: cr.resize_plain(o, t)
        t = in_turns(fns, xs, primed={"plain": False})
        ms.update({f"{name} {k}": v for k, v in t.items()})
        del xs
    torch.cuda.empty_cache()
    rate = BF16_OPS_PER_S if relaxed else INT8_OPS_PER_S
    luma_b, luma_o = bound(planes[:1], rate)
    frame_b, frame_o = bound(planes, rate)
    row = {"frame": tag, "luma_variant": variants["luma"],
           "chroma_variant": variants["chroma"], "ms": ms,
           "frame_ms": ms["luma route"] + ms["chroma route"],
           "luma_bound_ms": max(luma_b, luma_o),
           "luma_bound_by": "bytes" if luma_b >= luma_o else "operations",
           "bound_ms": max(frame_b, frame_o),
           "bound_by": "bytes" if frame_b >= frame_o else "operations"}
    print(f"time thumbnail {tag}: luma {variants['luma']} {ms['luma route']!r} ms, "
          f"windowed twin {ms['luma windowed']!r} ms, plain {ms['luma plain']!r} ms"
          + "".join(f", {k[5:]} {v!r} ms" for k, v in ms.items()
                    if k.startswith("luma") and k[5:] not in ("route", "windowed", "plain"))
          + f"; chroma {variants['chroma']} {ms['chroma route']!r} ms; frame "
          f"{row['frame_ms']!r} ms; bound luma {row['luma_bound_ms']!r} ms, frame "
          f"{row['bound_ms']!r} ms ({row['bound_by']}) (in turns; {card})")
    return row


# the executable layer's routes (ops/executable.py): (label, YUV420Resizer
# frame, precision, LIBIQO_TPU_CARRY set): both main paths exact and relaxed,
# the carry main paths and phase 5b's strips; WIDE_FACADE beside them
EXEC_FRAMES = (
    ("lanczos main", ("lanczos3", SRC_W, SRC_H, DST_W, DST_H), "exact", False),
    ("area main", AREA_MAIN, "exact", False),
    ("lanczos main", ("lanczos3", SRC_W, SRC_H, DST_W, DST_H), "relaxed", False),
    ("area main", AREA_MAIN, "relaxed", False),
    *(("carry path", f, p, True) for f, _, _, p in CARRY_PATHS),
    *(("thumbnail", f, p, False) for f, _, _, p in THUMB_FRAMES if f[1] <= SRC_W),
)
EXEC_BATCHES = (1, 16)          # a lone frame, and tools/bench.py's batch
EXEC_ISSUE_CALLS = 256          # frames a host-clock issue timing queues
EXEC_ISSUE_ROUNDS = 3           # rounds of issue timings in turns (A B C C B A)


def hold_executable(cr, tag: str, ex, x: torch.Tensor) -> int:
    """One executable on the card: ``ex(x)`` is one launch of its variant
    and == ``cr.resize_fused(ex.ops, x)`` == the plain path, byte for
    byte."""
    cr.reset_launches()
    got = ex(x)
    torch.cuda.synchronize()
    check(cr.LAUNCHES == 1 and cr.LAUNCHES_BY_VARIANT[ex.variant] == 1,
          f"{tag}: {cr.LAUNCHES} launches {cr.LAUNCHES_BY_VARIANT}, expected one "
          f"{ex.variant}")
    err = compare(f"{tag} executable vs resize_fused", got, cr.resize_fused(ex.ops, x))
    return max(err, compare(f"{tag} executable vs plain", got, cr.resize_plain(ex.ops, x)))


def frame_layouts(rng, batch: int, sw: int, sh: int):
    """(name, y, u, v) CUDA planes of ``batch`` frames: U and V tensors of
    their own ("in place"), views of one buffer ("stacked"), and each plane
    5 bytes into an odd-pitched buffer ("pitched")."""
    off, pad = WIDE_STRIDED
    cw, ch = sw // 2, sh // 2

    def planes(shape):
        return torch.from_numpy(random_u8(rng, shape)).cuda()
    uv = planes((2 * batch, ch, cw))
    ybuf, uvbuf = planes((batch, sh, sw + pad)), planes((2 * batch, ch, cw + pad))
    return [("in place", planes((batch, sh, sw)), planes((batch, ch, cw)),
             planes((batch, ch, cw))),
            ("stacked", planes((batch, sh, sw)), uv[:batch], uv[batch:]),
            ("pitched", ybuf[..., off:off + sw], uvbuf[:batch, :, off:off + cw],
             uvbuf[batch:, :, off:off + cw])]


def hold_frames(cr, yuv, rng, label: str, r, lex, cex) -> None:
    """``r.resize_batch`` (3 frames) and ``r.resize`` (a lone frame) in
    each of :func:`frame_layouts`: one frame call, 3 launches a batch and 2
    a lone frame (luma on ``lex.variant``, U and V on ``cex.variant``), ==
    the per-plane path (``resize_fused`` on luma and on the stacked U and
    V) == the plain path, byte for byte."""
    (sw, sh), (dw, dh) = r._true_src, r._true_dst
    check((sw, sh) == r.src_size and (dw, dh) == r.dst_size, f"{label}: odd sizes")
    for layout, y, u, v in frame_layouts(rng, 3, sw, sh):
        per_plane = (cr.resize_fused(lex.ops, y), cr.resize_fused(cex.ops, torch.cat([u, v])))
        plain = (cr.resize_plain(lex.ops, y), cr.resize_plain(cex.ops, torch.cat([u, v])))
        for what, call, b, launches in (
                ("resize_batch(3)", lambda: r.resize_batch(y, u, v), 3, 3),
                ("resize", lambda: r.resize(yuv.YUV420Frame(y[1], u[1], v[1])), 1, 2)):
            cr.reset_launches()
            got = call()
            got = (got.y, got.u, got.v) if b == 1 else got
            torch.cuda.synchronize()
            want = {lex.variant: 1}
            want[cex.variant] = want.get(cex.variant, 0) + launches - 1
            by = {k: n for k, n in cr.LAUNCHES_BY_VARIANT.items() if n}
            check(cr.LAUNCHES == launches and by == want,
                  f"{label} {layout} {what}: launches {by}, expected {want}")
            sel = slice(0, 3) if b == 3 else slice(1, 2)
            wants = ((per_plane[0][sel], per_plane[1][:3][sel], per_plane[1][3:][sel]),
                     (plain[0][sel], plain[1][:3][sel], plain[1][3:][sel]))
            for name, g, pp, pl in zip("yuv", got, *wants):
                g = g if b == 3 else g[None]
                compare(f"{label} {layout} {what} {name} vs per-plane", g, pp)
                compare(f"{label} {layout} {what} {name} vs plain", g, pl)


def time_frames(cr, yuv, bench_decomp, _bench, rng, card: str) -> list:
    """The Lanczos main frame at EXEC_BATCHES: card ms a frame (CUDA
    events, the card spinning while the host queues) and host ms to issue a
    call (host clock, ``bench_decomp.issue_ms``) of the executable's frame
    call against the per-plane path (``resize_fused`` on luma and on U and
    V stacked: today's copy and one chroma launch) and the per-plane
    executables in place (three launches), each form timed twice in turns;
    each form == the frame call on one input first.  The host's issue time
    is the min over EXEC_ISSUE_ROUNDS rounds in turns: it spreads between
    runs far more than the card's time."""
    r = yuv.YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H)
    dev = torch.device("cuda", 0)
    lex, cex = r._luma._bind(dev)[1], r._chroma._bind(dev)[1]
    rows = []
    for b in EXEC_BATCHES:
        planes = [torch.from_numpy(p).cuda() for p in _bench.seeded_planes((b, SRC_H, SRC_W))]
        if b == 1:
            xs = _bench.copies(tuple(p[0] for p in planes))
            calls = {
                "executable": lambda x: r.resize(yuv.YUV420Frame(*x)),
                "per_plane_stacked": lambda x: (cr.resize_fused(lex.ops, x[0][None]),
                                                cr.resize_fused(cex.ops, torch.stack(x[1:]))),
                "per_plane_in_place": lambda x: (lex(x[0][None]), cex(x[1][None]),
                                                 cex(x[2][None]))}
        else:
            xs = _bench.copies(tuple(planes))
            calls = {
                "executable": lambda x: r.resize_batch(*x),
                "per_plane_stacked": lambda x: (cr.resize_fused(lex.ops, x[0]),
                                                cr.resize_fused(cex.ops, torch.cat(x[1:]))),
                "per_plane_in_place": lambda x: (lex(x[0]), cex(x[1]), cex(x[2]))}
        outs = {n: c(xs[0]) for n, c in calls.items()}
        f = outs.pop("executable")
        ref = (f.y[None], f.u[None], f.v[None]) if b == 1 else f
        y_, uv = outs.pop("per_plane_stacked")
        outs["per_plane_stacked"] = (y_, uv[:b], uv[b:])
        for n, o in outs.items():
            for name, g, w in zip("yuv", o, ref):
                compare(f"time batch {b} {n} {name}", g, w)
        card_ms = in_turns(calls, xs)
        host_ms = in_turns(calls, xs, dict.fromkeys(calls, False))
        names = list(calls)
        issue = {n: [] for n in names}
        for n in (names + names[::-1]) * EXEC_ISSUE_ROUNDS:
            issue[n].append(bench_decomp.issue_ms(calls[n], xs, EXEC_ISSUE_CALLS // b, 1))
        for n in names:
            row = {"batch": b, "form": n, "card_ms_per_frame": card_ms[n] / b,
                   "host_paced_ms_per_frame": host_ms[n] / b,
                   "issue_ms_per_call": min(issue[n]), "card": card}
            rows.append(row)
            print(f"frame call batch {b:2d} {n:18s}: {row['card_ms_per_frame']!r} ms a "
                  f"frame on the card, {row['host_paced_ms_per_frame']!r} at the host's "
                  f"pace; a call issued in {row['issue_ms_per_call']!r} ms ({card})")
    return rows


def phase_executables(cr, yuv, rng, card: str) -> dict:
    """Phase 5c, the executable layer: every facade route through its
    executable == ``resize_fused`` == plain, from aligned sources and 5
    bytes into odd pitches; the frame calls' launches and bytes with U and
    V in place, stacked and pitched; then the frame call's times against
    the per-plane path.  Returns {"variants", "rows"}."""
    from libiqo_tpu_torch.tools import _bench, bench_decomp

    t_phase = time.perf_counter()
    off, pad = WIDE_STRIDED
    dev = torch.device("cuda", 0)
    variants, n = set(), 0
    carry_env = os.environ.pop("LIBIQO_TPU_CARRY", None)
    try:
        for label, frame, precision, carry in EXEC_FRAMES:
            if carry:
                os.environ["LIBIQO_TPU_CARRY"] = "1"
            method, sw, sh, dw, dh = frame
            label = f"{label} {method} {sw}x{sh}->{dw}x{dh} {precision}"
            r = yuv.YUV420Resizer(method, sw, sh, dw, dh, precision=precision)
            exs = []
            for plane, res, (h, w) in (("luma", r._luma, (sh, sw)),
                                       ("chroma", r._chroma, (sh // 2, sw // 2))):
                kernel, ex = res._bind(dev)
                check(kernel, f"{label} {plane}: route {res.resolved_backend()}")
                buf = torch.from_numpy(random_u8(rng, (2, h, w + pad))).cuda()
                hold_executable(cr, f"{label} {plane}", ex, buf[..., :w].contiguous())
                hold_executable(cr, f"{label} {plane} +{off}", ex, buf[..., off:off + w])
                exs.append(ex)
                variants.add(ex.variant)
            hold_frames(cr, yuv, rng, label, r, *exs)
            os.environ.pop("LIBIQO_TPU_CARRY", None)
            n += 1
            print(f"executables {label}: luma {exs[0].variant}, chroma {exs[1].variant} "
                  f"== resize_fused == plain (aligned, +{off} bytes); frame calls "
                  "(in place, stacked, pitched) == per-plane == plain, 3 launches a "
                  "batch, 2 a lone frame")
        for case in card_check.WIDE_FACADE:
            res = card_check.facade(case)
            kernel, ex = res._bind(dev)
            check(kernel and ex.ops.tables.wide, f"{case}: {ex.variant}")
            alg, sw, sh, dw, dh, _ = case
            buf = torch.from_numpy(random_u8(rng, (1, sh, sw + pad))).cuda()
            hold_executable(cr, f"wide {case}", ex, buf[..., :sw].contiguous())
            hold_executable(cr, f"wide {case} +{off}", ex, buf[..., off:off + sw])
            variants.add(ex.variant)
            n += 1
    finally:
        os.environ.pop("LIBIQO_TPU_CARRY", None)
        if carry_env is not None:
            os.environ["LIBIQO_TPU_CARRY"] = carry_env
    print(f"executable layer: {n} routes, variants {sorted(variants)}, every one == "
          "resize_fused == plain byte for byte")
    rows = time_frames(cr, yuv, bench_decomp, _bench, rng, card)
    print(f"phase 5c (executables): {time.perf_counter() - t_phase!r} s")
    return {"variants": sorted(variants), "rows": rows}


def phase_benchmark_cli(card: str, runs=CLI_RUNS, route: str = "cuda"):
    for extra in runs:
        cmd = [sys.executable, "-m", "libiqo_tpu_torch.cli.benchmark", *extra]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              timeout=600)
        check(proc.returncode == 0, f"{' '.join(cmd[1:])} failed "
              f"({proc.returncode}): {proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()
        elapsed = [ln.strip() for ln in lines if "elapsed time:" in ln]
        check(len(elapsed) == 1, f"{' '.join(cmd[1:])}: no elapsed time line")
        mode = next((ln for ln in lines if ln.startswith("benchmark (")), "?")
        check(f"  backend: {route}" in lines,
              f"{' '.join(cmd[1:])}: backend is not {route}")
        print(f"benchmark CLI {' '.join(extra)}: {mode}: {elapsed[0]} ({card})")


def n_inputs(nbytes: int) -> int:
    """Enough distinct inputs (>= 8) that they exceed the 50 MB L2 together."""
    return max(8, math.ceil(64e6 / nbytes))


def bound(planes, x_ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, float]:
    """The two lower bounds (ms) on the card's time for these (plan, batch)
    planes: each source byte read once and each output byte written once at
    the memory rate; and the tap multiply-adds (two operations each) that
    the separable form needs (Y over every source column, X over every
    output), the Y pass's at the int8 tensor-core rate and the X pass's at
    ``x_ops_per_s`` (int8 for the exact kernel, bf16 for the relaxed
    one)."""
    nbytes = ops_s = 0.0
    for plan, batch in planes:
        (sh, sw, dh, dw) = (plan.y.n_src, plan.x.n_src, plan.y.n_dst, plan.x.n_dst)
        nbytes += batch * (sh * sw + dh * dw)
        ops_s += 2 * batch * (plan.y.num_coefs * dh * sw / INT8_OPS_PER_S
                              + plan.x.num_coefs * dh * dw / x_ops_per_s)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3


def phase_times(cr, yuv, build_plan, rng, card: str, frame) -> dict:
    """The tiled kernel and the windowed ``resize_fused`` (``tiled=False``)
    in turns (windowed, tiled, tiled, windowed: min of each pair), the plain
    version and (Area/Linear) the yardstick, ms per plane and per frame
    (the planes' sum, and ``YUV420Resizer`` on the tiled route), beside the
    frame's bound."""
    method, sw, sh, dw, dh = frame
    mode = {"area": "area", "linear": "bilinear"}.get(method)
    F = torch.nn.functional
    rows, planes = {}, []
    for name, plan, batch in yuv_planes(build_plan, *frame):
        planes.append((plan, batch))
        ops = cr.pack_operands(plan, "cuda")
        shape = (batch, plan.y.n_src, plan.x.n_src)
        xs = _harness.perturbed(torch.from_numpy(random_u8(rng, shape)).cuda(),
                       n_inputs(math.prod(shape)))
        size = (plan.y.n_dst, plan.x.n_dst)
        yard = None
        if mode:
            fs = [x.float()[:, None] for x in xs]
            kw = {} if mode == "area" else dict(align_corners=False)
            yard = _harness.launches_ms(lambda x: F.interpolate(x, size=size, mode=mode, **kw), fs)
            del fs
        old = cr.pack_operands(plan, "cuda", tiled=False)
        check(ops.tables.tiled and not old.tables.tiled, f"{name}: routes")
        tiled = lambda x: cr.resize_fused(ops, x)       # noqa: E731
        fused = lambda x: cr.resize_fused(old, x)       # noqa: E731
        times = [_harness.launches_ms(f, xs) for f in (fused, tiled, tiled, fused)]
        rows[name] = (min(times[1:3]), _harness.launches_ms(tiled, xs, primed=False),
                      _harness.launches_ms(lambda x: cr.resize_plain(ops, x), xs,
                                           primed=False), yard,
                      min(times[0], times[3]))

    shapes = ((sh, sw), (sh // 2, sw // 2), (sh // 2, sw // 2))
    n = n_inputs(sum(map(math.prod, shapes)))
    fs = [yuv.YUV420Frame(*p) for p in zip(*(
        _harness.perturbed(torch.from_numpy(random_u8(rng, s)).cuda(), n) for s in shapes))]
    kernel = yuv.YUV420Resizer(method, sw, sh, dw, dh, backend="cuda")
    plain = yuv.YUV420Resizer(method, sw, sh, dw, dh, backend="torch")
    rows["frame (YUV420Resizer)"] = (
        _harness.launches_ms(kernel.resize, fs), _harness.launches_ms(kernel.resize, fs, primed=False),
        _harness.launches_ms(plain.resize, fs, primed=False), None, None)
    bytes_ms, ops_ms = bound(planes)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    tag = f"{method} {sw}x{sh}->{dw}x{dh}"
    for name, (k, ku, p, y, f) in rows.items():
        yard = (f", yardstick F.interpolate({mode}) on float32 {y!r} ms "
                "(not byte-equal)" if y is not None else "")
        old = (f", windowed resize_fused {f!r} ms, tiled/windowed {k / f!r}"
               if f is not None else " (the tiled route)")
        print(f"time {tag} {name}: tiled kernel {k!r} ms (unprimed {ku!r})"
              f"{old}, plain {p!r} ms, plain/kernel {p / k!r}{yard} ({card})")
    k, p, f = (rows["luma"][i] + rows["chroma"][i] for i in (0, 2, 4))
    y = rows["luma"][3] + rows["chroma"][3] if mode else None
    print(f"time {tag} planes per frame: tiled kernel {k!r} ms, windowed "
          f"resize_fused {f!r} ms (same call, in turns), tiled/windowed "
          f"{k / f!r}, plain {p!r} ms, yardstick {y!r} ms, bound {bound_ms!r} "
          f"ms ({bound_by}; bytes {bytes_ms!r} ms, operations {ops_ms!r} ms), "
          f"tiled/bound {k / bound_ms!r}, windowed/bound {f / bound_ms!r} "
          f"({card})")
    return {"ms": k, "fused_ms": f, "plain_ms": p, "bound_ms": bound_ms,
            "bound_by": bound_by, "yardstick_ms": y,
            "planes": {n: {"tiled_ms": r[0], "fused_ms": r[4]}
                       for n, r in rows.items() if r[4] is not None}}


def err_stats(got: torch.Tensor, want: torch.Tensor) -> tuple[int, float]:
    d = (got.int() - want.int()).abs()
    return int(d.max().item()), float(d.double().mean().item())


def hold_relaxed(cr, tag: str, plan, host: np.ndarray, oracle=None):
    """Relaxed kernels == relaxed plain on the card, byte for byte, for one
    plan and a (B, h, w) source: the plan's own route (the tiled kernel's
    relaxed form where ``tiled_ok(plan, relaxed=True)``, else the
    wide-window kernel's), the kernel of ``tiled=False`` and its twin
    (``card_check.twin``: the windowed ``resize_fused`` beside the
    wide-window kernel's relaxed form); the first within RELAXED_LSB of the
    exact kernel, or with an oracle within RELAXED_ORACLE_LSB of it; flat
    fields 0/128/255 equal to the exact output.  Errors against the plain
    version are noted by variant in MAX_ERR.  Returns the route's variant,
    its error against the relaxed plain version and the (max, mean) error
    against the exact output."""
    check(cr.supports_plan(plan, relaxed=True), f"{tag}: relaxed form refuses")
    rel = cr.pack_operands(plan, "cuda", relaxed=True)
    ex = cr.pack_operands(plan, "cuda")
    src = torch.from_numpy(host).cuda()
    got = cr.resize_fused(rel, src)
    v = cr.variant(rel.tables)
    plain = cr.resize_plain(rel, src)
    plain_err = compare(f"{tag} {v}", got, plain)
    windowed = cr.pack_operands(plan, "cuda", relaxed=True, tiled=False)
    for ops in (windowed, card_check.twin(plan, windowed, relaxed=True)):
        w = cr.variant(ops.tables)
        MAX_ERR[w] = max(MAX_ERR.get(w, 0), compare(
            f"{tag} {w}", cr.resize_fused(ops, src), plain))
    MAX_ERR[v] = max(MAX_ERR.get(v, 0), plain_err)
    if oracle is None:
        want = cr.resize_fused(ex, src)
        compare(f"{tag} relaxed vs exact", got, want, RELAXED_LSB)
    else:
        want = torch.from_numpy(np.stack([oracle.resize_u8(plan, f) for f in host]))
        compare(f"{tag} relaxed vs numpy_ref", got.cpu(), want, RELAXED_ORACLE_LSB)
        want = want.cuda()
    for level in (0, 128, 255):
        flat = torch.full_like(src, level)
        compare(f"{tag} relaxed flat {level}", cr.resize_fused(rel, flat),
                cr.resize_fused(ex, flat))
    return (v, plain_err, *err_stats(got, want))


def phase_relaxed_vs_plain(cr, build_plan, numpy_ref, rng):
    """Phase 8.  Returns, per relaxed variant of the plans' own routes, the
    largest error against the relaxed plain version and against the exact
    output."""
    worst = {}

    def note(stats):
        v, plain_err, lsb = stats[:3]
        old = worst.get(v, [0, 0])
        worst[v] = [max(old[0], plain_err), max(old[1], lsb)]
        return v

    frames = [("lanczos3", SRC_W, SRC_H, DST_W, DST_H), *U16_FRAMES.values()]
    for frame in frames:
        for plane, plan, batch in yuv_planes(build_plan, *frame):
            host = random_u8(rng, (batch, plan.y.n_src, plan.x.n_src))
            tag = f"{frame[0]} {plane} {tuple(host.shape)}"
            stats = hold_relaxed(cr, tag, plan, host)
            v = note(stats)
            check(v.endswith("_relaxed_tiled"), f"{tag}: relaxed route {v}")
            print(f"kernel[{v}], the windowed and the wide-window relaxed kernels "
                  f"== plain: {tag}, "
                  f"flat fields exact; vs exact max {stats[2]} mean {stats[3]!r} LSB")
    tpu = {row["case"]: row for row in json.loads(
        (ROOT / "scripts" / "check_relaxed_result.json").read_text())}
    for name, (algo, kw, sw, sh, dw, dh) in RELAXED_GRADED.items():
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        stats = hold_relaxed(cr, name, plan, random_u8(rng, (1, sh, sw)))
        note(stats)
        t = tpu[name]
        print(f"relaxed graded {name} ({stats[0]}): vs exact max {stats[2]} mean "
              f"{stats[3]!r} LSB (TPU vs oracle: max {t['max_lsb']} mean "
              f"{t['mean_lsb']}, scripts/check_relaxed_result.json)")
    algo, kw, sw, sh, dw, dh = RELAXED_RESIDUAL
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    check(cr.relaxed_plane(plan.x)[1] is not None, "residual plan has no residual")
    stats = hold_relaxed(cr, "residual plane", plan, random_u8(rng, (4, sh, sw)),
                         numpy_ref)
    note(stats)
    print(f"relaxed residual-plane plan {algo}{kw} {sw}x{sh}->{dw}x{dh} "
          f"({stats[0]}, two X planes; the windowed and wide-window twins too): == "
          f"plain, within {RELAXED_ORACLE_LSB} "
          "LSB of numpy_ref, flat fields exact")
    fuzz = np.random.default_rng(SEED + 1)
    for name, cases in (("lanczos px1-2 fuzz", lanczos_fuzz(fuzz)),
                        ("lanczos px3-4", lanczos_px34(fuzz)),
                        ("area/linear fuzz", area_linear_fuzz(fuzz))):
        n = refused = 0
        for algo, kw, src, dst in cases:
            (sw, sh), (dw, dh) = map(int, src), map(int, dst)
            plan = build_plan(algo, sw, sh, dw, dh, **kw)
            if not cr.supports_plan(plan, relaxed=True):
                refused += 1
                continue
            tag = f"{name} {algo}{kw or ''} {sw}x{sh}->{dw}x{dh}"
            note(hold_relaxed(cr, tag, plan, random_u8(fuzz, (2, sh, sw)),
                              numpy_ref))
            n += 1
        print(f"the three relaxed kernels == relaxed plain, within "
              f"{RELAXED_ORACLE_LSB} LSB of numpy_ref, flat fields exact, on {n} "
              f"{name} geometries ({refused} refused by "
              f"supports_plan(relaxed=True))")
    print(f"phase 8 routes (largest error vs plain, vs exact): {worst}")
    return worst


def phase_relaxed_times(cr, build_plan, rng, card: str, frame) -> dict:
    """Phase 10: the tiled relaxed kernel, the windowed relaxed kernel
    (``tiled=False``) and the exact tiled kernel in turns (windowed, tiled,
    exact, exact, tiled, windowed: min of each pair), the relaxed plain
    version, per plane and per frame, beside the frame's bound (the same
    bytes as exact)."""
    method, sw, sh, dw, dh = frame
    rows, planes = {}, []
    for name, plan, batch in yuv_planes(build_plan, *frame):
        planes.append((plan, batch))
        rel = cr.pack_operands(plan, "cuda", relaxed=True)
        win = cr.pack_operands(plan, "cuda", relaxed=True, tiled=False)
        ex = cr.pack_operands(plan, "cuda")
        check(rel.tables.tiled and not win.tables.tiled and ex.tables.tiled,
              f"relaxed {name}: routes")
        shape = (batch, plan.y.n_src, plan.x.n_src)
        xs = _harness.perturbed(torch.from_numpy(random_u8(rng, shape)).cuda(),
                       n_inputs(math.prod(shape)))
        times = [_harness.launches_ms(lambda x, o=o: cr.resize_fused(o, x), xs)
                 for o in (win, rel, ex, ex, rel, win)]
        rows[name] = (min(times[1], times[4]),
                      _harness.launches_ms(lambda x: cr.resize_fused(rel, x), xs, primed=False),
                      min(times[2], times[3]),
                      _harness.launches_ms(lambda x: cr.resize_plain(rel, x), xs,
                                           primed=False),
                      min(times[0], times[5]))
        variants = (cr.variant(rel.tables), cr.variant(win.tables),
                    cr.variant(ex.tables))
    bytes_ms, ops_ms = bound(planes, BF16_OPS_PER_S)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    tag = f"{method} {sw}x{sh}->{dw}x{dh}"
    for name, (r, ru, e, p, w) in rows.items():
        print(f"time relaxed {tag} {name}: relaxed tiled kernel ({variants[0]}) "
              f"{r!r} ms (unprimed {ru!r}), windowed relaxed ({variants[1]}) {w!r} "
              f"ms, exact tiled ({variants[2]}) {e!r} ms, relaxed plain {p!r} ms, "
              f"relaxed/exact {r / e!r}, tiled/windowed {r / w!r} ({card})")
    r, e, p, w = (rows["luma"][i] + rows["chroma"][i] for i in (0, 2, 3, 4))
    print(f"time relaxed {tag} planes per frame: relaxed tiled kernel {r!r} ms, "
          f"windowed relaxed {w!r} ms, exact tiled {e!r} ms (same call, in "
          f"turns), relaxed/exact {r / e!r}, tiled/windowed {r / w!r}, relaxed "
          f"plain {p!r} ms, bound {bound_ms!r} ms ({bound_by}), relaxed/bound "
          f"{r / bound_ms!r} ({card})")
    return {"ms": r, "windowed_ms": w, "exact_ms": e, "exact_kernel": variants[2],
            "plain_ms": p, "bound_ms": bound_ms, "bound_by": bound_by,
            "planes": {n: {"tiled_ms": v[0], "windowed_ms": v[4]}
                       for n, v in rows.items()}}


def phase_px4_time(cr, build_plan, rng, card: str) -> None:
    """Phase 10, K5's plans: the exact wrap16 kernel on one full-size
    px_scale-4 plane, held to its plain version, then timed."""
    algo, kw, sw, sh, dw, dh = PX4_PLANE
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    host = random_u8(rng, (1, sh, sw))
    hold(cr, "px4 plane", plan, host)
    ops = cr.pack_operands(plan, "cuda")
    xs = _harness.perturbed(torch.from_numpy(host).cuda(), n_inputs(host.size))
    k = _harness.launches_ms(lambda x: cr.resize_fused(ops, x), xs)
    ku = _harness.launches_ms(lambda x: cr.resize_fused(ops, x), xs, primed=False)
    p = _harness.launches_ms(lambda x: cr.resize_plain(ops, x), xs, primed=False)
    bytes_ms, ops_ms = bound([(plan, 1)])
    print(f"time px4 lanczos3 {sw}x{sh}->{dw}x{dh} (1 plane, "
          f"{cr.variant(ops.tables)}): kernel "
          f"{k!r} ms (unprimed {ku!r}), plain {p!r} ms, bound "
          f"{max(bytes_ms, ops_ms)!r} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'};"
          f" bytes {bytes_ms!r}, operations {ops_ms!r}) ({card})")


BENCH_MODULES = ("bench", "bench_configs", "bench_video64", "bench_fallback",
                 "bench_decomp", "tile_sweep", "host_split")


def phase_bench_modules(cr) -> dict:
    """Phase 10b: the measurement modules (``libiqo_tpu_torch/tools/
    bench*.py``, ``tile_sweep.py``, the ports of ``bench.py`` and the JAX
    package's bench scripts, and ``host_split.py``) in their short form
    (``--quick``: fewer counts,
    the same shapes and checks), each in this process through its
    ``main``; every one must exit 0 (its checks and guards passed), and
    the main paths' tiled kernel must have launched (``bench_fallback``
    sets the counts to 0 before each of its cases, so what is left is the
    launches since its last one).  Returns the launches by variant."""
    import importlib

    t_phase = time.perf_counter()
    cr.reset_launches()
    for name in BENCH_MODULES:
        t0 = time.perf_counter()
        rc = importlib.import_module(f"libiqo_tpu_torch.tools.{name}").main(["--quick"])
        check(rc == 0, f"tools.{name} --quick exited {rc}")
        torch.cuda.empty_cache()
        print(f"tools.{name} --quick: {time.perf_counter() - t0!r} s")
    launches = {v: n for v, n in cr.LAUNCHES_BY_VARIANT.items() if n}
    check(launches.get("wrap16_tiled") and launches.get("u16_tiled"),
          f"the bench modules launched {launches}")
    print(f"bench modules' launches: {launches}")
    print(f"phase bench modules: {time.perf_counter() - t_phase!r} s")
    return launches


def halo_rows(sharding, plan, shards: int) -> int:
    """Halo rows that a row-sharded call of ``plan`` writes into its bands
    (each is read once more by the kernel)."""
    padded = sharding._pad_rows_plan(plan, shards)[0]
    lay = sharding._row_shard_layout(padded, shards)
    return shards * (lay.halo_up + lay.halo_dn)


def sharded_small(rng):
    """tests/test_sharding.py's row-sharded geometries (the two multi-hop
    Area cases and the 237 -> 119-row odd height among them), then a seeded
    fuzz set: (shards, algo, kwargs, (sw, sh), (dw, dh))."""
    yield from SHARDED_SMALL
    for i in range(SHARDED_FUZZ):
        algo = ("lanczos", "area", "linear")[i % 3]
        src = rng.integers(16, 400, 2) | (i % 2)
        dst = (np.maximum(4, src // rng.integers(1, 5, 2)) if i % 4 < 2
               else src * 2 - rng.integers(0, 3, 2))
        kw = dict(degree=int(2 + i % 3)) if algo == "lanczos" else {}
        yield int(2 + i % 7), algo, kw, tuple(map(int, src)), tuple(map(int, dst))


def phase_sharded(cr, sharding, build_plan, numpy_ref, rng, card: str) -> dict:
    """Phase 11, sharding on one card: a mesh that names ``cuda:0``
    SHARDS times.  Returns the sharded entries of the kernels line."""
    t_phase = time.perf_counter()
    cuda = torch.device("cuda", 0)
    rows = sharding.Mesh([cuda] * SHARDS, ("row",))
    data = sharding.Mesh([cuda] * SHARDS, ("data",))
    grid = sharding.Mesh([[cuda] * 2] * 2, ("data", "row"))
    planes = {}
    for name, (algo, kw, sw, sh, dw, dh, batch) in SHARDED_PLANES.items():
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        fn, ops = sharding.make_row_sharded_fn(plan, rows)
        check(fn.routes == ("cuda",) * SHARDS, f"sharded {name}: routes {fn.routes}")
        shape = (sh, sw) if batch == 1 else (batch, sh, sw)
        planes[name] = (plan, fn, ops, torch.from_numpy(random_u8(rng, shape)).cuda())
    step, step_ops = sharding.make_yuv_step_fn(data, SRC_W, SRC_H, DST_W, DST_H)
    check(step.routes == ("cuda",) * 2 * SHARDS, f"yuv step routes {step.routes}")
    yuv_in = [torch.from_numpy(random_u8(rng, (SHARDS, h, w))).cuda()
              for h, w in ((SRC_H, SRC_W),) + ((SRC_H // 2, SRC_W // 2),) * 2]
    algo, kw, sw, sh, dw, dh, nb = DP_SP_FRAME
    dpsp_plan = build_plan(algo, sw, sh, dw, dh, **kw)
    dpsp, dpsp_ops = sharding.make_batch_row_sharded_fn(dpsp_plan, grid)
    check(dpsp.routes == ("cuda",) * 4, f"dp x sp routes {dpsp.routes}")
    dpsp_in = torch.from_numpy(random_u8(rng, (nb, sh, sw))).cuda()

    # the sharded main path: every count set to 0 just before, read after
    def launched(what: str, n: int, call):
        before = cr.LAUNCHES
        out = call()
        check(cr.LAUNCHES - before == n, f"{what}: {cr.LAUNCHES - before} "
              f"launches, expected {n}")
        return out

    cr.reset_launches()
    outs = {name: launched(f"sharded {name}", SHARDS, lambda: fn(*ops, x))
            for name, (_, fn, ops, x) in planes.items()}
    # a frame per shard: one frame call, luma and U and V as one launch
    yuv_out = launched("yuv step", 2 * SHARDS, lambda: step(*step_ops, *yuv_in))
    dpsp_out = launched("dp x sp", 4, lambda: dpsp(*dpsp_ops, dpsp_in))
    torch.cuda.synchronize()
    by_variant = dict(cr.LAUNCHES_BY_VARIANT)
    want = {**dict.fromkeys(by_variant, 0),
            "wrap16_tiled": 2 * SHARDS + 2 * SHARDS + 4, "u16_tiled": SHARDS}
    check(by_variant == want, f"sharded main path launched {by_variant}, "
          f"expected {want}: one per shard per plane call, 2 per shard's frame")
    print(f"sharded main path on {SHARDS} x {cuda}: 4K luma, px2 chroma and "
          f"Area 360p row-sharded, YUV step 4K->1080p batch {SHARDS} over dp "
          f"{SHARDS}, dp x sp 2x2 -> launches "
          f"{ {v: n for v, n in by_variant.items() if n} }")

    max_err = {"wrap16_tiled": 0, "u16_tiled": 0}
    for name, (plan, fn, ops, x) in planes.items():
        got = sharding.gather(outs[name])
        x3 = x if x.ndim == 3 else x[None]
        ops_u = cr.pack_operands(plan, "cuda")
        whole = cr.resize_fused(ops_u, x3).reshape(got.shape)
        v = cr.variant(ops_u.tables)
        err = max(compare(f"sharded {name} vs unsharded kernel", got, whole),
                  compare(f"sharded {name} vs plain",
                          got, cr.resize_plain(ops_u, x3).reshape(got.shape)))
        max_err[v] = max(max_err[v], err)
        print(f"sharded {name} {tuple(x.shape)} over {SHARDS} shards == "
              f"unsharded kernel == plain, byte for byte ({v})")
    luma = build_plan("lanczos", SRC_W, SRC_H, DST_W, DST_H, degree=3)
    chroma = build_plan("lanczos", SRC_W // 2, SRC_H // 2, DST_W // 2,
                        DST_H // 2, degree=3, px_scale=2)
    for plane, plan, got, x in zip("yuv", (luma, chroma, chroma),
                                   sharding.gather(yuv_out), yuv_in):
        max_err["wrap16_tiled"] = max(max_err["wrap16_tiled"], compare(
            f"yuv step {plane}", got,
            cr.resize_plain(cr.pack_operands(plan, "cuda"), x)))
    print(f"yuv step 4K->1080p, {SHARDS} frames over dp {SHARDS}: every plane "
          "== plain path")
    got = sharding.gather(dpsp_out)
    check(got.shape == (nb, dh, dw), f"dp x sp shape {tuple(got.shape)}")
    max_err["wrap16_tiled"] = max(max_err["wrap16_tiled"], compare(
        "dp x sp", got, cr.resize_plain(cr.pack_operands(dpsp_plan, "cuda"),
                                        dpsp_in)))
    print(f"dp x sp 2x2: {nb} frames {sw}x{sh}->{dw}x{dh} ({dh} rows over 2 "
          "row shards) == plain path")

    n_small = 0
    for shards, algo, kw, (sw, sh), (dw, dh) in sharded_small(rng):
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        fn, ops = sharding.make_row_sharded_fn(
            plan, sharding.Mesh([cuda] * shards, ("row",)))
        host = random_u8(rng, (sh, sw))
        before = cr.LAUNCHES
        got = sharding.gather(fn(*ops, torch.from_numpy(host).cuda())).cpu()
        kernel_shards = fn.routes.count("cuda")
        check(cr.LAUNCHES - before == kernel_shards,
              f"sharded {algo} {sw}x{sh}->{dw}x{dh}: {cr.LAUNCHES - before} "
              f"launches, {kernel_shards} kernel shards")
        compare(f"sharded {algo}{kw or ''} {sw}x{sh}->{dw}x{dh} on {shards} "
                "vs numpy_ref", got,
                torch.from_numpy(numpy_ref.resize_u8(plan, host)))
        n_small += 1
    print(f"row-sharded == numpy_ref on {n_small} small geometries "
          "(multi-hop Area and odd heights among them)")
    before = cr.LAUNCHES
    summary = sharding.dryrun(8, "cuda")
    check(cr.LAUNCHES > before, "dryrun launched no kernel")
    print(f"dryrun(8, 'cuda') == numpy_ref: {summary}, "
          f"{cr.LAUNCHES - before} launches")

    entries = {}
    for name, v in (("lanczos3 4K->1080p luma", "wrap16_tiled"),
                    ("area 1080p->360p luma", "u16_tiled")):
        plan, fn, ops, x = planes[name]
        ops_u = cr.pack_operands(plan, "cuda")
        fn_t, ops_t = sharding.make_row_sharded_fn(plan, rows, backend="torch")
        xs = _harness.perturbed(x, n_inputs(x.numel()))
        sharded = lambda t: fn(*ops, t)                          # noqa: E731
        whole = lambda t: cr.resize_fused(ops_u, t[None])        # noqa: E731
        # in turns, unsharded, sharded, sharded, unsharded
        times = [_harness.launches_ms(f, xs) for f in (whole, sharded, sharded, whole)]
        k, u = min(times[1:3]), min(times[0], times[3])
        ku = _harness.launches_ms(sharded, xs, primed=False)
        uu = _harness.launches_ms(whole, xs, primed=False)
        p = _harness.launches_ms(lambda t: fn_t(*ops_t, t), xs, primed=False)
        halo = halo_rows(sharding, plan, SHARDS) * plan.x.n_src
        nbytes = (plan.y.n_src * plan.x.n_src + 2 * halo
                  + plan.y.n_dst * plan.x.n_dst)
        b = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"time sharded {name}, {SHARDS} shards on one card (not a "
              f"multi-card figure), both on {v}: sharded {k!r} ms (host-paced "
              f"{ku!r}), unsharded kernel {u!r} ms (host-paced {uu!r}), sharded plain "
              f"{p!r} ms, sharded/unsharded {k / u!r}, bound {b!r} ms (bytes: "
              f"source, {halo} halo bytes read and written once more, output)"
              f" ({card})")
        # the shards launch the tiled kernel; "was" names the entry that
        # held the sharded path while it ran on resize_fused
        entries[v.removesuffix("_tiled")] = {
            "name": f"resize_tiled[{v.removesuffix('_tiled')},sharded]",
            "was": f"resize_fused[{v.removesuffix('_tiled')},sharded]",
            "route": "cuda", "launched": v,
            "source": "libiqo_tpu_torch/csrc/resize_tiled.cu",
            "replaces": "libiqo_tpu/parallel/sharding.py:197",
            "launches": by_variant[v], "max_abs_err": max_err[v], "ms": k,
            "plain_ms": p, "bound_ms": b, "bound_by": "bytes",
            "library_ms": None, "unsharded_ms": u, "host_paced_ms": ku,
            "shards_on_one_card": SHARDS}
    print(f"phase sharded: {time.perf_counter() - t_phase!r} s")
    return entries


def carry_small(rng, cr, build_plan):
    """A seeded fuzz set of small plans that the tiled carry form takes."""
    n = tries = 0
    while n < CARRY_FUZZ and tries < 400:
        tries += 1
        algo = ("lanczos", "linear")[tries % 2]
        sw, sh = (int(v) for v in rng.integers(64, 400, 2))
        dw, dh = ((sw // 2, sh // 2) if tries % 4 < 2
                  else (sw * 3 // 2 + tries % 3, sh * 3 // 2 + tries % 5))
        kw = dict(degree=int(2 + tries % 3)) if algo == "lanczos" else {}
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        if cr.supports_plan(plan) and cr.tiled_carry_layout(plan) is not None:
            n += 1
            yield algo, kw, sw, sh, dw, dh, plan


def hold_carry(cr, tag: str, plan, host: np.ndarray, oracle=None) -> dict:
    """The tiled carry kernel == the tiled kernel without carry on the card,
    byte for byte, and == the windowed carry kernel where ``carry_ok``
    holds, exact and (where the relaxed form takes the plan) relaxed; exact
    also == the NumPy oracle when one is given.  Returns the largest error
    by variant."""
    check(cr.tiled_carry_layout(plan) is not None, f"{tag}: tiled carry refuses")
    src = torch.from_numpy(host).cuda()
    errs = {}
    for relaxed in (False, True):
        if relaxed and not cr.supports_plan(plan, relaxed=True):
            continue
        carry = cr.pack_operands(plan, "cuda", relaxed, carry=True)
        tiled = cr.pack_operands(plan, "cuda", relaxed)
        v = cr.variant(carry.tables)
        check(v == cr.variant(plan, relaxed, carry=True) + "_tiled",
              f"{tag}: carry tables are {v}")
        got = cr.resize_fused(carry, src)
        err = compare(f"{tag} {v} vs {cr.variant(tiled.tables)}", got,
                      cr.resize_fused(tiled, src))
        if oracle is not None and not relaxed:
            want = np.stack([oracle.resize_u8(plan, f) for f in host])
            err = max(err, compare(f"{tag} {v} vs numpy_ref", got.cpu(),
                                   torch.from_numpy(want)))
        errs[v] = max(errs.get(v, 0), err)
        if cr.carry_ok(plan):
            windowed = cr.pack_operands(plan, "cuda", relaxed, carry=True, tiled=False)
            w = cr.variant(windowed.tables)
            errs[w] = max(errs.get(w, 0), compare(
                f"{tag} {w} vs {v}", cr.resize_fused(windowed, src), got))
    return errs


def in_turns(fns: dict, xs, primed: dict | None = None) -> dict:
    """Each of ``fns`` timed twice, in the order given and then reversed
    (min of its two): {name: ms}; ``primed`` maps a name to False to time
    it at the host's pace (a plain path, whose launches overfill the queue
    that the card's spin holds)."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(_harness.launches_ms(fns[n], xs,
                                             primed=(primed or {}).get(n, True)))
    return {n: min(t) for n, t in times.items()}


def phase_carry(cr, yuv, build_plan, numpy_ref, rng, card: str) -> dict:
    """Phase 12, the carry forms.  Returns their entries of the kernels
    line, the tiled carry form's and the windowed ``resize_fused``'s."""
    t_phase = time.perf_counter()
    max_err = {}

    def note(errs):
        for v, e in errs.items():
            max_err[v] = max(max_err.get(v, 0), e)

    plans = {}
    for name, (algo, kw, sw, sh, dw, dh, batch) in CARRY_PLANES.items():
        plan = plans[name] = build_plan(algo, sw, sh, dw, dh, **kw)
        lay, win = cr.tiled_carry_layout(plan), cr.carry_layout(plan)
        check(lay is not None and win is not None, f"carry refuses {name}")
        note(hold_carry(cr, name, plan, random_u8(rng, (batch, sh, sw))))
        print(f"tiled carry == tiled == windowed carry, exact and relaxed: "
              f"{name} ({batch}, {sh}, {sw}); tiled: TW {lay.tw}, run {lay.run}, "
              f"ring {lay.slots} rows x {lay.pitch} B, {lay.smem} B of shared "
              f"memory, fetch/band {lay.fetch / lay.band!r}; windowed: run "
              f"{win.run}, fetch/band {win.fetch / win.band!r}")
    n = skipped = 0
    for algo, sw, sh, dw, dh, kw in (card_check.CARRY_CASES
                                     + card_check.fuzz_cases(*card_check.CARRY_FUZZ)):
        plan = build_plan(algo, sw, sh, dw, dh, **kw)
        if not (cr.supports_plan(plan) and cr.tiled_carry_layout(plan) is not None):
            skipped += 1
            continue
        small = sw * sh <= ORACLE_MAX_PIXELS
        note(hold_carry(cr, f"carry sweep {algo}{kw or ''} {sw}x{sh}->{dw}x{dh}",
                        plan, random_u8(rng, (4, sh, sw)),
                        numpy_ref if small else None))
        n += 1
    print(f"tiled carry == tiled (== windowed carry where carry_ok) (batch 4, "
          f"exact and relaxed) on {n} scripts/tpu_check.py:carry_sweep cases "
          f"({skipped} where carry or supports_plan refuses)")
    n = 0
    for algo, kw, sw, sh, dw, dh, plan in carry_small(rng, cr, build_plan):
        note(hold_carry(cr, f"carry fuzz {algo}{kw or ''} {sw}x{sh}->{dw}x{dh}",
                        plan, random_u8(rng, (4, sh, sw)), numpy_ref))
        n += 1
    print(f"tiled carry == tiled == numpy_ref (batch 4) on {n} small fuzz plans")

    launches = {}
    for frame, luma_v, chroma_v, precision in CARRY_PATHS + WINDOWED_CARRY_PATHS:
        if not luma_v.endswith("_tiled"):
            (_, luma, _), _ = yuv_planes(build_plan, *frame)
            check(cr.tiled_carry_layout(luma) is None and cr.carry_ok(luma),
                  f"{frame}: luma takes the tiled carry form")
        by_variant, err, _, _ = drive_yuv(cr, yuv, build_plan, rng, frame,
                                          luma_v, chroma_v, precision=precision)
        launches[luma_v] = by_variant[luma_v]
        max_err[luma_v] = max(max_err.get(luma_v, 0), err)
    print(f"carry main paths with LIBIQO_TPU_CARRY=1 -> launches {launches}")

    entries = {}
    for v, name in (("wrap16_carry", "lanczos3 4K->1080p luma"),
                    ("u16_carry", "linear 1080p->4K luma"),
                    ("wrap16_relaxed_carry", "lanczos3 4K->1080p luma"),
                    ("u16_relaxed_carry", "linear 1080p->4K luma")):
        relaxed = "_relaxed" in v
        plan = plans[name]
        carry = cr.pack_operands(plan, "cuda", relaxed, carry=True)
        tiled = cr.pack_operands(plan, "cuda", relaxed)
        windowed = cr.pack_operands(plan, "cuda", relaxed, carry=True, tiled=False)
        check(cr.variant(carry.tables) == v + "_tiled"
              and cr.variant(windowed.tables) == v, f"{name}: carry routes")
        x = torch.from_numpy(random_u8(rng, (1, plan.y.n_src, plan.x.n_src))).cuda()
        xs = _harness.perturbed(x, n_inputs(x.numel()))
        ms = in_turns({"windowed": lambda t: cr.resize_fused(windowed, t),
                       "tiled": lambda t: cr.resize_fused(tiled, t),
                       "carry": lambda t: cr.resize_fused(carry, t)}, xs)
        ku = _harness.launches_ms(lambda t: cr.resize_fused(carry, t), xs, primed=False)
        p = _harness.launches_ms(lambda t: cr.resize_plain(carry, t), xs, primed=False)
        bytes_ms, ops_ms = bound([(plan, 1)], BF16_OPS_PER_S if relaxed
                                 else INT8_OPS_PER_S)
        b = max(bytes_ms, ops_ms)
        lay = carry.tables.layout
        print(f"time carry {v}_tiled {name} (TW {lay.tw}, run {lay.run}): tiled "
              f"carry {ms['carry']!r} ms (unprimed {ku!r}), tiled {ms['tiled']!r} "
              f"ms, windowed carry {ms['windowed']!r} ms (same call, in turns), "
              f"carry/tiled {ms['carry'] / ms['tiled']!r}, tiled carry/windowed "
              f"carry {ms['carry'] / ms['windowed']!r}, plain {p!r} ms, bound "
              f"{b!r} ms ({card})")
        common = {"route": "cuda", "replaces": "libiqo_tpu/ops/pallas_resize.py:1242",
                  "plain_ms": p, "bound_ms": b,
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                  "library_ms": None, "plane": name}
        entries[v + "_tiled"] = {
            "name": f"resize_tiled[{v.replace('_', ',')}]",
            "source": "libiqo_tpu_torch/csrc/resize_tiled.cuh",
            "launches": launches[v + "_tiled"], "max_abs_err": max_err[v + "_tiled"],
            "ms": ms["carry"], **common, "windowed_ms": ms["windowed"],
            "tiled_ms": ms["tiled"], "tw": lay.tw, "run": lay.run}
        # the windowed carry form: launched by the column thumbnails whose
        # tiled ring does not fit, timed on the same plane in the same turns
        entries[v] = {
            "name": f"resize_fused[{v.replace('_', ',')}]",
            "was": "the carry route of every plan that carry_ok takes; now of "
                   "those whose tiled ring does not fit",
            "source": "libiqo_tpu_torch/csrc/resize_fused.cu",
            "launches": launches[v], "max_abs_err": max_err[v],
            "ms": ms["windowed"], **common, "tiled_carry_ms": ms["carry"]}
    for name in ("lanczos3 8K->1080p", "lanczos2 720p->1080p",
                 "linear 1080p->4K chroma"):
        plan, batch = plans[name], CARRY_PLANES[name][-1]
        carry = cr.pack_operands(plan, "cuda", carry=True)
        tiled = cr.pack_operands(plan, "cuda")
        windowed = cr.pack_operands(plan, "cuda", carry=True, tiled=False)
        x = torch.from_numpy(random_u8(rng, (batch, plan.y.n_src, plan.x.n_src))).cuda()
        xs = _harness.perturbed(x, n_inputs(x.numel()))
        ms = in_turns({"windowed": lambda t: cr.resize_fused(windowed, t),
                       "tiled": lambda t: cr.resize_fused(tiled, t),
                       "carry": lambda t: cr.resize_fused(carry, t)}, xs)
        lay = carry.tables.layout
        print(f"time carry {cr.variant(carry.tables)} {name} {tuple(x.shape)} (TW "
              f"{lay.tw}, run {lay.run}): tiled carry {ms['carry']!r} ms, tiled "
              f"{ms['tiled']!r} ms, windowed carry {ms['windowed']!r} ms, "
              f"carry/tiled {ms['carry'] / ms['tiled']!r}, bound "
              f"{bound([(plan, batch)])[0]!r} ms ({card})")
    # the run and the width against the grid's size, on 4K luma
    plan = plans["lanczos3 4K->1080p luma"]
    tiled = cr.pack_operands(plan, "cuda")
    windowed = cr.pack_operands(plan, "cuda", tiled=False)
    x = torch.from_numpy(random_u8(rng, (1, plan.y.n_src, plan.x.n_src))).cuda()
    xs = _harness.perturbed(x, n_inputs(x.numel()))
    want = cr.resize_fused(tiled, x)
    for tw, run in CARRY_TILED_SWEEP:
        lay = cr.tiled_carry_layout(plan, tw=tw, run=run)
        check(lay is not None, f"tiled carry refuses TW {tw}, run {run}")
        carry = cr.KernelOperands(plain=tiled.plain,
                                  tables=cr.tiled_tables(plan, "cuda", lay))
        compare(f"tiled carry TW {tw} run {run} vs tiled", cr.resize_fused(carry, x),
                want)
        ms = in_turns({"tiled": lambda t: cr.resize_fused(tiled, t),
                       "carry": lambda t: cr.resize_fused(carry, t)}, xs)
        blocks = -(-plan.x.n_dst // tw) * -(-len(lay.rrec) // run)
        print(f"time tiled carry sweep, lanczos3 4K luma: TW {tw}, run {run} "
              f"row tiles, {blocks} blocks, ring {lay.slots} rows, {lay.smem} B, "
              f"fetch/band {lay.fetch / lay.band!r}: carry {ms['carry']!r} ms, "
              f"tiled {ms['tiled']!r} ms, carry/tiled "
              f"{ms['carry'] / ms['tiled']!r} ({card})")
    n_ct = -(-plan.x.n_dst // cr.TILE_COLS)
    saved = cr.CARRY_BLOCKS
    try:
        for blocks in CARRY_RUN_SWEEP:
            cr.CARRY_BLOCKS = blocks
            lay = cr.carry_layout(plan)
            carry = cr.pack_operands(plan, "cuda", carry=True, tiled=False)
            compare(f"windowed carry run {lay.run} vs tiled", cr.resize_fused(carry, x),
                    want)
            ms = in_turns({"windowed": lambda t: cr.resize_fused(windowed, t),
                           "carry": lambda t: cr.resize_fused(carry, t)}, xs)
            print(f"time windowed carry run sweep, lanczos3 4K luma: run "
                  f"{lay.run} row tiles, {n_ct * -(-len(lay.rwin) // lay.run)} "
                  f"blocks, fetch/band {lay.fetch / lay.band!r}: carry "
                  f"{ms['carry']!r} ms, windowed {ms['windowed']!r} ms, "
                  f"carry/windowed {ms['carry'] / ms['windowed']!r} ({card})")
    finally:
        cr.CARRY_BLOCKS = saved
    print(f"phase carry: {time.perf_counter() - t_phase!r} s")
    return entries


def probe_err(tag: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Kernel == plain, bit for bit (shape, dtype, every element); returns
    the largest absolute difference, 0.0."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tag}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        d = (got.double() - want.double()).abs()
        raise SmokeFailure(f"{tag}: kernel != plain, max abs err "
                           f"{d.max().item()!r}; " + first_diff(got, want))
    return 0.0


def probe_inputs(dma, gen):
    """Kernel A and B's inputs at the TPU script's full shapes, drawn on the
    card: {row: (op, tensor)}; i32 rows take the whole int32 range."""
    h, w, dev = dma.H, dma.W, torch.device("cuda", 0)

    def u8(rows):
        return torch.randint(0, 256, (rows, w), dtype=torch.uint8, device=dev,
                             generator=gen)

    def i32(rows):
        return torch.randint(-2**31, 2**31, (rows, w // 4), dtype=torch.int32,
                             device=dev, generator=gen)
    return {"inc": ("inc_u8", u8(h)), "inc_i32": ("inc_i32", i32(h)),
            "inc33MB": ("inc_u8", u8(4 * h)), "inc33MB32": ("inc_i32", i32(4 * h)),
            "mix33MB32": ("mix_i32", i32(4 * h)), "copy33MB": ("copy", u8(4 * h)),
            "inc133MB": ("inc_u8", u8(16 * h)), "copy133MB": ("copy", u8(16 * h)),
            "readsum": ("readsum", u8(h))}


MMA_SECOND_SHAPE = (36, 384, 768, 640)     # (steps, M, N, K): C's wgmma form, 324 tiles
BANDED_SHORT = 3                           # D's second stack: a partial last wave


def phase_probes(card: str) -> list:
    """Phase 13, the H100 probes (``libiqo_tpu_torch/experiments``): each
    of the four kernels == its plain version at the TPU scripts' full shapes
    in every variant; each script's ``main()`` with every count set to 0
    just before (chain checksums asserted inside); plain and library times.
    Kernel C in both forms, the first, ``mma_sync``, and the ``wgmma`` form, the
    latter also at :data:`MMA_SECOND_SHAPE`; ``mxu.main()`` times both forms
    and each row's library call in turns; ``dma.main()`` times B's two
    forms and the library fold in turns.  Kernel D in both forms, ``sync``
    and ``wgmma``, in all nine modes at GRID 35 and on :data:`BANDED_SHORT`
    tiles, ``bd.main()`` timing both in turns, then mono/mono and
    grouped/grouped in turns with the two-``bmm`` chain.  Returns the seven
    entries of the kernels line."""
    from libiqo_tpu_torch.experiments import (_harness, exp_banded_dots as bd,
                                              exp_dma_ceiling as dma,
                                              exp_int8_mxu as mxu)
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)

    # 1. kernel == plain, every variant, full shapes
    err = dict.fromkeys(("stream_map", "mma_steps", "mma_steps[wgmma]", "banded_tile",
                         "banded_tile[wgmma]"), 0.0)
    dma_in = probe_inputs(dma, gen)
    for row, (op, x) in dma_in.items():
        if op != "readsum":
            err["stream_map"] = max(err["stream_map"], probe_err(
                f"{row} {op}", dma.stream_map(x, op), dma.stream_map_plain(x, op)))
    # B in every form, at the script's plane, a ragged height and one chunk
    # of 128 columns
    rs_planes = [dma_in["readsum"][1], torch.randint(
        0, 256, (dma.H + 1, dma.W), dtype=torch.uint8, device=dev, generator=gen),
        torch.randint(0, 256, (dma.H, dma.LANES), dtype=torch.uint8, device=dev,
                      generator=gen)]
    for x in rs_planes:
        want = dma.readsum_plain(x)
        for form in dma.FORMS_READSUM:
            key = dma.readsum_key(form)
            err[key] = max(err.get(key, 0.0), probe_err(f"readsum[{form}] {tuple(x.shape)}",
                                                         dma.readsum(x, form), want))
    del rs_planes[1:]
    print(f"stream_map == plain on {len(dma_in) - 1} exp_dma_ceiling rows, "
          f"readsum in forms {dma.FORMS_READSUM} == plain on (H, W), (H + 1, W) and "
          f"(H, 128) at (H, W) = {(dma.H, dma.W)}, bit for bit")
    for row, (in_dt, acc) in mxu.ROWS.items():
        a, b = mxu.inputs(in_dt, dev)
        bt = mxu.k_major(b)
        want = mxu.mma_steps_plain(a, bt, acc)
        for form, key in (("mma_sync", "mma_steps"), ("wgmma", "mma_steps[wgmma]")):
            err[key] = max(err[key], probe_err(f"{row} {form}", mxu.mma_steps(a, bt, acc, form),
                                               want))
        # the wgmma form's second shape: 324 tiles of 128 x 256 over the SMs,
        # several a block and a partial last wave; K of 5, 10 or 20 chunks
        steps2, m2, n2, k2 = MMA_SECOND_SHAPE
        a2 = torch.randint(-100, 100, (steps2, m2, k2), device=dev, generator=gen)
        b2 = torch.randint(-100, 100, (k2, n2), device=dev, generator=gen)
        a2, bt2 = a2.to(in_dt), mxu.k_major(b2.to(in_dt))
        err["mma_steps[wgmma]"] = max(err["mma_steps[wgmma]"], probe_err(
            f"{row} wgmma {MMA_SECOND_SHAPE}", mxu.mma_steps(a2, bt2, acc, "wgmma"),
            mxu.mma_steps_plain(a2, bt2, acc)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"mma_steps == plain on all {len(mxu.ROWS)} exp_int8_mxu rows at "
          f"STEPS={mxu.STEPS}, ({mxu.M}, {mxu.K}) @ ({mxu.K}, {mxu.N}) in both forms, bit for "
          f"bit; the wgmma form also at (steps, M, N, K) {MMA_SECOND_SHAPE}: "
          f"{MMA_SECOND_SHAPE[0] * MMA_SECOND_SHAPE[1] // 128 * MMA_SECOND_SHAPE[2] // 256} "
          f"tiles on {sms} SMs")
    band, cy, cxs = bd.inputs(dev)
    ops = bd.pack(cy, *cxs)
    # D in both forms at GRID 35 and on a short stack of 3 tiles (the wgmma
    # form's X walk then has 24 items: a partial last row pair, blocks of one
    # item)
    band3 = band[:BANDED_SHORT].flip(2).contiguous()
    for b_ in (band, band3):
        for ym, xm in bd.PAIRS:
            want = bd.banded_tile_plain(ops, b_, ym, xm)
            for form, key in (("sync", "banded_tile"), ("wgmma", "banded_tile[wgmma]")):
                err[key] = max(err[key], probe_err(
                    f"banded [{form}] y={ym} x={xm} on {b_.shape[0]} tiles",
                    bd.banded_tile(ops, b_, ym, xm, form), want))
    del band3
    print(f"banded_tile == plain in all {len(bd.PAIRS)} (Y, X) modes in forms {bd.FORMS} at "
          f"GRID={bd.GRID} and on {BANDED_SHORT} tiles, bit for bit")

    # 2. the probes' main paths, every count set to 0 just before
    for mod in (dma, mxu, bd):
        mod.reset_launches()
    rows = {"dma": dma.main(), "mxu": mxu.main(), "bd": bd.main()}
    torch.cuda.synchronize()
    launches = {"stream_map": sum(dma.LAUNCHES[op] for op in dma.OPS),
                **{dma.readsum_key(f): dma.LAUNCHES[dma.readsum_key(f)]
                   for f in dma.FORMS_READSUM},
                "mma_steps": sum(mxu.LAUNCHES[r] for r in mxu.ROWS),
                "mma_steps[wgmma]": sum(mxu.LAUNCHES[mxu.launch_key(r, "wgmma")]
                                        for r in mxu.ROWS),
                "banded_tile": sum(bd.LAUNCHES[bd.launch_key(y, x, "sync")]
                                   for y, x in bd.PAIRS),
                "banded_tile[wgmma]": sum(bd.LAUNCHES[bd.launch_key(y, x, "wgmma")]
                                          for y, x in bd.PAIRS)}
    idle = [f"{mod.__name__.rsplit('.', 1)[-1]}:{v}" for mod in (dma, mxu, bd)
            for v, n in mod.LAUNCHES.items() if n == 0]
    check(not idle, f"probe variants never launched by main(): {idle}")
    print(f"probe main() runs -> launches {launches}; by variant "
          f"{dict(dma.LAUNCHES)} {dict(mxu.LAUNCHES)} {dict(bd.LAUNCHES)}")

    # 3. plain times, host-paced (they synchronise); library yardsticks
    # under their kernel's own protocol: a serial chain into preallocated
    # buffers for A, the kernel's perturbed inputs back to back for B and C,
    # each first held equal to the plain version where it is the same function
    def plain_ms(fn, x, n=2):
        return _harness.launches_ms(fn, _harness.perturbed(x, n), repeats=2,
                                    primed=False)

    xb = dma_in["inc33MB"][1]
    lib_add = _harness.chain_ms(lambda a, b: torch.add(a, 1, out=b), xb,
                                dma.INNER[4], dma.expect_inc(torch.uint8))
    lib_copy = _harness.chain_ms(lambda a, b: b.copy_(a), dma_in["copy33MB"][1],
                                 dma.INNER[4], dma.expect_copy)
    p_inc = plain_ms(lambda t: dma.stream_map_plain(t, "inc_u8"), xb)
    rs = dma_in["readsum"][1]
    # B's library fold is held equal to the plain version and timed in turns
    # with B's forms inside dma.main()
    p_readsum = plain_ms(dma.readsum_plain, rs)
    # C's library calls (torch._int_mm, torch.mm) are held equal to the plain
    # version and timed in turns with both forms inside mxu.main(); the bf16
    # torch.matmul writes bf16, so it stays a yardstick
    a8, b8 = mxu.inputs(torch.int8, dev)
    a16, b16 = mxu.inputs(torch.bfloat16, dev)
    bt8, bt16 = mxu.k_major(b8), mxu.k_major(b16)
    lib_matmul = _harness.launches_ms(lambda t: torch.matmul(t, bt16.t()),
                                      _harness.perturbed(a16, mxu.ITERS))
    p_mma = plain_ms(lambda t: mxu.mma_steps_plain(t, bt8, torch.int32), a8)
    p_banded = plain_ms(lambda t: bd.banded_tile_plain(ops, t, "mono", "mono"), band)
    # D: no one PyTorch call computes banded_tile (two dependent products,
    # an int16 wrap and a split between them, then the epilogue).  Its two
    # mono products alone, as two bf16 torch.bmm with float32 out over
    # operands laid out beforehand (the band in bf16, the X planes of each
    # band's own Y product), first rebuilt into D's whole function and held
    # equal to the plain version
    cy_stack = ops.cy.expand(bd.GRID, -1, -1).contiguous()
    cx_stack = torch.stack([c_.t() for c_ in ops.cxt]).contiguous()      # (3, 896, 384)

    def d_operands(t):
        bb = t.to(torch.bfloat16)
        y = torch.bmm(cy_stack, bb, out_dtype=torch.float32).to(torch.int64)
        w16 = _harness.wrap(y, 16)
        b_ = ((w16 + 128) & 255) - 128
        a_ = (w16 - b_) >> 8
        planes = torch.stack([p_.reshape(-1, bd.BW) for p_ in (a_, b_, a_ + b_)])
        return bb, planes.to(torch.bfloat16).contiguous()

    def d_dots(xy):
        bb, planes = xy
        return (torch.bmm(cy_stack, bb, out_dtype=torch.float32),
                torch.bmm(planes, cx_stack, out_dtype=torch.float32))

    _, xd = d_dots(d_operands(band))
    sums = sum(_harness.wrap(xd[i].to(torch.int64), 32) * wt for i, wt in enumerate(bd.XWEIGHTS))
    v = _harness.wrap(_harness.wrap(sums, 32) + (1 << 19), 32) >> 20
    rebuilt = _harness.wrap(v, 16).clamp(0, 255).to(torch.uint8).view(bd.GRID, bd.TH, bd.TW)
    check(torch.equal(rebuilt, bd.banded_tile_plain(ops, band, "mono", "mono")),
          "banded_tile rebuilt from two bf16 torch.bmm != banded_tile_plain mono/mono")
    # ... timed in turns with both forms of mono/mono and of grouped/grouped
    bands = _harness.perturbed(band, bd.ITERS)
    d_turns = _harness.turns_ms({
        **{f"{form} {ym}": (functools.partial(
            lambda t, f, y_: bd.banded_tile(ops, t, y_, y_, f), f=form, y_=ym), bands)
           for form in bd.FORMS for ym in ("mono", "grouped")},
        "dots": (d_dots, [d_operands(t) for t in bands])})
    lib_d_dots = d_turns["dots"]
    del dma_in, xb, rs, bands

    d, m, b = rows["dma"], rows["mxu"], rows["bd"]
    inc_bytes = d["inc33MB"]["bytes"]
    print(f"probe inc33MB (u8): kernel {d['inc33MB']['ms']!r} ms, plain {p_inc!r} "
          f"ms, library torch.add(a, 1, out=b) on uint8, same chain, "
          f"{lib_add!r} ms, bound {inc_bytes / HBM_BYTES_PER_S * 1e3!r} ms "
          f"(bytes) ({card})")
    print(f"probe copy33MB: kernel {d['copy33MB']['ms']!r} ms, library "
          f"b.copy_(a), same chain, {lib_copy!r} ms ({card})")
    lib_rs = d["readsum_library"]["ms"]
    print(f"probe readsum, in turns: warp {d['readsum[warp]']['ms']!r} ms, "
          f"rows8 {d['readsum']['ms']!r} ms, library "
          f"x.view(h, -1, 128).sum(1, dtype=uint8) {lib_rs!r} ms, an empty launch "
          f"{d['launch_floor']['ms']!r} ms; plain {p_readsum!r} ms; "
          f"bound {(dma.H * dma.W + dma.H * dma.LANES) / HBM_BYTES_PER_S * 1e3!r} ms (bytes) "
          f"({card})")
    for row in ("inc", "copy33MB", "inc133MB", "copy133MB", "readsum", "readsum[warp]",
                "readsum_library", "readsum133MB"):
        print(f"probe ceiling {row}: {d[row]['gbs']!r} GB/s against the data "
              f"sheet's {HBM_BYTES_PER_S / 1e9!r} GB/s ({card})")
    for row, r in m.items():
        print(f"probe mma_steps {row}: wgmma {r['ms']!r} ms, mma_sync {r['ms_mma_sync']!r} ms, "
              f"library {r['library']} {r['library_ms']!r} ms"
              f"{'' if r['library_one_call'] else ' (two calls: a yardstick)'}, in turns; "
              f"wgmma/library {r['ms'] / r['library_ms']!r}, wgmma/bound "
              f"{r['ms'] / r['bound_ms']!r} (bound {r['bound_ms']!r} ms, {r['bound_by']}) "
              f"({card})")
    print(f"probe mma_steps s8xs8->i32 plain {p_mma!r} ms; bf16 yardstick torch.matmul "
          f"(bf16 out) {lib_matmul!r} ms ({card})")
    mm = b["y=mono x=mono"]
    print(f"probe banded_tile mono/mono, in turns: wgmma {d_turns['wgmma mono']!r} ms, sync "
          f"{d_turns['sync mono']!r} ms, its two products alone as two bf16 "
          f"torch.bmm(out_dtype=float32), operands laid out beforehand, {lib_d_dots!r} ms "
          f"(wgmma/bmm {d_turns['wgmma mono'] / lib_d_dots!r}); grouped/grouped wgmma "
          f"{d_turns['wgmma grouped']!r} ms, sync {d_turns['sync grouped']!r} ms; plain "
          f"{p_banded!r} ms, bound {mm['bound_ms']!r} ms ({mm['bound_by']}), library none (no "
          f"one call computes it) ({card})")
    for name, r in b.items():
        print(f"probe banded_tile {name}: wgmma {r['ms']!r} ms, sync {r['ms_sync']!r} ms "
              f"(in turns in main()), bound {r['bound_ms']!r} ms ({r['bound_by']}), "
              f"wgmma/bound {r['ms'] / r['bound_ms']!r}; wgmma L2 reads from its walk "
              f"{r['issued']} bytes ({card})")
    h, w = dma.H, dma.W
    rs_bytes = h * w + h * dma.LANES
    entries = [
        {"name": "stream_map", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_stream.cu",
         "replaces": "scripts/exp_dma_ceiling.py:57",
         "launches": launches["stream_map"], "max_abs_err": err["stream_map"],
         "ms": d["inc33MB"]["ms"], "plain_ms": p_inc,
         "bound_ms": inc_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": lib_add, "row": "inc33MB",
         "copy33MB_ms": d["copy33MB"]["ms"], "copy33MB_library_ms": lib_copy,
         "gbs": {r: d[r]["gbs"] for r in d
                 if not r.startswith("readsum") and r not in ("resize4k", "launch_floor")}},
        *({"name": dma.readsum_key(f), "route": "cuda",
           "source": "libiqo_tpu_torch/csrc/exp/exp_stream.cu",
           "replaces": "scripts/exp_dma_ceiling.py:73", "form": f,
           "launches": launches[dma.readsum_key(f)], "max_abs_err": err[dma.readsum_key(f)],
           "ms": d[dma.readsum_key(f)]["ms"], "plain_ms": p_readsum,
           "bound_ms": rs_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": lib_rs, "gbs": d[dma.readsum_key(f)]["gbs"],
           "rows8_ms": d["readsum"]["ms"], "launch_floor_ms": d["launch_floor"]["ms"],
           **({"resize4k_ms": d["resize4k"]["ms"]} if f == "rows8" else
              {"gbs_133MB": d["readsum133MB"]["gbs"]})}
          for f in reversed(dma.FORMS_READSUM)),
        {"name": "mma_steps", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_mma.cu",
         "replaces": "scripts/exp_int8_mxu.py:29",
         "launches": launches["mma_steps"], "max_abs_err": err["mma_steps"],
         "ms": m["s8xs8->i32"]["ms_mma_sync"], "plain_ms": p_mma,
         "bound_ms": m["s8xs8->i32"]["bound_ms"],
         "bound_by": m["s8xs8->i32"]["bound_by"],
         "library_ms": m["s8xs8->i32"]["library_ms"], "row": "s8xs8->i32",
         "bf16_out_matmul_ms": lib_matmul,
         "rows": {r: {"ms": v["ms_mma_sync"], "tmacs": v["tmacs_mma_sync"],
                      "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
                      "library_ms": v["library_ms"], "library": v["library"],
                      "library_one_call": v["library_one_call"], "wgmma_ms": v["ms"]}
                  for r, v in m.items()}},
        {"name": "mma_steps[wgmma]", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_mma_wgmma.cu",
         "replaces": "scripts/exp_int8_mxu.py:29",
         "launches": launches["mma_steps[wgmma]"], "max_abs_err": err["mma_steps[wgmma]"],
         "ms": m["s8xs8->i32"]["ms"], "plain_ms": p_mma,
         "bound_ms": m["s8xs8->i32"]["bound_ms"], "bound_by": m["s8xs8->i32"]["bound_by"],
         "library_ms": m["s8xs8->i32"]["library_ms"], "row": "s8xs8->i32",
         "mma_sync_ms": m["s8xs8->i32"]["ms_mma_sync"],
         "second_shape": list(MMA_SECOND_SHAPE),
         "rows": {r: {"ms": v["ms"], "tmacs": v["tmacs"], "mma_sync_ms": v["ms_mma_sync"],
                      "library_ms": v["library_ms"], "library": v["library"],
                      "library_one_call": v["library_one_call"], "bound_ms": v["bound_ms"],
                      "bound_by": v["bound_by"]} for r, v in m.items()}},
        {"name": "banded_tile", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_banded.cu",
         "replaces": "scripts/exp_banded_dots.py:92",
         "launches": launches["banded_tile"], "max_abs_err": err["banded_tile"],
         "ms": mm["ms_sync"], "plain_ms": p_banded, "bound_ms": mm["bound_ms"],
         "bound_by": mm["bound_by"], "library_ms": None, "row": "y=mono x=mono", "form": "sync",
         "library_none": "no one PyTorch call computes it: two dependent products with an "
                         "int16 wrap and a split between them, then the epilogue",
         "dots_library_ms": lib_d_dots, "ms_in_turns": d_turns["sync mono"],
         "grouped_ms_in_turns": d_turns["sync grouped"],
         "rows": {r: v["ms_sync"] for r, v in b.items()}},
        {"name": "banded_tile[wgmma]", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_banded_wgmma.cu",
         "replaces": "scripts/exp_banded_dots.py:92", "form": "wgmma",
         "launches": launches["banded_tile[wgmma]"], "max_abs_err": err["banded_tile[wgmma]"],
         "ms": mm["ms"], "plain_ms": p_banded, "bound_ms": mm["bound_ms"],
         "bound_by": mm["bound_by"], "library_ms": None, "row": "y=mono x=mono",
         "library_none": "no one PyTorch call computes it: two dependent products with an "
                         "int16 wrap and a split between them, then the epilogue",
         "dots_library_ms": lib_d_dots, "ms_in_turns": d_turns["wgmma mono"],
         "grouped_ms_in_turns": d_turns["wgmma grouped"], "short_tiles": BANDED_SHORT,
         "rows": {r: {"ms": v["ms"], "bound_ms": v["bound_ms"]} for r, v in b.items()}},
    ]
    print(f"phase probes: {time.perf_counter() - t_phase!r} s")
    return entries


BAND_SECOND_H = 2100    # G's ring: a short last run, a shared clamped window, rows past H


def phase_band_fetch(card: str) -> list:
    """Phase 14, the band-fetch probes: kernels E, G and H == their plain
    versions at the TPU scripts' full shapes in every form and variant, E
    and G in both implementations (``ring``, ``sync``), the ring also on a
    2-frame ``grid3`` source and at 2100 rows, H in both forms (``walk``,
    ``grid``), also on ``EDGE_SHAPES``; the four scripts' ``main()`` with
    every count set to 0 just before (E, G and H timing both forms and their
    library call in turns); plain times.  Returns the six entries of the
    kernels line."""
    from libiqo_tpu_torch.experiments import (_harness, exp_band_shape as bs,
                                              exp_blocked_halo as bh,
                                              exp_i32_band as ib, exp_overlap as ov)
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)

    # 1. kernel == plain, every form and variant, full shapes, both impls
    err = dict.fromkeys(("band_ydot", "band_ydot[ring]", "overlap_dots",
                         "overlap_dots[ring]", "band_colsum", "band_colsum[walk]"), 0.0)
    key = lambda name, impl: name if impl == "sync" else f"{name}[{impl}]"  # noqa: E731
    coef, src = bs.inputs(dev)
    ops = bs.operands(dev, seed=SEED + 6)
    for impl in bs.IMPLS:
        scratch = torch.zeros_like(ops.slab)
        for form in bs.FORMS:
            x = src if form in ("base", "arb") else src[None]
            o = ops if form in ("streams", "vmem") else None
            err[key("band_ydot", impl)] = max(err[key("band_ydot", impl)], probe_err(
                f"band_ydot {form} {impl}", bs.band_ydot(
                    coef, x, form, o, scratch if form == "vmem" else None, impl),
                bs.band_ydot_plain(coef, x, form, o)))
        check(torch.equal(scratch, ops.slab), f"band_ydot vmem {impl}: scratch != the slab")
        words = ib.to_words(src)
        err[key("band_ydot", impl)] = max(err[key("band_ydot", impl)], probe_err(
            f"band_ydot i32 {impl}", bs.band_ydot(coef, words, "i32", impl=impl),
            bs.band_ydot_plain(coef, words, "i32")))
        ib.rows(coef, src, impl)                # the i32 output is the u8 output permuted
    two = torch.stack([src, src.flip(0)]).contiguous()
    err["band_ydot[ring]"] = max(err["band_ydot[ring]"], probe_err(
        "band_ydot grid3 ring, 2 frames", bs.band_ydot(coef, two, "grid3", impl="ring"),
        bs.band_ydot_plain(coef, two, "grid3")))
    print(f"band_ydot == plain in all {len(bs.FORMS)} forms and the word form at "
          f"{tuple(src.shape)}, N_T={bs.N_T}, impls {bs.IMPLS}, the ring also on 2 frames; "
          f"i32 == u8 permuted")
    osrc, ocoef = ov.inputs(dev)
    short = osrc[:BAND_SECOND_H].contiguous()
    for impl in ov.IMPLS:
        for x in ((osrc, short) if impl == "ring" else (osrc,)):
            for variant in ov.VARIANTS:
                for p in ov.PS:
                    err[key("overlap_dots", impl)] = max(err[key("overlap_dots", impl)], probe_err(
                        f"overlap_dots {variant} P={p} {impl} at {x.shape[0]} rows",
                        ov.overlap_dots(x, ocoef, variant, p, impl=impl),
                        ov.overlap_dots_plain(x, ocoef, variant, p)))
    print(f"overlap_dots == plain in all {len(ov.VARIANTS)} variants x P {ov.PS} at "
          f"{tuple(osrc.shape)}, ND={ov.ND}, N_TY={ov.N_TY}, impls {ov.IMPLS}; the ring also "
          f"at {tuple(short.shape)}")
    ckey = {"grid": "band_colsum", "walk": "band_colsum[walk]"}
    for name, n_t, step, halo, w, variant, x in bh.sources(dev):
        want = bh.band_colsum_plain(x, variant, n_t, step, halo)
        for form in bh.FORMS:
            err[ckey[form]] = max(err[ckey[form]], probe_err(
                f"band_colsum[{form}] {name} {variant}",
                bh.band_colsum(x, variant, n_t, step, halo, form=form), want))
        if (name, variant) == ("luma-like", "element"):
            hx = x                             # the plain path's timed source
    # shapes off the script's, blocked2 with a halo plane of its own, and
    # the walk's 4-byte loads where w or a plane's address is not a
    # multiple of 16 (a plane 4 bytes into its buffer, which the grid form
    # refuses)
    gen = np.random.default_rng(SEED + 14)
    edges = []
    for name, n_t, step, halo, w in bh.EDGE_SHAPES:
        rows = n_t * step + halo
        buf = torch.from_numpy(gen.integers(0, 256, (2 * rows * w + 16,), np.uint8)).to(dev)
        for off in (0, 4):
            x = buf[off:off + rows * w].view(rows, w)
            y = buf[rows * w + 16 - off:2 * rows * w + 16 - off].view(rows, w)
            vec = 16 if w % 16 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0 else 4
            for variant in bh.VARIANTS:
                want = bh.band_colsum_plain(x, variant, n_t, step, halo, y)
                for form in bh.FORMS[:1] if off else bh.FORMS:   # grid takes 16-byte aligned planes
                    err[ckey[form]] = max(err[ckey[form]], probe_err(
                        f"band_colsum[{form}] {name} +{off} {variant}",
                        bh.band_colsum(x, variant, n_t, step, halo, y, form=form), want))
            edges.append(f"{name} +{off} (vec {vec})")
    print(f"band_colsum == plain in both forms, all {len(bh.CONFIGS)} configs x "
          f"{len(bh.VARIANTS)} variants and on {edges}, blocked2's halo from a plane of its own")

    # 2. the probes' main paths, every count set to 0 just before; E and G
    # time both implementations and the library call in turns
    for mod in (bs, ov, bh):
        mod.reset_launches()
    rows = {"bs": bs.main(), "ib": ib.main(), "ov": ov.main(), "bh": bh.main()}
    torch.cuda.synchronize()

    def count(mod, ring):
        return sum(n for k, n in mod.LAUNCHES.items() if k.endswith("[ring]") == ring)
    launches = {"band_ydot": count(bs, False), "band_ydot[ring]": count(bs, True),
                "overlap_dots": count(ov, False), "overlap_dots[ring]": count(ov, True),
                "band_colsum": sum(bh.LAUNCHES[bh.launch_key(v, "grid")] for v in bh.VARIANTS),
                "band_colsum[walk]": sum(bh.LAUNCHES[bh.launch_key(v, "walk")]
                                         for v in bh.VARIANTS)}
    idle = [f"{mod.__name__.rsplit('.', 1)[-1]}:{v}" for mod in (bs, ov, bh)
            for v, n in mod.LAUNCHES.items() if n == 0]
    check(not idle, f"band-fetch variants never launched by main(): {idle}")
    print(f"band-fetch main() runs -> launches {launches}; by variant "
          f"{dict(bs.LAUNCHES)} {dict(ov.LAUNCHES)} {dict(bh.LAUNCHES)}")

    # 3. plain times, host-paced (the library calls are timed in turns by
    # the probes' main(): H's a strided-view sum, its 8-row broadcast left
    # as an expand)
    def plain_ms(fn, x, n=2):
        return _harness.launches_ms(fn, _harness.perturbed(x, n), repeats=2,
                                    primed=False)

    p_ydot = {form: plain_ms(functools.partial(
        lambda t, f: bs.band_ydot_plain(coef, t, f, ops if f in ("streams", "vmem") else None),
        f=form), src if form in ("base", "arb") else src[None]) for form in bs.FORMS}
    p_ydot["i32"] = plain_ms(lambda t: bs.band_ydot_plain(coef, t, "i32"), words)
    p_overlap = {f"{v} P={p}": plain_ms(functools.partial(
        lambda t, v, p: ov.overlap_dots_plain(t, ocoef, v, p), v=v, p=p), osrc)
        for v in ov.VARIANTS for p in (0, 8)}
    p_colsum = {v: plain_ms(functools.partial(
        lambda t, v: bh.band_colsum_plain(t, v, 64, 64, 64), v=v), hx) for v in bh.VARIANTS}
    print(f"plain ms, host-paced: band_ydot {p_ydot}; overlap_dots {p_overlap}; "
          f"band_colsum luma-like {p_colsum} ({card})")

    hr = rows["bh"]
    lib_colsum_rows = {r: v["library_ms"] for r, v in hr.items()}
    for row in ("narrow element", "luma-like element"):
        hn = hr[row]
        print(f"probe band_colsum {row}: walk {hn['ms']!r} ms ({hn['bound_ms'] / hn['ms']!r} "
              f"of its bound's pace), grid {hn['grid_ms']!r} ms "
              f"({hn['bound_ms'] / hn['grid_ms']!r}), library as_strided(...).sum(1, "
              f"dtype=int32) + expand {hn['library_ms']!r} ms, in turns; bound "
              f"{hn['bound_ms']!r} ms; walk {hn['walk']} ({card})")

    e, g, h = rows["bs"]["base"], rows["ov"]["elem P=8"], rows["bh"]["luma-like element"]
    print(f"probe band_ydot base: ring {e['ring_ms']!r} ms, sync {e['sync_ms']!r} ms, plain "
          f"{p_ydot['base']!r} ms, library torch._int_mm over laid-out windows (the dot alone) "
          f"{e['library_ms']!r} ms, bound {e['bound_ms']!r} ms ({e['bound_by']}) ({card})")
    print(f"probe overlap_dots elem P=8: ring {g['ring_ms']!r} ms, sync {g['sync_ms']!r} ms, "
          f"plain {p_overlap['elem P=8']!r} ms, library torch._int_mm of [C]*8 over the stacked "
          f"slices (the dots alone) {g['library_ms']!r} ms, bound {g['bound_ms']!r} ms "
          f"({g['bound_by']}) ({card})")
    print(f"probe band_colsum luma-like element: walk {h['ms']!r} ms, grid "
          f"{h['grid_ms']!r} ms, plain {p_colsum['element']!r} ms, library "
          f"{h['library_ms']!r} ms, bound {h['bound_ms']!r} ms ({h['bound_by']}) ({card})")
    src_file = "libiqo_tpu_torch/csrc/exp/exp_band.cu"
    ring_file = "libiqo_tpu_torch/csrc/exp/exp_band_ring.cu"
    e_rows = {**rows["bs"], "i32": rows["ib"]["i32"], "u8": rows["ib"]["u8"]}
    e_common = {"route": "cuda", "replaces": "scripts/exp_band_shape.py:65",
                "also_replaces": ["scripts/exp_band_shape.py:124", "scripts/exp_band_shape.py:147",
                                  "scripts/exp_i32_band.py:65", "scripts/exp_i32_band.py:94"],
                "plain_ms": p_ydot["base"], "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"], "library_ms": e["library_ms"], "row": "base",
                "plain_rows": p_ydot,
                "library_rows": {f: v["library_ms"] for f, v in e_rows.items()}}
    g_rows = rows["ov"]
    g_common = {"route": "cuda", "replaces": "scripts/exp_overlap.py:82",
                "plain_ms": p_overlap["elem P=8"], "bound_ms": g["bound_ms"],
                "bound_by": g["bound_by"], "library_ms": g["library_ms"], "row": "elem P=8",
                "plain_rows": p_overlap,
                "library_rows": {r: v["library_ms"] for r, v in g_rows.items()}}
    entries = [
        {"name": "band_ydot", "source": src_file, "launches": launches["band_ydot"],
         "max_abs_err": err["band_ydot"], "ms": e["sync_ms"], **e_common,
         "rows": {f: v["sync_ms"] for f, v in e_rows.items()}},
        {"name": "band_ydot[ring]", "source": ring_file, "launches": launches["band_ydot[ring]"],
         "max_abs_err": err["band_ydot[ring]"], "ms": e["ring_ms"], **e_common,
         "rows": {f: v["ring_ms"] for f, v in e_rows.items()},
         "sync_ms": e["sync_ms"], "sync_rows": {f: v["sync_ms"] for f, v in e_rows.items()}},
        {"name": "overlap_dots", "source": src_file, "launches": launches["overlap_dots"],
         "max_abs_err": err["overlap_dots"], "ms": g["sync_ms"], **g_common,
         "rows": {r: v["sync_ms"] for r, v in g_rows.items()}},
        {"name": "overlap_dots[ring]", "source": ring_file,
         "launches": launches["overlap_dots[ring]"], "max_abs_err": err["overlap_dots[ring]"],
         "ms": g["ring_ms"], **g_common, "rows": {r: v["ring_ms"] for r, v in g_rows.items()},
         "sync_ms": g["sync_ms"], "sync_rows": {r: v["sync_ms"] for r, v in g_rows.items()}},
        {"name": "band_colsum", "route": "cuda", "source": src_file,
         "replaces": "scripts/exp_blocked_halo.py:82", "form": "grid",
         "launches": launches["band_colsum"], "max_abs_err": err["band_colsum"],
         "ms": h["grid_ms"], "plain_ms": p_colsum["element"], "bound_ms": h["bound_ms"],
         "bound_by": h["bound_by"], "library_ms": h["library_ms"],
         "library_rows": lib_colsum_rows, "row": "luma-like element",
         "rows": {r: v["grid_ms"] for r, v in hr.items()},
         "bound_rows": {r: v["bound_ms"] for r, v in hr.items()},
         "walk_ms": h["ms"], "plain_rows": {f"luma-like {v}": t for v, t in p_colsum.items()}},
        {"name": "band_colsum[walk]", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_colsum_walk.cu",
         "replaces": "scripts/exp_blocked_halo.py:82", "form": "walk",
         "launches": launches["band_colsum[walk]"], "max_abs_err": err["band_colsum[walk]"],
         "ms": h["ms"], "plain_ms": p_colsum["element"], "bound_ms": h["bound_ms"],
         "bound_by": h["bound_by"], "library_ms": h["library_ms"],
         "library_rows": lib_colsum_rows, "row": "luma-like element",
         "rows": {r: v["ms"] for r, v in hr.items()},
         "grid_rows": {r: v["grid_ms"] for r, v in hr.items()},
         "bound_rows": {r: v["bound_ms"] for r, v in hr.items()},
         "walks": {r: v["walk"] for r, v in hr.items()}, "grid_ms": h["grid_ms"],
         "plain_rows": {f"luma-like {v}": t for v, t in p_colsum.items()}},
    ]
    print(f"phase band fetch: {time.perf_counter() - t_phase!r} s")
    return entries


GEMM_REPS = {"xs": (1, 3, 64, 67, 512), "vx": (1, 3, 13, 24)}   # R/8, R and partial steps
WIDE_REPS = (1, 3, 24, 25)      # J's wide form: R/8, R, one past (thirds of 8, 8, 9)
S8_VARIANTS = ("s8_4dot", "s8_2dot_cat")
SLICE_SECOND_STEPS = 35    # L's wgmma form: a partial M tile and a partial last wave


def probe_turns(fns: dict, inputs) -> dict:
    """Each of ``fns`` timed twice under the probes' protocol (back-to-back
    calls on ``inputs``, ``_harness.launches_ms``), in the order given and
    then reversed (min of its two): {name: ms per call}."""
    return _harness.turns_ms({n: (f, inputs) for n, f in fns.items()})


def phase_xpass(card: str) -> list:
    """Phase 15, the X-pass and legality probes: kernels I-M == their plain
    versions at the TPU scripts' full shapes and full repeat counts in every
    variant (``bf16_1dot`` within its f32 summation bound; ``slice_groups``
    in both output forms); the five scripts' ``main()`` with every count set
    to 0 just before; plain times at the host's pace and library yardsticks.
    Then the gemm forms of ``f32_2dot`` and ``dense4`` (``exp_xpass_gemm.cu``)
    == plain at 1, 3, R/8 and R repeats (and == gold, or the library
    products, at one application), and ``bf16_1dot``'s within its bound of
    plain at the same repeats, timed in turns with the serial forms (bf16_1dot
    also with its bf16 ``torch.bmm``).  L in both forms, the ``wgmma`` form
    also at :data:`SLICE_SECOND_STEPS` steps.  ``s16_1dot``'s gemm form ==
    plain at the same repeats and at the int16 extremes, timed in turns with
    its serial form, a float64 ``torch.bmm`` and ``torch._int_mm``.
    ``s8_4dot``'s and ``s8_2dot_cat``'s gemm forms (``exp_xpass_s8.cu``) ==
    plain at the same repeats, with the script's zero ``corr`` and a nonzero one, at the byte extremes and on a walk of 7
    blocks (flushes cut at 64 steps), timed in turns with their serial forms,
    ``s16_1dot[gemm]`` and ``torch._int_mm`` of their dots.  J's wide forms
    of ``corr_f32`` and ``muls_f32`` (``exp_vpu_f32.cu``) == plain at
    :data:`WIDE_REPS`, at the int16 extremes and past 2^22, timed in turns
    with their serial forms; X3's cluster form == plain on ``arange`` and on
    float bits with NaN and -0.0 (as int32 views), timed inside
    ``ec.main()``; X2's split form == plain, its spill == its model, timed
    inside ``ec.main()`` in turns with its single-box form and
    ``src[128:160, :128].clone()``; X1's split form, 2-D and batch, == plain
    and its model, timed inside ``ec.main()`` in turns with its single-box
    form and the corner-gathering index.  Returns the seventeen entries of
    the kernels line."""
    from libiqo_tpu_torch.experiments import (_harness, exp_element_clamp as ec,
                                              exp_slice_align as sa, exp_vpu_rate as vr,
                                              exp_vpu_xpass as vx, exp_x_schemes as xs,
                                              vpu_f32, xpass_gemm)
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    names = ("xscheme_tile", "vpu_xpass_tile", "op_mix", "slice_groups", "window_probe")
    err = dict.fromkeys(names + ("xscheme_gemm", "vpu_xpass_gemm", "xscheme_bf16_gemm",
                                 "xscheme_s16_gemm", "slice_groups[wgmma]", "s8_4dot[gemm]",
                                 "s8_2dot_cat[gemm]", "window_probe[x3,cluster]",
                                 "window_probe[x2,boxes]", "window_probe[x1,boxes]",
                                 *(f"vpu_xpass_tile[{v},wide]" for v in vx.WIDE_VARIANTS)), 0.0)

    # 1. kernel == plain, every variant, full shapes and repeats
    w, c = xs.inputs(dev)
    for v in xs.VARIANTS:
        cv = xs.build_cvals(v, c)
        got, want = xs.x_scheme(v, w, cv, xs.R, "serial"), xs.x_scheme_plain(v, w, cv, xs.R)
        if v == "bf16_1dot":
            d = (got.to(torch.int64) - want.to(torch.int64)).abs().to(torch.float64)
            b = xs.bf16_bound(w, cv, xs.R)
            check(bool((d <= b).all()), f"x_scheme bf16_1dot: |kernel - plain| exceeds the f32 "
                  f"summation bound at {int((d > b).sum())} outputs")
            bf16_err, bf16_share = float(d.max()), float((d / b).max())
        else:
            err["xscheme_tile"] = max(err["xscheme_tile"], probe_err(f"x_scheme {v}", got, want))
    cv = xs.build_cvals("bf16_1dot", c)
    lsb = xs.lsb_error(xs.x_scheme("bf16_1dot", w, cv, 1, "serial"), xs.gold(w, c))
    lsb_plain = xs.lsb_error(xs.x_scheme_plain("bf16_1dot", w, cv, 1), xs.gold(w, c))
    print(f"x_scheme == plain in all {len(xs.VARIANTS)} variants at R={xs.R}, bit for bit but "
          f"bf16_1dot: max |kernel - plain| {bf16_err!r} over R={xs.R} ({bf16_share!r} of its "
          f"bound (K+1) 2^-24 sum|a c| per application); bf16_1dot against gold at R=1: kernel "
          f"{lsb[0]!r} LSB max, {lsb[1]!r} mean; plain (the f32 rounding of the exact sum) "
          f"{lsb_plain[0]!r} / {lsb_plain[1]!r}; the script in interpret mode 2.153 / 0.352")
    ops = vx.operands(dev)
    for v in vx.VARIANTS:
        err["vpu_xpass_tile"] = max(err["vpu_xpass_tile"], probe_err(
            f"vpu_xpass {v}", vx.vpu_xpass(v, ops, vx.R, "serial"),
            vx.vpu_xpass_plain(v, ops, vx.R)))
    print(f"vpu_xpass == plain in all {len(vx.VARIANTS)} variants at R={vx.R}, bit for bit")
    # J's wide forms: == plain at WIDE_REPS, at the int16 extremes (we, wo at
    # -32768 and 32767, r up to R) and with work values past 2^22, whose
    # warps take I2F (the NumPy model says which)
    we_x, wo_x = ops.we.clone(), ops.wo.clone()
    we_x[::2, ::3], wo_x[::2, 1::3] = -32768, 32767
    we_x[1::2, 1::3], wo_x[1::2, ::3] = 32767, -32768
    ops_ext = dataclasses.replace(ops, we=we_x, wo=wo_x)
    we_b, wo_b = ops.we.clone(), ops.wo.clone()
    we_b[7, 100], wo_b[90, 300], we_b[150, 5] = 2**22 + 5, -(2**28) - 3, -(2**22)
    ops_big = dataclasses.replace(ops, we=we_b, wo=wo_b)
    for v in vx.WIDE_VARIANTS:
        key = f"vpu_xpass_tile[{v},wide]"
        cases = [(f"R={r}", ops, r) for r in WIDE_REPS] + \
            [(f"R={r} at the int16 extremes", ops_ext, r) for r in (3, vx.R + 1)] + \
            [(f"R={r} past 2^22", ops_big, r) for r in (3, vx.R)]
        for tag, o, r in cases:
            err[key] = max(err[key], probe_err(f"vpu_xpass {v}[wide] {tag}",
                                               vx.vpu_xpass(v, o, r, "wide"),
                                               vx.vpu_xpass_plain(v, o, r)))
    _, paths = vpu_f32.model("corr_f32", we_b.cpu().numpy(), wo_b.cpu().numpy(), ops.taps, vx.R)
    check(not paths.all(), "the input past 2^22 sends no warp to I2F")
    print(f"corr_f32[wide], muls_f32[wide] == plain at R {WIDE_REPS}, at the int16 extremes "
          f"(R 3, {vx.R + 1}) and past 2^22 (R 3, {vx.R}; {int((~paths).sum())} of "
          f"{paths.size} warps on I2F), bit for bit")
    # the gemm forms (csrc/exp/exp_xpass_gemm.cu): == plain at 1, 3, R/8, R
    # and a partial last step; at one application I's also == gold
    cvf = xs.build_cvals("f32_2dot", c)
    for reps in GEMM_REPS["xs"]:
        err["xscheme_gemm"] = max(err["xscheme_gemm"], probe_err(
            f"x_scheme f32_2dot[gemm] R={reps}", xs.x_scheme("f32_2dot", w, cvf, reps, "gemm"),
            xs.x_scheme_plain("f32_2dot", w, cvf, reps)))
    check(torch.equal(xs.x_scheme("f32_2dot", w, cvf, 1, "gemm"), xs.gold(w, c)),
          "x_scheme f32_2dot[gemm] at R=1 != gold")
    # s16_1dot's gemm form (four s8 byte-plane products): == plain at the same
    # repeats, bit for bit, and == gold at one application
    cv16 = xs.build_cvals("s16_1dot", c)
    for reps in GEMM_REPS["xs"]:
        err["xscheme_s16_gemm"] = max(err["xscheme_s16_gemm"], probe_err(
            f"x_scheme s16_1dot[gemm] R={reps}", xs.x_scheme("s16_1dot", w, cv16, reps, "gemm"),
            xs.x_scheme_plain("s16_1dot", w, cv16, reps)))
    check(torch.equal(xs.x_scheme("s16_1dot", w, cv16, 1, "gemm"), xs.gold(w, c)),
          "x_scheme s16_1dot[gemm] at R=1 != gold")
    # ... and at the int16 extremes: work values at -32768 and 32767 and taps
    # at +-8192 in every byte combination, over repeats that wrap them
    w_ext = w.clone()
    w_ext[::2, ::3] = 32767
    w_ext[1::2, 1::3] = -32768
    c_ext = c.clone()
    nz = c_ext != 0
    ends = torch.tensor([8192, -8192, 8191, -8191, 255, -256, 129, -129], dtype=c.dtype,
                        device=dev)
    c_ext[nz] = ends[torch.arange(int(nz.sum()), device=dev) % len(ends)]
    cv_ext = xs.build_cvals("s16_1dot", c_ext)
    for reps in (3, 67):
        err["xscheme_s16_gemm"] = max(err["xscheme_s16_gemm"], probe_err(
            f"x_scheme s16_1dot[gemm] R={reps} at the int16 extremes",
            xs.x_scheme("s16_1dot", w_ext, cv_ext, reps, "gemm"),
            xs.x_scheme_plain("s16_1dot", w_ext, cv_ext, reps)))
    print(f"s16_1dot[gemm] == plain at R {GEMM_REPS['xs']} and at R 3, 67 on int16 extremes, "
          f"== gold at R=1, bit for bit")
    # the s8 variants' gemm forms: == plain at the same repeats with the script's zero corr and with a nonzero one, at the byte
    # extremes (work values past int16, taps whose e and f reach -128 and
    # 127), and on a walk of 7 blocks at R 600 (runs of 75 steps of a tile,
    # their flushes cut at 64)
    corr_nz = torch.from_numpy(np.random.default_rng(15).integers(
        -2**31, 2**31, (xs.N_G, xs.GN)).astype(np.int32)).to(dev)
    w_ext[::3, 1::5] = 2**20 + 129
    w_ext[1::3, 2::7] = -(2**20) - 257
    c_ext8 = c.clone()
    ends8 = torch.tensor([-32768, 32767, 127, 128, -129, 32639, -32641, 255], dtype=c.dtype,
                         device=dev)
    c_ext8[nz] = ends8[torch.arange(int(nz.sum()), device=dev) % len(ends8)]
    for v in S8_VARIANTS:
        cv8v = xs.build_cvals(v, c)
        for reps in GEMM_REPS["xs"]:
            for corr in (cv8v["corr"], corr_nz):
                cvr = {**cv8v, "corr": corr}
                err[f"{v}[gemm]"] = max(err[f"{v}[gemm]"], probe_err(
                    f"x_scheme {v}[gemm] R={reps}{' nonzero corr' if corr is corr_nz else ''}",
                    xs.x_scheme(v, w, cvr, reps, "gemm"), xs.x_scheme_plain(v, w, cvr, reps)))
        cve = {**xs.build_cvals(v, c_ext8), "corr": corr_nz}
        planes = (cve["e"], cve["f"]) if v == "s8_4dot" else (cve["ef"],)
        check(all(int(p.min()) == -128 and int(p.max()) == 127 for p in planes),
              f"{v}: the extreme taps miss -128 or 127")
        for reps in (3, 67):
            err[f"{v}[gemm]"] = max(err[f"{v}[gemm]"], probe_err(
                f"x_scheme {v}[gemm] R={reps} at the byte extremes",
                xs.x_scheme(v, w_ext, cve, reps), xs.x_scheme_plain(v, w_ext, cve, reps)))
        cvr = {**cv8v, "corr": corr_nz}
        cut = xpass_gemm.s8_launch(600, 7)
        err[f"{v}[gemm]"] = max(err[f"{v}[gemm]"], probe_err(
            f"x_scheme {v}[gemm] R=600 on a walk of 7 blocks",
            xs.s8_gemm_launch(v, w, cvr["ef_k"], corr_nz, cut), xs.x_scheme_plain(v, w, cvr, 600)))
    del w_ext
    walk8 = xpass_gemm.s8_launch(xs.R, xpass_gemm.sm_count(dev))
    print(f"s8_4dot[gemm], s8_2dot_cat[gemm] == plain at R {GEMM_REPS['xs']}, with zero and "
          f"nonzero corr, at R 3, 67 on the byte extremes and at R 600 on a walk of 7 blocks "
          f"(flushes cut at 64 steps), bit for bit")
    print(f"s8 gemm walk at R={xs.R}: {walk8.units} units on {walk8.blocks} blocks, wave "
          f"efficiency computed from the walk {walk8.wave_efficiency!r} ({walk8.sms} SMs)")
    # bf16_1dot's gemm form: the tensor cores sum in their own order, so it is
    # held within the f32 summation bound of its plain version (unchanged)
    bf16_gemm_share = 0.0
    for reps in GEMM_REPS["xs"]:
        got = xs.x_scheme("bf16_1dot", w, cv, reps, "gemm")
        d = (got.to(torch.int64) - xs.x_scheme_plain("bf16_1dot", w, cv, reps).to(torch.int64)) \
            .abs().to(torch.float64)
        b = xs.bf16_bound(w, cv, reps)
        check(bool((d <= b).all()), f"x_scheme bf16_1dot[gemm] R={reps}: |kernel - plain| exceeds "
              f"the f32 summation bound at {int((d > b).sum())} outputs, by up to "
              f"{float((d - b).max())!r}")
        err["xscheme_bf16_gemm"] = max(err["xscheme_bf16_gemm"], float(d.max()))
        bf16_gemm_share = max(bf16_gemm_share, float((d / b).max()))
    # ... also where a block's window reaches 2^24: those blocks take the
    # int32 path.  Work column 800 lies only in group 2's window, where no tap
    # reads it (its dots keep within int32, as the kernel's truncation needs),
    # so the first row tile's group-2 block takes that path, the others not
    w_wide = w.clone()
    w_wide[:16, 800] += 2**24
    for reps in (3, 67):
        got = xs.x_scheme("bf16_1dot", w_wide, cv, reps, "gemm")
        d = (got.to(torch.int64) - xs.x_scheme_plain("bf16_1dot", w_wide, cv, reps)
             .to(torch.int64)).abs().to(torch.float64)
        b = xs.bf16_bound(w_wide, cv, reps)
        check(bool((d <= b).all()), f"x_scheme bf16_1dot[gemm] R={reps}, window past 2^24: "
              f"|kernel - plain| exceeds the bound at {int((d > b).sum())} outputs")
        err["xscheme_bf16_gemm"] = max(err["xscheme_bf16_gemm"], float(d.max()))
        bf16_gemm_share = max(bf16_gemm_share, float((d / b).max()))
    del w_wide
    lsb_gemm = xs.lsb_error(xs.x_scheme("bf16_1dot", w, cv, 1, "gemm"), xs.gold(w, c))
    print(f"bf16_1dot[gemm] within its bound of plain at R {GEMM_REPS['xs']} (and at R 3, 67 "
          f"with a window past 2^24: the int32 path): max |kernel - "
          f"plain| {err['xscheme_bf16_gemm']!r}, {bf16_gemm_share!r} of the bound; against gold "
          f"at R=1: gemm {lsb_gemm[0]!r} LSB max, {lsb_gemm[1]!r} mean; the serial form "
          f"{lsb[0]!r} / {lsb[1]!r}; plain {lsb_plain[0]!r} / {lsb_plain[1]!r}; the script in "
          f"interpret mode 2.153 / 0.352")
    for reps in GEMM_REPS["vx"]:
        err["vpu_xpass_gemm"] = max(err["vpu_xpass_gemm"], probe_err(
            f"vpu_xpass dense4[gemm] R={reps}", vx.vpu_xpass("dense4", ops, reps, "gemm"),
            vx.vpu_xpass_plain("dense4", ops, reps)))
    print(f"f32_2dot[gemm] == plain at R {GEMM_REPS['xs']} and == gold at R=1; dense4[gemm] "
          f"== plain at R {GEMM_REPS['vx']}, bit for bit")
    src = vr.inputs(dev)
    for mix in vr.MIXES:
        for p in vr.PS:
            err["op_mix"] = max(err["op_mix"], probe_err(
                f"op_mix {mix} P={p}", vr.op_mix(src, mix, p), vr.op_mix_plain(src, mix, p)))
    print(f"op_mix == plain in all {len(vr.MIXES)} mixes x P {vr.PS} at {tuple(src.shape)}")
    sw, sops = sa.inputs(dev)
    # L in both forms; the wgmma form also at 35 steps: a partial M tile and
    # a partial last wave (540 tiles on the SMs)
    sw35 = torch.cat([sw, sw[:SLICE_SECOND_STEPS - sa.GRID].flip(2)])
    for align, kl in sa.CONFIGS:
        for ck in (False, True):
            for form, key in (("mma_sync", "slice_groups"), ("wgmma", "slice_groups[wgmma]")):
                err[key] = max(err[key], probe_err(
                    f"slice_groups[{form}] {align},{kl} check={ck}",
                    sa.slice_groups(sw, sops, align, kl, ck, form),
                    sa.slice_groups_plain(sw, sops, align, kl, ck)))
            err["slice_groups[wgmma]"] = max(err["slice_groups[wgmma]"], probe_err(
                f"slice_groups[wgmma] {align},{kl} check={ck} at {SLICE_SECOND_STEPS} steps",
                sa.slice_groups(sw35, sops, align, kl, ck, "wgmma"),
                sa.slice_groups_plain(sw35, sops, align, kl, ck)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"slice_groups == plain at {sa.CONFIGS} on {tuple(sw.shape)}, u8 and int32 sums, "
          f"both forms; the wgmma form also on {tuple(sw35.shape)}: "
          f"{sa.wgmma_tiles(SLICE_SECOND_STEPS)} tiles on {sms} SMs, wave efficiency "
          f"{sa.wave_efficiency(SLICE_SECOND_STEPS, sms)!r} (34 steps: "
          f"{sa.wave_efficiency(sa.GRID, sms)!r})")
    del sw35
    srcs = ec.inputs(dev)
    single_x1 = functools.partial(ec.window_x1, form="single")
    for row, fn, plain in (("x1", single_x1, ec.window_x1_plain),
                           ("x1_batch", single_x1, ec.window_x1_plain),
                           ("x2", functools.partial(ec.window_x2, form="single"),
                            ec.window_x2_plain),
                           ("x3", functools.partial(ec.window_x3, form="serial"),
                            ec.window_x3_plain)):
        err["window_probe"] = max(err["window_probe"], probe_err(
            f"window {row}", fn(srcs[row]), plain(srcs[row])))
    # X1's split form, 2-D and batch: == plain, == its model
    for row in ("x1", "x1_batch"):
        got = ec.window_x1(srcs[row], form="boxes")
        err["window_probe[x1,boxes]"] = max(
            probe_err(f"window_x1[boxes] {row}", got, ec.window_x1_plain(srcs[row])),
            probe_err(f"window_x1[boxes] {row} model", got.cpu(),
                      torch.from_numpy(ec.x1_model(srcs[row].cpu().numpy())[0])))
    # X2's split form: out == plain; spill rows inside == src, past the end 0
    spill = torch.full((ec.BAND_H, ec.BAND_W), -1, dtype=torch.int32, device=dev)
    got = ec.window_x2(srcs["x2"], spill, form="boxes")
    err["window_probe[x2,boxes]"] = max(
        probe_err("window_x2[boxes]", got, ec.window_x2_plain(srcs["x2"])),
        probe_err("window_x2[boxes] spill", spill.cpu(),
                  torch.from_numpy(ec.x2_model(srcs["x2"].cpu().numpy())[1])))
    # X3's cluster form: a copy keeps every bit, so compare int32 views, on
    # arange and on random bits with NaN and -0.0 patterns among them
    bits = torch.from_numpy(np.random.default_rng(16).integers(
        -2**31, 2**31, (ec.N_VAR, ec.A, ec.B)).astype(np.int32))
    bits.view(-1)[::97] = 0x7FC00001          # a quiet NaN with a payload
    bits.view(-1)[5::89] = -2**31             # -0.0
    bits.view(-1)[7::101] = 0x7F800001        # a signalling NaN
    for tag, var in (("arange", srcs["x3"]), ("random bits", bits.view(torch.float32).to(dev))):
        for form in ec.FORMS:
            got = ec.window_x3(var, form).view(torch.int32)
            want = ec.window_x3_plain(var).view(torch.int32)
            key = "window_probe[x3,cluster]" if form == "cluster" else "window_probe"
            err[key] = max(err[key], probe_err(f"window_x3[{form}] {tag}", got, want))
    print("window_x1 (both forms, 2-D and batch 3; the boxes == their model), window_x2 "
          "(both forms; the boxes' spill == its "
          "model: rows inside == src, past the end 0), window_x3 == plain; window_x3 "
          "[cluster] == plain, bit for bit as int32 views, on arange and on random bits with "
          "NaN and -0.0")

    # 2. the probes' main paths, every count set to 0 just before
    mods = (xs, vx, vr, sa, ec)
    for mod in mods:
        mod.reset_launches()
    rows = {"xs": xs.main(), "vx": vx.main(), "vr": vr.main(), "sa": sa.main(), "ec": ec.main()}
    torch.cuda.synchronize()
    launches = {n: mod.LAUNCHES.total() for n, mod in zip(names, mods)}
    launches["xscheme_tile"] = sum(xs.LAUNCHES[v] for v in xs.VARIANTS)
    launches["vpu_xpass_tile"] = sum(vx.LAUNCHES[v] for v in vx.VARIANTS)
    launches["xscheme_gemm"] = xs.LAUNCHES[xs.launch_key("f32_2dot", "gemm")]
    launches["xscheme_bf16_gemm"] = xs.LAUNCHES[xs.launch_key("bf16_1dot", "gemm")]
    launches["xscheme_s16_gemm"] = xs.LAUNCHES[xs.launch_key("s16_1dot", "gemm")]
    for v in S8_VARIANTS:
        launches[f"{v}[gemm]"] = xs.LAUNCHES[xs.launch_key(v, "gemm")]
    launches["vpu_xpass_gemm"] = vx.LAUNCHES[vx.launch_key("dense4", "gemm")]
    for v in vx.WIDE_VARIANTS:
        launches[f"vpu_xpass_tile[{v},wide]"] = vx.LAUNCHES[vx.launch_key(v, "wide")]
    launches["window_probe"] = sum(ec.LAUNCHES[r] for r in ("x1", "x1_batch", "x2", "x3"))
    launches["window_probe[x3,cluster]"] = ec.LAUNCHES["x3[cluster]"]
    launches["window_probe[x2,boxes]"] = ec.LAUNCHES["x2[boxes]"]
    launches["window_probe[x1,boxes]"] = ec.LAUNCHES["x1[boxes]"] + ec.LAUNCHES["x1_batch[boxes]"]
    launches["slice_groups"] = sum(sa.LAUNCHES[sa.launch_key(a, kl, "mma_sync")]
                                   for a, kl in sa.CONFIGS)
    launches["slice_groups[wgmma]"] = sum(sa.LAUNCHES[sa.launch_key(a, kl, "wgmma")]
                                          for a, kl in sa.CONFIGS)
    idle = [f"{mod.__name__.rsplit('.', 1)[-1]}:{v}" for mod in mods
            for v, n in mod.LAUNCHES.items() if n == 0]
    check(not idle, f"X-pass probe variants never launched by main(): {idle}")
    bad = [r for r, v in rows["ec"].items() if r in ec.ROWS and not v["ok"]]
    check(not bad, f"window probes not OK: {bad}")
    past = rows["ec"]["x2_past_end"]
    check(past["all_zeros"] and past["inside_equal"], f"X2's spill: {past}")
    check(all(rows["xs"]["checks"][k] for k in ("f32_exact", "f32_exact_serial", "s16_exact",
                                                "s16_exact_serial")) and
          not rows["xs"]["checks"]["s8_4dot_gold"] and
          not rows["xs"]["checks"]["s8_4dot_gold_serial"] and
          rows["vx"]["checks"]["corr_i32_exact"],
          f"x_scheme / vpu_xpass checks: {rows['xs']['checks']} {rows['vx']['checks']}")
    print(f"X-pass main() runs -> launches {launches}; by variant " +
          " ".join(str(dict(mod.LAUNCHES)) for mod in mods))

    # 3. plain times, host-paced; library yardsticks under the kernels' own
    # protocol, each first held equal to the plain version's function
    def plain_ms(fn, x, n=2):
        return _harness.launches_ms(fn, _harness.perturbed(x, n), repeats=2, primed=False)

    cv8 = xs.build_cvals("s8_4dot", c)
    p_xs = plain_ms(lambda t: xs.x_scheme_plain("s8_4dot", t, cv8, xs.R), w)
    p_vx = _harness.launches_ms(lambda o: vx.vpu_xpass_plain("dense4", o, vx.R),
                                [ops.perturbed(i) for i in range(2)], repeats=2, primed=False)
    p_f32 = plain_ms(lambda t: xs.x_scheme_plain("f32_2dot", t, cvf, xs.R), w)
    p_bf16 = plain_ms(lambda t: xs.x_scheme_plain("bf16_1dot", t, cv, xs.R), w)
    p_s16 = plain_ms(lambda t: xs.x_scheme_plain("s16_1dot", t, cv16, xs.R), w)
    cvc = xs.build_cvals("s8_2dot_cat", c)
    p_s8 = {"s8_4dot": p_xs,
            "s8_2dot_cat": plain_ms(lambda t: xs.x_scheme_plain("s8_2dot_cat", t, cvc, xs.R), w)}
    p_vr = plain_ms(lambda t: vr.op_mix_plain(t, "epi", 8), src)
    p_sa = plain_ms(lambda t: sa.slice_groups_plain(t, sops, 128, 512), sw)
    p_ec = plain_ms(ec.window_x1_plain, srcs["x1"])
    p_x3 = plain_ms(ec.window_x3_plain, srcs["x3"])
    p_x2 = plain_ms(ec.window_x2_plain, srcs["x2"])
    p_wide = {v: _harness.launches_ms(lambda o, v=v: vx.vpu_xpass_plain(v, o, vx.R),
                                      [ops.perturbed(i) for i in range(2)], repeats=2,
                                      primed=False) for v in vx.WIDE_VARIANTS}
    print(f"plain ms, host-paced: x_scheme s8_4dot R={xs.R} {p_xs!r}, f32_2dot {p_f32!r}, "
          f"bf16_1dot {p_bf16!r}, s16_1dot {p_s16!r}; "
          f"vpu_xpass dense4 "
          f"R={vx.R} {p_vx!r}, corr_f32 {p_wide['corr_f32']!r}, muls_f32 "
          f"{p_wide['muls_f32']!r}; op_mix epi P=8 {p_vr!r}; slice_groups 128,512 {p_sa!r}; "
          f"window_x1 {p_ec!r}, window_x3 {p_x3!r}, window_x2 {p_x2!r} ({card})")

    # I: per group, the work planes of 64 applications stacked by rows over
    # the group's window, (64 x planes x 160, K); the s8 dots alone are
    # torch._int_mm of the a/b planes (M = 64 x 320) against [e | f]
    reps = xs.R // 8

    def window_rows(variant, t, dtype):
        planes = xs.split(variant, xs.repeats(t, 0, reps))
        return [torch.cat([p[..., k0:k1] for p in planes], dim=1).reshape(-1, xs.K)
                .to(dtype).contiguous() for k0, k1 in xs.WINDOWS]

    def s8_planes(t):
        return window_rows("s8_4dot", t, torch.int8)

    eft = [torch.cat([cv8["e"][g], cv8["f"][g]], dim=1).t().contiguous() for g in range(xs.N_G)]

    def lib_s8(planes):
        return [torch._int_mm(p, e.t()) for p, e in zip(planes, eft)]

    got = lib_s8(s8_planes(w))
    rec = torch.cat([(d[:xs.TH, :xs.GN].to(torch.int64) * 65536 +
                      (d[:xs.TH, xs.GN:] + d[xs.TH:2 * xs.TH, :xs.GN]).to(torch.int64) * 256 +
                      d[xs.TH:2 * xs.TH, xs.GN:].to(torch.int64)) for d in got], dim=1)
    check(torch.equal(_harness.wrap(rec, 32).to(torch.int32),
                      xs.x_scheme_plain("s8_4dot", w, cv8, 1)),
          "torch._int_mm over the stacked planes != x_scheme_plain s8_4dot")
    lib_xs = _harness.launches_ms(lib_s8, [s8_planes(t) for t in _harness.perturbed(w, 4)]) \
        * (xs.R // reps)
    # I f32_2dot: torch.bmm in float32 with TF32 off, the same exact dots
    torch.backends.cuda.matmul.allow_tf32 = False
    cf = xs.build_cvals("f32_2dot", c)["cf32"]

    def f32_planes(t):
        return torch.stack(window_rows("f32_2dot", t, torch.float32))

    fp = f32_planes(w)
    d = torch.bmm(fp, cf).to(torch.int64)[:, :2 * xs.TH]
    rec = torch.cat([d[g, :xs.TH] * 256 + d[g, xs.TH:] for g in range(xs.N_G)], dim=1)
    check(torch.equal(_harness.wrap(rec, 32).to(torch.int32),
                      xs.x_scheme_plain("f32_2dot", w, {"cf32": cf}, 1)),
          "torch.bmm f32 != x_scheme_plain f32_2dot")
    check(torch.equal(_harness.wrap(rec, 32).to(torch.int32),
                      xs.x_scheme("f32_2dot", w, cvf, 1, "gemm")),
          "x_scheme f32_2dot[gemm] at R=1 != the torch.bmm f32 products")
    lib_f32 = _harness.launches_ms(lambda t: torch.bmm(t, cf),
                                   [f32_planes(t) for t in _harness.perturbed(w, 4)]) \
        * (xs.R // reps)
    # I bf16_1dot: its dots as one bf16 torch.bmm with float32 output; the
    # sums' order is cuBLAS's, so it is held within bf16_1dot's bound
    cb = xs.build_cvals("bf16_1dot", c)["cbf"]

    def bf16_planes(t):
        return torch.stack(window_rows("bf16_1dot", t, torch.bfloat16))

    d = torch.bmm(bf16_planes(w), cb, out_dtype=torch.float32)[:, :xs.TH]
    got = torch.cat(list(d), dim=1).to(torch.int32)      # truncated: integer-valued sums
    want = xs.x_scheme_plain("bf16_1dot", w, {"cbf": cb}, 1)
    check(bool(((got.to(torch.int64) - want.to(torch.int64)).abs().to(torch.float64)
                <= xs.bf16_bound(w, {"cbf": cb}, 1)).all()),
          "torch.bmm bf16 outside bf16_1dot's bound from x_scheme_plain")
    # ... timed in turns with bf16_1dot's two forms at R and R / 8 (the
    # kernels on ITERS perturbed tiles, the library on 4 perturbed stacks)
    bf_planes = [bf16_planes(t) for t in _harness.perturbed(w, 4)]
    wsb = _harness.perturbed(w, xs.ITERS)
    tb = probe_turns({**{f"{form} {r}": functools.partial(
        lambda i, r, f: xs.x_scheme("bf16_1dot", wsb[i], cv, r, f), r=r, f=form)
        for form in ("gemm", "serial") for r in (xs.R, xs.R // 8)},
        "library": lambda i: torch.bmm(bf_planes[i % 4], cb, out_dtype=torch.float32)},
        list(range(xs.ITERS)))
    lib_bf16 = tb["library"] * (xs.R // reps)
    del bf_planes
    # I s16_1dot: one float64 torch.bmm over 64 applications' int16 planes
    # (exact: every |sum| < 384 x 2^15 x 2^13 < 2^53), rebuilt into the
    # function (the repeats summed, wrapped to int32) and held equal to the
    # plain version; timed in turns with s16_1dot's two forms at R and R / 8
    # and with torch._int_mm of 64 applications' four s8 byte-plane products
    # (s8_4dot's planes: the same products' count, not the same function)
    c64 = cv16["c16"].to(torch.float64)

    def s16_planes(t):
        return torch.stack([p.to(torch.float64) for p in window_rows("s16_1dot", t, torch.int16)])

    d = torch.bmm(s16_planes(w), c64).to(torch.int64).view(xs.N_G, reps, xs.TH, xs.GN)
    got = _harness.wrap(torch.cat(list(d.sum(1)), dim=1), 32).to(torch.int32)
    check(torch.equal(got, xs.x_scheme_plain("s16_1dot", w, cv16, reps)),
          "torch.bmm float64 over the int16 planes != x_scheme_plain s16_1dot")
    s16p = [s16_planes(t) for t in _harness.perturbed(w, 4)]
    s8p = [s8_planes(t) for t in _harness.perturbed(w, 4)]
    wss = _harness.perturbed(w, xs.ITERS)
    ts = probe_turns({**{f"{form} {r}": functools.partial(
        lambda i, r, f: xs.x_scheme("s16_1dot", wss[i], cv16, r, f), r=r, f=form)
        for form in ("gemm", "serial") for r in (xs.R, xs.R // 8)},
        "library": lambda i: torch.bmm(s16p[i % 4], c64),
        "int_mm": lambda i: lib_s8(s8p[i % 4])}, list(range(xs.ITERS)))
    lib_s16 = ts["library"] * (xs.R // reps)
    lib_s16_int_mm = ts["int_mm"] * (xs.R // reps)
    del s16p, s8p
    # I s8_4dot and s8_2dot_cat: torch._int_mm of their dots alone over 64
    # applications' a and b planes (each (64 x 160, 384) s8 a group), four
    # calls of N = 128 a group (a e, a f, b e, b f) for s8_4dot and two of N =
    # 256 against [e | f] for s8_2dot_cat, each rebuilt into the function and
    # held equal to the plain version; timed in turns with both gemm forms at
    # R and R / 8, their serial forms and s16_1dot[gemm]
    e_t = [cv8["e"][g].t().contiguous() for g in range(xs.N_G)]
    f_t = [cv8["f"][g].t().contiguous() for g in range(xs.N_G)]

    def ab_planes(t):
        a, b = xs.split("s8_4dot", xs.repeats(t, 0, reps))
        return [(a[..., k0:k1].reshape(-1, xs.K).to(torch.int8).contiguous(),
                 b[..., k0:k1].reshape(-1, xs.K).to(torch.int8).contiguous())
                for k0, k1 in xs.WINDOWS]

    def lib4(planes):
        return [(torch._int_mm(a, e.t()), torch._int_mm(a, f.t()), torch._int_mm(b, e.t()),
                 torch._int_mm(b, f.t())) for (a, b), e, f in zip(planes, e_t, f_t)]

    def lib2(planes):
        return [(torch._int_mm(a, ef.t()), torch._int_mm(b, ef.t()))
                for (a, b), ef in zip(planes, eft)]

    def rebuilt(ae, af, be, bf):
        s_ = [x.to(torch.int64).reshape(reps, xs.TH, xs.GN).sum(0) for x in (ae, af, be, bf)]
        return s_[0] * 65536 + (s_[1] + s_[2]) * 256 + s_[3]

    abp = ab_planes(w)
    want64 = xs.x_scheme_plain("s8_4dot", w, cv8, reps)
    got4 = torch.cat([rebuilt(*d) for d in lib4(abp)], dim=1)
    check(torch.equal(_harness.wrap(got4, 32).to(torch.int32), want64),
          "torch._int_mm, four calls of N = 128 a group, != x_scheme_plain s8_4dot")
    got2 = torch.cat([rebuilt(da[:, :xs.GN], da[:, xs.GN:], db[:, :xs.GN], db[:, xs.GN:])
                      for da, db in lib2(abp)], dim=1)
    check(torch.equal(_harness.wrap(got2, 32).to(torch.int32), want64),
          "torch._int_mm, two calls of N = 256 a group, != x_scheme_plain s8_2dot_cat")
    del abp
    abps = [ab_planes(t) for t in _harness.perturbed(w, 4)]
    ws8 = _harness.perturbed(w, xs.ITERS)
    cvs8 = {v: xs.build_cvals(v, c) for v in S8_VARIANTS}
    t8 = probe_turns({
        **{f"{v} {form} {r}": functools.partial(
            lambda i, v, r, f: xs.x_scheme(v, ws8[i], cvs8[v], r, f), v=v, r=r, f=form)
           for v in S8_VARIANTS for form in ("gemm", "serial") for r in (xs.R, xs.R // 8)},
        **{f"s16_1dot gemm {r}": functools.partial(
            lambda i, r: xs.x_scheme("s16_1dot", ws8[i], cv16, r, "gemm"), r=r)
           for r in (xs.R, xs.R // 8)},
        "int_mm4": lambda i: lib4(abps[i % 4]), "int_mm2": lambda i: lib2(abps[i % 4])},
        list(range(xs.ITERS)))
    del abps
    lib_s8v = {"s8_4dot": t8["int_mm4"] * (xs.R // reps),
              "s8_2dot_cat": t8["int_mm2"] * (xs.R // reps)}
    # the gemm and the serial form's times under gemm_entry's keys
    t8v = {v: {f"{form} {r}": t8[f"{v} {form} {r}"]
               for form in ("gemm", "serial") for r in (xs.R, xs.R // 8)} for v in S8_VARIANTS}
    # J dense4: the four bf16 dots of 24 applications as one product
    cx = torch.cat([ops.cxh, ops.cxl], dim=1)

    def dense_planes(o):
        hi, lo = vx.split_dense(o.wd, torch.arange(vx.R, device=dev))
        return torch.cat([hi, lo], dim=1).reshape(1, -1, vx.BAND).to(torch.bfloat16)

    dp = dense_planes(ops)
    s = torch.bmm(dp, cx[None], out_dtype=torch.float32)[0, :2 * vx.TH].to(torch.int64)
    rec = (s[:vx.TH, :vx.TW] + s[:vx.TH, vx.TW:]) * 256 + s[vx.TH:, :vx.TW] + s[vx.TH:, vx.TW:]
    check(torch.equal(_harness.wrap(rec, 32).to(torch.int32), vx.vpu_xpass_plain("dense4", ops, 1)),
          "torch.bmm(out_dtype=float32) != vpu_xpass_plain dense4")
    check(torch.equal(_harness.wrap(rec, 32).to(torch.int32),
                      vx.vpu_xpass("dense4", ops, 1, "gemm")),
          "vpu_xpass dense4[gemm] at R=1 != the bf16 torch.bmm products")
    lib_vx = _harness.launches_ms(lambda t: torch.bmm(t, cx[None], out_dtype=torch.float32),
                                  [dense_planes(ops.perturbed(i)) for i in range(4)])
    # K: the epi mix as a chain of int32 elementwise calls
    def lib_epi(x):
        v, acc = x.clone(), torch.zeros_like(x)
        for _ in range(8):
            m = torch.bitwise_right_shift(v + 32, 6)
            acc ^= (((m + 32768) & 65535) - 32768).clamp_(0, 255)
            v += 1
        return acc
    check(torch.equal(lib_epi(src), vr.op_mix_plain(src, "epi", 8)),
          "the int32 chain != op_mix_plain epi P=8")
    lib_vr = _harness.launches_ms(lib_epi, _harness.perturbed(src, vr.ITERS))
    # L: its dots as one bf16 torch.bmm with float32 out over the 45 windows
    # (3 planes x 15 groups) and as three (one a plane), both held equal to
    # the plain sums and timed in turns with both forms inside sa.main()
    lib_sa = {name: (r["library_ms"], r["library3_ms"]) for name, r in rows["sa"].items()}
    # M: one indexing call gathering the 16 corners, held equal to plain and
    # timed in turns with X1's two forms inside ec.main()
    lib_ec = rows["ec"]["x1"]["library_ms"]
    print(f"library: torch._int_mm of the s8 dots alone {lib_xs!r} ms per {xs.R} applications; "
          f"torch.bmm f32 (TF32 off) {lib_f32!r}; bf16_1dot's dots as one bf16 torch.bmm with "
          f"float32 out {lib_bf16!r}; dense4's dots as one bf16 torch.bmm with "
          f"float32 out {lib_vx!r} ms per {vx.R}; int32 epi chain {lib_vr!r}; slice dots as "
          f"(one, three) bf16 torch.bmm with float32 out {lib_sa!r}; corner gather {lib_ec!r} "
          f"({card})")

    # the gemm forms against PR 7's serial forms, in turns, at R and R / 8
    ti = probe_turns({f"{form} {reps}": functools.partial(
        lambda x, r, f: xs.x_scheme("f32_2dot", x, cvf, r, f), r=reps, f=form)
        for form in ("gemm", "serial") for reps in (xs.R, xs.R // 8)},
        _harness.perturbed(w, xs.ITERS))
    # J's gemm form computes whole steps of 8 repeats: R/8 = 3 costs it a step,
    # so it is also timed at one whole step
    j_step = xpass_gemm.DENSE4_GEMM.rep_step
    tj = probe_turns({f"{form} {reps}": functools.partial(
        lambda o, r, f: vx.vpu_xpass("dense4", o, r, f), r=reps, f=form)
        for form, reps in (("gemm", vx.R), ("gemm", vx.R // 8), ("gemm", j_step),
                           ("serial", vx.R), ("serial", vx.R // 8))},
        [ops.perturbed(i) for i in range(vx.ITERS)])
    j_whole = (tj[f"gemm {vx.R}"] - tj[f"gemm {j_step}"]) / (vx.R - j_step) * 1e3
    per_app = {}
    for tag, t, r_full in (("f32_2dot", ti, xs.R), ("bf16_1dot", tb, xs.R), ("s16_1dot", ts, xs.R),
                           ("dense4", tj, vx.R), ("s8_4dot", t8v["s8_4dot"], xs.R),
                           ("s8_2dot_cat", t8v["s8_2dot_cat"], xs.R)):
        for form in ("gemm", "serial"):
            hi_, lo_ = t[f"{form} {r_full}"], t[f"{form} {r_full // 8}"]
            per_app[tag, form] = ((hi_ - lo_) / (r_full - r_full // 8) * 1e3, hi_ / r_full * 1e3)
    lib_app = {"f32_2dot": lib_f32 / xs.R * 1e3, "bf16_1dot": lib_bf16 / xs.R * 1e3,
               "s16_1dot": lib_s16 / xs.R * 1e3, "dense4": lib_vx / vx.R * 1e3,
               **{v: lib_s8v[v] / xs.R * 1e3 for v in S8_VARIANTS}}
    for tag, variant_bound, r_full in (("f32_2dot", xs.bound("f32_2dot"), xs.R),
                                       ("bf16_1dot", xs.bound("bf16_1dot"), xs.R),
                                       ("s16_1dot", xs.bound("s16_1dot", form="gemm"), xs.R),
                                       ("dense4", vx.bound("dense4"), vx.R)):
        (gs, gr), (ss, sr) = per_app[tag, "gemm"], per_app[tag, "serial"]
        print(f"{tag}[gemm] in turns with PR 7's form: {gs!r} us/application (slope R={r_full} "
              f"to R/8), t(R)/R {gr!r}; serial form {ss!r} / {sr!r}; bound {variant_bound[2]!r}; "
              f"library {lib_app[tag]!r} us/application; gemm/library t(R)/R "
              f"{gr / lib_app[tag]!r}, slope {gs / lib_app[tag]!r} ({card})")
    print(f"dense4[gemm] slope between whole steps (R={vx.R} and {j_step}): {j_whole!r} "
          f"us/application ({card})")
    print(f"s16_1dot in turns: gemm t(R)/R {per_app['s16_1dot', 'gemm'][1]!r} us/application, "
          f"serial (IMAD) {per_app['s16_1dot', 'serial'][1]!r}, float64 torch.bmm "
          f"{lib_app['s16_1dot']!r}, torch._int_mm of four s8 byte-plane products "
          f"{lib_s16_int_mm / xs.R * 1e3!r}; bounds: four s8 products "
          f"{xs.bound('s16_1dot', form='gemm')[2]!r}, IMAD {xs.bound('s16_1dot')[2]!r} ({card})")
    per8 = {k: ((t8[f"{k} {xs.R}"] - t8[f"{k} {xs.R // 8}"]) / (xs.R - xs.R // 8) * 1e3,
                t8[f"{k} {xs.R}"] / xs.R * 1e3)
            for k in [f"{v} {form}" for v in S8_VARIANTS
                      for form in ("gemm", "serial")] + ["s16_1dot gemm"]}
    for k, (slope, at_r) in per8.items():
        print(f"s8 turns: {k}: t(R)/R {at_r!r} us/application, slope {slope!r} ({card})")
    print(f"s8 turns: torch._int_mm of the dots alone, four calls of N = 128 a group "
          f"{lib_app['s8_4dot']!r} us/application, two of N = 256 against [e | f] "
          f"{lib_app['s8_2dot_cat']!r}; bound {xs.bound('s8_4dot', form='gemm')[2]!r}; "
          f"s8_2dot_cat[gemm] / s8_4dot[gemm] t(R)/R "
          f"{per8['s8_2dot_cat gemm'][1] / per8['s8_4dot gemm'][1]!r} ({card})")

    # J's wide forms against their serial forms, in turns, at R and R / 8;
    # no one PyTorch call sums in the script's order (a conv1d differs once
    # the sums pass 2^24), so there is no library row
    tw = probe_turns({f"{v} {form} {r}": functools.partial(
        lambda o, v, r, f: vx.vpu_xpass(v, o, r, f), v=v, r=r, f=form)
        for v in vx.WIDE_VARIANTS for form in ("wide", "serial") for r in (vx.R, vx.R // 8)},
        [ops.perturbed(i) for i in range(vx.ITERS)])
    wide_app = {(v, form): ((tw[f"{v} {form} {vx.R}"] - tw[f"{v} {form} {vx.R // 8}"])
                            / (vx.R - vx.R // 8) * 1e3, tw[f"{v} {form} {vx.R}"] / vx.R * 1e3)
                for v in vx.WIDE_VARIANTS for form in ("wide", "serial")}
    for v in vx.WIDE_VARIANTS:
        (ws_, wr_), (ss_, sr_) = wide_app[v, "wide"], wide_app[v, "serial"]
        app_b = vx.bound(v)[2]
        print(f"{v}[wide] in turns with the serial form: {ws_!r} us/application (slope R={vx.R} "
              f"to R/8), t(R)/R {wr_!r}; serial form {ss_!r} / {sr_!r}; bound {app_b!r} "
              f"(wide at {app_b / ws_!r} of the bound's pace); library none ({card})")
    x3c, x2b = rows["ec"]["x3[cluster]"], rows["ec"]["x2[boxes]"]
    print(f"window_x3 [cluster] {x3c['ms'] * 1e3!r} us a launch, serial "
          f"{x3c['serial_ms'] * 1e3!r}, var.index_select(0, idx) "
          f"{x3c['library_ms'] * 1e3!r} in the same turns; X2 [boxes] "
          f"{rows['ec']['x2[boxes]']['ms'] * 1e3!r}, [single] {rows['ec']['x2']['ms'] * 1e3!r}, "
          f"src[128:160, :128].clone() {rows['ec']['x2']['library_ms'] * 1e3!r} in the same "
          f"turns; X1 [boxes] {rows['ec']['x1[boxes]']['ms'] * 1e3!r}, [single] "
          f"{rows['ec']['x1']['ms'] * 1e3!r}, corner index {lib_ec * 1e3!r}; X1 batch [boxes] "
          f"{rows['ec']['x1_batch[boxes]']['ms'] * 1e3!r}, [single] "
          f"{rows['ec']['x1_batch']['ms'] * 1e3!r}, index over the batch "
          f"{rows['ec']['x1_batch']['library_ms'] * 1e3!r} in the same turns ({card})")

    x, j, k, l_, m = (rows["xs"]["s8_4dot"], rows["vx"]["dense4"], rows["vr"]["epi P=8"],
                      rows["sa"]["k0%128, kl=512"], rows["ec"]["x1"])

    def gemm_entry(name, replaces, tag, key, t, r_full, mod, plain, lib):
        """A gemm form's entry: µs per application as the slope and as
        t(R)/R, beside PR 7's serial form timed in the same turns."""
        b_ms, by, app_us, _ = xs.bound(tag, form="gemm") if mod is xs else mod.bound(tag)
        (gs, gr), (ss, sr) = per_app[tag, "gemm"], per_app[tag, "serial"]
        return {"name": name, "route": "cuda",
                "source": "libiqo_tpu_torch/csrc/exp/exp_xpass_gemm.cu", "replaces": replaces,
                "launches": launches[key], "max_abs_err": err[key], "ms": t[f"gemm {r_full}"],
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": by, "library_ms": lib,
                "row": f"{tag} R={r_full}", "us_per_app": gs, "us_per_app_at_r": gr,
                "bound_us_per_app": app_us, "library_us_per_app": lib_app[tag],
                "ms_r8": t[f"gemm {r_full // 8}"], "serial_ms": t[f"serial {r_full}"],
                "serial_us_per_app": ss, "serial_us_per_app_at_r": sr}
    entries = [
        {"name": "xscheme_tile", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_xpass.cu",
         "replaces": "scripts/exp_x_schemes.py:156",
         "also_replaces": ["scripts/exp_x_schemes.py:230", "scripts/exp_x_schemes.py:248",
                           "scripts/exp_x_schemes.py:271"],
         "launches": launches["xscheme_tile"], "max_abs_err": err["xscheme_tile"],
         "bf16_1dot_max_abs_err": bf16_err, "bf16_1dot_bound_share": bf16_share,
         "bf16_1dot_lsb_vs_gold": lsb, "ms": x["ms"], "plain_ms": p_xs,
         "bound_ms": x["bound_ms"], "bound_by": x["bound_by"], "library_ms": lib_xs,
         "row": f"s8_4dot R={xs.R}", "f32_library_ms": lib_f32,
         "bf16_library_ms": lib_bf16,
         "us_per_app": {v: rows["xs"][v]["us_per_app"] for v in xs.VARIANTS},
         "rows": {v: rows["xs"][v]["ms"] for v in xs.VARIANTS}},
        {"name": "vpu_xpass_tile", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_xpass.cu",
         "replaces": "scripts/exp_vpu_xpass.py:156",
         "also_replaces": ["scripts/exp_vpu_xpass.py:191"],
         "launches": launches["vpu_xpass_tile"], "max_abs_err": err["vpu_xpass_tile"],
         "ms": j["ms"], "plain_ms": p_vx, "bound_ms": j["bound_ms"], "bound_by": j["bound_by"],
         "library_ms": lib_vx, "row": f"dense4 R={vx.R}",
         "us_per_app": {v: rows["vx"][v]["us_per_app"] for v in vx.VARIANTS},
         "rows": {v: rows["vx"][v]["ms"] for v in vx.VARIANTS}},
        {"name": "op_mix", "route": "cuda", "source": "libiqo_tpu_torch/csrc/exp/exp_vpu.cu",
         "replaces": "scripts/exp_vpu_rate.py:50",
         "launches": launches["op_mix"], "max_abs_err": err["op_mix"],
         "ms": k["ms"], "plain_ms": p_vr, "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": lib_vr, "row": "epi P=8",
         "rows": {r: v["ms"] for r, v in rows["vr"].items() if "P=" in r},
         "per_rep": {mx: rows["vr"][mx] for mx in vr.MIXES}},
        {"name": "slice_groups", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_slice.cu",
         "replaces": "scripts/exp_slice_align.py:56", "form": "mma_sync",
         "launches": launches["slice_groups"], "max_abs_err": err["slice_groups"],
         "ms": l_["ms_mma_sync"], "plain_ms": p_sa, "bound_ms": l_["bound_ms"],
         "bound_by": l_["bound_by"], "library_ms": l_["library_ms"],
         "library3_ms": l_["library3_ms"], "row": "k0%128, kl=512",
         "wgmma_ms": l_["ms"],
         "rows": {r: v["ms_mma_sync"] for r, v in rows["sa"].items()}},
        {"name": "slice_groups[wgmma]", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_slice_wgmma.cu",
         "replaces": "scripts/exp_slice_align.py:56", "form": "wgmma",
         "launches": launches["slice_groups[wgmma]"], "max_abs_err": err["slice_groups[wgmma]"],
         "ms": l_["ms"], "plain_ms": p_sa, "bound_ms": l_["bound_ms"],
         "bound_by": l_["bound_by"], "library_ms": l_["library_ms"],
         "library3_ms": l_["library3_ms"], "row": "k0%128, kl=512",
         "mma_sync_ms": l_["ms_mma_sync"], "second_steps": SLICE_SECOND_STEPS,
         "rows": {r: {k: v[k] for k in ("ms", "ms_mma_sync", "library_ms", "library3_ms",
                                        "bound_ms")} for r, v in rows["sa"].items()}},
        {"name": "window_probe", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_clamp.cu",
         "replaces": "scripts/exp_element_clamp.py:44",
         "also_replaces": ["scripts/exp_element_clamp.py:83", "scripts/exp_element_clamp.py:127"],
         "launches": launches["window_probe"], "max_abs_err": err["window_probe"],
         "ms": m["ms"], "plain_ms": p_ec, "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
         "library_ms": lib_ec, "row": "x1",
         "rows": {r: v["ms"] for r, v in rows["ec"].items() if r in ec.ROWS},
         "row_library_ms": {r: rows["ec"][r]["library_ms"]
                            for r in ("x1", "x1_batch", "x2", "x3")},
         "x2_past_end_zeros": rows["ec"]["x2_past_end"]["all_zeros"]},
        {"name": "window_probe[x1,boxes]", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_clamp.cu",
         "replaces": "scripts/exp_element_clamp.py:44",
         "launches": launches["window_probe[x1,boxes]"],
         "max_abs_err": err["window_probe[x1,boxes]"], "ms": rows["ec"]["x1[boxes]"]["ms"],
         "plain_ms": p_ec, "bound_ms": rows["ec"]["x1[boxes]"]["bound_ms"],
         "bound_by": rows["ec"]["x1[boxes]"]["bound_by"], "library_ms": lib_ec, "row": "x1",
         "library_call": "src.view(-1)[flat], the corner-gathering index, timed in the same "
                         "turns; over the batch src.view(B, -1)[:, flat]",
         "single_ms": rows["ec"]["x1"]["ms"],
         "batch": {k: rows["ec"]["x1_batch[boxes]"][k]
                   for k in ("ms", "single_ms", "library_ms", "bound_ms")}},
        {"name": "window_probe[x3,cluster]", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_clamp.cu",
         "replaces": "scripts/exp_element_clamp.py:127",
         "launches": launches["window_probe[x3,cluster]"],
         "max_abs_err": err["window_probe[x3,cluster]"], "ms": x3c["ms"], "plain_ms": p_x3,
         "bound_ms": x3c["bound_ms"], "bound_by": x3c["bound_by"],
         "library_ms": x3c["library_ms"], "row": "x3",
         "library_call": "var.index_select(0, idx), idx = [0, 1, 1, 2] on the card, "
                         "timed in the same turns",
         "serial_ms": x3c["serial_ms"]},
        {"name": "window_probe[x2,boxes]", "route": "cuda",
         "source": "libiqo_tpu_torch/csrc/exp/exp_clamp.cu",
         "replaces": "scripts/exp_element_clamp.py:83",
         "launches": launches["window_probe[x2,boxes]"],
         "max_abs_err": err["window_probe[x2,boxes]"], "ms": x2b["ms"], "plain_ms": p_x2,
         "bound_ms": x2b["bound_ms"], "bound_by": x2b["bound_by"],
         "library_ms": x2b["library_ms"], "row": "x2",
         "library_call": "src[128:160, :128].clone(), timed in the same turns",
         "single_ms": x2b["single_ms"]},
        *[{"name": f"vpu_xpass_tile[{v},wide]", "route": "cuda",
           "source": "libiqo_tpu_torch/csrc/exp/exp_vpu_f32.cu",
           "replaces": "scripts/exp_vpu_xpass.py:156",
           "launches": launches[f"vpu_xpass_tile[{v},wide]"],
           "max_abs_err": err[f"vpu_xpass_tile[{v},wide]"], "ms": tw[f"{v} wide {vx.R}"],
           "plain_ms": p_wide[v], "bound_ms": vx.bound(v)[0], "bound_by": vx.bound(v)[1],
           "library_ms": None,
           "library_none": "no one PyTorch call sums in the script's order; a conv1d "
                           "differs once the sums pass 2^24",
           "row": f"{v} R={vx.R}", "us_per_app": wide_app[v, "wide"][0],
           "us_per_app_at_r": wide_app[v, "wide"][1], "bound_us_per_app": vx.bound(v)[2],
           "ms_r8": tw[f"{v} wide {vx.R // 8}"], "serial_ms": tw[f"{v} serial {vx.R}"],
           "serial_us_per_app": wide_app[v, "serial"][0],
           "serial_us_per_app_at_r": wide_app[v, "serial"][1]}
          for v in vx.WIDE_VARIANTS],
        {**gemm_entry("xscheme_tile[f32_2dot,gemm]", "scripts/exp_x_schemes.py:156", "f32_2dot",
                      "xscheme_gemm", ti, xs.R, xs, p_f32, lib_f32),
         "also_replaces": ["scripts/exp_x_schemes.py:230"]},
        {**gemm_entry("vpu_xpass_tile[dense4,gemm]", "scripts/exp_vpu_xpass.py:156", "dense4",
                      "vpu_xpass_gemm", tj, vx.R, vx, p_vx, lib_vx),
         "us_per_app_whole_steps": j_whole, "ms_step": tj[f"gemm {j_step}"]},
        {**gemm_entry("xscheme_bf16_gemm", "scripts/exp_x_schemes.py:156", "bf16_1dot",
                      "xscheme_bf16_gemm", tb, xs.R, xs, p_bf16, lib_bf16),
         "also_replaces": ["scripts/exp_x_schemes.py:271"], "bound_share": bf16_gemm_share,
         "lsb_vs_gold": lsb_gemm, "serial_lsb_vs_gold": lsb,
         "library_in_turns": f"one bf16 torch.bmm(out_dtype=float32) over {reps} "
                             "applications' planes, timed in the same turns"},
        {**gemm_entry("xscheme_tile[s16_1dot,gemm]", "scripts/exp_x_schemes.py:156", "s16_1dot",
                      "xscheme_s16_gemm", ts, xs.R, xs, p_s16, lib_s16),
         "also_replaces": ["scripts/exp_x_schemes.py:248"],
         "serial_bound_us_per_app": xs.bound("s16_1dot")[2],
         "int_mm_ms": lib_s16_int_mm,
         "int_mm_us_per_app": lib_s16_int_mm / xs.R * 1e3,
         "library_in_turns": f"one float64 torch.bmm over {reps} applications' int16 planes, "
                             "timed in the same turns; int_mm_ms: torch._int_mm of the four s8 "
                             "byte-plane products (s8_4dot's planes), a yardstick"},
        *[{**gemm_entry(f"xscheme_tile[{v},gemm]", "scripts/exp_x_schemes.py:156", v,
                        f"{v}[gemm]", t8v[v], xs.R, xs, p_s8[v], lib_s8v[v]),
           "source": "libiqo_tpu_torch/csrc/exp/exp_xpass_s8.cu",
           "s16_1dot_gemm_ms": t8[f"s16_1dot gemm {xs.R}"],
           "library_call": ("torch._int_mm, four calls of N = 128 a group" if v == "s8_4dot" else
                            "torch._int_mm, two calls of N = 256 against [e | f] a group")
           + f", over {reps} applications' planes, timed in the same turns"}
          for v in S8_VARIANTS],
    ]
    print(f"phase xpass: {time.perf_counter() - t_phase!r} s")
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    from libiqo_tpu_torch import build_plan, yuv
    from libiqo_tpu_torch.cli import benchmark
    from libiqo_tpu_torch.golden import numpy_ref
    from libiqo_tpu_torch.ops import _build, cuda_resize
    from libiqo_tpu_torch.parallel import sharding
    from libiqo_tpu_torch.utils import device

    rng = np.random.default_rng(SEED)
    smi, name = phase_device(_build, device)
    err16 = phase_kernel_vs_plain(
        cuda_resize, build_plan, numpy_ref, rng, "wrap16",
        [("lanczos3", SRC_W, SRC_H, DST_W, DST_H)],
        [("lanczos px1-2 fuzz", lanczos_fuzz(rng)),
         ("lanczos px3-4", lanczos_px34(rng))])
    erru = phase_kernel_vs_plain(
        cuda_resize, build_plan, numpy_ref, rng, "u16", U16_FRAMES.values(),
        [("area/linear fuzz", area_linear_fuzz(rng))])
    phase_tpu_fuzz(cuda_resize, build_plan, numpy_ref, rng)
    wide = phase_card_check(cuda_resize, build_plan, smi)
    with tempfile.TemporaryDirectory() as tmp:
        launches16, e = phase_lanczos_path(cuda_resize, yuv, build_plan, rng,
                                           Path(tmp))
    MAX_ERR["wrap16_tiled"] = max(MAX_ERR["wrap16_tiled"], e)
    launchesu, e = phase_area_path(cuda_resize, yuv, build_plan, benchmark, rng)
    MAX_ERR["u16_tiled"] = max(MAX_ERR["u16_tiled"], e)
    thumbs = phase_thumbnail_path(cuda_resize, yuv, build_plan, rng, smi)
    executables = phase_executables(cuda_resize, yuv, np.random.default_rng(SEED + 5), smi)
    phase_benchmark_cli(smi)

    t16 = phase_times(cuda_resize, yuv, build_plan, rng, smi,
                      ("lanczos3", SRC_W, SRC_H, DST_W, DST_H))
    tu = [phase_times(cuda_resize, yuv, build_plan, rng, smi, f)
          for f in U16_FRAMES.values()][0]          # AREA_MAIN comes first

    rrng = np.random.default_rng(SEED + 2)
    rerr = phase_relaxed_vs_plain(cuda_resize, build_plan, numpy_ref, rrng)
    with tempfile.TemporaryDirectory() as tmp:
        launches16r, e = phase_lanczos_path(cuda_resize, yuv, build_plan, rrng,
                                            Path(tmp), "wrap16_relaxed_tiled")
    plain16r = max(rerr["wrap16_relaxed_tiled"][0], e)
    err16r = rerr["wrap16_relaxed_tiled"][1]
    launchesur, e = phase_area_path(cuda_resize, yuv, build_plan, benchmark,
                                    rrng, "u16_relaxed_tiled")
    plainur, errur = max(rerr["u16_relaxed_tiled"][0], e), rerr["u16_relaxed_tiled"][1]
    phase_benchmark_cli(smi, [["--cycles", "32", "--precision", "relaxed"],
                              ["--batch", "16", "--precision", "relaxed"]],
                        route="cuda-relaxed")
    t16r = phase_relaxed_times(cuda_resize, build_plan, rrng, smi,
                               ("lanczos3", SRC_W, SRC_H, DST_W, DST_H))
    tur = phase_relaxed_times(cuda_resize, build_plan, rrng, smi, AREA_MAIN)
    phase_px4_time(cuda_resize, build_plan, rrng, smi)
    phase_bench_modules(cuda_resize)

    sharded = phase_sharded(cuda_resize, sharding, build_plan, numpy_ref,
                            np.random.default_rng(SEED + 3), smi)
    os.environ["LIBIQO_TPU_CARRY"] = "1"          # the opt-in, from here on
    carry = phase_carry(cuda_resize, yuv, build_plan, numpy_ref,
                        np.random.default_rng(SEED + 4), smi)
    probes = phase_probes(smi)
    band_fetch = phase_band_fetch(smi)
    xpass = phase_xpass(smi)

    src = "libiqo_tpu_torch/csrc/resize_fused.cu"
    tiled_src = "libiqo_tpu_torch/csrc/resize_tiled.cuh"

    def wide_entry(wide, v, name, plan):
        """The wide-window kernel's entry ``name`` for instantiation ``v``:
        its launches on the facade's paths (phase 3b's and the thumbnail
        route's), its times on ``plan`` beside the walk's (and for the s8 Y
        form the scalar form's at its layout, in the same turns), every
        plan it took in phase 3b and the thumbnail frames it ran."""
        mine = [r for r in wide["rows"] if r["variant"] == v]
        t = next(r for r in mine if r["plan"] == plan)
        keys = ("ms", "walk_ms", "route_ms", "route_variant", "plain_ms", "bound_ms",
                "layout", "scalar_ms", "scalar_layout")
        return {"name": name, "route": "cuda",
                "source": "libiqo_tpu_torch/csrc/resize_wide.cu", "replaces": replaces,
                "launches": wide["launches"][v] + thumbs["launches"].get(v, 0),
                "thumbnails": [r for r in thumbs["rows"] if r["luma_variant"] == v],
                "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None, "plan": plan,
                "walk_ms": t["walk_ms"], "layout": t["layout"],
                **{k: t[k] for k in ("scalar_ms", "scalar_layout") if k in t},
                "plans": {r["plan"]: {k: r[k] for k in keys if k in r} for r in mine}}

    def thumb_wide_entry(v, name, frame):
        """The wide-window kernel's entry ``name`` for instantiation ``v``
        where no phase 3b plan launches it: its launches on the thumbnail
        route (and phase 3b's, if any), its times on ``frame``'s luma plane
        beside the windowed twin's and the plain path's in the same turns,
        every thumbnail frame it ran."""
        mine = [r for r in thumbs["rows"] if r["luma_variant"] == v]
        t = next(r for r in mine if r["frame"] == frame)
        return {"name": name, "route": "cuda",
                "source": "libiqo_tpu_torch/csrc/resize_wide.cu", "replaces": replaces,
                "launches": thumbs["launches"][v] + wide["launches"].get(v, 0),
                "max_abs_err": MAX_ERR[v], "ms": t["ms"]["luma route"],
                "plain_ms": t["ms"]["luma plain"], "bound_ms": t["luma_bound_ms"],
                "bound_by": t["luma_bound_by"], "library_ms": None,
                "windowed_ms": t["ms"]["luma windowed"], "plan": frame + " luma",
                "thumbnails": mine}
    replaces = "libiqo_tpu/ops/pallas_resize.py:1687"
    replaces_relaxed = "libiqo_tpu/ops/pallas_resize.py:1486"

    def relaxed_wide_entry(v, frame):
        """The wide-window kernel's relaxed form ``v``: launches on the
        thumbnail route, times of ``frame``'s luma plane beside the windowed
        twin's in the same turns, every frame it ran."""
        mine = [r for r in thumbs["rows"] if r["luma_variant"] == v]
        t = next(r for r in mine if r["frame"] == frame)
        return {"name": f"resize_wide[{v.split('_')[0]},relaxed]", "route": "cuda",
                "source": "libiqo_tpu_torch/csrc/resize_wide.cu",
                "replaces": replaces_relaxed, "launches": thumbs["launches"][v],
                "max_abs_err": MAX_ERR[v], "max_lsb_vs_exact": LSB_VS_EXACT[v],
                "ms": t["ms"]["luma route"], "plain_ms": t["ms"]["luma plain"],
                "bound_ms": t["luma_bound_ms"], "bound_by": t["luma_bound_by"],
                "library_ms": None, "windowed_ms": t["ms"]["luma windowed"],
                "plan": frame + " luma", "frames": mine}

    def relaxed_entries(v, launches, plain_err, lsb, t):
        """The tiled relaxed form's entry (launches from its main path) and
        the windowed one's (launches from the thumbnail path, timed on the
        main frame in the same turns).  max_abs_err: against the relaxed
        plain version; max_lsb_vs_exact: against the exact output, the
        relaxed contract's <= 2 LSB."""
        common = {"route": "cuda", "replaces": replaces_relaxed,
                  "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                  "bound_by": t["bound_by"], "library_ms": None,
                  "exact_kernel_ms": t["exact_ms"], "exact_kernel": t["exact_kernel"]}
        twin_note = ("the windowed twin of the timing turns (tiled=False, wide=False): "
                     "every plan outside tiled_ok takes resize_wide; launches from "
                     "phase 5b's twin run")
        return [
            {"name": f"resize_tiled[{v},relaxed]", "source": tiled_src,
             "launches": launches, "max_abs_err": plain_err,
             "max_lsb_vs_exact": lsb, "ms": t["ms"], **common,
             "windowed_ms": t["windowed_ms"], "planes": t["planes"]},
            {"name": f"resize_fused[{v},relaxed]", "source": src,
             "was": "the relaxed route of every plan, then of the plans "
                    "outside tiled_ok(relaxed=True)", "now": twin_note,
             "launches": thumbs["twin"][f"{v}_relaxed"],
             "max_abs_err": MAX_ERR[f"{v}_relaxed"], "ms": t["windowed_ms"],
             **common, "tiled_relaxed_ms": t["ms"]}]

    print(json.dumps({"kernels": [
        # the main path's kernel: launches from the Lanczos and Area main
        # paths; fused_ms is the windowed resize_fused in the same call
        {"name": "resize_tiled[wrap16]", "route": "cuda", "source": tiled_src,
         "replaces": replaces, "launches": launches16,
         "max_abs_err": MAX_ERR["wrap16_tiled"], "ms": t16["ms"],
         "plain_ms": t16["plain_ms"], "bound_ms": t16["bound_ms"],
         "bound_by": t16["bound_by"], "library_ms": None,
         "fused_ms": t16["fused_ms"], "planes": t16["planes"],
         "executable": executables},
        {"name": "resize_tiled[u16]", "route": "cuda", "source": tiled_src,
         "replaces": replaces, "launches": launchesu,
         "max_abs_err": MAX_ERR["u16_tiled"], "ms": tu["ms"],
         "plain_ms": tu["plain_ms"], "bound_ms": tu["bound_ms"],
         "bound_by": tu["bound_by"], "library_ms": None,
         "fused_ms": tu["fused_ms"], "yardstick_ms": tu["yardstick_ms"],
         "planes": tu["planes"]},
        # the windowed kernel: the twin of the timing turns; launches from
        # phase 5b's twin run on the thumbnail frames' luma; ms timed on the
        # main frames, in turns; on a facade only where wide_layout refuses
        {"name": "resize_fused[wrap16]", "route": "cuda", "source": src,
         "replaces": replaces, "launches": thumbs["twin"]["wrap16"],
         "now": "the windowed twin (tiled=False, wide=False); a facade plan reaches it "
                "only where wide_layout refuses the plan",
         "max_abs_err": max(err16, MAX_ERR["wrap16"]), "ms": t16["fused_ms"],
         "plain_ms": t16["plain_ms"], "bound_ms": t16["bound_ms"],
         "bound_by": t16["bound_by"], "library_ms": None},
        {"name": "resize_fused[u16]", "route": "cuda", "source": src,
         "replaces": replaces, "launches": thumbs["twin"]["u16"],
         "now": "the windowed twin (tiled=False, wide=False); a facade plan reaches it "
                "only where wide_layout refuses the plan (refused_layout_plan)",
         "max_abs_err": max(erru, MAX_ERR["u16"]), "ms": tu["fused_ms"],
         "plain_ms": tu["plain_ms"], "bound_ms": tu["bound_ms"],
         "bound_by": tu["bound_by"], "library_ms": None,
         "yardstick_ms": tu["yardstick_ms"],
         "wide_window_walk_ms": {r["plan"]: r["walk_ms"] for r in wide["rows"]},
         "refused_layout_plan": wide["refused"]},
        # the wide-window kernel: launches from the facade on WIDE_FACADE and
        # the thumbnail route; ms on the largest phase 3b plan of its
        # instantiation, every plan under "plans"; the scalar wrap16 form,
        # which no phase 3b plan launches, on the 4K strips' luma
        wide_entry(wide, "u16_wide", "resize_wide[u16]", "area 7680x4320->240x135"),
        thumb_wide_entry("wrap16_wide", "resize_wide[wrap16]",
                         "lanczos3 3840x2160->1920x16 exact"),
        wide_entry(wide, "wrap16_wide_s8", "resize_wide[wrap16_s8]",
                   "lanczos3 7680x4320->240x135"),
        relaxed_wide_entry("wrap16_relaxed_wide", "lanczos3 3840x2160->256x144 relaxed"),
        relaxed_wide_entry("u16_relaxed_wide", "area 3840x2160->1920x16 relaxed"),
        *relaxed_entries("wrap16", launches16r, plain16r, err16r, t16r),
        *relaxed_entries("u16", launchesur, plainur, errur, tur),
        sharded["wrap16"], sharded["u16"],
        *(carry[v + suffix] for v in ("wrap16_carry", "u16_carry",
                                      "wrap16_relaxed_carry", "u16_relaxed_carry")
          for suffix in ("_tiled", "")),
        *probes, *band_fetch, *xpass]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))     # the one card driven
    return 0


if __name__ == "__main__":
    sys.exit(main())
