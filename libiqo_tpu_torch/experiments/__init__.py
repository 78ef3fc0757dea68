"""The repository's TPU measurement scripts (``scripts/exp_*.py``) as probes of
one NVIDIA H100, each with a kernel written by hand for Hopper
(``libiqo_tpu_torch/csrc/exp/*.cu``) and its plain PyTorch version:

* ``exp_dma_ceiling``: streaming ceilings for u8 and i32 planes and a
  read-dominated fold (kernels ``stream_map`` and ``readsum``);
* ``exp_int8_mxu``: tensor-core products in f32 (TF32), bf16, s8 -> s32 and
  s8 -> f32 (kernel ``mma_steps``);
* ``exp_banded_dots``: the Y and X dots of a 4K Lanczos3 tile, monolithic,
  block-banded or skipped (kernel ``banded_tile``);
* ``exp_band_shape``: the Y pass of a 2:1 tile in seven launch forms, each
  adding one ingredient of the resize kernel's band fetch (kernel
  ``band_ydot``);
* ``exp_i32_band``: the same Y pass with its band fetched as bytes or as
  4-byte words unpacked in registers (``band_ydot``'s two load forms);
* ``exp_overlap``: whether the band fetch overlaps P s8 dots, with
  synchronous loads or a ``cp.async`` double buffer (kernel
  ``overlap_dots``);
* ``exp_blocked_halo``: one overlapping band window against a disjoint step
  plus a halo, on a column sum (kernel ``band_colsum``);
* ``exp_x_schemes``: the X pass of one resize work tile as four s8 dots, two
  f32 dots, an int32 IMAD dot (the substitute for an s16 product) or one bf16
  dot, repeated in the kernel (kernel ``xscheme_tile``);
* ``exp_vpu_xpass``: a 12-tap stride-2 correlation on CUDA cores against the
  dense X pass of four bf16 dots (kernel ``vpu_xpass_tile``);
* ``exp_vpu_rate``: the cost per element of the resize's elementwise op
  mixes, P repeats (kernel ``op_mix``);
* ``exp_slice_align``: 15 grouped Karatsuba bf16 dot triples per 4K row tile
  with K windows aligned to 128, 64 or 32 (kernel ``slice_groups``);
* ``exp_element_clamp``: clamped windows, a window past the array's end and a
  dynamic scratch index, as TMA boxes and a bulk copy (the window probes).

Each runs on the card as ``python -m libiqo_tpu_torch.experiments.<name>``
and raises without one.  None of it is on the resize path.
"""
