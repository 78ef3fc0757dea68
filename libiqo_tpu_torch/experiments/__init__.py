"""The repository's TPU measurement scripts (``scripts/exp_*.py``) as probes of
one NVIDIA H100, each with a kernel written by hand for Hopper
(``libiqo_tpu_torch/csrc/exp/*.cu``) and its plain PyTorch version:

* ``exp_dma_ceiling``: streaming ceilings for u8 and i32 planes and a
  read-dominated fold (kernels ``stream_map`` and ``readsum``);
* ``exp_int8_mxu``: tensor-core products in f32 (TF32), bf16, s8 -> s32 and
  s8 -> f32 (kernel ``mma_steps``);
* ``exp_banded_dots``: the Y and X dots of a 4K Lanczos3 tile, monolithic,
  block-banded or skipped (kernel ``banded_tile``).

Each runs on the card as ``python -m libiqo_tpu_torch.experiments.<name>``
and raises without one.  None of it is on the resize path.
"""
