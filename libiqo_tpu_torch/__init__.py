"""libiqo_tpu_torch: the PyTorch / CUDA port of libiqo_tpu.

Lanczos, Area and Linear resampling of single-channel uint8 images,
byte-identical to the reference's Generic fixed-point implementations and
to the JAX package ``libiqo_tpu``.  The port keeps its own copy of the host
layer (plans, coefficient tables, NumPy oracle) and imports nothing of the
JAX package.  On a CUDA device, the plans a hand-written Hopper kernel
(sm_90a) takes run it; every other plan runs the exact PyTorch path on the
data's device.  ``precision="relaxed"`` runs the kernel's relaxed form
(within 2 LSB, flat fields exact), as the JAX package's relaxed kernel.  Resizers run on the card unless ``device="cpu"`` is asked
for.  Imports ``torch``, never ``jax``.

Quick start::

    import numpy as np
    from libiqo_tpu_torch import LanczosResizer

    r = LanczosResizer(degree=3, src_w=3840, src_h=2160,
                       dst_w=1920, dst_h=1080)      # device="cuda"
    out = r.resize(np.zeros((2160, 3840), np.uint8))   # (1080, 1920) u8
"""

from .core.plan import ResizePlan, build_plan, plan_from_arrays

from .api import AreaResizer, LanczosResizer, LinearResizer, Resizer

__version__ = "0.4.0"

__all__ = [
    "AreaResizer",
    "LanczosResizer",
    "LinearResizer",
    "Resizer",
    "ResizePlan",
    "build_plan",
    "plan_from_arrays",
    "__version__",
]
