"""The frames a cell resizes, made on the device from the seed.

Most frames are seeded random bytes, as the reference's benchmark fills its
planes (ref: benchmark/benchmark.cpp:51-59).  Every fourth frame is
structured instead, so that the comparison sees the flat-field and clamping
paths: a flat field, a hard vertical edge, a checkerboard or a hard
horizontal edge, between levels drawn from the seed (0 and 255 among them).
The pool is made in a few large calls on the device; a cell cycles through
it, so that its inputs together pass the card's L2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

STRUCTURED_EVERY = 4
LEVELS = (0, 255, 16, 235, 128)


@dataclasses.dataclass
class Pool:
    """n YUV420 frames: y (n, h, w), u and v (n, h/2, w/2), uint8."""
    y: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor

    def __len__(self) -> int:
        return self.y.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(p.numel() for p in (self.y, self.u, self.v))

    def batch(self, index: int, size: int):
        """The planes of frames index*size .. index*size + size - 1."""
        s = slice(index * size, (index + 1) * size)
        return self.y[s], self.u[s], self.v[s]

    def host(self, i: int):
        """Frame i's planes as NumPy arrays."""
        return tuple(p[i].cpu().numpy() for p in (self.y, self.u, self.v))


def _structured(kind: int, plane: torch.Tensor, rng: np.random.Generator) -> None:
    h, w = plane.shape
    lo, hi = rng.choice(LEVELS, 2, replace=False)
    if kind == 0:
        plane.fill_(int(rng.choice(LEVELS)))
        return
    rows = torch.arange(h, device=plane.device)[:, None]
    cols = torch.arange(w, device=plane.device)[None, :]
    if kind == 1:
        mask = (cols >= int(rng.integers(1, w))).expand(h, w)
    elif kind == 2:
        size = int(rng.choice((1, 2, 3, 8, 17)))
        mask = ((rows // size + cols // size) % 2).bool()
    else:
        mask = (rows >= int(rng.integers(1, h))).expand(h, w)
    plane.copy_(torch.where(mask, int(hi), int(lo)).to(torch.uint8))


def make(n: int, src_w: int, src_h: int, seed: int, device) -> Pool:
    """n frames of (src_w, src_h), chroma at half the evened size."""
    cw, ch = ((src_w + 1) & ~1) // 2, ((src_h + 1) & ~1) // 2
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    pool = Pool(*(torch.randint(0, 256, (n, h, w), generator=g, device=device,
                                dtype=torch.uint8)
                  for h, w in ((src_h, src_w), (ch, cw), (ch, cw))))
    rng = np.random.default_rng(seed % 2**63)
    for i in range(STRUCTURED_EVERY - 1, n, STRUCTURED_EVERY):
        kind = (i // STRUCTURED_EVERY) % 4
        for p in (pool.y, pool.u, pool.v):
            _structured(kind, p[i], rng)
    return pool
