"""What one frame of a configuration must cost at least: the bytes it must
move, the operations it must do, and the least time the card's peaks allow.

Bytes: each source byte read once and each output byte written once, over
the three planes.  Operations: a multiply and an add for each tap that the
reference's two passes apply to a plane (the reference's ``Frame.macs``), counted
against the card's int8 rate.  Peaks: ``peaks.json`` by the card's name.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

from . import spec

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def _even(v: int) -> int:
    return (v + 1) & ~1


def frame_bytes(cfg: dict) -> int:
    sw, sh, dw, dh = cfg["src_w"], cfg["src_h"], cfg["dst_w"], cfg["dst_h"]
    chroma_in = 2 * (_even(sw) // 2) * (_even(sh) // 2)
    chroma_out = 2 * (_even(dw) // 2) * (_even(dh) // 2)
    return sw * sh + chroma_in + _even(dw) * _even(dh) + chroma_out


@functools.lru_cache(maxsize=None)
def _macs(reference: str, method: str, sw: int, sh: int, dw: int, dh: int) -> int:
    return spec.reference(reference).Frame(method, sw, sh, dw, dh).macs()


def frame_ops(cfg: dict) -> int:
    return 2 * _macs(cfg["reference"], cfg["method"], cfg["src_w"], cfg["src_h"],
                     cfg["dst_w"], cfg["dst_h"])


def peaks(kind: str) -> dict | None:
    return json.loads(PEAKS.read_text()).get(kind)


def frame_bound_s(cfg: dict, kind: str) -> tuple[float, str] | None:
    """(least seconds a frame can take on a card of this kind, "bytes" or
    "operations": whichever bounds it), or None for a card with no peaks."""
    p = peaks(kind)
    if p is None:
        return None
    by_bytes = frame_bytes(cfg) / p["hbm_bytes_per_s"]
    by_ops = frame_ops(cfg) / p["int8_ops_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
