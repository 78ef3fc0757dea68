"""The port's own spans (``libiqo_tpu_torch.tracing``) read beside the
device trace of a traced window (``trace.py``), on the same host clock.

The traced window's kernels are mapped to frame calls and planes in stream
order: each ``port.launch`` record of the window says how many launches of
luma and then of chroma it issued, so the n-th kernel on the card is the
n-th launch issued.  Where the trace's kernel count differs from the
recorded launches the mapping, and all that rests on it, reads None.

An idle gap of the card whose next kernel had been issued (its
``port.launch`` had returned) before the gap's end is split there: the part
after the return is ``queued``, the card's own gap between launches it
already held; the part before it is starved, and goes under the innermost
span the host was in (the port's spans nest inside the harness's ``issue``
span), ``none`` where it was in none.  A gap with no kernel after it is
starved whole.  The launch's return stands for the issue of each kernel of
its C call, the latest it can have been.  A launch of a plane its site
could not know (``tracing.UNKNOWN_PLANE``) leaves the mapping None.

Six numbers, each None where its record is missing:

* ``facade_ms.batch``: self time of ``port.frame_call`` outside its
  ``port.launch``, mean per frame call of the traced window;
* ``launch_ms.batch``: ``port.launch``, mean per frame call;
* ``luma_roofline.batch``, ``chroma_roofline.batch``: frames x the plane's
  least time on the card (:func:`plane_bound_s`) over the union of the
  plane's kernel intervals;
* ``starved_pct.batch``: share of the traced window in which the card was
  idle before its next kernel was issued;
* ``port_setup_s``: union of the set-up recording's ``port.plan``,
  ``port.tables``, ``port.library`` and ``port.exec_create`` spans.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

from . import spec, work
from .stats import gaps, overlap, union_length
from .trace import Trace, label_at

LUMA, CHROMA = 0, 1
SETUP_SPANS = ("port.plan", "port.tables", "port.library", "port.exec_create")


def port_tracing():
    """The port's ``tracing`` module, or None for a port that has none."""
    try:
        return importlib.import_module("libiqo_tpu_torch.tracing")
    except ImportError:
        return None


def _even(v: int) -> int:
    return (v + 1) & ~1


def plane_bytes(cfg: dict, plane: int) -> int:
    """Bytes a frame's luma, or its U and V together, must move: the
    source read once and the output written once (``work.frame_bytes``
    split by plane)."""
    sw, sh, dw, dh = cfg["src_w"], cfg["src_h"], cfg["dst_w"], cfg["dst_h"]
    if plane == LUMA:
        return sw * sh + _even(dw) * _even(dh)
    return 2 * (_even(sw) // 2) * (_even(sh) // 2) + 2 * (_even(dw) // 2) * (_even(dh) // 2)


def plane_ops(cfg: dict, plane: int) -> int:
    """A multiply and an add for each tap the reference applies to luma,
    or to U and V (``Frame.luma``/``Frame.chroma`` ``macs()``)."""
    f = spec.reference(cfg["reference"]).Frame(cfg["method"], cfg["src_w"], cfg["src_h"],
                                               cfg["dst_w"], cfg["dst_h"])
    return 2 * (f.luma.macs() if plane == LUMA else 2 * f.chroma.macs())


def plane_bound_s(cfg: dict, kind: str, plane: int) -> float | None:
    """Least seconds a frame's plane can take on a card of this kind,
    bytes or operations, whichever is longer; None for a card with no
    peaks."""
    p = work.peaks(kind)
    if p is None:
        return None
    return max(plane_bytes(cfg, plane) / p["hbm_bytes_per_s"],
               plane_ops(cfg, plane) / p["int8_ops_per_s"])


@dataclasses.dataclass
class PortTrace:
    """A traced window's device trace and the port's record of it."""
    trace: Trace
    calls: np.ndarray       # (n, 3) port.frame_call spans in the window: start, end, call
    launches: np.ndarray    # (m, 3) port.launch spans in the window
    planes: np.ndarray      # (m, 2) luma, chroma launches of each

    @classmethod
    def of(cls, trace: Trace, rec) -> "PortTrace":
        """The spans of recording ``rec`` that lie inside the traced window."""
        def inside(a):
            return (a[:, 0] >= trace.t0) & (a[:, 1] <= trace.t1)
        calls = rec.spans("port.frame_call")
        launches, planes = rec.spans("port.launch"), rec.launch_planes()
        keep = inside(launches)
        return cls(trace, calls[inside(calls)], launches[keep], planes[keep])

    def kernel_map(self):
        """(kernel intervals in start order, plane of each, the index in
        :attr:`launches` of the launch that issued each), or None where
        the trace holds no kernel or another number than were launched,
        or a launch's plane is unknown."""
        k = self.trace.kernels
        flat = self.planes.ravel()
        if not len(k) or (flat < 0).any() or len(k) != int(flat.sum()):
            return None
        order = np.argsort(k[:, 0], kind="stable")
        plane = np.repeat(np.tile([LUMA, CHROMA], len(self.planes)), flat)
        launch = np.repeat(np.repeat(np.arange(len(self.planes)), 2), flat)
        return k[order], plane, launch

    def plane_s(self, plane: int) -> float | None:
        m = self.kernel_map()
        if m is None:
            return None
        kernels, planes, _ = m
        return union_length(kernels[planes == plane]) / 1e9

    def idle_split(self):
        """(queued, starved) idle intervals of the traced window, or None
        without the kernel map."""
        m = self.kernel_map()
        if m is None:
            return None
        kernels, _, launch = m
        t = self.trace
        idle = gaps(t.busy(), t.t0, t.t1)
        issued = np.full(len(idle), np.inf)
        i = np.searchsorted(kernels[:, 0], idle[:, 1], side="left")
        hit = i < len(kernels)
        hit[hit] = kernels[i[hit], 0] == idle[hit, 1]
        issued[hit] = self.launches[launch[i[hit]], 1]
        cut = np.clip(issued, idle[:, 0], idle[:, 1])
        queued = np.stack([cut, idle[:, 1]], axis=1)
        starved = np.stack([idle[:, 0], cut], axis=1)
        return queued[queued[:, 1] > queued[:, 0]], starved[starved[:, 1] > starved[:, 0]]

    def host_labels(self) -> list[tuple[str, np.ndarray]]:
        """(label, (n, 2) host intervals), innermost first: the port's
        launch, then its frame call, then the harness's spans."""
        rows = [("port.launch", self.launches[:, :2].astype(np.float64)),
                ("port.frame_call", self.calls[:, :2].astype(np.float64))]
        return rows + [(label, self.trace.spans.array(label))
                       for label in self.trace.spans.by_label]

    def idle_gaps(self, top: int = 10) -> list | None:
        """``Trace.idle_gaps`` with its idle split: ``queued``, then the
        starved time under the innermost host span, longest first, then
        the longest single gap as ``longest:<label>`` (the harness's
        label, as ``Trace.idle_gaps``); None without the kernel map.  A
        label takes the starved time its spans cover and no inner label's
        spans cover: the growth of the starved time under the union of
        the spans of it and of every label inside it."""
        split = self.idle_split()
        if split is None:
            return None
        queued, starved = split
        rows = [["queued", union_length(queued) / 1e9]]
        inner, under = np.empty((0, 2)), 0.0
        for label, spans in self.host_labels():
            inner = np.concatenate([inner, spans])
            now = overlap(starved, inner)
            rows.append([label, (now - under) / 1e9])
            under = now
        rows.append(["none", (union_length(starved) - under) / 1e9])
        rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])[:top - 1]
        t = self.trace
        idle = gaps(t.busy(), t.t0, t.t1)
        if len(idle):
            longest = idle[np.argmax(idle[:, 1] - idle[:, 0])]
            rows.append([f"longest:{label_at(t.spans, (longest[0] + longest[1]) / 2)}",
                         (longest[1] - longest[0]) / 1e9])
        return rows


def facade_ms(pt: PortTrace) -> float | None:
    if not len(pt.calls):
        return None
    mine = np.isin(pt.launches[:, 2], pt.calls[:, 2])
    launch = (pt.launches[mine, 1] - pt.launches[mine, 0]).sum()
    return float((pt.calls[:, 1] - pt.calls[:, 0]).sum() - launch) / len(pt.calls) / 1e6


def launch_ms(pt: PortTrace) -> float | None:
    mine = np.isin(pt.launches[:, 2], pt.calls[:, 2])
    if not mine.any():
        return None
    return float((pt.launches[mine, 1] - pt.launches[mine, 0]).sum()) / len(pt.calls) / 1e6


def plane_roofline_pct(pt: PortTrace, cfg: dict, kind: str, plane: int) -> float | None:
    s = pt.plane_s(plane)
    bound = plane_bound_s(cfg, kind, plane)
    if not s or bound is None or not pt.trace.frames:
        return None
    return 100.0 * pt.trace.frames * bound / s


def starved_pct(pt: PortTrace) -> float | None:
    split = pt.idle_split()
    if split is None or pt.trace.window_s <= 0:
        return None
    return 100.0 * union_length(split[1]) / 1e9 / pt.trace.window_s


def port_setup_s(rec) -> float | None:
    if rec is None:
        return None
    rows = [rec.spans(name)[:, :2] for name in SETUP_SPANS]
    return union_length(np.concatenate(rows).astype(np.float64)) / 1e9


def metrics(pt: PortTrace | None, setup_rec, cfg: dict, kind: str) -> dict:
    """The six numbers by name, those that read something."""
    values = {"port_setup_s": port_setup_s(setup_rec)}
    if pt is not None:
        values.update({
            "facade_ms.batch": facade_ms(pt), "launch_ms.batch": launch_ms(pt),
            "luma_roofline.batch": plane_roofline_pct(pt, cfg, kind, LUMA),
            "chroma_roofline.batch": plane_roofline_pct(pt, cfg, kind, CHROMA),
            "starved_pct.batch": starved_pct(pt)})
    return {k: v for k, v in values.items() if v is not None}
