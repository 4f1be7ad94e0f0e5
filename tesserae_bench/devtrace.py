"""The traced window: ``torch.profiler`` over the card, read into device
busy time, device time by op name, and idle gaps named by the host span
open during them.

The profiler records the card's activity only (no host ops, so the host
path runs as it does untraced, less the Tracer's spans).  Its clock and the
host's are tied by two markers: a one-element fill launched on an idle card
at a known ``perf_counter`` reading before the window and another after
it, the trace's first and last device ops.  The Tracer's span times are
offsets from its epoch, which the window resets at a known reading too.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

from tesserae_bench import yardstick


class Window:
    """``torch.profiler`` over one window of the card's activity."""

    def __init__(self, obs=None):
        self.obs = obs
        self.prof = None
        self.t_mark = 0.0
        self.t_epoch = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t_mark = _mark()
        if self.obs is not None:
            a = time.perf_counter()
            self.obs.tracer.reset()
            self.t_epoch = 0.5 * (a + time.perf_counter())

    def stop(self, t0: float, t1: float) -> Optional[Dict]:
        """Busy and window seconds over [t0, t1] (host clock), device time by
        op name, and idle seconds by the innermost host span open."""
        from torch.autograd import DeviceType

        t_mark2 = _mark()
        self.prof.stop()
        dev = [e for e in self.prof.events() if e.device_type == DeviceType.CUDA]
        if len(dev) < 2:
            return None
        mark_us = min(e.time_range.start for e in dev)
        mark2_us = max(e.time_range.start for e in dev)
        rate = (mark2_us - mark_us) / ((t_mark2 - self.t_mark) * 1e6)

        def to_us(h: float) -> float:
            return (h - self.t_mark) * 1e6 * rate + mark_us

        lo, hi = to_us(t0), to_us(t1)
        intervals = [(e.time_range.start, e.time_range.end) for e in dev]
        busy = yardstick.union(intervals, lo, hi)
        by_name: Dict[str, float] = defaultdict(float)
        for e in dev:
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b > a:
                by_name[short_name(e.name)] += (b - a) * 1e-6
        roots = self.obs.tracer.roots() if self.obs is not None else []
        segs = [(to_us(self.t_epoch + a), to_us(self.t_epoch + b), name)
                for a, b, name in innermost(roots, (t0 - self.t_epoch, t1 - self.t_epoch))]
        idle_by_span: Dict[str, float] = defaultdict(float)
        for name, us in overlaps(yardstick.gaps(busy, lo, hi), segs):
            idle_by_span[name] += us * 1e-6
        return dict(
            busy_s=sum(b - a for a, b in busy) * 1e-6,
            window_s=(hi - lo) * 1e-6,
            kernel_s=dict(by_name),
            idle_by_span=dict(idle_by_span),
        )


def _mark() -> float:
    """Launch a one-element fill on an idle card; the host time it left."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    return t


def innermost(spans: List, within: tuple, outside: str = "no span") -> List[tuple]:
    """``within`` (seconds after the Tracer's epoch) cut into consecutive
    (start, end, name) pieces, each named by the innermost span open in
    it, or ``outside`` where none is."""
    lo, hi = within
    out, t = [], lo
    for sp in sorted(spans, key=lambda x: x.t0):
        a, b = max(sp.t0, lo), min(sp.t0 + sp.dur_s, hi)
        if b <= a:
            continue
        if a > t:
            out.append((t, a, outside))
        out.extend(innermost(sp.children, (a, b), sp.name))
        t = b
    if hi > t:
        out.append((t, hi, outside))
    return out


def overlaps(gaps: List[tuple], segs: List[tuple]):
    """(name, length) of every overlap of sorted gaps with sorted pieces."""
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            o = min(b, segs[k][1]) - max(a, segs[k][0])
            if o > 0:
                yield segs[k][2], o
            k += 1


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list, at most 80 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:80].strip()


def breakdown(info: Dict) -> Dict:
    """The ten device ops that took most time and the ten host spans under
    which the device idled longest, in seconds."""
    ops = sorted(info["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(info["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}
