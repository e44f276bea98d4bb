"""The device trace of a measured window, reduced to what the metrics read.

``torch.profiler`` records the host's operations and the card's kernels,
copies and fills over the window (marked by a ``benchmark.window`` range).
The reduction gives the seconds in which some operation (a kernel, a copy
or a fill) ran on the device
(``busy_s``, the union of their intervals), the window's length, each device
operation's summed seconds by name, and the idle gaps between device
operations, each named by the program span and the host operation that
hold its middle (``span/operation``; ``harness`` and ``host`` where none
does).
"""

from __future__ import annotations

import bisect
import collections
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "benchmark.window"
_SCAN = 256  # intervals looked back at for a gap's name


@dataclass
class TraceSummary:
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: Dict[str, float] = field(default_factory=dict)  # name -> seconds
    idle_gaps: Dict[str, float] = field(default_factory=dict)  # host operation -> seconds

    def seconds(self, *marks: str) -> float:
        """Summed device seconds of the operations whose name holds any mark."""
        return sum(s for n, s in self.device_ops.items() if any(m in n for m in marks))

    def breakdown(self) -> Dict[str, List[List]]:
        top = sorted(self.device_ops.items(), key=lambda x: -x[1])[:10]
        gaps = sorted(self.idle_gaps.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


class WindowTrace:
    """``open()`` as the window opens and ``close()`` as it closes, then
    ``summarize(spans)``. Off, it records nothing and costs nothing."""

    def __init__(self, enabled: bool, cuda: bool = True) -> None:
        self.enabled = enabled
        self.cuda = cuda
        self.prof = None
        self.t_enter = 0.0

    def open(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=activities)
        self.prof.start()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        self.t_enter = time.perf_counter()

    def close(self) -> None:
        if not self.enabled:
            return
        import torch

        self._range.__exit__(None, None, None)
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()

    def summarize(self, spans: List[Tuple[float, float, str]]) -> TraceSummary:
        """The reduction; ``spans`` are the program's spans ``(start, end,
        name)`` on the host clock, which name the idle gaps they hold."""
        if self.prof is None:
            return TraceSummary()
        return reduce(self.prof.profiler.kineto_results.events(), spans, self.t_enter)


def _is_annotation(e) -> bool:
    """A range mirrored on the device timeline, not an operation."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _innermost(items: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """Of the (sorted) intervals that hold ``t``, the one that started last
    (the innermost of nested ones), looking back ``_SCAN`` intervals; else ""."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _SCAN, -1), -1):
        if items[j][1] >= t:
            return items[j][2]
    return ""


def reduce(events, spans=(), t_enter: float = 0.0) -> TraceSummary:
    """Kineto events -> :class:`TraceSummary` over the window range."""
    from torch.autograd import DeviceType

    host, dev = [], []
    ws = we = None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name != WINDOW and not _is_annotation(e):
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name == WINDOW:
            ws, we = e.start_ns(), e.start_ns() + e.duration_ns()
        else:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    s = TraceSummary()
    if ws is None:
        return s
    s.window_s = (we - ws) / 1e9
    ops: Dict[str, float] = collections.defaultdict(float)
    busy_iv = []
    for a, b, name in dev:
        a, b = max(a, ws), min(b, we)
        if b > a:
            ops[name] += (b - a) / 1e9
            busy_iv.append((a, b))
    s.device_ops = dict(ops)
    busy = _merge(busy_iv)
    s.busy_s = sum(b - a for a, b in busy) / 1e9
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host.sort()
    hstarts = [h[0] for h in host]
    prog = sorted((ws + int((a - t_enter) * 1e9), ws + int((b - t_enter) * 1e9), n) for a, b, n in spans)
    pstarts = [p[0] for p in prog]
    named: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        named[f"{_innermost(prog, pstarts, mid) or 'harness'}/{_innermost(host, hstarts, mid) or 'host'}"] += (b - a) / 1e9
    s.idle_gaps = dict(named)
    return s
