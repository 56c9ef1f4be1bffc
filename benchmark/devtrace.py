"""The device's busy time, its kernels and its idle gaps, from ``torch.profiler``.

The arithmetic of the engine's ``profile_paths.py`` (device time of the traced
window by kernel name, busy and idle share), kept here so that a change to the
engine cannot move it, with two changes: busy time is the union of the
device's kernel, copy and set intervals inside the window, so that nothing is
counted twice, and each idle gap is named by what the host was doing at its
middle. The window runs from the ``bench.window_open`` marker to the
``bench.window_close`` marker, both on the profiler's own clock.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import nullcontext
from typing import List, NamedTuple, Sequence, Tuple

import torch

#: The device activities that occupy the card.
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
OPEN, CLOSE = "bench.window_open", "bench.window_close"
#: The harness's own host annotations start with this.
ANNOTATION = "bench."
#: How far back from a gap's middle to look for the host op around it.
LOOKBACK = 256


class Span(NamedTuple):
    name: str
    start: int  # ns, profiler clock
    end: int


def _ns(ev, which: str) -> int:
    """An event's start or end in ns, across profiler versions."""
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    if which == "start":
        return int(ev.start_us() * 1000)
    return int((ev.start_us() + ev.duration_us()) * 1000)


def _is_work(ev, activities) -> bool:
    """Whether an event of the device is one of ``activities``. A profiler
    whose events do not name their activity leaves out only annotations,
    the harness's and any others."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() in activities
    note = getattr(ev, "is_user_annotation", None)
    return not ((note is not None and note())
                or ev.name().startswith(ANNOTATION))


class Tracer:
    """A profiler over part of a run: ``start()`` and ``stop()`` may be
    called from anywhere on the host thread that drives the device. On a
    CPU device (the tests) the host's ops stand for the device's work."""

    def __init__(self, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        self._cuda = torch.device(device).type == "cuda"
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self._prof.start()
        mark(OPEN)

    def stop(self) -> "Trace":
        mark(CLOSE)
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        if self._cuda:
            return Trace.from_events(events)
        return Trace.from_events(events, torch.autograd.DeviceType.CPU,
                                 ("cpu_op",))


def mark(name: str) -> None:
    """An instant annotation on the profiler's clock."""
    with torch.profiler.record_function(name):
        pass


def annotate(name: str, on: bool):
    """A host annotation of the traced window when ``on``, else nothing."""
    return torch.profiler.record_function(name) if on else nullcontext()


def merge(spans: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """Device and host spans of one traced window."""

    def __init__(self, window: Tuple[int, int], device: List[Span],
                 host: List[Span]):
        self.window = window
        lo, hi = window
        self.device = [Span(n, max(s, lo), min(e, hi)) for n, s, e in device
                       if e > lo and s < hi]
        self.host = sorted(host, key=lambda sp: sp.start)
        self._starts = [sp.start for sp in self.host]
        self.busy = merge([(s, e) for _, s, e in self.device])

    @classmethod
    def from_events(cls, events,
                    device_type=torch.autograd.DeviceType.CUDA,
                    activities=DEVICE_ACTIVITIES) -> "Trace":
        """Spans of the ``activities`` on ``device_type``, and every other
        host span, from the profiler's events."""
        cpu = torch.autograd.DeviceType.CPU
        device, host, marks = [], [], {}
        for ev in events:
            name, on = ev.name(), ev.device_type()
            start, end = _ns(ev, "start"), _ns(ev, "end")
            if name in (OPEN, CLOSE) and on == cpu:
                marks[name] = (start, end)
            elif on == device_type and _is_work(ev, activities):
                device.append(Span(name, start, end))
            elif on == cpu and end > start:
                host.append(Span(name, start, end))
        if OPEN not in marks or CLOSE not in marks:
            raise RuntimeError("the trace lacks its window markers")
        return cls((marks[OPEN][0], marks[CLOSE][1]), device, host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_s(self, names: Sequence[str]) -> float:
        """Device seconds of the spans whose name contains any of
        ``names``."""
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names)) / 1e9

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        """The device operations that took most time: [name, seconds]."""
        by = defaultdict(int)
        for n, s, e in self.device:
            by[n[:160]] += e - s
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns / 1e9] for n, ns in ranked]

    def _host_at(self, t: int) -> str:
        """What the host was doing at ``t``: the innermost harness
        annotation and the innermost op around it."""
        i = bisect.bisect_right(self._starts, t)
        op, note = None, None
        for sp in reversed(self.host[max(0, i - LOOKBACK):i]):
            if sp.end < t:
                continue
            if sp.name.startswith(ANNOTATION):
                note = note or sp.name
            else:
                op = op or sp.name
            if op and note:
                break
        return "/".join(x for x in (note, op or "no traced op") if x)

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The device's idle time in the window, summed by what the host was
        doing at the middle of each gap: [name, seconds], largest first."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        by = defaultdict(int)
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                by[self._host_at((s + e) // 2)[:160]] += e - s
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns / 1e9] for n, ns in ranked]


def kernel_names(folder) -> List[str]:
    """The kernel names a metric matches: one file per kernel in
    ``folder``, holding a substring of the profiler's name for it."""
    return sorted(p.read_text().strip() for p in folder.glob("*.txt"))
