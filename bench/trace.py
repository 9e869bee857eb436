"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics and the ``breakdown`` read.

``device`` intervals are the kernels, copies and sets that ran on the card;
``spans`` are the benchmark's own host spans (``serve.Recorder``) on the
Unix clock of the profiler's timestamps; ``window`` is the traced part. An
idle gap is an interval of the window in which no device interval runs; it
is labelled by the innermost benchmark span (in ``LABELS`` order) that
covers at least half of it on some host thread, or ``other``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

LABELS = ("kb.call", "knn.interpolate", "engine.prefill", "engine.decode", "fleet.round")


@dataclass
class Trace:
    window: tuple                                    # (start_ns, end_ns)
    device: list = field(default_factory=list)       # (name, start_ns, end_ns)
    spans: list = field(default_factory=list)        # (label, thread, start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device intervals inside the window, sorted."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self) -> list:
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def device_time(self, *names) -> float:
        """Seconds of device intervals whose name holds any of ``names``."""
        return sum(e - s for n, s, e in self.device if any(x in n for x in names)) / 1e9

    def top_ops(self, n: int = 10) -> list:
        tot: dict = defaultdict(int)
        for name, s, e in self.device:
            tot[short(name)] += e - s
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]

    def idle_by_label(self, n: int = 10) -> list:
        """Idle seconds by what the host was doing, most first."""
        by: dict = defaultdict(int)
        spans = sorted(self.spans, key=lambda x: x[2])
        active, i = [], 0
        for gs, ge in self.gaps():
            while i < len(spans) and spans[i][2] < ge:
                active.append(spans[i])
                i += 1
            active = [sp for sp in active if sp[3] > gs]
            cover: dict = defaultdict(int)
            for label, _, s, e in active:
                if s < ge:
                    cover[label] += min(e, ge) - max(s, gs)
            half = [lb for lb in LABELS if cover.get(lb, 0) * 2 >= ge - gs]
            by[half[0] if half else "other"] += ge - gs
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its template arguments and parameter list."""
    if name.startswith("void "):
        name = name[5:]
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0] or [len(name)])
    return name[:cut][:width] if cut > 0 else name[:width]


def reduce(prof, window: tuple, spans: list) -> tuple:
    """-> (the traced part's Trace from a finished ``torch.profiler.profile``,
    the share of the host's kernel launches that fall inside a span: a check
    that the spans and the profiler share one clock)."""
    device, launches = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CPU":
            if e.name().startswith("cuLaunchKernel") or e.name().startswith("cudaLaunchKernel"):
                launches.append(e.start_ns())
        elif not e.is_user_annotation():
            device.append((e.name(), e.start_ns(), e.end_ns()))
    tr = Trace(window=window, device=device, spans=list(spans))
    iv = sorted((s, e) for _, _, s, e in spans)
    starts = [s for s, _ in iv]
    reach, inside = [], 0
    for s, e in iv:                       # reach[i]: the latest end among spans 0..i
        reach.append(max(e, reach[-1]) if reach else e)
    for t in launches:
        i = bisect.bisect_right(starts, t) - 1
        inside += i >= 0 and reach[i] >= t
    return tr, inside / len(launches) if launches else 0.0
