"""The program's own spans (``repro_torch.trace``) of a traced run, as the
per-layer metrics read them.

The traced part runs under ``torch.profiler``, which turns the program's
tracer on by itself, so its spans share the clock of the device trace (Unix
ns). ``of`` keeps those that lie inside the traced part; where the program
has no tracer, or recorded nothing there, it gives None and the metric reads
nothing.
"""
from __future__ import annotations

from collections import defaultdict


def of(run):
    """-> the program's spans inside ``run.trace.window``, or None."""
    if run.trace is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    lo, hi = run.trace.window
    sp = [s for s in trace.spans() if s.t0_ns >= lo and s.t1_ns <= hi]
    return sp or None


def self_ns(spans, name: str) -> list:
    """Self time (ns) of each span called ``name``: its length less that of
    its children on its own thread."""
    by_id = {s.id: s for s in spans}
    inner: dict = defaultdict(int)
    for s in spans:
        p = by_id.get(s.parent)
        if p is not None and p.thread == s.thread:
            inner[p.id] += s.t1_ns - s.t0_ns
    return [s.t1_ns - s.t0_ns - inner[s.id] for s in spans if s.name == name]


def union(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def overlap_ns(a, b) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def intervals(spans, *names) -> list:
    """The union of the spans called any of ``names``."""
    return union((s.t0_ns, s.t1_ns) for s in spans if s.name in names)


def tokens(spans) -> int:
    """Tokens served by the requests of the traced part."""
    return sum(s.attrs.get("tokens", 0) for s in spans if s.name == "request")
