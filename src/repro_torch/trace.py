"""Spans of the port's serving path, on the clock of ``torch.profiler``'s
timestamps (``time.time_ns``, Unix ns), so a span lines up with the kernels
and copies of a device trace taken at the same time.

    with trace.span("engine.dispatch", live=3):
        ...

A finished span is a :class:`Span` ``(name, id, parent, thread, t0_ns,
t1_ns, attrs)``: ``parent`` is the id of the innermost span open on the same
thread when it began (0: none), unless the site names it (the verification
worker names the round that submitted its call); ``thread`` is the native
thread id; counts ride in ``attrs`` (``set`` adds to them before the span
ends).

Spans record while :func:`recording` is entered or a ``torch.profiler``
session is active (torch's own flag), so a profiled run gets the program's
spans beside its device timeline with nothing else turned on. Otherwise a
site costs one flag read and returns the shared no-op context :data:`OFF`:
no span is made, no clock read and nothing touches the device. The spans stay in
memory, at most :data:`CAP` of them (later ones are counted in
:func:`dropped`), until :func:`clear`.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

CAP = 1 << 20


class Span(NamedTuple):
    name: str
    id: int
    parent: int
    thread: int
    t0_ns: int
    t1_ns: int
    attrs: dict


class _Off:
    """The context every site gets while nothing records."""

    __slots__ = ()
    id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class _Thread(threading.local):
    """This thread's open spans and native id, read once: a
    ``get_native_id`` is a system call, which a container that intercepts
    system calls can make cost more than the rest of a span."""

    def __init__(self):
        self.stack: List[int] = []
        self.tid = threading.get_native_id()


_buf: List[Span] = []
_dropped = 0
_forced = 0
_ids = itertools.count(1)
_here = _Thread()
_lock = threading.Lock()


def on() -> bool:
    """Whether a span begun now records."""
    return _forced > 0 or _profiler._is_profiler_enabled


def _keep(sp: Span) -> None:
    global _dropped
    if len(_buf) < CAP:
        _buf.append(sp)
    else:
        with _lock:
            _dropped += 1


class _Open:
    __slots__ = ("name", "id", "parent", "t0", "attrs")

    def __init__(self, name: str, parent: Optional[int], attrs: dict):
        self.name, self.id, self.parent, self.attrs = name, next(_ids), parent, attrs

    def __enter__(self):
        st = _here.stack
        if self.parent is None:
            self.parent = st[-1] if st else 0
        st.append(self.id)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        here = _here
        st = here.stack
        if st and st[-1] == self.id:
            st.pop()
        elif self.id in st:
            st.remove(self.id)
        _keep(Span(self.name, self.id, self.parent, here.tid, self.t0, t1, self.attrs))
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


def span(name: str, parent: Optional[int] = None, **attrs):
    """A context manager timing its body as span ``name`` (the no-op
    :data:`OFF` while nothing records). ``parent`` names the parent span's
    id; by default it is the innermost open span of this thread."""
    if not (_forced or _profiler._is_profiler_enabled):
        return OFF
    return _Open(name, parent, attrs)


def record(name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
    """Keep a span whose ends were taken elsewhere (a request, from its
    admission to its finish), as a child of this thread's innermost open
    span; nothing while nothing records."""
    if not (_forced or _profiler._is_profiler_enabled):
        return
    here = _here
    _keep(Span(name, next(_ids), here.stack[-1] if here.stack else 0, here.tid,
               t0_ns, t1_ns, attrs))


@contextmanager
def recording(on: bool = True):
    """Record spans inside the block (``on=False``: leave it as it is)."""
    global _forced
    if not on:
        yield
        return
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def spans() -> List[Span]:
    """The spans kept so far, in the order they ended."""
    return list(_buf)


def dropped() -> int:
    """Spans not kept because the buffer held :data:`CAP`."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _buf.clear()
        _dropped = 0
