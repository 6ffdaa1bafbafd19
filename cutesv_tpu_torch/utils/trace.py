"""Spans of one pipeline call, with their counters, on the profiler's
clock.

``pipeline.run_pipeline`` opens one :class:`Recorder` per call
(:func:`recording`); while it is active, :func:`span` records a named
interval with its counters. Each span holds its ``id`` (its index in the
call's list), ``name``, ``parent`` (the id of the span open on the same
thread when it began, or None), ``thread``, ``t0_ns`` and ``t1_ns`` from
:func:`time.time_ns` (the epoch clock that ``torch.profiler`` stamps its
events with, so spans line up with a profile's device operations) and
its ``counters``. The recorder's ``id`` is shared by every span of the
call. Spans go at stage, chromosome, cluster program, flush and launch
level, never per record or read, so recording stays on.

With no recorder active, :func:`span` does nothing: library functions
called outside a pipeline call (tools, tests) record nothing.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Iterable, List, Optional

_active: Optional["Recorder"] = None
_ids = itertools.count()


class Recorder:
    """The spans of one call, kept in memory."""

    def __init__(self):
        self.id = "%d.%d" % (os.getpid(), next(_ids))
        self.spans: List[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, t0_ns: int, counters: dict,
             thread: Optional[str] = None) -> dict:
        stack = self._stack()
        with self._lock:
            s = dict(id=len(self.spans), name=name,
                     parent=stack[-1]["id"] if stack else None,
                     thread=thread or threading.current_thread().name,
                     t0_ns=t0_ns, t1_ns=None, counters=counters)
            self.spans.append(s)
        return s

    def export(self) -> dict:
        """``{"id", "spans"}``: what a call returns as ``stats["trace"]``."""
        return dict(id=self.id, spans=self.spans)


@contextmanager
def recording():
    """Make a new :class:`Recorder` the active one for the block (the
    previous one, if any, is restored after it); yields the recorder."""
    global _active
    prev, rec = _active, Recorder()
    _active = rec
    try:
        yield rec
    finally:
        _active = prev


@contextmanager
def span(name: str, **counters):
    """Record the block as a span named ``name`` with ``counters``;
    yields the span's counter dict, which the block may add to. Does
    nothing (and yields a dict that is dropped) without a recorder."""
    rec = _active
    if rec is None:
        yield counters
        return
    s = rec.open(name, time.time_ns(), counters)
    stack = rec._stack()
    stack.append(s)
    try:
        yield counters
    finally:
        s["t1_ns"] = time.time_ns()
        stack.pop()


def add_span(name: str, t0_ns: int, t1_ns: int, thread: str,
             **counters) -> None:
    """Record a span measured elsewhere (the native decoder's record
    walk, on its own thread), as a child of the calling thread's
    innermost open span."""
    rec = _active
    if rec is not None:
        rec.open(name, int(t0_ns), counters, thread)["t1_ns"] = int(t1_ns)


def seconds(spans: Iterable[dict], name: str, **match) -> float:
    """Summed seconds of the closed spans named ``name`` whose counters
    hold every ``match`` item."""
    return sum(s["t1_ns"] - s["t0_ns"] for s in spans
               if s["name"] == name and s["t1_ns"] is not None
               and all(s["counters"].get(k, 0) == v
                       for k, v in match.items())) / 1e9


def merge_chrome_trace(trace: dict, path: str,
                       profile_path: Optional[str] = None) -> None:
    """Write ``trace``'s spans to ``path`` as chrome-trace events beside
    those of ``profile_path`` (a ``torch.profiler`` chrome trace) when
    given: complete events (``"ph": "X"``, category ``program_span``)
    on this process, one row per thread, counters as their ``args``."""
    doc = {"traceEvents": []}
    if profile_path is not None:
        with open(profile_path) as fh:
            doc = json.load(fh)
    # the profiler's timestamps are microseconds after its base time
    base_ns = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for s in trace["spans"]:
        if s["t1_ns"] is None:
            continue
        doc["traceEvents"].append(dict(
            ph="X", cat="program_span", name=s["name"], pid=pid,
            tid=s["thread"], ts=(s["t0_ns"] - base_ns) / 1e3,
            dur=(s["t1_ns"] - s["t0_ns"]) / 1e3,
            args=dict(s["counters"], id=s["id"], parent=s["parent"],
                      call=trace["id"])))
    with open(path, "w") as fh:
        json.dump(doc, fh)
