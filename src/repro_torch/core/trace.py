"""Spans and counters inside the program, kept where the work happens.

A *scope* names the table that spans add to: a program call opens one on
its context's ``HEContext.counters``, and so does ``HEContext.keygen``.
Inside a scope, ``span(name)`` adds three integers to the table when it
closes::

    <name>.ns       host nanoseconds (time.perf_counter_ns), nested spans
                    included
    <name>.calls    times the span closed
    <name>.h2d      host-to-device copies started inside it (``h2d()``),
                    nested spans included

Outside any scope a span records nothing, and ``h2d()`` counts nothing.
Keys stay flat integers beside the table's own, so a snapshot
(``dict(ctx.counters)``) and a difference of two snapshots keep working.

``h2d(n)`` is called at each site that builds a device tensor from host
data (a Python list, a numpy array, a CPU tensor), whether the device is
a GPU or, in the CPU tests, the CPU itself: the count is of the sites a
call passes, and on the GPU each is one ``Memcpy HtoD``.

Profiler ranges are off unless ``ranges()`` turns them on for a block.
Then each span also opens ``torch.profiler.record_function(name)``, whose
``args`` carry the index of the program call it belongs to, and
``stage(name)`` opens a program's stage range between two of its marks.
On a ``torch.profiler`` trace the program's layers then share the
profiler's clock with the device's work.  The profiler draws each such
range on the device's track too, as a CUDA-typed event; a reader that
counts device work has to leave those out, so the benchmark does not turn
ranges on.

State lives in context variables: each thread (and asyncio task) has its
own stack of scopes.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Optional

import torch


class _Scope:
    """One open scope: its table, the copy count it shares with the scopes
    around it, the program call's index and the open stage range."""

    __slots__ = ("table", "copies", "call", "stage")

    def __init__(self, table: dict, copies: list, call: Optional[int]):
        self.table, self.copies, self.call = table, copies, call
        self.stage = None


_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_trace_scope", default=None)
_RANGES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_trace_ranges", default=False)
_KEYS: dict = {}


def _keys(name: str) -> tuple:
    keys = _KEYS.get(name)
    if keys is None:
        keys = _KEYS[name] = (f"{name}.ns", f"{name}.calls", f"{name}.h2d")
    return keys


def _open_range(name: str, call: Optional[int]):
    rf = torch.profiler.record_function(
        name, None if call is None else f"call {call}")
    rf.__enter__()
    return rf


@contextlib.contextmanager
def scope(table: dict, call: Optional[int] = None):
    """Spans inside the block add to ``table``; ``call`` is the program
    call's index that profiler ranges carry (the enclosing scope's when
    None)."""
    outer = _SCOPE.get()
    s = _Scope(table, [0] if outer is None else outer.copies,
               call if call is not None or outer is None else outer.call)
    token = _SCOPE.set(s)
    try:
        yield
    finally:
        stage(None)
        _SCOPE.reset(token)


@contextlib.contextmanager
def ranges(on: bool = True):
    """Profiler ranges for spans and stages opened inside the block."""
    token = _RANGES.set(on)
    try:
        yield
    finally:
        _RANGES.reset(token)


def h2d(n: int = 1) -> None:
    """Count ``n`` host-to-device copies started here."""
    s = _SCOPE.get()
    if s is not None:
        s.copies[0] += n


def stage(name: Optional[str]) -> None:
    """Close the scope's open stage range, then, with ranges on, open
    ``name`` (None opens nothing).  The scope's end closes it too."""
    s = _SCOPE.get()
    if s is None:
        return
    if s.stage is not None:
        s.stage.__exit__(None, None, None)
        s.stage = None
    if name is not None and _RANGES.get():
        s.stage = _open_range(name, s.call)


class span:
    """``with span(name):`` times and counts the block into the active
    scope's table (nothing outside a scope)."""

    __slots__ = ("name", "scope", "rf", "t0", "c0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        s = self.scope = _SCOPE.get()
        if s is not None:
            self.rf = _open_range(self.name, s.call) if _RANGES.get() else None
            self.c0 = s.copies[0]
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        s = self.scope
        if s is None:
            return
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        t = s.table
        ns, calls, copies = _keys(self.name)
        t[ns] = t.get(ns, 0) + dt
        t[calls] = t.get(calls, 0) + 1
        t[copies] = t.get(copies, 0) + s.copies[0] - self.c0
