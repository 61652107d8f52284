"""Spans and counters of the port's host work, on the profiler's clock.

The rule: tracing is on exactly while a torch profiler records. Then
``span(name)`` is a ``torch.profiler.record_function`` (a
``user_annotation`` event in the Chrome trace, on the clock of the
device's events), and it adds its duration to an in-memory record: per
name, a count, the total time and the self time (the total less the time
its child spans on the same thread cover). ``count(name, n)`` adds to a
counter of the record. Off, ``span`` returns one shared
``contextlib.nullcontext()`` and ``count`` returns at once: nothing is
allocated and ``record_function`` is not entered.

The record holds what ran under every profiled block since the last
``reset()``; a process that profiles only its measured window reads that
window. The profiler that switches it is process-wide, and so is the
record. The gate reads a private flag of torch's
(``torch.autograd.profiler._is_profiler_enabled``, set by every profiler
on start and cleared on stop); ``tests/test_torch_tracing.py`` pins its
behaviour.

No span goes inside code a CUDA graph captures: a replay runs none of the
captured Python.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler

__all__ = ["count", "record", "reset", "span", "spanned"]

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_spans: Dict[str, List[int]] = {}   # name -> [count, total ns, self ns]
_counters: Dict[str, int] = {}
_open = threading.local()           # .stack: this thread's open spans


def span(name: str, **args):
    """A context manager around host work named ``name``; ``args`` (a
    request's sequence number, say) go to ``record_function`` as its
    argument string."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


def spanned(name: str):
    """A decorator: the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def record() -> Dict[str, Dict]:
    """``{"spans": {name: (count, total_s, self_s)}, "counters": {name:
    n}}`` since the last ``reset()``."""
    with _lock:
        return {"spans": {k: (c, t * 1e-9, s * 1e-9)
                          for k, (c, t, s) in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()


def _stack() -> List["_Span"]:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("name", "_rf", "_t0", "_child_ns")

    def __init__(self, name: str, args: Dict):
        self.name = name
        self._rf = torch.profiler.record_function(
            name, ", ".join(f"{k}={v}" for k, v in args.items()) or None)

    def __enter__(self):
        _stack().append(self)
        self._child_ns = 0
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        self._rf.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._child_ns += ns
        with _lock:
            s = _spans.setdefault(self.name, [0, 0, 0])
            s[0] += 1
            s[1] += ns
            s[2] += ns - self._child_ns
        return False
