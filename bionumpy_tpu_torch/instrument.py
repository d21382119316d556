"""Spans and counters of the port's stages (the port's copy of
bionumpy_tpu/instrument.py, extended with nesting, call ids, counts,
device time and the profiler's trace).

    from bionumpy_tpu_torch import instrument
    with instrument.stage("pack") as span:
        words = ...
        span.bytes = words.nbytes      # counts may be set inside
    instrument.add("cap-rerun", 0.0)   # a counter without a span
    print(instrument.report())   # {"pack": {"seconds", "calls", ...}}
    instrument.spans()           # the most recent closed spans

A span measures host wall time.  Device work is asynchronous, so a
span around device work measures its enqueue unless the code inside
waits for the device; `device=True` adds its device time (below).

Nesting: each thread keeps a stack of its open spans.  A span's parent
is the innermost span open on its thread when it opened, and its self
time is its duration less its same-thread children's durations.

Calls: each public entry point of the port that reaches the card opens
a call span (`call_span`).  The outermost call span draws a new call
id, and every span opened under it carries that id, spans on the pool
threads the call hands work to included (`carried` binds a task to a
copy of the caller's context).  A worker's span is not subtracted from
the call's self time: it ran beside it.

Device time: a span opened with `device=True` while CUDA is initialised
records a pair of CUDA events on the current stream, at its entry and
at its exit.  The pair brackets the stream's time from the completion
of the work enqueued before the span (so from its first enqueued work)
to the completion of the last work the span enqueued, stream idle
inside the span included: a span whose host side is slower than its
device side reads the host's pace.  Pairs resolve lazily, by query(),
at later span entries and in report(); nothing synchronises for
tracing.  At most PENDING pairs wait; past that the oldest is dropped
and counted as `device_unresolved`.

The profiler's clock: while torch.profiler records, each span also
opens torch.autograd.profiler.record_function(<its name>), so it lands
in the chrome trace (category user_annotation) beside the kernels.
When no profiler records, no range is opened.

ENABLED = False makes every span and counter a no-op.  Accumulators and
the span log are shared by all threads, under a lock.
"""
from __future__ import annotations

import contextvars
import functools
import itertools
import threading
import time
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _prof

ENABLED = True
PENDING = 1024   # device event pairs awaiting resolution, at most
LOG = 65536      # closed spans kept for spans()

_lock = threading.Lock()
_times = defaultdict(float)
_self = defaultdict(float)
_calls = defaultdict(int)
_bytes = defaultdict(int)
_rows = defaultdict(int)
_device = defaultdict(float)
_unresolved = defaultdict(int)
_call_names = set()
_log = deque(maxlen=LOG)
_pending = deque()
_call_ids = itertools.count(1)
_call = contextvars.ContextVar("instrument_call", default=None)
_local = threading.local()


def _cuda_ready() -> bool:
    return torch.cuda.is_initialized()


def _new_event():
    return torch.cuda.Event(enable_timing=True)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One span: a context manager while open, a record once closed."""

    __slots__ = ("name", "call", "parent", "thread", "start", "end",
                 "bytes", "rows", "device_seconds", "_device", "_is_call",
                 "_child", "_events", "_range", "_token")

    def __init__(self, name: str, n_bytes: int = 0, rows: int = 0,
                 device: bool = False, call: bool = False):
        self.name = name
        self.bytes = n_bytes
        self.rows = rows
        self.device_seconds = None
        self._device = device
        self._is_call = call
        self._child = 0.0
        self._events = self._range = self._token = None

    def __enter__(self) -> "Span":
        if _pending:
            _resolve()
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        if self._is_call and _call.get() is None:
            self._token = _call.set(next(_call_ids))
        self.call = _call.get()
        self.thread = threading.get_ident()
        if _prof._is_profiler_enabled:
            self._range = _prof.record_function(self.name)
            self._range.__enter__()
        if self._device and _cuda_ready():
            self._events = (_new_event(), _new_event())
            self._events[0].record()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        if self._events is not None:
            self._events[1].record()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        duration = self.end - self.start
        if stack:
            stack[-1]._child += duration
        if self._token is not None:
            _call.reset(self._token)
            self._token = None
        _close(self, duration, duration - self._child)
        return False


class _Null:
    """What a span is when instrumentation is off: takes counts, keeps
    nothing."""

    __slots__ = ("bytes", "rows")

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


def stage(name: str, n_bytes: int = 0, rows: int = 0,
          device: bool = False):
    """A span named `name`: accumulates wall time, self time, calls and
    the byte and row counts given here or set on the yielded span; with
    `device`, its device time by CUDA events."""
    if not ENABLED:
        return _NULL
    return Span(name, n_bytes, rows, device)


def call_span(fn):
    """Decorator of a public entry point: a call span named after `fn`
    around each call."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not ENABLED:
            return fn(*args, **kwargs)
        with Span(name, call=True):
            return fn(*args, **kwargs)

    return wrapper


def carried(fn):
    """`fn` bound to a copy of the caller's context, to be run on another
    thread: the spans it opens carry the caller's call id."""
    return functools.partial(contextvars.copy_context().run, fn)


def add(name: str, seconds: float, n_bytes: int = 0, rows: int = 0) -> None:
    """Record an externally measured duration, or with zero seconds a
    count (a counter without a span)."""
    if not ENABLED:
        return
    rec = Span(name, n_bytes, rows)
    stack = _stack()
    rec.parent = stack[-1].name if stack else None
    rec.call = _call.get()
    rec.thread = threading.get_ident()
    rec.end = time.perf_counter()
    rec.start = rec.end - seconds
    _close(rec, seconds, seconds)


def _close(span: Span, seconds: float, self_seconds: float) -> None:
    name = span.name
    with _lock:
        _times[name] += seconds
        _self[name] += self_seconds
        _calls[name] += 1
        _bytes[name] += span.bytes
        _rows[name] += span.rows
        if span._is_call:
            _call_names.add(name)
        _log.append(span)
        if span._events is not None:
            if len(_pending) >= PENDING:
                old = _pending.popleft()
                old._events = None
                _unresolved[old.name] += 1
            _pending.append(span)


def _resolve() -> None:
    """Device seconds of the pending event pairs that have completed,
    oldest first; stops at the first still running."""
    with _lock:
        while _pending:
            span = _pending[0]
            start, end = span._events
            if not end.query():
                break
            span.device_seconds = start.elapsed_time(end) / 1e3
            _device[span.name] += span.device_seconds
            span._events = None
            _pending.popleft()


def report() -> dict:
    """{"stage": {"seconds", "calls", "self_seconds"[, "bytes", "rows",
    "device_seconds", "device_unresolved", "call"]}} snapshot; the
    optional keys where nonzero, resolved or true."""
    _resolve()
    with _lock:
        out = {}
        for name, seconds in _times.items():
            r = {"seconds": round(seconds, 6), "calls": _calls[name],
                 "self_seconds": round(_self[name], 6)}
            if _bytes.get(name):
                r["bytes"] = _bytes[name]
            if _rows.get(name):
                r["rows"] = _rows[name]
            if name in _device:
                r["device_seconds"] = round(_device[name], 6)
            if _unresolved.get(name):
                r["device_unresolved"] = _unresolved[name]
            if name in _call_names:
                r["call"] = True
            out[name] = r
        return out


def spans() -> list:
    """The most recent closed spans (at most LOG), oldest first, as
    dicts: name, call id, parent's name, thread, start and end
    (perf_counter seconds), bytes, rows and device seconds (None until
    resolved)."""
    _resolve()
    with _lock:
        return [{"name": s.name, "call": s.call, "parent": s.parent,
                 "thread": s.thread, "start": s.start, "end": s.end,
                 "bytes": s.bytes, "rows": s.rows,
                 "device_seconds": s.device_seconds} for s in _log]


def summary(total: float = None) -> str:
    """One-line 'stage=1.23s(45%)' split for bench output."""
    rep = report()
    parts = []
    for name, r in sorted(rep.items(), key=lambda kv: -kv[1]["seconds"]):
        s = r["seconds"]
        pct = f"({100 * s / total:.0f}%)" if total else ""
        parts.append(f"{name}={s:.2f}s{pct}")
    return " ".join(parts)


def reset() -> None:
    """Clear every accumulator, the span log and the pending pairs."""
    with _lock:
        for d in (_times, _self, _calls, _bytes, _rows, _device,
                  _unresolved):
            d.clear()
        _call_names.clear()
        _log.clear()
        _pending.clear()
