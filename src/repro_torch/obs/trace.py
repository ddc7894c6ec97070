"""Structured span tracing with Chrome/Perfetto trace-event export.

A ``Tracer`` records *complete* spans ("ph": "X" trace events): wall-clock
begin + duration, per-thread track, nesting derived from the per-thread span
stack.  The API is a context manager (``with tracer.span("repro.x.y",
k=v):``) or a decorator (``@tracer.traced()``); exported JSON
(``tracer.export(path)``) loads directly in ``chrome://tracing`` and
https://ui.perfetto.dev.

Overhead contract (the serving hot path depends on it): the *disabled* path
is a single branch — ``span()`` returns a shared no-op handle without
allocating anything, and callers pay only the attribute check.  Code that
wants to skip even argument computation can guard on ``tracer.enabled``
explicitly.  Enabled-path cost is two ``perf_counter`` calls, one dict, and
one list append per span.

The span stream is subscribable: ``tracer.subscribe(fn)`` delivers every
finished ``Span`` (name, wall-times, args) to ``fn`` — the serving layer's
``DispatchRecord`` emission is one such subscriber, so anything the audit
hook sees is definitionally also in the exported trace.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import tempfile
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

__all__ = ["Span", "Tracer", "default_tracer", "set_default_tracer"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span, as delivered to subscribers."""

    name: str
    t0: float              # tracer-relative start, seconds
    dur: float             # seconds
    tid: int
    args: Dict


class _NoopSpan:
    """Shared do-nothing handle returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kwargs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _SpanHandle:
    """Live span: records on ``__exit__``.  Only ever constructed while the
    tracer is enabled (tests assert the disabled path allocates none)."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0

    def set(self, **kwargs) -> "_SpanHandle":
        """Attach/overwrite args on the live span (visible in the exported
        event and to subscribers)."""
        self.args.update(kwargs)
        return self

    def __enter__(self) -> "_SpanHandle":
        stack = self._tracer._stack()
        if stack:
            self.args.setdefault("parent", stack[-1].name)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._finish(self, self._t0, t1 - self._t0)
        return False


class Tracer:
    """Span recorder with an explicit ``enabled`` gate.

    ``max_events`` bounds memory as a ring buffer: the newest spans win and
    ``dropped_events`` counts what fell off — a long soak with tracing left
    on degrades to a rolling window, never to an OOM.
    """

    def __init__(self, *, enabled: bool = False, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self._events: Deque[Dict] = collections.deque(maxlen=max_events)
        self.dropped_events = 0
        self._lock = threading.Lock()
        self._subscribers: List[Callable[[Span], None]] = []
        self._tls = threading.local()
        self._epoch = time.perf_counter()

    # -- span API ------------------------------------------------------------
    def span(self, name: str, **args) -> "_SpanHandle":
        """Context manager for one span.  Disabled tracing returns a shared
        no-op handle — a single branch, zero allocation."""
        if not self.enabled:
            return _NOOP
        return _SpanHandle(self, name, args)

    def traced(self, name: Optional[str] = None) -> Callable:
        """Decorator form: spans every call of the wrapped function."""
        def deco(fn):
            span_name = name or f"{fn.__module__}.{fn.__qualname__}"

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(span_name):
                    return fn(*a, **kw)
            return wrapper
        return deco

    def current(self) -> Optional[str]:
        """Name of this thread's innermost open span, if any."""
        stack = self._stack()
        return stack[-1].name if stack else None

    def _stack(self) -> List["_SpanHandle"]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _finish(self, handle: "_SpanHandle", t0: float, dur: float) -> None:
        event = {
            "ph": "X", "cat": "repro", "name": handle.name,
            "ts": (t0 - self._epoch) * 1e6,     # trace-event µs
            "dur": dur * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": handle.args,
        }
        with self._lock:
            if len(self._events) == self.max_events:
                self.dropped_events += 1
            self._events.append(event)
            subscribers = list(self._subscribers)
        if subscribers:
            span = Span(name=handle.name, t0=t0 - self._epoch, dur=dur,
                        tid=event["tid"], args=handle.args)
            for fn in subscribers:
                try:
                    fn(span)
                except Exception:  # noqa: BLE001 — a broken sink must never
                    pass           # kill the traced operation

    # -- span stream ---------------------------------------------------------
    def subscribe(self, fn: Callable[[Span], None]) -> Callable:
        """Deliver every finished span to ``fn`` (while enabled); returns
        ``fn`` so callers can ``unsubscribe`` it later."""
        with self._lock:
            self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    # -- buffer --------------------------------------------------------------
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped_events = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def export(self, path: str) -> str:
        """Write the buffered spans as Chrome trace-event JSON (atomic
        tmp+rename).  Open in chrome://tracing or https://ui.perfetto.dev."""
        p = os.path.abspath(os.path.expanduser(path))
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms",
               "otherData": {"producer": "repro_torch.obs.trace",
                             "dropped_events": self.dropped_events}}
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, p)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return p


# -- process-global default tracer (disabled until someone enables it) -------
_default: Optional[Tracer] = None
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Tracer()
    return _default


def set_default_tracer(tracer: Optional[Tracer]) -> None:
    """Install (or with None, reset) the process-global tracer — tests."""
    global _default
    _default = tracer
