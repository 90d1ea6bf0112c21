"""Span tracer: nested named spans with explicit device-sync boundaries
(the port's copy of repro.obs.trace).

CUDA launches are asynchronous: ``commit(block)`` returns as soon as its
kernels are queued, and whichever host line next waits on the card absorbs
all pending device work. A naive ``perf_counter`` pair around one stage
therefore bills its latency to a bystander. The tracer's contract is the
opposite: device syncs happen only at span edges, and only when the caller
asks for them --

    with tracer.span("round.commit", sync=lambda: state.ledger_head):
        state = commit(state, block)           # async launches inside

``sync=`` (a tensor, a tuple or list of tensors, a callable returning one,
or None) is resolved at span *exit*: a callable is called, and each CUDA
device among the tensors is synchronized (``torch.cuda.synchronize``);
CPU tensors need nothing. The span's duration then covers the launches
and the device work of exactly what it encloses. Spans with
``sync=None`` time host work and never touch the device.

Spans nest per thread (a ``threading.local`` stack: the storage writer
thread can trace without corrupting the engine thread's stack) and carry
a depth and parent name, so ordering is reconstructible from the flat
record list. Exports:

  * :meth:`Tracer.dump_jsonl` -- one JSON object per line
    (``{"name", "ts", "dur", "depth", "parent", "tid", "args"}``).
  * :meth:`Tracer.dump_chrome` -- Chrome ``trace_event`` JSON (``"ph":
    "X"`` complete events, microsecond timestamps) for chrome://tracing
    or https://ui.perfetto.dev.

``tracer.event(name, **args)`` records zero-duration structured events
(resize decisions, re-anchor epochs), instant events in the Chrome view.
:data:`NULL_TRACER` is the shared no-op of an engine with obs off: it
never resolves, let alone calls, a sync target.

Memory is bounded on request: ``Tracer(max_events=N)`` keeps the N most
recent records in a drop-oldest :class:`Ring` (the ring the flight
recorder uses too) and counts evictions in :attr:`Tracer.dropped_events`.
The default stays unbounded.
"""

from __future__ import annotations

import collections
import json
import threading
import time

import torch

__all__ = ["Ring", "Span", "Tracer", "NULL_TRACER", "null_tracer",
           "chrome_events"]


class Ring:
    """Bounded drop-oldest buffer with an exact eviction counter.

    The fixed-memory primitive shared by the bounded tracer and the
    flight recorder: pushes never fail, the oldest item falls out once
    ``capacity`` is reached, and ``dropped`` counts exactly how many
    items the window no longer holds. ``capacity=None`` is unbounded.
    """

    __slots__ = ("capacity", "dropped", "_items")

    def __init__(self, capacity: int | None = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dropped = 0
        self._items: collections.deque = collections.deque(maxlen=capacity)

    def push(self, item) -> None:
        if self.capacity is not None and len(self._items) == self.capacity:
            self.dropped += 1
        self._items.append(item)

    def items(self) -> list:
        return list(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def clear(self) -> None:
        self._items.clear()
        self.dropped = 0


def _tensors(obj):
    """The tensors of a sync target: a tensor, or tuples and lists of
    them (a ``HashState`` is a tuple)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)


def _block(obj) -> None:
    """Resolve a sync target: call it if callable, then synchronize every
    CUDA device its tensors live on (CPU tensors are always ready)."""
    if obj is None:
        return
    if callable(obj):
        obj = obj()
    if obj is None:
        return
    for dev in {t.device for t in _tensors(obj) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Span:
    """Context manager for one timed region. Created via Tracer.span."""

    __slots__ = ("tracer", "name", "sync", "args", "t0", "depth", "parent")

    def __init__(self, tracer: "Tracer", name: str, sync, args: dict):
        self.tracer = tracer
        self.name = name
        self.sync = sync
        self.args = args
        self.t0 = 0.0
        self.depth = 0
        self.parent = None

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        # No sync on entry: the caller places the span after an edge that
        # already synced (the target usually does not exist yet anyway).
        self.t0 = time.perf_counter()
        return self

    def set_sync(self, sync) -> None:
        """Install/replace the exit sync target from inside the span."""
        self.sync = sync

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            _block(self.sync)
        t1 = time.perf_counter()
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._emit(self, t1)


class Tracer:
    """Collects spans and instant events; exports JSONL / Chrome JSON.

    ``max_events`` bounds the retained records (drop-oldest);
    ``drop_counter`` is an optional counter-like object (``.inc()``)
    bumped once per evicted record — the ``trace.dropped_events``
    registry counter when wired through :class:`repro_torch.obs.Obs`. Sinks
    registered via :meth:`add_sink` see every record as it completes
    (the flight recorder taps the stream this way) regardless of what
    the ring later evicts.
    """

    def __init__(self, max_events: int | None = None,
                 drop_counter=None) -> None:
        self._events = Ring(max_events)
        self._drop_counter = drop_counter
        self._sinks: list = []
        self._local = threading.local()
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    @property
    def dropped_events(self) -> int:
        """Records evicted by the ``max_events`` bound so far."""
        return self._events.dropped

    def add_sink(self, fn) -> None:
        """Register ``fn(record)`` to observe every completed record."""
        self._sinks.append(fn)

    def set_drop_counter(self, counter) -> None:
        self._drop_counter = counter

    def _append(self, rec: dict) -> None:
        with self._lock:
            before = self._events.dropped
            self._events.push(rec)
            if self._events.dropped != before \
                    and self._drop_counter is not None:
                self._drop_counter.inc()
        for fn in self._sinks:
            fn(rec)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, sync=None, **args) -> Span:
        """Open a nested span. ``sync`` is blocked on at exit (see module
        docstring); ``args`` become structured payload on the record."""
        return Span(self, name, sync, args)

    def event(self, name: str, **args) -> None:
        """Zero-duration structured event at the current nesting level."""
        stack = self._stack()
        rec = {
            "name": name,
            "ts": time.perf_counter() - self._epoch,
            "dur": 0.0,
            "depth": len(stack),
            "parent": stack[-1].name if stack else None,
            "tid": threading.get_ident(),
            "args": args,
        }
        self._append(rec)

    def _emit(self, span: Span, t1: float) -> None:
        rec = {
            "name": span.name,
            "ts": span.t0 - self._epoch,
            "dur": t1 - span.t0,
            "depth": span.depth,
            "parent": span.parent,
            "tid": threading.get_ident(),
            "args": span.args,
        }
        self._append(rec)

    # -- export ----------------------------------------------------------

    def records(self) -> list[dict]:
        """Completed records, ordered by start time."""
        with self._lock:
            return sorted(self._events.items(), key=lambda r: r["ts"])

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec) + "\n")

    def chrome_events(self) -> list[dict]:
        """Chrome trace_event list: "X" complete events (+instants)."""
        return chrome_events(self.records())

    def dump_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
        self._epoch = time.perf_counter()


def chrome_events(records: list[dict]) -> list[dict]:
    """Tracer-record list -> Chrome trace_event list (shared with the
    flight recorder, whose ring holds records of the same schema)."""
    out = []
    for rec in records:
        ev = {
            "name": rec["name"],
            "cat": rec["parent"] or "root",
            "pid": 1,
            "tid": rec["tid"],
            "ts": rec["ts"] * 1e6,
            "args": rec["args"],
        }
        if rec["dur"] > 0.0:
            ev["ph"] = "X"
            ev["dur"] = rec["dur"] * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        out.append(ev)
    return out


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def set_sync(self, sync) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer. span() skips even the sync (obs-off must not add
    device blocking that obs-on placed deliberately at span edges)."""

    dropped_events = 0

    def span(self, name, sync=None, **args):
        return _NULL_SPAN

    def event(self, name, **args) -> None:
        pass

    def add_sink(self, fn) -> None:
        pass

    def set_drop_counter(self, counter) -> None:
        pass

    def records(self) -> list:
        return []

    def chrome_events(self) -> list:
        return []

    def dump_jsonl(self, path) -> None:
        pass

    def dump_chrome(self, path) -> None:
        pass

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()


def null_tracer() -> NullTracer:
    return NULL_TRACER
