"""Flight recorder: always-on bounded rings + fault-edge auto-dump (the
port's copy of repro.obs.recorder).

A production peer cannot run with an unbounded tracer, but the run that
matters most — the one that hits a fault — is exactly the run whose last
seconds you want on disk. The flight recorder keeps fixed-memory
drop-oldest rings (:class:`repro_torch.obs.trace.Ring` — the same machinery
that bounds the tracer) of:

  * recent span/event records (tapped from the engine tracer as a sink,
    so the recorder's window survives the tracer's own eviction);
  * recent full tx lifecycles (fed by :mod:`repro_torch.obs.txtrace`);
  * periodic registry snapshots (one per engine round, last few kept).

Evictions are counted, never silent (``dropped`` per ring, surfaced in
the dump's ``meta.json``).

``dump(dir)`` writes the whole window as a self-contained post-mortem:

  * ``trace.jsonl``       — the ring's records, one JSON object/line;
  * ``trace_chrome.json`` — the same window as Chrome trace_event JSON;
  * ``metrics.json``      — the freshest registry snapshot (plus the
    periodic snapshot ring, so rate-of-change is reconstructible);
  * ``lifecycles.json``   — the last-N complete tx lifecycles;
  * ``meta.json``         — trip reasons/contexts, ring drop counters.

The engine trips the recorder automatically on its fault edges —
``verify()`` contract failure, a NEW sticky overflow latch, a resize
refusal, an exception escaping ``run_rounds`` — and the trip auto-dumps
when a dump directory is configured (``EngineConfig.recorder_dir``);
without one the trip is still recorded (ring note + trip log) and
``dump()`` stays available manually.

Trip contexts may carry tensors: :func:`_jsonable` turns them into plain
numbers and lists, u32 words (int32 bits) as their unsigned values.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from repro_torch.core import u32

from .trace import NullTracer, Ring, chrome_events

__all__ = ["FlightRecorder"]


def _jsonable(obj):
    """Best-effort plain-JSON coercion for trip contexts / exemplars.
    Tensors and numpy arrays become numbers or nested lists; an int32
    tensor holds u32 words and becomes their unsigned values."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, torch.Tensor):
        obj = u32.to_numpy(obj)
    if isinstance(obj, (np.ndarray, np.generic)):
        return obj.tolist()
    try:
        return int(obj)
    except (TypeError, ValueError):
        return repr(obj)


class FlightRecorder:
    """Bounded always-on recorder with fault-edge auto-dump."""

    def __init__(self, *, capacity: int = 2048,
                 lifecycle_capacity: int = 64,
                 snapshot_capacity: int = 8,
                 dump_dir: str | None = None,
                 registry=None):
        self.spans = Ring(capacity)
        self.lifecycles = Ring(lifecycle_capacity)
        self.snapshots = Ring(snapshot_capacity)
        self.dump_dir = dump_dir
        self.registry = registry
        self.trips: list[dict] = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    # -- feeds --------------------------------------------------------------

    def attach(self, tracer) -> None:
        """Tap ``tracer`` as a record sink (no-op for the null tracer:
        obs-off engines keep their no-sync contract; the recorder then
        holds only explicit notes + lifecycles)."""
        if not isinstance(tracer, NullTracer):
            tracer.add_sink(self._on_record)

    def _on_record(self, rec: dict) -> None:
        with self._lock:
            self.spans.push(rec)

    def record_lifecycle(self, lc: dict) -> None:
        with self._lock:
            self.lifecycles.push(lc)

    def snapshot_registry(self) -> None:
        """Push one periodic metrics snapshot (engine calls per round)."""
        if self.registry is None:
            return
        snap = {"ts": time.perf_counter() - self._epoch,
                "metrics": self.registry.collect()}
        with self._lock:
            self.snapshots.push(snap)

    def note(self, name: str, **args) -> None:
        """Instant event straight into the span ring (works obs-off)."""
        rec = {"name": name, "ts": time.perf_counter() - self._epoch,
               "dur": 0.0, "depth": 0, "parent": None,
               "tid": threading.get_ident(), "args": _jsonable(args)}
        with self._lock:
            self.spans.push(rec)

    # -- fault edges --------------------------------------------------------

    def trip(self, reason: str, **ctx) -> str | None:
        """One fault edge fired: log it, and auto-dump when a dump dir is
        configured. Returns the dump path (or None)."""
        self.note(f"flightrec.trip.{reason}", **ctx)
        self.trips.append({
            "reason": reason, "ctx": _jsonable(ctx),
            "ts": time.perf_counter() - self._epoch,
        })
        if self.dump_dir is not None:
            return self.dump(self.dump_dir)
        return None

    @property
    def tripped(self) -> bool:
        return bool(self.trips)

    # -- dump ---------------------------------------------------------------

    def dump(self, out_dir: str) -> str:
        """Write the current window to ``out_dir`` (created if needed);
        later dumps overwrite with a fresher window. Returns the dir."""
        os.makedirs(out_dir, exist_ok=True)
        with self._lock:
            spans = sorted(self.spans.items(), key=lambda r: r["ts"])
            lifecycles = self.lifecycles.items()
            snapshots = self.snapshots.items()
            meta = {
                "trips": list(self.trips),
                "dropped": {
                    "spans": self.spans.dropped,
                    "lifecycles": self.lifecycles.dropped,
                    "snapshots": self.snapshots.dropped,
                },
                "counts": {
                    "spans": len(spans), "lifecycles": len(lifecycles),
                    "snapshots": len(snapshots),
                },
            }
        with open(os.path.join(out_dir, "trace.jsonl"), "w") as f:
            for rec in spans:
                f.write(json.dumps(_jsonable(rec)) + "\n")
        with open(os.path.join(out_dir, "trace_chrome.json"), "w") as f:
            json.dump({"traceEvents": _jsonable(chrome_events(spans)),
                       "displayTimeUnit": "ms"}, f)
        metrics = {
            "latest": (self.registry.collect()
                       if self.registry is not None else {}),
            "periodic": snapshots,
        }
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(_jsonable(metrics), f, indent=1)
        with open(os.path.join(out_dir, "lifecycles.json"), "w") as f:
            json.dump(_jsonable(lifecycles), f, indent=1)
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump(_jsonable(meta), f, indent=1)
        return out_dir
