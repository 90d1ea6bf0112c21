"""Engine-wide observability (the port's copy of repro.obs): spans, metrics,
tx tracing, the flight recorder and health.

  * :mod:`repro_torch.obs.trace`    -- span tracer (device syncs only at
    span edges, bounded drop-oldest ring), shared :class:`Ring`.
  * :mod:`repro_torch.obs.metrics`  -- counters/gauges/log2 histograms
    with exact merge and per-bucket exemplars.
  * :mod:`repro_torch.obs.txtrace`  -- per-transaction lifecycle tracing.
  * :mod:`repro_torch.obs.recorder` -- always-on flight recorder with
    fault-edge auto-dump.
  * :mod:`repro_torch.obs.health`   -- rolling-window SLO rollup.

Typical wiring::

    from repro_torch import obs

    o = obs.Obs.enabled()             # or obs.Obs.disabled()
    with o.tracer.span("commit.block", sync=lambda: state.keys):
        state = commit(state, block)
    o.registry.counter("txs.valid").inc(n_valid)
    print(o.registry.to_prometheus())
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .health import (  # noqa: F401
    CRITICAL, DEGRADED, HEALTHY, STATUS_RANK, HealthRollup, HealthVerdict,
    SLOConfig,
)
from .metrics import (  # noqa: F401
    NULL_REGISTRY, Counter, Gauge, Histogram, NullRegistry, Registry,
    null_registry,
)
from .recorder import FlightRecorder  # noqa: F401
from .trace import (  # noqa: F401
    NULL_TRACER, NullTracer, Ring, Span, Tracer, null_tracer,
)
from .txtrace import (  # noqa: F401
    NULL_ROUND, NULL_TXTRACER, NullTxTracer, RoundTxTrace, TxTracer,
)

__all__ = [
    "Obs", "Counter", "Gauge", "Histogram", "Registry", "NullRegistry",
    "Span", "Tracer", "NullTracer", "Ring", "NULL_REGISTRY", "NULL_TRACER",
    "null_registry", "null_tracer",
    "TxTracer", "RoundTxTrace", "NullTxTracer", "NULL_TXTRACER",
    "NULL_ROUND", "FlightRecorder",
    "SLOConfig", "HealthRollup", "HealthVerdict",
    "HEALTHY", "DEGRADED", "CRITICAL", "STATUS_RANK",
]


@dataclass
class Obs:
    """One handle bundling a tracer + registry, on or off together."""

    tracer: object = field(default_factory=lambda: NULL_TRACER)
    registry: object = field(default_factory=lambda: NULL_REGISTRY)

    @classmethod
    def enabled(cls, max_events: int | None = None) -> "Obs":
        """Live pair. ``max_events`` bounds the tracer (drop-oldest ring)
        and wires its evictions to the ``trace.dropped_events`` counter;
        None keeps the complete trace."""
        registry = Registry()
        tracer = Tracer(max_events=max_events)
        if max_events is not None:
            tracer.set_drop_counter(
                registry.counter("trace.dropped_events")
            )
        return cls(tracer=tracer, registry=registry)

    @classmethod
    def disabled(cls) -> "Obs":
        return cls()

    @property
    def on(self) -> bool:
        return not isinstance(self.tracer, NullTracer)
