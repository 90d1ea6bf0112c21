"""Health verdict statuses (the part of repro.obs.health the serving
engine uses; the SLO rollup over per-round buckets comes with the obs
slice)."""

from __future__ import annotations

import dataclasses

__all__ = ["HealthVerdict", "HEALTHY", "DEGRADED", "CRITICAL", "STATUS_RANK"]

HEALTHY = "healthy"
DEGRADED = "degraded"
CRITICAL = "critical"
STATUS_RANK = {HEALTHY: 0, DEGRADED: 1, CRITICAL: 2}


@dataclasses.dataclass
class HealthVerdict:
    """Structured verdict: overall status + per-channel breakdown."""

    status: str
    reasons: list
    channels: dict  # channel -> {"status": str, "reasons": [str, ...]}

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
