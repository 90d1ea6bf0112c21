"""Health/SLO rollup: rolling-window verdicts from per-round buckets (the
port's copy of repro.obs.health).

The rollup keeps a bounded ring of per-round buckets per channel
(:class:`repro_torch.obs.trace.Ring`: fixed memory, drop-oldest) and
evaluates three objectives over that window:

  * **commit latency** -- the window's p95 per-block commit latency must
    stay under ``SLOConfig.commit_p95_s``;
  * **validity rate**  -- valid/total over the window must stay above
    ``min_validity_rate`` (``critical_validity_rate`` floors it: below
    that the channel is failing, not degraded);
  * **capacity headroom** -- per-shard occupancy must stay under
    ``max_occupancy``, and a latched sticky overflow bit is immediately
    ``critical`` (writes were DROPPED on that shard).

Verdicts are ``healthy | degraded | critical`` with per-channel,
per-shard reasons; ``FabricEngine.health()`` feeds the rollup live
overflow and occupancy (one stacked stats read) and mirrors the verdict
to ``health.status`` / ``health.channel{channel=c}`` gauges. The serving
engine uses the statuses and :class:`HealthVerdict`.

Registry-independent: the rollup runs on host-side round accounting, so
``health()`` works with observability off.
"""

from __future__ import annotations

import dataclasses
import math

from .trace import Ring

__all__ = ["SLOConfig", "HealthVerdict", "HealthRollup",
           "HEALTHY", "DEGRADED", "CRITICAL", "STATUS_RANK"]

HEALTHY = "healthy"
DEGRADED = "degraded"
CRITICAL = "critical"
STATUS_RANK = {HEALTHY: 0, DEGRADED: 1, CRITICAL: 2}


def _worst(a: str, b: str) -> str:
    return a if STATUS_RANK[a] >= STATUS_RANK[b] else b


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """The peer's objectives. Defaults are deliberately loose (a CPU CI
    runner must read healthy); deployments tighten them."""

    commit_p95_s: float = 1.0  # window p95 of per-block commit latency
    min_validity_rate: float = 0.99  # below -> degraded
    critical_validity_rate: float = 0.5  # below -> critical
    max_occupancy: float = 0.85  # any shard above -> degraded (headroom)
    window_rounds: int = 16  # per-round buckets retained per channel


@dataclasses.dataclass
class HealthVerdict:
    """Structured verdict: overall status + per-channel breakdown."""

    status: str
    reasons: list
    channels: dict  # channel -> {"status": str, "reasons": [str, ...]}

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class HealthRollup:
    """Ring-of-round-buckets SLO evaluator for one engine."""

    def __init__(self, slo: SLOConfig | None = None, n_channels: int = 1):
        self.slo = slo if slo is not None else SLOConfig()
        self.n_channels = n_channels
        self._rounds = [Ring(self.slo.window_rounds)
                        for _ in range(n_channels)]
        self._overflow: dict[int, int] = {}  # latest sticky bits
        self._occupancy: dict[int, list] = {}  # latest per-shard fraction

    # -- feeds (engine-side, per round / per stats pass) --------------------

    def push_round(self, channel: int, *, n_txs: int, n_valid: int,
                   wall_s: float, n_blocks: int) -> None:
        self._rounds[channel].push({
            "n_txs": n_txs, "n_valid": n_valid,
            "block_latency_s": wall_s / max(n_blocks, 1),
            "n_blocks": n_blocks,
        })

    def set_overflow(self, channel: int, bits: int) -> None:
        self._overflow[channel] = bits

    def set_occupancy(self, channel: int, fractions) -> None:
        """Latest per-shard occupancy fractions (one stacked stats read
        feeds every channel — the resize-policy pass or ``health()``)."""
        self._occupancy[channel] = [float(f) for f in fractions]

    # -- evaluation ---------------------------------------------------------

    def _window_p95(self, buckets: list) -> float:
        lats = sorted(b["block_latency_s"] for b in buckets
                      for _ in range(b["n_blocks"]))
        if not lats:
            return float("nan")
        rank = max(1, math.ceil(0.95 * len(lats)))
        return lats[rank - 1]

    def evaluate_channel(self, channel: int) -> tuple[str, list]:
        slo = self.slo
        status = HEALTHY
        reasons: list[str] = []
        bits = self._overflow.get(channel, 0)
        m = 0
        while bits >> m:
            if (bits >> m) & 1:
                status = _worst(status, CRITICAL)
                reasons.append(
                    f"channel {channel} shard {m}: sticky overflow "
                    f"latched (writes dropped)"
                )
            m += 1
        buckets = self._rounds[channel].items()
        n_txs = sum(b["n_txs"] for b in buckets)
        n_valid = sum(b["n_valid"] for b in buckets)
        if n_txs:
            rate = n_valid / n_txs
            if rate < slo.critical_validity_rate:
                status = _worst(status, CRITICAL)
                reasons.append(
                    f"channel {channel}: validity rate {rate:.3f} below "
                    f"critical floor {slo.critical_validity_rate}"
                )
            elif rate < slo.min_validity_rate:
                status = _worst(status, DEGRADED)
                reasons.append(
                    f"channel {channel}: validity rate {rate:.3f} below "
                    f"objective {slo.min_validity_rate}"
                )
        p95 = self._window_p95(buckets)
        if p95 == p95 and p95 > slo.commit_p95_s:  # nan-safe
            status = _worst(status, DEGRADED)
            reasons.append(
                f"channel {channel}: commit p95 {p95:.3f}s over "
                f"objective {slo.commit_p95_s}s"
            )
        for shard, frac in enumerate(self._occupancy.get(channel, ())):
            if frac >= slo.max_occupancy:
                status = _worst(status, DEGRADED)
                reasons.append(
                    f"channel {channel} shard {shard}: occupancy "
                    f"{frac:.2f} over headroom {slo.max_occupancy}"
                )
        return status, reasons

    def evaluate(self) -> HealthVerdict:
        status = HEALTHY
        reasons: list[str] = []
        channels = {}
        for c in range(self.n_channels):
            st, rs = self.evaluate_channel(c)
            channels[c] = {"status": st, "reasons": rs}
            status = _worst(status, st)
            reasons.extend(rs)
        return HealthVerdict(status=status, reasons=reasons,
                             channels=channels)
