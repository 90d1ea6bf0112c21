"""Fault tolerance: failure detection, elastic membership, stragglers
(port of repro.ft.membership, a copy: host-side numpy and Python only).

Paper mapping: permissioned fabrics run a membership service provider
(MSP) — every node is known, and the system reacts to faulty peers by
excluding them without stopping the network. Applied to the training
cluster:

  * ``HeartbeatMonitor`` — the MSP's liveness view: workers report
    heartbeats; silence past ``timeout_s`` marks a failure.
  * ``rendezvous_assign`` — deterministic highest-random-weight (HRW)
    assignment of data shards to surviving workers: when membership
    changes, only the failed worker's shards move (minimal-churn elastic
    rescale), and every survivor computes the same assignment with no
    coordinator — the consensus-free analogue of Fabric's deterministic
    ordering.
  * ``StragglerPolicy`` — the backup-endorsement rule: a microbatch whose
    endorsement (gradient) is ``beta`` x slower than the running median is
    speculatively re-executed on the fastest idle worker; first result
    wins (the paper's invalid-transaction flag never stalls the block).

All host-side and deterministic => unit-testable without a cluster
(tests/test_torch_train_parts.py); launch/train.py wires the straggler
policy and checkpoint restore into the driver loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import numpy as np

_FNV_PRIME = np.uint64(0x100000001B3)


def _h64(x: int, y: int) -> int:
    mask = (1 << 64) - 1
    h = 0xCBF29CE484222325
    for w in (x & mask, y & mask):
        h = ((h ^ w) * 0x100000001B3) & mask
        h ^= h >> 29
    return h


def rendezvous_assign(shard_ids: Iterable[int], workers: Iterable[int]
                      ) -> dict[int, int]:
    """HRW: shard -> argmax_w h(shard, w). Deterministic, minimal churn."""
    workers = list(workers)
    if not workers:
        raise ValueError("no live workers")
    return {
        s: max(workers, key=lambda w: _h64(s, w)) for s in shard_ids
    }


class HeartbeatMonitor:
    """Tracks worker liveness from heartbeat timestamps."""

    def __init__(self, workers: Iterable[int], *, timeout_s: float = 30.0,
                 clock=time.monotonic):
        self._clock = clock
        self.timeout_s = timeout_s
        now = clock()
        self._last = {w: now for w in workers}
        self._dead: set[int] = set()

    def beat(self, worker: int) -> None:
        if worker in self._dead:
            return  # must rejoin explicitly
        self._last[worker] = self._clock()

    def rejoin(self, worker: int) -> None:
        self._dead.discard(worker)
        self._last[worker] = self._clock()

    def check(self) -> set[int]:
        """Returns newly failed workers (and marks them dead)."""
        now = self._clock()
        newly = {
            w for w, t in self._last.items()
            if w not in self._dead and now - t > self.timeout_s
        }
        self._dead |= newly
        return newly

    @property
    def live(self) -> list[int]:
        return sorted(w for w in self._last if w not in self._dead)


@dataclasses.dataclass
class StragglerPolicy:
    """Backup-endorsement decision rule over observed step durations."""

    beta: float = 2.0  # re-execute if slower than beta x median
    window: int = 32

    def __post_init__(self):
        self._hist: list[float] = []

    def observe(self, duration_s: float) -> None:
        self._hist.append(duration_s)
        if len(self._hist) > self.window:
            self._hist.pop(0)

    @property
    def median(self) -> float:
        return float(np.median(self._hist)) if self._hist else 0.0

    def should_backup(self, elapsed_s: float) -> bool:
        """True if an in-flight microbatch should be speculatively
        duplicated onto an idle worker."""
        med = self.median
        return bool(med > 0 and elapsed_s > self.beta * med)


@dataclasses.dataclass
class ElasticPlan:
    """A concrete rescale decision after membership change."""

    survivors: list[int]
    assignment: dict[int, int]  # data shard -> worker
    resume_step: int

    @staticmethod
    def make(monitor: HeartbeatMonitor, n_shards: int, resume_step: int
             ) -> "ElasticPlan":
        live = monitor.live
        return ElasticPlan(
            survivors=live,
            assignment=rendezvous_assign(range(n_shards), live),
            resume_step=resume_step,
        )
