"""Metrics registry: counters, gauges, and log2 latency histograms (the
port's copy of repro.obs.metrics; stdlib only).

Three instrument kinds:

  * :class:`Counter` -- monotonically increasing total.
  * :class:`Gauge`   -- last-set value.
  * :class:`Histogram` -- fixed log2 buckets over a [lo, hi): edges are
    ``lo * 2**i``, so :meth:`Histogram.merge` is exact, and percentiles use
    the nearest-rank rule over bucket counts, reporting the bucket's upper
    edge (within one bucket ratio, 2x, of the exact sample percentile).

Instruments support labels; a labeled instrument is keyed ``name{k=v}`` in
:meth:`Registry.collect` snapshots, and ``Registry.to_prometheus`` renders
the standard text exposition (histograms as cumulative ``_bucket{le=...}``
series) for the serving engine's ``stats_text``. The no-op registry of the
JAX package comes with the obs slice, whose engines switch metrics off.
"""

from __future__ import annotations

import collections
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]


class Counter:
    """Monotonic counter. ``inc`` with a negative amount is an error."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, amount: int | float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter decrement: {amount}")
        self.value += amount


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def set(self, value) -> None:
        self.value = value

    def inc(self, amount: int | float = 1) -> None:
        self.value += amount

    def dec(self, amount: int | float = 1) -> None:
        self.value -= amount


class Histogram:
    """Fixed-bucket log2 histogram over ``[lo, hi)``, with exemplars.

    Bucket 0 holds values ``<= lo``; bucket ``1 + i`` holds
    ``(lo * 2**i, lo * 2**(i+1)]``; the last bucket is the OVERFLOW
    bucket and holds values clamped past ``hi``. Defaults cover
    100ns..~1700s — the full latency range of a block commit, a snapshot
    save, or a whole benchmark round — in 35 buckets.

    Pinned edge behavior (the JAX package's tests/test_obs.py):

      * empty histogram — :meth:`percentile` returns ``nan``;
      * rank in the overflow bucket — :meth:`percentile` returns ``inf``
        (the value was clamped at ``hi``: widen the range if it matters);
      * exemplars recorded for clamped values are NEVER silently filed
        under the clamp bucket's index — they live under the explicit
        ``"overflow"`` key in :meth:`exemplar_snapshot`, so a p99 of
        ``inf`` still names the transactions that caused it while making
        the clamping visible.

    Exemplar sampling: ``record(v, exemplar=meta)`` retains up to
    ``max_exemplars`` most-recent ``meta`` payloads PER BUCKET — a tail
    bucket therefore always carries concrete recent instances (tx-ids +
    their phase breakdown for the tx-lifecycle histograms), making a p99
    spike attributable without replaying the workload. ``record(v, n=k)``
    records ``k`` occurrences of one value in O(1) (the engine's
    per-block amortized phase times weight by block size this way).
    """

    __slots__ = ("lo", "n_buckets", "counts", "count", "sum", "_edges",
                 "max_exemplars", "_exemplars")

    def __init__(self, lo: float = 1e-7, hi: float = 1e3,
                 max_exemplars: int = 4) -> None:
        if not (lo > 0 and hi > lo):
            raise ValueError(f"bad histogram range [{lo}, {hi})")
        self.lo = float(lo)
        self.n_buckets = int(math.ceil(math.log2(hi / lo))) + 2
        self.counts = [0] * self.n_buckets
        self.count = 0
        self.sum = 0.0
        self._edges = [lo * 2.0 ** i for i in range(self.n_buckets - 1)]
        self.max_exemplars = int(max_exemplars)
        self._exemplars: dict = {}  # bucket index | "overflow" -> deque

    def bucket_of(self, value: float) -> int:
        if value <= self.lo:
            return 0
        return min(int(math.ceil(math.log2(value / self.lo))),
                   self.n_buckets - 1)

    def record(self, value: float, n: int = 1, exemplar=None) -> None:
        self.count += n
        self.sum += value * n
        i = self.bucket_of(value)
        self.counts[i] += n
        if exemplar is not None and self.max_exemplars:
            key = "overflow" if i == self.n_buckets - 1 else i
            dq = self._exemplars.get(key)
            if dq is None:
                dq = self._exemplars[key] = collections.deque(
                    maxlen=self.max_exemplars
                )
            dq.append(exemplar)

    @property
    def edges(self) -> list[float]:
        """Upper edges of the finite buckets (the last bucket is +inf)."""
        return list(self._edges)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, reported as the bucket's upper edge.

        Exact modulo bucket resolution: the true sample at rank
        ``ceil(q/100 * count)`` lies in the returned bucket, so the result
        over-reports by at most one bucket ratio (2x). Returns ``nan`` on
        an empty histogram and ``inf`` when the rank falls in the overflow
        bucket (values past ``hi`` — widen the range if that matters).
        """
        i = self._bucket_at_rank(q)
        if i is None:
            return float("nan")
        return self._edges[i] if i < len(self._edges) else float("inf")

    def merge(self, other: "Histogram") -> None:
        """Exact pooled merge (bucket edges must match). Exemplars pool
        too, keeping each bucket's most recent ``max_exemplars``."""
        if other.lo != self.lo or other.n_buckets != self.n_buckets:
            raise ValueError("histogram ranges differ: merge is not exact")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        for key, dq in other._exemplars.items():
            mine = self._exemplars.get(key)
            if mine is None:
                mine = self._exemplars[key] = collections.deque(
                    maxlen=self.max_exemplars
                )
            mine.extend(dq)

    def _bucket_at_rank(self, q: float) -> int | None:
        """Bucket index holding the nearest-rank sample for ``q``."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return i
        return self.n_buckets - 1

    def exemplars_for(self, q: float) -> list:
        """Exemplar payloads retained in the bucket holding percentile
        ``q`` (the ``"overflow"`` bin when that bucket is the clamp
        bucket). Empty when nothing was recorded with an exemplar."""
        i = self._bucket_at_rank(q)
        if i is None:
            return []
        key = "overflow" if i == self.n_buckets - 1 else i
        return list(self._exemplars.get(key, ()))

    def exemplar_snapshot(self) -> dict:
        """All retained exemplars keyed by bucket index (clamped values
        under the explicit ``"overflow"`` key)."""
        return {k: list(v) for k, v in self._exemplars.items()}

    def snapshot(self) -> dict:
        """count/sum/mean + the standard percentiles, one dict. When any
        exemplars were recorded, ``p99_exemplars`` carries the payloads
        retained in the p99 bucket (the exemplar contract benchmarks
        assert: a p99 spike names concrete tx-ids)."""
        mean = self.sum / self.count if self.count else float("nan")
        snap = {
            "count": self.count, "sum": self.sum, "mean": mean,
            "p50": self.percentile(50), "p95": self.percentile(95),
            "p99": self.percentile(99),
        }
        if self._exemplars:
            snap["p99_exemplars"] = self.exemplars_for(99)
        return snap


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Registry:
    """Get-or-create instrument store with a one-call snapshot.

    Thread-safe creation (the storage role's writer thread records journal
    metrics concurrently with the engine thread); individual increments
    ride the GIL like every other host-side counter in the repo.
    """

    def __init__(self) -> None:
        self._instruments: dict[str, object] = {}
        self._kinds: dict[str, str] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, labels: dict, kind: str, factory):
        key = _key(name, labels)
        inst = self._instruments.get(key)
        if inst is not None:
            if self._kinds[key] != kind:
                raise TypeError(
                    f"{key} already registered as {self._kinds[key]}"
                )
            return inst
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = factory()
                self._instruments[key] = inst
                self._kinds[key] = kind
            elif self._kinds[key] != kind:
                raise TypeError(
                    f"{key} already registered as {self._kinds[key]}"
                )
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, "counter", Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, "gauge", Gauge)

    def histogram(self, name: str, lo: float = 1e-7, hi: float = 1e3,
                  max_exemplars: int = 4, **labels) -> Histogram:
        return self._get(name, labels, "histogram",
                         lambda: Histogram(lo, hi, max_exemplars))

    def collect(self) -> dict:
        """Flat snapshot: ``name{labels}`` -> value (histograms -> the
        count/sum/mean/p50/p95/p99 dict). Safe to call any time; values
        are plain Python numbers, JSON-ready."""
        out = {}
        for key, inst in sorted(self._instruments.items()):
            if isinstance(inst, Histogram):
                out[key] = inst.snapshot()
            else:
                out[key] = inst.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (metric names sanitized to
        ``[a-zA-Z0-9_]``, histograms as cumulative ``le`` buckets)."""
        by_name: dict[str, list] = {}
        for key, inst in sorted(self._instruments.items()):
            name, _, rest = key.partition("{")
            labels = rest[:-1] if rest else ""
            by_name.setdefault(name, []).append((labels, inst))
        lines = []
        for name, entries in sorted(by_name.items()):
            pname = "".join(
                c if c.isalnum() or c == "_" else "_" for c in name
            )
            kind = self._kinds[_key(name, {})] if name in self._kinds \
                else self._kinds[
                    next(k for k in self._kinds if k.startswith(name + "{"))]
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram"}[kind]
            lines.append(f"# TYPE {pname} {ptype}")
            for labels, inst in entries:
                plabels = labels.replace("=", '="').replace(",", '",') \
                    + ('"' if labels else "")
                sfx = f"{{{plabels}}}" if labels else ""
                if isinstance(inst, Histogram):
                    acc = 0
                    for i, c in enumerate(inst.counts):
                        acc += c
                        le = (f"{inst.edges[i]:.9g}" if i < len(inst.edges)
                              else "+Inf")
                        sep = "," if labels else ""
                        lines.append(
                            f'{pname}_bucket{{{plabels}{sep}le="{le}"}} '
                            f"{acc}"
                        )
                    lines.append(f"{pname}_sum{sfx} {inst.sum:.9g}")
                    lines.append(f"{pname}_count{sfx} {inst.count}")
                else:
                    lines.append(f"{pname}{sfx} {inst.value}")
        return "\n".join(lines) + "\n"
