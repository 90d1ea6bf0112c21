"""Transaction-lifecycle tracing: what happened to ONE transaction (the
port's copy of repro.obs.txtrace).

Spans and histograms measure *stages*; this module measures
*transactions*: every proposal gets a tx-id at submission (the endorser's
paired content hash, ``TxBatch.tx_id``), a host-side sidecar of per-block
timestamps rides alongside the blocks through order -> validate ->
commit, and each tx's phase durations land in per-phase histograms:

  * ``tx.phase.queue``    -- submission (pre-endorsed wire ready) to
    order start: time waiting at the ordering service.
  * ``tx.phase.order``    -- the ordering span (O-I/O-II work).
  * ``tx.phase.validate`` -- order end to the tx's block clearing
    validation (the round-commit sync on the per-block path).
  * ``tx.phase.commit``   -- validation done to the round's retirement
    (endorser-replica apply + ship).
  * ``tx.e2e``            -- submission to retirement. By construction
    ``queue + order + validate + commit == e2e`` exactly per tx.

Timestamps are taken ONLY on sync edges the round already has (order-span
exit, round-commit sync, endorser-replay exit): the tracer never adds a
device sync. Transactions in one block share those edges, so each block
records once with ``n=block_size`` weight (O(blocks), not O(txs), host
work per round) and attaches ONE exemplar -- its first tx-id plus the
full phase breakdown -- so every histogram bucket retains up to K
concrete recent transactions (see
:class:`repro_torch.obs.metrics.Histogram`).

Outcomes are labeled counters under ``tx.outcome``:

  * ``valid``            -- committed, version bumps applied;
  * ``mvcc_conflict``    -- failed validation (read-set version mismatch);
  * ``overflow_dropped`` -- the tx's round latched a NEW sticky overflow
    bit: its writes may have been dropped by a full bucket, so "valid"
    can no longer be claimed (round-granular, a deliberate upper bound).

A bounded ring of full per-tx lifecycles (sampled per block: the first
tx, plus the first invalid tx when the block has one) feeds the flight
recorder's ``lifecycles.json`` dump.

Tx-ids arrive as a host-side ``np.uint32`` sidecar ((N, 2), the words'
unsigned values; the engine copies ``TxBatch.tx_id`` through
``core.u32.to_numpy``) and the validity of each block as a host bool
array.
"""

from __future__ import annotations

import time

__all__ = ["TxTracer", "RoundTxTrace", "NullTxTracer", "NULL_TXTRACER",
           "NULL_ROUND", "PHASES"]

PHASES = ("queue", "order", "validate", "commit")


def _tx_hex(row) -> str:
    """(2,) u32 paired-hash tx-id -> 16-char hex string."""
    return f"{int(row[0]):08x}{int(row[1]):08x}"


class RoundTxTrace:
    """Per-round sidecar: tx-ids + the phase timestamps of one round.

    The engine stamps it at the existing sync edges (``order_start``,
    ``ordered``, ``validated(lo, hi)`` per drained window,
    ``committed``) and ``finish(...)`` folds the stamps into the
    registry histograms, outcome counters and lifecycle ring.
    """

    __slots__ = ("tt", "channel", "tx_ids", "bs", "n_blocks", "block_no0",
                 "t_submit", "t_order0", "t_order1", "t_end",
                 "t_validated")

    def __init__(self, tt: "TxTracer", channel: int, tx_ids, bs: int,
                 block_no0: int):
        self.tt = tt
        self.channel = channel
        self.tx_ids = tx_ids  # (N, 2) host-side sidecar
        self.bs = bs
        self.n_blocks = len(tx_ids) // bs
        self.block_no0 = block_no0
        self.t_submit = time.perf_counter()
        self.t_order0 = self.t_order1 = self.t_end = 0.0
        self.t_validated: list = [None] * self.n_blocks

    def order_start(self) -> None:
        self.t_order0 = time.perf_counter()

    def ordered(self) -> None:
        self.t_order1 = time.perf_counter()

    def validated(self, lo: int, hi: int) -> None:
        """Blocks [lo, hi) of the round cleared validation NOW (called
        right after the window that carried them drained)."""
        t = time.perf_counter()
        for k in range(lo, min(hi, self.n_blocks)):
            self.t_validated[k] = t

    def committed(self) -> None:
        self.t_end = time.perf_counter()

    def finish(self, valid_by_block: list | None,
               overflow_latched: bool = False) -> None:
        """Record the round: ``valid_by_block`` is one host-side bool
        array per block (None skips outcome/lifecycle accounting)."""
        if self.t_end == 0.0:
            self.t_end = time.perf_counter()
        self.tt._finish(self, valid_by_block, overflow_latched)


class TxTracer:
    """Engine-side factory + sink for :class:`RoundTxTrace` sidecars."""

    def __init__(self, registry, *, recorder=None, max_exemplars: int = 4,
                 lifecycle_capacity: int = 64):
        from .trace import Ring  # stdlib sibling; avoids import cycles

        self.registry = registry
        self.recorder = recorder
        self.max_exemplars = max_exemplars
        self.lifecycles = Ring(lifecycle_capacity)
        self._hists = {
            p: registry.histogram(f"tx.phase.{p}",
                                  max_exemplars=max_exemplars)
            for p in PHASES
        }
        self._hists["e2e"] = registry.histogram(
            "tx.e2e", max_exemplars=max_exemplars
        )

    def begin_round(self, channel: int, tx_ids, block_size: int,
                    block_no0: int) -> RoundTxTrace:
        """Open a round sidecar at SUBMISSION time (the pre-endorsed
        wire is ready; the tx-ids are the endorser's content hashes)."""
        return RoundTxTrace(self, channel, tx_ids, block_size, block_no0)

    def _finish(self, rt: RoundTxTrace, valid_by_block,
                overflow_latched: bool) -> None:
        reg = self.registry
        queue = max(rt.t_order0 - rt.t_submit, 0.0)
        order = max(rt.t_order1 - rt.t_order0, 0.0)
        for k in range(rt.n_blocks):
            tv = rt.t_validated[k]
            if tv is None:
                tv = rt.t_end  # never marked: clears with the round sync
            validate = max(tv - rt.t_order1, 0.0)
            commit = max(rt.t_end - tv, 0.0)
            e2e = queue + order + validate + commit
            phases = {"queue": queue, "order": order,
                      "validate": validate, "commit": commit}
            first = rt.tx_ids[k * rt.bs]
            exemplar = {
                "tx_id": _tx_hex(first), "channel": rt.channel,
                "block_no": rt.block_no0 + k, "e2e": e2e, **phases,
            }
            for p, v in phases.items():
                self._hists[p].record(v, n=rt.bs, exemplar=exemplar)
            self._hists["e2e"].record(e2e, n=rt.bs, exemplar=exemplar)

            if valid_by_block is None:
                continue
            valid = valid_by_block[k]
            nv = int(valid.sum())
            ok_label = "overflow_dropped" if overflow_latched else "valid"
            if nv:
                reg.counter("tx.outcome", outcome=ok_label).inc(nv)
            if rt.bs - nv:
                reg.counter("tx.outcome", outcome="mvcc_conflict").inc(
                    rt.bs - nv
                )
            # Lifecycle samples: block's first tx; plus its first invalid
            # tx, so conflict lifecycles stay represented in the ring.
            sample = [0]
            if nv < rt.bs:
                sample.append(int(valid.argmin()))
            for i in dict.fromkeys(sample):
                tx = rt.tx_ids[k * rt.bs + i]
                ok = bool(valid[i])
                lc = {
                    "tx_id": _tx_hex(tx), "channel": rt.channel,
                    "block_no": rt.block_no0 + k,
                    "outcome": (ok_label if ok else "mvcc_conflict"),
                    "t_submit": rt.t_submit, "phases": phases, "e2e": e2e,
                }
                self.lifecycles.push(lc)
                if self.recorder is not None:
                    self.recorder.record_lifecycle(lc)


class _NullRoundTxTrace:
    __slots__ = ()

    def order_start(self) -> None:
        pass

    def ordered(self) -> None:
        pass

    def validated(self, lo, hi) -> None:
        pass

    def committed(self) -> None:
        pass

    def finish(self, valid_by_block=None, overflow_latched=False) -> None:
        pass


NULL_ROUND = _NullRoundTxTrace()


class NullTxTracer:
    """Obs-off tx tracing: no sidecars, no host transfers, no stamps.
    Callers skip materializing the tx-id sidecar (pass ``None``)."""

    lifecycles = None

    def begin_round(self, channel, tx_ids, block_size, block_no0):
        return NULL_ROUND


NULL_TXTRACER = NullTxTracer()
