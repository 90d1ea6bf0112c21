"""End-to-end FastFabric engine: client -> endorse -> order -> commit ->
store (port of repro.core.engine, one channel).

  client (synthetic proposals, numpy: both packages see the same ones)
    -> endorser (transfer chaincode on the replica; MAC tags)
    -> orderer (Fabric 1.2 or O-I/O-II; blocks of ``block_size``)
    -> committer peer (Fabric 1.2, P-I, P-I+II or P-I+II+III)
    -> block store (writer thread, off the critical path; block spill and
       state journal when the durability layer is configured)
    -> endorser replica update
    -> snapshot every ``snapshot_every_blocks`` blocks, chain and journal
       pruned a snapshot behind

``recover`` rebuilds the state from the newest snapshot and the journal
suffix, ``restore`` restarts a peer from its directories, and ``verify``
proves both the chain replay and the recovery against the live peer.

Observability (``EngineConfig.obs``): spans on the round's existing sync
edges, the metrics registry, per-transaction lifecycle tracing, the
always-on flight recorder with its fault edges (``exception``,
``overflow_latch``, ``resize_refused``, ``verify_contract``) and the SLO
rollup behind :meth:`FabricEngine.health`. Elastic state
(``EngineConfig.resize_policy``): a policy pass between rounds doubles or
halves the table (:meth:`FabricEngine.resize`), journaled as re-anchor
records that replay and recovery cross.

Device-side block pipeline (``window_committer=``): a
``pipeline.engine_bridge.WindowCommitter`` commits each round in windows of
its depth instead of one block at a time, and the engine reads the peer's
table, heads and overflow bits, snapshots, verifies and resizes through it.

Not ported yet: several channels (``n_channels``, ``run_rounds``); the
engine runs channel 0 of the reference's API.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (committer, endorser, ledger, orderer, types,
                              u32, unmarshal)
from repro_torch.core import world_state as ws
from repro_torch import obs as obs_mod
from repro_torch.storage import journal as state_journal
from repro_torch.storage import recovery, snapshot


@dataclasses.dataclass(frozen=True)
class ResizePolicy:
    """Between-rounds elastic-state policy: when to halve or double the
    table. Overflow strikes when a single BUCKET fills, so the grow
    triggers watch per-shard minimum free slots (the early warning) and
    the sticky overflow bitmask (the repair: a bigger table instead of a
    fail-stop), not just mean occupancy."""

    grow_free_slots: int = 1  # double when any shard's fullest bucket has
    # <= this many empty slots left (0 disables the pressure trigger)
    grow_fill: float = 0.0  # ... or when any shard's occupancy fraction
    # exceeds this (0 disables)
    grow_on_overflow: bool = True  # ... or when the sticky bitmask sets
    # (capacity repair; the flag itself stays latched: health is honest)
    shrink_fill: float = 0.0  # halve when TOTAL occupancy drops below this
    # fraction of the halved table (0 disables shrinking)
    max_buckets: int = 1 << 24
    min_buckets: int = 8


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dims: types.FabricDims = types.TEST_DIMS
    orderer: orderer.OrdererConfig = orderer.OrdererConfig()
    peer: committer.PeerConfig = committer.FASTFABRIC_PEER
    n_buckets: int = 1 << 12
    slots: int = 8
    n_endorsers: int = 3
    store_blocks: bool = True
    # Block spill directory of the storage role: lets restore() rebuild
    # the ledger head of a snapshot that trails the journal tip.
    block_dir: str | None = None
    # Durability layer (storage/): snapshot every N committed blocks (0 =
    # off), persisted to snapshot_dir if set; journal_dir spills journal
    # records for a cold start; prune_chain compacts the chain and the
    # journal up to the snapshot before the newest; snapshot_shards
    # partitions each snapshot into per-shard files.
    snapshot_every_blocks: int = 0
    snapshot_dir: str | None = None
    journal_dir: str | None = None
    prune_chain: bool = True
    snapshot_shards: int = 1
    # Elastic state: between-rounds halve/double of the world-state table,
    # journaled as re-anchor records (None = static table).
    resize_policy: ResizePolicy | None = None
    # Observability (repro_torch.obs): True builds a tracer and registry
    # and instruments the round (spans on its sync edges, commit.latency,
    # tx lifecycles, overflow and resize metrics); False routes every
    # probe to the shared no-op sinks, which add no device sync and no
    # host copy. An obs.Obs instance is accepted too (one registry shared
    # by several engines, or Obs(registry=reg) for the storage metrics
    # alone).
    obs: bool | object = False
    # Tracer bound when obs=True builds the tracer: drop-oldest past this
    # many records, evictions counted in trace.dropped_events (None =
    # unbounded).
    trace_max_events: int | None = None
    # Flight recorder (always on): a fault edge auto-dumps its window
    # here (None: the trip is logged, dump stays manual).
    recorder_dir: str | None = None
    # Health objectives (obs.SLOConfig); None uses the loose defaults.
    slo: object | None = None


FASTFABRIC = EngineConfig()
FABRIC_V12 = EngineConfig(
    orderer=orderer.OrdererConfig(separate_metadata=False, pipelined=False,
                                  block_size=100),
    peer=committer.FABRIC_V12_PEER,
)


class RoundStats(NamedTuple):
    """One round. ``wall_s`` (order + commit) is the paper's peer-throughput
    window; ``order_s``/``commit_s`` split it, and ``replay_s`` is the
    endorser replica update after it. All end in a device synchronize."""

    n_txs: int
    n_blocks: int
    n_valid: int
    wall_s: float
    order_s: float
    commit_s: float
    replay_s: float

    @property
    def tps(self) -> float:
        return self.n_txs / self.wall_s if self.wall_s else float("inf")


class FabricEngine:
    """Single-host engine holding all roles, on one device.

    ``device`` defaults to the card; without one the constructor raises
    unless the caller passes ``device='cpu'`` (the plain versions of the
    kernels then run). The obs handle (``cfg.obs``) gives the durability
    layer's journal and snapshot metrics their registry. A
    ``window_committer`` (on the engine's device) takes over the commit:
    the peer's table and heads are then its state, at its bucket count."""

    def __init__(self, cfg: EngineConfig = FASTFABRIC, *, device=None,
                 window_committer=None):
        if cfg.snapshot_every_blocks and not (
                cfg.store_blocks and cfg.peer.journal and cfg.peer.hash_state):
            raise ValueError(
                "snapshot_every_blocks requires store_blocks=True and a "
                "peer config with journal=True and hash_state=True (P-I): "
                "snapshots cover the hash-table state and recovery replays "
                "the journal the storage role materializes")
        self.cfg = cfg
        self.device = resolve_device(device)
        if (window_committer is not None
                and window_committer.device != self.device):
            raise ValueError(
                f"window committer on {window_committer.device}, engine on "
                f"{self.device}")
        # Observability handle: a per-engine tracer and registry, the
        # caller's, or the shared no-op pair. The window committer reports
        # through the same handle.
        if isinstance(cfg.obs, obs_mod.Obs):
            self.obs = cfg.obs
        else:
            self.obs = (obs_mod.Obs.enabled(max_events=cfg.trace_max_events)
                        if cfg.obs else obs_mod.Obs.disabled())
        if window_committer is not None and self.obs.on:
            window_committer.attach_obs(self.obs)
        # Device-side block pipeline: commits a window of the committer's
        # depth a call instead of one block (pipeline/engine_bridge).
        self.window_committer = window_committer
        # Always-on flight recorder: taps the live tracer; with obs off it
        # still logs trips and notes.
        self.recorder = obs_mod.FlightRecorder(
            dump_dir=cfg.recorder_dir, registry=self.obs.registry)
        self.recorder.attach(self.obs.tracer)
        # Per-transaction lifecycles ride the obs switch: the tx-id sidecar
        # is a host copy that obs off skips.
        self.txtrace = (
            obs_mod.TxTracer(self.obs.registry, recorder=self.recorder)
            if self.obs.on else obs_mod.NULL_TXTRACER)
        # Health/SLO rollup: host-side per-round buckets, works obs-off.
        self.health_rollup = obs_mod.HealthRollup(cfg.slo)
        self.peer_state = committer.create_peer_state(
            cfg.dims, n_buckets=cfg.n_buckets, slots=cfg.slots,
            hash_state=cfg.peer.hash_state, device=self.device)
        self.endorser_state = ws.create(cfg.n_buckets, cfg.slots,
                                        cfg.dims.vw, device=self.device)
        self.log_head = torch.zeros((2,), dtype=u32.WORD, device=self.device)
        self.next_block_no = 0
        # The table's CURRENT layout; resize epochs move it, while
        # recovery and replay start from the genesis layout, cfg.n_buckets.
        self.n_buckets = (cfg.n_buckets if window_committer is None
                          else window_committer.n_buckets)
        # Sticky: some commit dropped a write on a full bucket.
        self.overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        # The overflow bitmask a restart re-latched from its snapshot.
        self.restored_overflow_bits = 0
        # Overflow bits an overflow-triggered grow already repaired (the
        # sticky mask never un-latches, so the repair fires once a bit),
        # and the bits the obs latch counter has seen.
        self.repaired_bits = 0
        self.obs_seen_bits = 0
        # Resize epochs the chain replay must cross: (boundary block, new
        # bucket count), from resize() and from the journal's re-anchor
        # records on restore.
        self.reanchor_log: list[tuple[int, int]] = []
        self.snapshots: list[snapshot.Snapshot] = []
        # The journal rides the storage role's writer thread, attached only
        # when the durability layer is configured (a snapshot cadence or an
        # on-disk journal); the commit-path head is independent of it.
        self.journal = None
        if (cfg.store_blocks and cfg.peer.journal
                and (cfg.snapshot_every_blocks > 0
                     or cfg.journal_dir is not None)):
            self.journal = state_journal.StateJournal(
                cfg.dims, spill_dir=cfg.journal_dir,
                metrics=self.obs.registry)
        self.store = None
        if cfg.store_blocks:
            if cfg.block_dir is not None:
                os.makedirs(cfg.block_dir, exist_ok=True)
            self.store = ledger.BlockStore(cfg.block_dir,
                                           journal=self.journal)
        self.total_valid = 0
        self.total_txs = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _edge(self, name: str, sync, **args):
        """A span that ends on one of the round's device syncs: with obs on
        the span synchronizes at its exit (on ``sync``'s device), with obs
        off the null span does nothing and the engine synchronizes after
        it. Either way the round syncs there exactly once."""
        with self.obs.tracer.span(name, sync=sync, **args):
            yield
        if not self.obs.on:
            self._sync()

    # -- client --------------------------------------------------------------

    def make_proposals(self, n: int, *, seed: int = 0,
                       n_accounts: int = 1 << 16) -> endorser.Proposal:
        """Synthetic transfer proposals with disjoint account pairs, drawn
        from numpy's generator in the JAX engine's order."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(max(n_accounts, 2 * n))[: 2 * n].astype(
            np.uint32)
        amount = rng.integers(1, 1000, size=n, dtype=np.uint32)
        client = rng.integers(0, 64, size=n, dtype=np.uint32)
        nonce = ((np.arange(n, dtype=np.uint64) + (seed << 16))
                 & u32.MASK).astype(np.uint32)
        return endorser.Proposal(*(u32.from_numpy(a, self.device) for a in (
            perm[:n], perm[n:], amount, client, nonce)))

    # -- one full round ------------------------------------------------------

    def run_round(self, proposals: endorser.Proposal) -> RoundStats:
        """One round: endorse (untimed) -> order -> commit -> replica update.

        As in the paper's measurement, the client sends pre-endorsed
        transactions, so endorsement and marshaling are outside the timed
        window, and the endorser replica updates after it. An exception
        escaping the round trips the flight recorder (``exception``).
        """
        try:
            return self._round(proposals)
        except Exception as e:
            self._fault("exception", where="run_round", channel=0,
                        error=repr(e))
            raise

    def _round(self, proposals: endorser.Proposal) -> RoundStats:
        cfg = self.cfg
        n = int(proposals.src.shape[0])
        bs = cfg.orderer.block_size
        if n % bs:
            raise ValueError(f"round of {n} txs not a multiple of {bs}")

        txb = endorser.execute_and_endorse(
            self.endorser_state, proposals, cfg.dims,
            n_endorsers=cfg.n_endorsers)
        wire = unmarshal.marshal(txb, cfg.dims)
        self._sync()
        # Tx-lifecycle sidecar at submission: the tx ids (the endorser's
        # content hashes) as u32, one host copy with obs on.
        txr = self.txtrace.begin_round(
            0, u32.to_numpy(txb.tx_id) if self.obs.on else None, bs,
            self.next_block_no)
        t0 = time.perf_counter()

        txr.order_start()
        with self._edge("round.order", lambda: self.log_head, channel=0):
            blocks = orderer.order_batch(wire, txb.tx_id, txb.client,
                                         self.log_head, cfg.orderer)
            self.log_head = blocks.log_head
        t_order = time.perf_counter()
        txr.ordered()

        n_blocks = blocks.wire.shape[0]
        wc = self.window_committer
        if wc is not None:
            # Device-side block pipeline: a window of the committer's depth
            # a call; the span ends on the committer's device sync.
            with self._edge("round.commit", lambda: wc.state.ledger_head,
                            n_blocks=n_blocks, channel=0):
                retired = self._commit_windows(blocks, txr)
            t_commit = time.perf_counter()
        else:
            # Commit block by block; each block leaves for the store as
            # soon as it is committed (its head, hash and validity are
            # fresh tensors).
            retired = []
            with self._edge("round.commit",
                            lambda: self.peer_state.ledger_head,
                            n_blocks=n_blocks, channel=0):
                for b in range(n_blocks):
                    bno = self.next_block_no
                    self.next_block_no += 1
                    prev_head = self.peer_state.ledger_head
                    res = committer.commit_block(
                        self.peer_state, blocks.wire[b], cfg.dims, cfg.peer)
                    self.peer_state = res.state
                    self.overflow = self.overflow | res.overflow
                    retired.append(self._ship(blocks.wire[b], bno, prev_head,
                                              res.block_hash, res.valid))
            t_commit = time.perf_counter()
            txr.validated(0, n_blocks)
            # Per-block commit latency: the round's order + commit window
            # amortized over its blocks (they are in flight together); the
            # window committer records its windows' own.
            dt = (t_commit - t0) / n_blocks
            hist = self.obs.registry.histogram("commit.latency")
            for _ in range(n_blocks):
                hist.record(dt)

        n_valid, valids = self._endorser_replay(retired)
        t_replay = time.perf_counter()
        txr.committed()
        self._policy_pass()
        self._maybe_snapshot()
        wall = t_commit - t0
        new_bits = self._count_round(n, n_valid, wall, n_blocks)
        txr.finish(valids, overflow_latched=bool(new_bits))
        return RoundStats(
            n_txs=n, n_blocks=n_blocks, n_valid=n_valid, wall_s=wall,
            order_s=t_order - t0, commit_s=t_commit - t_order,
            replay_s=t_replay - t_commit)

    def _commit_windows(self, blocks, txr) -> list:
        """Slice the ordered round into windows of the committer's depth
        (a shorter tail window last), commit each, and ship every block to
        the store with the committer's chain hashes."""
        wc = self.window_committer
        retired = []
        n_blocks = blocks.wire.shape[0]
        for lo in range(0, n_blocks, wc.depth):
            hi = min(lo + wc.depth, n_blocks)
            res = wc.commit_window(blocks.wire[lo:hi], blocks.tx_ids[lo:hi])
            # The window's chain hashes came to the host in its drain span:
            # blocks [lo, hi) validated on that edge.
            txr.validated(lo, hi)
            for k in range(hi - lo):
                bno = self.next_block_no
                self.next_block_no += 1
                retired.append(self._ship(blocks.wire[lo + k], bno,
                                          res.prev_hash[k], res.block_hash[k],
                                          res.valid[k]))
        return retired

    def _endorser_replay(self, retired: list) -> tuple:
        """Endorser replica updates for the round's retired blocks; returns
        ``(n_valid, valid_by_block)``. With obs on, each block's validity
        comes to the host once (the tx-outcome feed; it replaces the
        count's read), else ``valid_by_block`` is None."""
        n_valid = 0
        valids: list | None = [] if self.obs.on else None
        with self._edge("round.endorser_replay",
                        lambda: self.endorser_state.versions, channel=0):
            for wire_b, valid in retired:
                dec = unmarshal.unmarshal(wire_b, self.cfg.dims)
                self.endorser_state = endorser.apply_validated(
                    self.endorser_state, dec.txb, valid)
                if valids is not None:
                    v = valid.cpu().numpy()
                    valids.append(v)
                    n_valid += int(v.sum())
                else:
                    n_valid += int(valid.sum())
        return n_valid, valids

    def _count_round(self, n: int, n_valid: int, wall_s: float,
                     n_blocks: int) -> int:
        """Fold one round into the totals, the health rollup and (obs on)
        the overflow gauges and the recorder's periodic snapshot. Returns
        the NEWLY latched sticky overflow bits (0 with obs off): a non-zero
        return is a fault edge."""
        self.total_valid += n_valid
        self.total_txs += n
        reg = self.obs.registry
        reg.counter("txs.valid").inc(n_valid)
        reg.counter("txs.invalid").inc(n - n_valid)
        self.health_rollup.push_round(0, n_txs=n, n_valid=n_valid,
                                      wall_s=wall_s, n_blocks=n_blocks)
        new_bits = 0
        if self.obs.on:
            new_bits = self._record_overflow_metrics()
            self.recorder.snapshot_registry()
            if new_bits:
                self._fault("overflow_latch", channel=0, bits=new_bits)
        return new_bits

    def _ship(self, wire_b, bno: int, prev_head, block_hash, valid):
        """A block leaves the pipeline: async handoff to the storage role."""
        if self.store is not None:
            with self.obs.tracer.span("block.ship", block_no=bno, channel=0):
                self.store.submit(bno, prev_head, block_hash, wire_b, valid)
        return wire_b, valid

    # -- observability ---------------------------------------------------------

    def metrics(self) -> dict:
        """One-call snapshot of every engine metric (the registry's
        ``collect``): counters/gauges as numbers, histograms as
        count/sum/mean/p50/p95/p99 dicts. Empty when obs is off."""
        return self.obs.registry.collect()

    def stats_text(self) -> str:
        """Prometheus text exposition of the engine metrics."""
        return self.obs.registry.to_prometheus()

    @property
    def tracer(self):
        return self.obs.tracer

    def _fault(self, reason: str, **ctx) -> None:
        """One engine fault edge fired: trip the flight recorder (which
        auto-dumps when ``cfg.recorder_dir`` is set) and mark the trace."""
        path = self.recorder.trip(reason, **ctx)
        self.obs.tracer.event("engine.fault", reason=reason,
                              dump=path or "")

    def health(self) -> obs_mod.HealthVerdict:
        """The peer's SLO verdict NOW: ``healthy | degraded | critical``
        with per-shard reasons. Feeds the rollup the live sticky overflow
        bits and per-shard occupancy (one stacked read), evaluates the
        rolling round window, and with obs on mirrors the verdict onto the
        ``health.status`` / ``health.channel{channel=0}`` gauges. Works
        with obs off, creating no gauge."""
        occ, _min_free, cap, bits = self._shard_stats()
        self.health_rollup.set_overflow(0, bits)
        self.health_rollup.set_occupancy(0, [int(o) / cap for o in occ])
        verdict = self.health_rollup.evaluate()
        if self.obs.on:
            reg = self.obs.registry
            reg.gauge("health.status").set(
                obs_mod.STATUS_RANK[verdict.status])
            for c, info in verdict.channels.items():
                reg.gauge("health.channel", channel=c).set(
                    obs_mod.STATUS_RANK[info["status"]])
        return verdict

    def _record_overflow_metrics(self) -> int:
        """Per-shard overflow bits as a labeled gauge and a latch counter
        that fires once per NEWLY set bit (one overflow read; obs on
        only). Returns the newly latched bits."""
        bits = self.overflow_bits()
        reg = self.obs.registry
        new = bits & ~self.obs_seen_bits
        if new:
            reg.counter("overflow.latches").inc(bin(new).count("1"))
            self.obs_seen_bits |= bits
        for m in range(self.n_shards):
            reg.gauge("state.shard_overflow", channel=0,
                      shard=m).set((bits >> m) & 1)
        return new

    # -- elastic state (resize epochs) -----------------------------------------

    @property
    def n_shards(self) -> int:
        """Bucket shards of snapshot manifests, digest trees and the
        policy's per-shard signals: the window committer's when one is
        attached, else ``cfg.snapshot_shards``."""
        if self.window_committer is not None:
            return self.window_committer.n_shards
        return self.cfg.snapshot_shards

    def _state_view(self) -> ws.HashState:
        """The peer's committed table: the window committer's, or the
        per-block peer state's."""
        if self.window_committer is not None:
            return self.window_committer.hash_state()
        return self.peer_state.hash_state

    def _peer_digest(self) -> np.ndarray:
        return u32.to_numpy(ws.state_digest(self._state_view()))

    def _peer_journal_head(self) -> np.ndarray:
        if self.window_committer is not None:
            return self.window_committer.journal_head
        return u32.to_numpy(self.peer_state.journal_head)

    def _ledger_head(self) -> np.ndarray:
        if self.window_committer is not None:
            return self.window_committer.ledger_head_for(0)
        return u32.to_numpy(self.peer_state.ledger_head)

    def _shard_stats(self) -> tuple:
        """(per-shard occupancy ``(M,)``, min free slots, per-shard slot
        capacity, sticky overflow bits) of the live table, in ONE stacked
        device read. Restored overflow bits are ORed in, as in
        :meth:`overflow_bits`."""
        if self.window_committer is not None:
            occ, min_free, cap, bits = self.window_committer.shard_stats()[0]
            return occ, min_free, cap, bits | self.restored_overflow_bits
        st = self.peer_state.hash_state
        m = self.n_shards
        host = torch.cat([ws.shard_occupancy(st, m),
                          ws.shard_min_free(st, m),
                          self.overflow.reshape(1).long()]).cpu().numpy()
        return (host[:m], int(host[m:2 * m].min()),
                st.n_buckets // m * st.slots,
                int(host[-1]) | self.restored_overflow_bits)

    def _policy_pass(self) -> dict | None:
        """The between-rounds policy trigger: one stacked stats read drives
        the grow/shrink decision (grow under bucket pressure or after an
        overflow, shrink a mostly empty table), the ``state.occupancy`` /
        ``state.health`` gauges and the health rollup's occupancy feed. No
        policy, no device read. Returns the resize info, if one ran."""
        pol = self.cfg.resize_policy
        if pol is None:
            return None
        occ, min_free, cap, bits = self._shard_stats()
        reg = self.obs.registry
        if self.obs.on:
            reg.counter("resize.policy_checks").inc(1)
        fills = [int(o) / cap for o in occ]
        self.health_rollup.set_occupancy(0, fills)
        pressure = bool(
            (pol.grow_free_slots and min_free <= pol.grow_free_slots)
            or (pol.grow_fill and max(fills) >= pol.grow_fill))
        if self.obs.on:
            reg.gauge("state.occupancy", channel=0).set(max(fills))
            # 2 = overflowed (fail-stop shard), 1 = under grow pressure,
            # 0 = headroom.
            reg.gauge("state.health", channel=0).set(
                2 if bits else (1 if pressure else 0))
        # Capacity repair: one overflow-triggered grow per NEWLY latched
        # bit (the mask is sticky; comparing with the repaired bits keeps
        # it from firing every round).
        if pressure or (pol.grow_on_overflow
                        and bits & ~self.repaired_bits):
            if self.n_buckets * 2 <= pol.max_buckets:
                self.obs.tracer.event(
                    "resize.decision", action="grow", min_free=min_free,
                    overflow_bits=bits, n_buckets=self.n_buckets,
                    channel=0)
                self.repaired_bits |= bits
                return self.resize(self.n_buckets * 2)
            if bits & ~self.repaired_bits:
                # Overflowed at the ceiling: the repair cannot run, a fault
                # edge. The bits count as repaired so it trips once.
                self.repaired_bits |= bits
                self._fault("resize_refused", channel=0,
                            n_buckets=self.n_buckets,
                            max_buckets=pol.max_buckets, overflow_bits=bits)
            return None
        if (pol.shrink_fill and self.n_buckets // 2 >= pol.min_buckets
                and int(occ.sum()) < pol.shrink_fill
                * (self.n_buckets // 2) * self.cfg.slots):
            self.obs.tracer.event(
                "resize.decision", action="shrink", occupancy=int(occ.sum()),
                n_buckets=self.n_buckets, channel=0)
            return self.resize(self.n_buckets // 2)
        return None

    def resize(self, new_n_buckets: int) -> dict:
        """Halve or double the world state NOW (between rounds): drain the
        store, rehash the peer's table and the endorser replica (its
        capacity must track the peer's, or the two diverge on which inserts
        drop), and commit a re-anchor record at the drained boundary when a
        journal is attached, so replay and recovery cross the epoch.
        Returns the epoch's info dict (the reference's keys)."""
        if self.store is not None:
            self.store.drain()  # the journal tip must be at the boundary
        old_nb = self.n_buckets
        hot = self._hot_shard()
        wc = self.window_committer
        if wc is not None:
            try:
                info = wc.resize(new_n_buckets)
            except ValueError as e:
                # The committer refused the epoch: a fault edge, as the
                # caller believed a capacity change was needed.
                self._fault("resize_refused", channel=0, n_buckets=old_nb,
                            requested=new_n_buckets, error=str(e))
                raise
            tree, bits = info.tree_head, info.overflow_bits
        else:
            res = ws.resize(self.peer_state.hash_state, new_n_buckets)
            self.peer_state = self.peer_state._replace(hash_state=res.state)
            self.overflow = self.overflow | res.overflow
            tree, bits = (ws.tree_head(res.state, self.n_shards),
                          self.overflow_bits())
        self.endorser_state = ws.resize(self.endorser_state,
                                        new_n_buckets).state
        self.n_buckets = new_n_buckets
        bno = self.next_block_no - 1
        if self.journal is not None:
            self.journal.append_reanchor(
                bno, old_n_buckets=old_nb, new_n_buckets=new_n_buckets,
                n_shards=self.n_shards, tree_head=tree, overflow_bits=bits)
        info = {"block_no": bno, "old_n_buckets": old_nb,
                "new_n_buckets": new_n_buckets, "overflow_bits": bits,
                "hot_shard": hot, "channel": 0}
        self.reanchor_log.append((bno, new_n_buckets))
        self.obs.registry.counter(
            "resize.grow" if new_n_buckets > old_nb else "resize.shrink"
        ).inc()
        self.obs.tracer.event("resize.epoch", **info)
        return info

    def _hot_shard(self) -> int:
        if self.window_committer is not None:
            return self.window_committer.hot_shard()
        return ws.hot_shard(
            self.overflow_bits(),
            ws.shard_occupancy(self.peer_state.hash_state, self.n_shards))

    # -- durability layer (storage/) --------------------------------------------

    def _maybe_snapshot(self) -> None:
        """Snapshot cadence, after the round's replica update: every
        ``snapshot_every_blocks`` committed blocks, drain the storage role,
        snapshot the peer's table, save and collect garbage (two kept), and
        prune the chain and the journal up to the snapshot BEFORE the
        newest, so the previous one stays recoverable if the newest is
        lost."""
        cfg = self.cfg
        if not cfg.snapshot_every_blocks:
            return
        last = self.snapshots[-1].block_no if self.snapshots else -1
        tip = self.next_block_no - 1
        if tip - last < cfg.snapshot_every_blocks:
            return
        self.store.drain()  # the journal must cover every shipped block
        with self.obs.tracer.span("snapshot.take", block_no=tip, channel=0):
            snap = snapshot.take(
                self._state_view(), block_no=tip,
                journal_head=self._peer_journal_head(),
                ledger_head=self._ledger_head(), n_shards=self.n_shards,
                overflow_bits=self.overflow_bits(),
                reanchor_head=self.journal.reanchor_head)
        self.snapshots.append(snap)
        reg = self.obs.registry
        if cfg.snapshot_dir is not None:
            snapshot.save(cfg.snapshot_dir, snap, registry=reg)
            snapshot.gc(cfg.snapshot_dir, keep=2, registry=reg)
        if cfg.prune_chain and len(self.snapshots) >= 2:
            base = self.snapshots[-2].block_no
            self.store.prune_upto(base)
            self.journal.prune_upto(base)
            self.snapshots = self.snapshots[-2:]

    def recover(self) -> recovery.RecoveryResult:
        """Cold-start recovery on the engine's device from the newest
        snapshot + the journal suffix."""
        if self.journal is None:
            raise recovery.RecoveryError("engine has no journal")
        self.store.drain()
        cfg = self.cfg
        return recovery.recover(
            self.journal,
            snapshot=self.snapshots[-1] if self.snapshots else None,
            n_buckets=cfg.n_buckets, slots=cfg.slots,
            value_width=cfg.dims.vw, device=self.device)

    @classmethod
    def restore(cls, cfg: EngineConfig, *, device=None) -> "FabricEngine":
        """Restart a peer on ``device`` (default: the card) from its
        persisted snapshots and journal spill (``journal_dir`` and
        ``snapshot_dir`` required).

        When the newest complete snapshot covers the journal tip, its heads
        restore directly. When it TRAILS the tip, the journal replays the
        suffix's state and the ``block_dir`` spill rebuilds its ledger
        head: the spilled blocks must chain from the snapshot's head, and
        they re-seed the store so ``verify()`` replays the same suffix. The
        persisted sticky overflow bitmask is re-latched (and counts as
        repaired, so a restart does not grow the table once per boot), and
        the peer resumes the persisted (post-resize) layout. As in the
        reference, the orderer's ``log_head`` restarts at genesis.
        """
        if cfg.journal_dir is None or cfg.snapshot_dir is None:
            raise recovery.RecoveryError(
                "restore requires journal_dir and snapshot_dir")
        eng = cls(cfg, device=device)
        eng._restore_channel()
        return eng

    def _restore_channel(self) -> None:
        cfg = self.cfg
        jrnl = state_journal.StateJournal.load(cfg.dims, cfg.journal_dir,
                                               metrics=self.obs.registry)
        self.journal = jrnl
        if self.store is not None:
            self.store.set_journal(jrnl)
        snap = snapshot.latest(cfg.snapshot_dir)
        if snap is None:
            raise recovery.RecoveryError(
                f"no complete snapshot in {cfg.snapshot_dir}")
        rec = recovery.recover(
            jrnl, snapshot=snap, n_buckets=cfg.n_buckets, slots=cfg.slots,
            value_width=cfg.dims.vw, device=self.device)
        suffix: list[ledger.StoredBlock] = []
        ledger_head = np.asarray(snap.ledger_head)
        if rec.block_no != snap.block_no:
            # The snapshot trails the journal tip: the journal replayed the
            # suffix's state, but the ledger head lives only in the chain.
            if cfg.block_dir is None:
                raise recovery.RecoveryError(
                    f"journal tip {rec.block_no} past the latest snapshot "
                    f"{snap.block_no}: the suffix's ledger head is not "
                    "recoverable without the block spill (cfg.block_dir)")
            suffix = [sb for sb in ledger.load_spilled_blocks(
                cfg.block_dir, snap.block_no + 1)
                if sb.block_no <= rec.block_no]
            if not suffix or suffix[-1].block_no != rec.block_no:
                have = suffix[-1].block_no if suffix else snap.block_no
                raise recovery.RecoveryError(
                    f"block spill covers only up to block {have}, journal "
                    f"tip is {rec.block_no}")
            for sb in suffix:
                if not np.array_equal(sb.prev_hash, ledger_head):
                    raise recovery.RecoveryError(
                        f"spilled block {sb.block_no} does not chain from "
                        "the snapshot's ledger head (corrupt or tampered)")
                if not np.array_equal(ledger.chained_hash(ledger_head, sb),
                                      sb.block_hash):
                    raise recovery.RecoveryError(
                        f"spilled block {sb.block_no} fails its chain "
                        "hash (corrupt or tampered)")
                ledger_head = sb.block_hash
            # Resize epochs inside the suffix re-enter the replay log.
            self.reanchor_log.extend(
                (r.block_no, r.new_n_buckets)
                for r in jrnl.suffix_reanchors(snap.block_no))
        word = lambda a: u32.from_numpy(np.asarray(a, np.uint32), self.device)
        self.snapshots = [snap]
        self.peer_state = self.peer_state._replace(
            hash_state=rec.state, ledger_head=word(ledger_head),
            journal_head=word(rec.journal_head),
            block_no=word(np.uint32(rec.block_no + 1)).reshape(()))
        self.endorser_state = ws.HashState(*(t.clone() for t in rec.state))
        self.n_buckets = rec.n_buckets
        self.restored_overflow_bits = rec.overflow_bits
        self.repaired_bits = rec.overflow_bits
        self.next_block_no = rec.block_no + 1
        if self.store is not None:
            # The chain re-anchors at the snapshot; a rebuilt suffix
            # re-enters it, so verify() replays what recovery replayed.
            self.store.base_block_no = snap.block_no
            self.store.base_hash = np.asarray(snap.ledger_head)
            self.store.chain = list(suffix)

    # -- checks ----------------------------------------------------------------

    def overflow_bits(self) -> int:
        """Sticky overflow bitmask: bit 0 once a commit dropped a write on
        a full bucket (the window committer's bits when one is attached),
        ORed with the bits a restart re-latched."""
        if self.window_committer is not None:
            bits = self.window_committer.overflow_bits
        else:
            bits = int(bool(self.overflow))
        return bits | self.restored_overflow_bits

    def overflowed(self) -> bool:
        return bool(self.overflow_bits())

    def verify(self) -> dict:
        """Drain storage, verify the chain, and check that no commit
        overflowed a bucket. A peer with the hash table (P-I) also replays
        the chain, from the snapshot that covers its pruned prefix, into a
        table and compares it and the endorser replica with the peer, by
        digest; the sorted store of the baseline is not compared, as in the
        reference. With a journal attached, ``recovery_ok`` runs
        :meth:`recover` and compares its state digest and journal head with
        the live peer's; without one there is no recovery path and it stays
        True. A pruned chain whose covering snapshot is gone fails
        ``chain_ok`` and ``replay_ok``."""
        out = {"chain_ok": True, "replica_ok": True, "replay_ok": True,
               "recovery_ok": True, "overflow_ok": not self.overflowed()}
        hashed = self.cfg.peer.hash_state
        peer = self._peer_digest() if hashed else None
        if self.store is not None:
            self.store.drain()
            out["chain_ok"] = self.store.verify_chain()
            base_bno = self.store.base_block_no
            start = None
            if base_bno >= 0:
                base = next((s for s in self.snapshots
                             if s.block_no == base_bno), None)
                if base is None:
                    out["chain_ok"] = out["replay_ok"] = False
                else:
                    start = snapshot.to_state(base, self.device)
            if hashed and out["replay_ok"]:
                resize_at: dict = {}
                for bno, nb in self.reanchor_log:
                    if bno > base_bno:
                        resize_at.setdefault(bno, []).append(nb)
                replayed = self.store.replay_state(
                    self.cfg.dims, self.cfg.n_buckets, self.cfg.slots,
                    start_state=start, resize_at=resize_at,
                    device=self.device)
                out["replay_ok"] = bool(np.array_equal(
                    u32.to_numpy(ws.state_digest(replayed)), peer))
        if self.journal is not None and hashed:
            try:
                rec = self.recover()
                out["recovery_ok"] = bool(
                    np.array_equal(rec.state_digest, peer)
                    and np.array_equal(rec.journal_head,
                                       self._peer_journal_head()))
            except recovery.RecoveryError:
                out["recovery_ok"] = False
        if hashed:
            out["replica_ok"] = bool(np.array_equal(
                u32.to_numpy(ws.state_digest(self.endorser_state)), peer))
        if not all(out.values()):
            # Fault edge: the durability contract broke. Trip the recorder
            # with the verdict, and with the journal's reason when it can
            # name the record that broke its chain.
            ctx = {"channel": 0,
                   "verdict": {k: bool(v) for k, v in out.items()}}
            if self.journal is not None:
                jok, why = self.journal.verify_chain_reason()
                if not jok:
                    ctx["journal_reason"] = why
            self._fault("verify_contract", **ctx)
        return out
