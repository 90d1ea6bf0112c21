"""End-to-end FastFabric engine: client -> endorse -> order -> commit ->
store (port of repro.core.engine).

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
A committer with bucket-sharded state gives its shard count
(:attr:`FabricEngine.n_shards`) to the snapshots' parts, the re-anchor
records, the ``state.shard_overflow`` gauges and the policy's hot shard. A
committer over a mesh of devices (``WindowCommitter(mesh=...)``) runs on
the mesh's first device, where the engine orders; the round's syncs then
wait for every card of the mesh, and each snapshot part is copied from its
shard's device.

Several channels (``EngineConfig.n_channels``): each channel has its own
peer and replica tables, heads, journal, snapshots, block chain and resize
epochs (``_Channel``), and one ``BlockStore`` multiplexes their chains.
:meth:`FabricEngine.run_rounds` runs one round on every channel: back to
back on the host path, or through a multi-channel window committer, which
commits every channel's window at one window position together. Channel 0
is the channel of the single-channel API.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import canonical_device, resolve_device
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
    # Independent channels, each with its own state, heads, journal,
    # snapshots and resize epochs; their directories nest under the ones
    # below (ledger.channel_dir). Channel 0 is the single-channel API's.
    n_channels: int = 1
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




class _Channel:
    """One channel's mutable state: the peer and endorser tables, the heads,
    the durability layer and the resize history. Channel 0 is the target of
    the single-channel API (the engine's property shims)."""

    __slots__ = (
        "peer_state", "endorser_state", "log_head", "journal", "snapshots",
        "next_block_no", "overflow", "n_buckets", "reanchor_log",
        "repaired_bits", "restored_overflow_bits", "obs_seen_bits",
        "total_valid", "total_txs",
    )

    def __init__(self, cfg: EngineConfig, device, journal, n_buckets: int):
        self.peer_state = committer.create_peer_state(
            cfg.dims, n_buckets=cfg.n_buckets, slots=cfg.slots,
            hash_state=cfg.peer.hash_state, device=device)
        self.endorser_state = ws.create(cfg.n_buckets, cfg.slots,
                                        cfg.dims.vw, device=device)
        self.log_head = torch.zeros((2,), dtype=u32.WORD, device=device)
        self.journal = journal
        self.snapshots: list[snapshot.Snapshot] = []
        self.next_block_no = 0
        # Sticky: some commit dropped a write on a full bucket.
        self.overflow = torch.zeros((), dtype=torch.bool, device=device)
        # The table's CURRENT layout; resize epochs move it, while
        # recovery and replay start from the genesis layout, cfg.n_buckets.
        self.n_buckets = n_buckets
        # Resize epochs the chain replay must cross: (boundary block, new
        # bucket count), from resize() and from the journal's re-anchor
        # records on restore.
        self.reanchor_log: list[tuple[int, int]] = []
        # Overflow bits an overflow-triggered grow already repaired (the
        # sticky mask never un-latches, so the repair fires once a bit),
        # the bits a restart re-latched from its snapshot, and the bits
        # the obs latch counter has seen.
        self.repaired_bits = 0
        self.restored_overflow_bits = 0
        self.obs_seen_bits = 0
        self.total_valid = 0
        self.total_txs = 0


def _shim(name: str, doc: str | None = None) -> property:
    """An engine attribute that is channel 0's."""
    return property(lambda self: getattr(self.chans[0], name),
                    lambda self, v: setattr(self.chans[0], name, v), doc=doc)


class FabricEngine:
    """Single-host engine holding all roles, on one device.

    ``device`` defaults to the card; without one the constructor raises
    unless the caller passes ``device='cpu'`` (the plain versions of the
    kernels then run). The obs handle (``cfg.obs``) gives the durability
    layer's journal and snapshot metrics their registry. A
    ``window_committer`` (on the engine's device, or over a mesh whose
    first device it is, driving ``cfg.n_channels`` channels) takes over the
    commit: the peer's tables and heads are then its state, at its bucket
    counts."""

    def __init__(self, cfg: EngineConfig = FASTFABRIC, *, device=None,
                 window_committer=None):
        if cfg.snapshot_every_blocks and not (
                cfg.store_blocks and cfg.peer.journal and cfg.peer.hash_state):
            raise ValueError(
                "snapshot_every_blocks requires store_blocks=True and a "
                "peer config with journal=True and hash_state=True (P-I): "
                "snapshots cover the hash-table state and recovery replays "
                "the journal the storage role materializes")
        if cfg.n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {cfg.n_channels}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if window_committer is not None:
            if (canonical_device(window_committer.device)
                    != canonical_device(self.device)):
                raise ValueError(
                    f"window committer on {window_committer.device}, engine "
                    f"on {self.device}")
            if window_committer.n_channels != cfg.n_channels:
                raise ValueError(
                    f"window committer drives {window_committer.n_channels} "
                    f"channels, engine is configured for {cfg.n_channels}")
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
        self.health_rollup = obs_mod.HealthRollup(
            cfg.slo, n_channels=cfg.n_channels)
        # The journal rides the storage role's writer thread, attached only
        # when the durability layer is configured (a snapshot cadence or an
        # on-disk journal); the commit-path head is independent of it. Each
        # channel journals into its own channel_dir.
        want_journal = (cfg.store_blocks and cfg.peer.journal
                        and (cfg.snapshot_every_blocks > 0
                             or cfg.journal_dir is not None))

        def make_journal(c: int):
            if not want_journal:
                return None
            spill = (ledger.channel_dir(cfg.journal_dir, c)
                     if cfg.journal_dir is not None else None)
            return state_journal.StateJournal(cfg.dims, spill_dir=spill,
                                              metrics=self.obs.registry)

        self.chans = [
            _Channel(cfg, self.device, make_journal(c),
                     cfg.n_buckets if window_committer is None
                     else window_committer.n_buckets_for(c))
            for c in range(cfg.n_channels)]
        # ONE store multiplexes every channel's chain and journal.
        self.store = None
        if cfg.store_blocks:
            if cfg.block_dir is not None:
                os.makedirs(cfg.block_dir, exist_ok=True)
            self.store = ledger.BlockStore(cfg.block_dir,
                                           journal=self.chans[0].journal)
            for c in range(1, cfg.n_channels):
                if self.chans[c].journal is not None:
                    self.store.set_journal(c, self.chans[c].journal)
        self.total_valid = 0
        self.total_txs = 0

    # -- channel 0: the single-channel API ---------------------------------------

    peer_state = _shim("peer_state", "Channel 0's committer-peer state.")
    endorser_state = _shim("endorser_state")
    log_head = _shim("log_head")
    journal = _shim("journal")
    snapshots = _shim("snapshots")
    reanchor_log = _shim("reanchor_log")
    n_buckets = _shim("n_buckets", "Channel 0's CURRENT table layout.")
    next_block_no = _shim("next_block_no")
    overflow = _shim("overflow", "Channel 0's sticky overflow flag.")
    repaired_bits = _shim("repaired_bits")
    restored_overflow_bits = _shim("restored_overflow_bits")
    obs_seen_bits = _shim("obs_seen_bits")

    @property
    def n_channels(self) -> int:
        return self.cfg.n_channels

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wc = self.window_committer
        if wc is not None and wc.mesh is not None:
            wc.block_until_ready()

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

    # -- rounds ----------------------------------------------------------------

    def run_round(self, proposals: endorser.Proposal,
                  channel: int = 0) -> RoundStats:
        """One round on ``channel``: endorse (untimed) -> order -> commit ->
        replica update.

        As in the paper's measurement, the client sends pre-endorsed
        transactions, so endorsement and marshaling are outside the timed
        window, and the endorser replica updates after it. A multi-channel
        window committer commits every channel's window together: drive it
        with :meth:`run_rounds`. An exception escaping the round trips the
        flight recorder (``exception``).
        """
        if self.window_committer is not None and self.cfg.n_channels > 1:
            raise ValueError(
                "multi-channel window committer commits all channels per "
                "dispatch: drive rounds with run_rounds(proposals_by_"
                "channel)")
        try:
            return self._round(proposals, channel)
        except Exception as e:
            self._fault("exception", where="run_round", channel=channel,
                        error=repr(e))
            raise

    def run_rounds(self, proposals_by_channel: list) -> list[RoundStats]:
        """One round on EVERY channel (entry c drives channel c).

        Without a window committer the channels run back to back on the
        host path; with one, every channel is ordered and then each window
        position commits on every channel together
        (:meth:`~repro_torch.pipeline.engine_bridge.WindowCommitter.commit_windows`),
        so rounds must be shape-uniform across channels. Every returned
        ``wall_s`` is the shared wall of all channels; per-channel tx/s is
        a channel's txs over it."""
        if len(proposals_by_channel) != self.cfg.n_channels:
            raise ValueError(
                f"expected {self.cfg.n_channels} proposal batches, got "
                f"{len(proposals_by_channel)}")
        try:
            if self.window_committer is None:
                t0 = time.perf_counter()
                stats = [self._round(p, c)
                         for c, p in enumerate(proposals_by_channel)]
                wall = time.perf_counter() - t0
                return [s._replace(wall_s=wall) for s in stats]
            return self._rounds_meshed(proposals_by_channel)
        except Exception as e:
            self._fault("exception", where="run_rounds", error=repr(e))
            raise

    def _endorse(self, ch: _Channel, proposals: endorser.Proposal):
        """Endorse and marshal a channel's round (untimed): (txb, wire)."""
        cfg = self.cfg
        n = int(proposals.src.shape[0])
        if n % cfg.orderer.block_size:
            raise ValueError(f"round of {n} txs not a multiple of "
                             f"{cfg.orderer.block_size}")
        txb = endorser.execute_and_endorse(
            ch.endorser_state, proposals, cfg.dims,
            n_endorsers=cfg.n_endorsers)
        return txb, unmarshal.marshal(txb, cfg.dims)

    def _round(self, proposals: endorser.Proposal, channel: int
               ) -> RoundStats:
        cfg = self.cfg
        ch = self.chans[channel]
        n = int(proposals.src.shape[0])
        bs = cfg.orderer.block_size
        txb, wire = self._endorse(ch, proposals)
        self._sync()
        # Tx-lifecycle sidecar at submission: the tx ids (the endorser's
        # content hashes) as u32, one host copy with obs on.
        txr = self.txtrace.begin_round(
            channel, u32.to_numpy(txb.tx_id) if self.obs.on else None, bs,
            ch.next_block_no)
        t0 = time.perf_counter()

        txr.order_start()
        with self._edge("round.order", lambda: ch.log_head, channel=channel):
            blocks = orderer.order_batch(wire, txb.tx_id, txb.client,
                                         ch.log_head, cfg.orderer)
            ch.log_head = blocks.log_head
        t_order = time.perf_counter()
        txr.ordered()

        n_blocks = blocks.wire.shape[0]
        wc = self.window_committer
        if wc is not None:
            # Device-side block pipeline: a window of the committer's depth
            # a call; the span ends on the committer's device sync.
            with self._edge("round.commit", wc.sync_target,
                            n_blocks=n_blocks, channel=channel):
                retired = self._commit_windows(blocks, channel, txr)
            t_commit = time.perf_counter()
        else:
            # Commit block by block; each block leaves for the store as
            # soon as it is committed (its head, hash and validity are
            # fresh tensors).
            retired = []
            with self._edge("round.commit",
                            lambda: ch.peer_state.ledger_head,
                            n_blocks=n_blocks, channel=channel):
                for b in range(n_blocks):
                    bno = ch.next_block_no
                    ch.next_block_no += 1
                    prev_head = ch.peer_state.ledger_head
                    res = committer.commit_block(
                        ch.peer_state, blocks.wire[b], cfg.dims, cfg.peer)
                    ch.peer_state = res.state
                    ch.overflow = ch.overflow | res.overflow
                    retired.append(self._ship(blocks.wire[b], bno, prev_head,
                                              res.block_hash, res.valid,
                                              channel))
            t_commit = time.perf_counter()
            txr.validated(0, n_blocks)
            # Per-block commit latency: the round's order + commit window
            # amortized over its blocks (they are in flight together); the
            # window committer records its windows' own.
            dt = (t_commit - t0) / n_blocks
            hist = self.obs.registry.histogram("commit.latency")
            for _ in range(n_blocks):
                hist.record(dt)

        n_valid, valids = self._endorser_replay(retired, channel)
        t_replay = time.perf_counter()
        txr.committed()
        self._policy_pass((channel,))
        self._maybe_snapshot(channel)
        wall = t_commit - t0
        new_bits = self._count_round(channel, n, n_valid, wall, n_blocks)
        txr.finish(valids, overflow_latched=bool(new_bits))
        return RoundStats(
            n_txs=n, n_blocks=n_blocks, n_valid=n_valid, wall_s=wall,
            order_s=t_order - t0, commit_s=t_commit - t_order,
            replay_s=t_replay - t_commit)

    def _rounds_meshed(self, proposals_by_channel: list) -> list[RoundStats]:
        """The multi-channel window round: endorse and order every channel,
        then commit window position by window position, each one
        ``commit_windows`` call for every channel; then the replica
        updates, ONE policy pass over all channels, and per-channel
        snapshots and counts."""
        cfg = self.cfg
        nch = cfg.n_channels
        bs = cfg.orderer.block_size
        endorsed = [self._endorse(self.chans[c], p)
                    for c, p in enumerate(proposals_by_channel)]
        shapes = {tuple(w.shape) for _, w in endorsed}
        if len(shapes) > 1:
            raise ValueError(
                f"lockstep rounds need shape-uniform channels, got {shapes}")
        self._sync()
        txrs = [self.txtrace.begin_round(
            c, u32.to_numpy(endorsed[c][0].tx_id) if self.obs.on else None,
            bs, self.chans[c].next_block_no) for c in range(nch)]
        t0 = time.perf_counter()

        ordered = []
        for txr in txrs:
            txr.order_start()
        with self._edge("round.order", lambda: [b.log_head for b in ordered],
                        channels=nch):
            for c, (txb, wire) in enumerate(endorsed):
                ch = self.chans[c]
                blocks = orderer.order_batch(wire, txb.tx_id, txb.client,
                                             ch.log_head, cfg.orderer)
                ch.log_head = blocks.log_head
                ordered.append(blocks)
        t_order = time.perf_counter()
        for txr in txrs:
            txr.ordered()

        wc = self.window_committer
        n_blocks = ordered[0].wire.shape[0]
        retired: list[list] = [[] for _ in range(nch)]
        with self._edge("round.commit", wc.sync_target, n_blocks=n_blocks,
                        channels=nch):
            for lo in range(0, n_blocks, wc.depth):
                hi = min(lo + wc.depth, n_blocks)
                res = wc.commit_windows(
                    torch.stack([b.wire[lo:hi] for b in ordered]),
                    torch.stack([b.tx_ids[lo:hi] for b in ordered]))
                # The window's chain hashes came to the host in its drain
                # span: blocks [lo, hi) of every channel validated there.
                for txr in txrs:
                    txr.validated(lo, hi)
                for c in range(nch):
                    ch = self.chans[c]
                    for k in range(hi - lo):
                        bno = ch.next_block_no
                        ch.next_block_no += 1
                        retired[c].append(self._ship(
                            ordered[c].wire[lo + k], bno, res.prev_hash[c, k],
                            res.block_hash[c, k], res.valid[c, k], c))
        t_commit = time.perf_counter()

        replayed = []
        for c in range(nch):
            replayed.append(self._endorser_replay(retired[c], c))
            txrs[c].committed()
        t_replay = time.perf_counter()
        self._policy_pass(range(nch))
        wall = t_commit - t0
        stats = []
        for c in range(nch):
            n = int(proposals_by_channel[c].src.shape[0])
            n_valid, valids = replayed[c]
            self._maybe_snapshot(c)
            new_bits = self._count_round(c, n, n_valid, wall, n_blocks)
            txrs[c].finish(valids, overflow_latched=bool(new_bits))
            stats.append(RoundStats(
                n_txs=n, n_blocks=n_blocks, n_valid=n_valid, wall_s=wall,
                order_s=t_order - t0, commit_s=t_commit - t_order,
                replay_s=t_replay - t_commit))
        return stats

    def _commit_windows(self, blocks, channel: int, txr) -> list:
        """Slice one channel's ordered round into windows of the
        committer's depth (a shorter tail window last), commit each, and
        ship every block to the store with the committer's chain hashes
        (single-channel committer)."""
        wc = self.window_committer
        ch = self.chans[channel]
        retired = []
        n_blocks = blocks.wire.shape[0]
        for lo in range(0, n_blocks, wc.depth):
            hi = min(lo + wc.depth, n_blocks)
            res = wc.commit_window(blocks.wire[lo:hi], blocks.tx_ids[lo:hi])
            # The window's chain hashes came to the host in its drain span:
            # blocks [lo, hi) validated on that edge.
            txr.validated(lo, hi)
            for k in range(hi - lo):
                bno = ch.next_block_no
                ch.next_block_no += 1
                retired.append(self._ship(blocks.wire[lo + k], bno,
                                          res.prev_hash[k], res.block_hash[k],
                                          res.valid[k], channel))
        return retired

    def _endorser_replay(self, retired: list, channel: int) -> tuple:
        """Endorser replica updates for one channel's retired blocks;
        returns ``(n_valid, valid_by_block)``. With obs on, each block's
        validity comes to the host once (the tx-outcome feed; it replaces
        the count's read), else ``valid_by_block`` is None."""
        ch = self.chans[channel]
        n_valid = 0
        valids: list | None = [] if self.obs.on else None
        with self._edge("round.endorser_replay",
                        lambda: ch.endorser_state.versions, channel=channel):
            for wire_b, valid in retired:
                dec = unmarshal.unmarshal(wire_b, self.cfg.dims)
                ch.endorser_state = endorser.apply_validated(
                    ch.endorser_state, dec.txb, valid)
                if valids is not None:
                    v = valid.cpu().numpy()
                    valids.append(v)
                    n_valid += int(v.sum())
                else:
                    n_valid += int(valid.sum())
        return n_valid, valids

    def _count_round(self, channel: int, n: int, n_valid: int,
                     wall_s: float, n_blocks: int) -> int:
        """Fold one channel's round into the totals, the health rollup and
        (obs on) the overflow gauges and the recorder's periodic snapshot;
        several channels also count ``txs.valid{channel=c}`` and
        ``txs.invalid{channel=c}``. Returns the NEWLY latched sticky
        overflow bits (0 with obs off): a non-zero return is a fault
        edge."""
        ch = self.chans[channel]
        ch.total_valid += n_valid
        ch.total_txs += n
        self.total_valid += n_valid
        self.total_txs += n
        reg = self.obs.registry
        reg.counter("txs.valid").inc(n_valid)
        reg.counter("txs.invalid").inc(n - n_valid)
        if self.cfg.n_channels > 1:
            reg.counter("txs.valid", channel=channel).inc(n_valid)
            reg.counter("txs.invalid", channel=channel).inc(n - n_valid)
        self.health_rollup.push_round(channel, n_txs=n, n_valid=n_valid,
                                      wall_s=wall_s, n_blocks=n_blocks)
        new_bits = 0
        if self.obs.on:
            new_bits = self._record_overflow_metrics(channel)
            self.recorder.snapshot_registry()
            if new_bits:
                self._fault("overflow_latch", channel=channel, bits=new_bits)
        return new_bits

    def _ship(self, wire_b, bno: int, prev_head, block_hash, valid,
              channel: int = 0):
        """A block leaves the pipeline: async handoff to the storage role."""
        if self.store is not None:
            with self.obs.tracer.span("block.ship", block_no=bno,
                                      channel=channel):
                self.store.submit(bno, prev_head, block_hash, wire_b, valid,
                                  channel=channel)
        return wire_b, valid

    # -- observability ---------------------------------------------------------

    def metrics(self) -> dict:
        """One-call snapshot of every engine metric (the registry's
        ``collect``): counters/gauges as numbers, histograms as
        count/sum/mean/p50/p95/p99 dicts. Empty when obs is off."""
        return self.obs.registry.collect()

    def stats_text(self) -> str:
        """Prometheus text exposition of the engine metrics (per-channel
        series carry a ``channel`` label)."""
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
        with per-channel, per-shard reasons. Feeds the rollup every
        channel's live sticky overflow bits and per-shard occupancy (one
        stacked read), evaluates the rolling round window, and with obs on
        mirrors the verdict onto the ``health.status`` /
        ``health.channel{channel=c}`` gauges. Works with obs off, creating
        no gauge."""
        chans = range(self.cfg.n_channels)
        stats = self._shard_stats(chans)
        for c in chans:
            occ, _min_free, cap, bits = stats[c]
            self.health_rollup.set_overflow(c, bits)
            self.health_rollup.set_occupancy(c, [int(o) / cap for o in occ])
        verdict = self.health_rollup.evaluate()
        if self.obs.on:
            reg = self.obs.registry
            reg.gauge("health.status").set(
                obs_mod.STATUS_RANK[verdict.status])
            for c, info in verdict.channels.items():
                reg.gauge("health.channel", channel=c).set(
                    obs_mod.STATUS_RANK[info["status"]])
        return verdict

    def _record_overflow_metrics(self, channel: int = 0) -> int:
        """A channel's per-shard overflow bits as a gauge labeled
        ``{channel, shard}`` and a latch counter that fires once per NEWLY
        set bit (one overflow read; obs on only). Returns the newly latched
        bits."""
        ch = self.chans[channel]
        bits = self.overflow_bits(channel)
        reg = self.obs.registry
        new = bits & ~ch.obs_seen_bits
        if new:
            reg.counter("overflow.latches").inc(bin(new).count("1"))
            ch.obs_seen_bits |= bits
        for m in range(self.n_shards):
            reg.gauge("state.shard_overflow", channel=channel,
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

    def _state_view(self, channel: int = 0) -> ws.HashState:
        """A channel's committed table: the window committer's, or the
        per-block peer state's."""
        if self.window_committer is not None:
            return self.window_committer.hash_state(channel)
        return self.chans[channel].peer_state.hash_state

    def _peer_digest(self, channel: int = 0) -> np.ndarray:
        if self.window_committer is not None:
            return self.window_committer.state_digest(channel)
        return u32.to_numpy(ws.state_digest(self._state_view(channel)))

    def _peer_journal_head(self, channel: int = 0) -> np.ndarray:
        if self.window_committer is not None:
            return self.window_committer.journal_head_for(channel)
        return u32.to_numpy(self.chans[channel].peer_state.journal_head)

    def _ledger_head(self, channel: int = 0) -> np.ndarray:
        if self.window_committer is not None:
            return self.window_committer.ledger_head_for(channel)
        return u32.to_numpy(self.chans[channel].peer_state.ledger_head)

    def _shard_stats(self, channels) -> dict:
        """channel -> (per-shard occupancy ``(M,)``, min free slots,
        per-shard slot capacity, sticky overflow bits) for every channel of
        ``channels``, in ONE stacked device read (one a shape group with a
        window committer). Restored overflow bits are ORed in, as in
        :meth:`overflow_bits`."""
        channels = list(channels)
        if self.window_committer is not None:
            stats = self.window_committer.shard_stats(channels)
            return {c: (occ, mf, cap,
                        bits | self.chans[c].restored_overflow_bits)
                    for c, (occ, mf, cap, bits) in stats.items()}
        m = self.n_shards
        parts = []
        for c in channels:
            ch = self.chans[c]
            st = ch.peer_state.hash_state
            parts += [ws.shard_occupancy(st, m), ws.shard_min_free(st, m),
                      ch.overflow.reshape(1).long()]
        host = torch.cat(parts).cpu().numpy()
        out = {}
        for i, c in enumerate(channels):
            ch = self.chans[c]
            row = host[i * (2 * m + 1):(i + 1) * (2 * m + 1)]
            st = ch.peer_state.hash_state
            out[c] = (row[:m], int(row[m:2 * m].min()),
                      st.n_buckets // m * st.slots,
                      int(row[-1]) | ch.restored_overflow_bits)
        return out

    def _policy_pass(self, channels) -> dict:
        """The between-rounds policy trigger: one stacked stats read
        (:meth:`_shard_stats`) drives every channel's grow/shrink decision
        (grow under bucket pressure or after an overflow, shrink a mostly
        empty table), its ``state.occupancy`` / ``state.health`` gauges and
        the health rollup's occupancy feed. No policy, no device read.
        Returns ``{channel: resize info}`` for the channels that resized."""
        pol = self.cfg.resize_policy
        if pol is None:
            return {}
        channels = list(channels)
        stats = self._shard_stats(channels)
        reg = self.obs.registry
        if self.obs.on:
            reg.counter("resize.policy_checks").inc(len(channels))
        out = {}
        for c in channels:
            ch = self.chans[c]
            occ, min_free, cap, bits = stats[c]
            fills = [int(o) / cap for o in occ]
            self.health_rollup.set_occupancy(c, fills)
            pressure = bool(
                (pol.grow_free_slots and min_free <= pol.grow_free_slots)
                or (pol.grow_fill and max(fills) >= pol.grow_fill))
            if self.obs.on:
                reg.gauge("state.occupancy", channel=c).set(max(fills))
                # 2 = overflowed (fail-stop shard), 1 = under grow
                # pressure, 0 = headroom.
                reg.gauge("state.health", channel=c).set(
                    2 if bits else (1 if pressure else 0))
            # Capacity repair: one overflow-triggered grow per NEWLY latched
            # bit (the mask is sticky; comparing with the repaired bits
            # keeps it from firing every round).
            if pressure or (pol.grow_on_overflow
                            and bits & ~ch.repaired_bits):
                if ch.n_buckets * 2 <= pol.max_buckets:
                    self.obs.tracer.event(
                        "resize.decision", action="grow", min_free=min_free,
                        overflow_bits=bits, n_buckets=ch.n_buckets,
                        channel=c)
                    ch.repaired_bits |= bits
                    out[c] = self.resize(ch.n_buckets * 2, c)
                elif bits & ~ch.repaired_bits:
                    # Overflowed at the ceiling: the repair cannot run, a
                    # fault edge. The bits count as repaired so it trips
                    # once.
                    ch.repaired_bits |= bits
                    self._fault("resize_refused", channel=c,
                                n_buckets=ch.n_buckets,
                                max_buckets=pol.max_buckets,
                                overflow_bits=bits)
                continue
            if (pol.shrink_fill and ch.n_buckets // 2 >= pol.min_buckets
                    and int(occ.sum()) < pol.shrink_fill
                    * (ch.n_buckets // 2) * self.cfg.slots):
                self.obs.tracer.event(
                    "resize.decision", action="shrink",
                    occupancy=int(occ.sum()), n_buckets=ch.n_buckets,
                    channel=c)
                out[c] = self.resize(ch.n_buckets // 2, c)
        return out

    def resize(self, new_n_buckets: int, channel: int = 0) -> dict:
        """Halve or double ONE channel's world state NOW (between rounds):
        drain the store, rehash the channel's peer table and endorser
        replica (its capacity must track the peer's, or the two diverge on
        which inserts drop), and commit a re-anchor record at the drained
        boundary to the channel's journal, when one is attached, so replay
        and recovery cross the epoch. Other channels are untouched.
        Returns the epoch's info dict (the reference's keys)."""
        if self.store is not None:
            self.store.drain()  # the journal tip must be at the boundary
        ch = self.chans[channel]
        old_nb = ch.n_buckets
        hot = self._hot_shard(channel)
        wc = self.window_committer
        if wc is not None:
            try:
                info = wc.resize(new_n_buckets, channel)
            except ValueError as e:
                # The committer refused the epoch: a fault edge, as the
                # caller believed a capacity change was needed.
                self._fault("resize_refused", channel=channel,
                            n_buckets=old_nb, requested=new_n_buckets,
                            error=str(e))
                raise
            tree, bits = info.tree_head, info.overflow_bits
        else:
            res = ws.resize(ch.peer_state.hash_state, new_n_buckets)
            ch.peer_state = ch.peer_state._replace(hash_state=res.state)
            ch.overflow = ch.overflow | res.overflow
            tree, bits = (ws.tree_head(res.state, self.n_shards),
                          self.overflow_bits(channel))
        ch.endorser_state = ws.resize(ch.endorser_state, new_n_buckets).state
        ch.n_buckets = new_n_buckets
        bno = ch.next_block_no - 1
        if ch.journal is not None:
            ch.journal.append_reanchor(
                bno, old_n_buckets=old_nb, new_n_buckets=new_n_buckets,
                n_shards=self.n_shards, tree_head=tree, overflow_bits=bits)
        info = {"block_no": bno, "old_n_buckets": old_nb,
                "new_n_buckets": new_n_buckets, "overflow_bits": bits,
                "hot_shard": hot, "channel": channel}
        ch.reanchor_log.append((bno, new_n_buckets))
        self.obs.registry.counter(
            "resize.grow" if new_n_buckets > old_nb else "resize.shrink"
        ).inc()
        self.obs.tracer.event("resize.epoch", **info)
        return info

    def _hot_shard(self, channel: int = 0) -> int:
        if self.window_committer is not None:
            return self.window_committer.hot_shard(channel)
        return ws.hot_shard(
            self.overflow_bits(channel),
            ws.shard_occupancy(self.chans[channel].peer_state.hash_state,
                               self.n_shards))

    # -- durability layer (storage/) --------------------------------------------

    def _maybe_snapshot(self, channel: int = 0) -> None:
        """Snapshot cadence of one channel, after its replica update: every
        ``snapshot_every_blocks`` of its committed blocks, drain the
        storage role, snapshot the channel's table into its
        ``channel_dir``, save and collect garbage (two kept), and prune the
        channel's chain and journal up to the snapshot BEFORE the newest,
        so the previous one stays recoverable if the newest is lost."""
        cfg = self.cfg
        if not cfg.snapshot_every_blocks:
            return
        ch = self.chans[channel]
        last = ch.snapshots[-1].block_no if ch.snapshots else -1
        tip = ch.next_block_no - 1
        if tip - last < cfg.snapshot_every_blocks:
            return
        self.store.drain()  # the journal must cover every shipped block
        with self.obs.tracer.span("snapshot.take", block_no=tip,
                                  channel=channel):
            wc = self.window_committer
            snap = snapshot.take(
                self._state_view(channel) if wc is None
                else wc.shard_tables(channel), block_no=tip,
                journal_head=self._peer_journal_head(channel),
                ledger_head=self._ledger_head(channel),
                n_shards=self.n_shards,
                overflow_bits=self.overflow_bits(channel),
                reanchor_head=ch.journal.reanchor_head)
        ch.snapshots.append(snap)
        reg = self.obs.registry
        if cfg.snapshot_dir is not None:
            sdir = ledger.channel_dir(cfg.snapshot_dir, channel)
            snapshot.save(sdir, snap, registry=reg)
            snapshot.gc(sdir, keep=2, registry=reg)
        if cfg.prune_chain and len(ch.snapshots) >= 2:
            base = ch.snapshots[-2].block_no
            self.store.prune_upto(base, channel)
            ch.journal.prune_upto(base)
            ch.snapshots = ch.snapshots[-2:]

    def recover(self, channel: int = 0) -> recovery.RecoveryResult:
        """Cold-start recovery of one channel on the engine's device from
        its newest snapshot + its journal suffix."""
        ch = self.chans[channel]
        if ch.journal is None:
            raise recovery.RecoveryError("engine has no journal")
        self.store.drain()
        cfg = self.cfg
        return recovery.recover(
            ch.journal, snapshot=ch.snapshots[-1] if ch.snapshots else None,
            n_buckets=cfg.n_buckets, slots=cfg.slots,
            value_width=cfg.dims.vw, device=self.device, channel=channel)

    @classmethod
    def restore(cls, cfg: EngineConfig, *, device=None) -> "FabricEngine":
        """Restart a peer on ``device`` (default: the card) from its
        persisted snapshots and journal spills (``journal_dir`` and
        ``snapshot_dir`` required); every channel restores from its own
        ``channel_dir``s.

        When a channel's newest complete snapshot covers its journal tip,
        its heads restore directly. When it TRAILS the tip, the journal
        replays the suffix's state and the ``block_dir`` spill rebuilds its
        ledger head: the spilled blocks must chain from the snapshot's
        head, and they re-seed the channel's chain so ``verify()`` replays
        the same suffix. The persisted sticky overflow bitmask is
        re-latched (and counts as repaired, so a restart does not grow the
        table once per boot), and the channel resumes the persisted
        (post-resize) layout. As in the reference, the orderer's
        ``log_head`` restarts at genesis.
        """
        if cfg.journal_dir is None or cfg.snapshot_dir is None:
            raise recovery.RecoveryError(
                "restore requires journal_dir and snapshot_dir")
        eng = cls(cfg, device=device)
        for c in range(cfg.n_channels):
            eng._restore_channel(c)
        if eng.store is not None:
            # Once, after the last channel's journal loaded: the writer
            # feeds every restored journal from here on.
            for c, ch in enumerate(eng.chans):
                eng.store.set_journal(c, ch.journal)
        return eng

    def _restore_channel(self, channel: int) -> None:
        cfg = self.cfg
        ch = self.chans[channel]
        jrnl = state_journal.StateJournal.load(
            cfg.dims, ledger.channel_dir(cfg.journal_dir, channel),
            metrics=self.obs.registry)
        ch.journal = jrnl
        snap = snapshot.latest(ledger.channel_dir(cfg.snapshot_dir, channel))
        if snap is None:
            raise recovery.RecoveryError(
                f"no complete snapshot for channel {channel} in "
                f"{cfg.snapshot_dir}")
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
                cfg.block_dir, snap.block_no + 1, channel)
                if sb.block_no <= rec.block_no]
            if not suffix or suffix[-1].block_no != rec.block_no:
                have = suffix[-1].block_no if suffix else snap.block_no
                raise recovery.RecoveryError(
                    f"block spill covers channel {channel} only up to block "
                    f"{have}, journal tip is {rec.block_no}")
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
            ch.reanchor_log.extend(
                (r.block_no, r.new_n_buckets)
                for r in jrnl.suffix_reanchors(snap.block_no))
        word = lambda a: u32.from_numpy(np.asarray(a, np.uint32), self.device)
        ch.snapshots = [snap]
        ch.peer_state = ch.peer_state._replace(
            hash_state=rec.state, ledger_head=word(ledger_head),
            journal_head=word(rec.journal_head),
            block_no=word(np.uint32(rec.block_no + 1)).reshape(()))
        ch.endorser_state = ws.HashState(*(t.clone() for t in rec.state))
        ch.n_buckets = rec.n_buckets
        ch.restored_overflow_bits = rec.overflow_bits
        ch.repaired_bits = rec.overflow_bits
        ch.next_block_no = rec.block_no + 1
        if self.store is not None:
            # The chain re-anchors at the snapshot; a rebuilt suffix
            # re-enters it, so verify() replays what recovery replayed.
            self.store.base_block_nos[channel] = snap.block_no
            self.store.base_hashes[channel] = np.asarray(snap.ledger_head)
            self.store.chains[channel] = list(suffix)

    # -- checks ----------------------------------------------------------------

    def overflow_bits(self, channel: int = 0) -> int:
        """A channel's sticky overflow bitmask: bit 0 once a commit dropped
        a write on a full bucket (the window committer's bits when one is
        attached), ORed with the bits a restart re-latched."""
        ch = self.chans[channel]
        if self.window_committer is not None:
            bits = self.window_committer.overflow_bits_for(channel)
        else:
            bits = int(bool(ch.overflow))
        return bits | ch.restored_overflow_bits

    def overflowed(self, channel: int = 0) -> bool:
        return bool(self.overflow_bits(channel))

    def verify(self, channel: int = 0) -> dict:
        """Drain storage, verify ONE channel's chain, and check that none of
        its commits overflowed a bucket. A peer with the hash table (P-I)
        also replays the chain, from the snapshot that covers its pruned
        prefix, into a table and compares it and the endorser replica with
        the peer, by digest; the sorted store of the baseline is not
        compared, as in the reference. With a journal attached,
        ``recovery_ok`` runs :meth:`recover` and compares its state digest
        and journal head with the live peer's; without one there is no
        recovery path and it stays True. A pruned chain whose covering
        snapshot is gone fails ``chain_ok`` and ``replay_ok``. Tampering
        with channel i's chain or journal flips only channel i's
        verdicts."""
        ch = self.chans[channel]
        out = {"chain_ok": True, "replica_ok": True, "replay_ok": True,
               "recovery_ok": True, "overflow_ok": not self.overflowed(channel)}
        hashed = self.cfg.peer.hash_state
        peer = self._peer_digest(channel) if hashed else None
        if self.store is not None:
            self.store.drain()
            out["chain_ok"] = self.store.verify_chain(channel)
            base_bno = self.store.base_block_nos.get(channel, -1)
            start = None
            if base_bno >= 0:
                base = next((s for s in ch.snapshots
                             if s.block_no == base_bno), None)
                if base is None:
                    out["chain_ok"] = out["replay_ok"] = False
                else:
                    start = snapshot.to_state(base, self.device)
            if hashed and out["replay_ok"]:
                resize_at: dict = {}
                for bno, nb in ch.reanchor_log:
                    if bno > base_bno:
                        resize_at.setdefault(bno, []).append(nb)
                replayed = self.store.replay_state(
                    self.cfg.dims, self.cfg.n_buckets, self.cfg.slots,
                    start_state=start, resize_at=resize_at,
                    device=self.device, channel=channel)
                out["replay_ok"] = bool(np.array_equal(
                    u32.to_numpy(ws.state_digest(replayed)), peer))
        if ch.journal is not None and hashed:
            try:
                rec = self.recover(channel)
                out["recovery_ok"] = bool(
                    np.array_equal(rec.state_digest, peer)
                    and np.array_equal(rec.journal_head,
                                       self._peer_journal_head(channel)))
            except recovery.RecoveryError:
                out["recovery_ok"] = False
        if hashed:
            out["replica_ok"] = bool(np.array_equal(
                u32.to_numpy(ws.state_digest(ch.endorser_state)), peer))
        if not all(out.values()):
            # Fault edge: the durability contract broke. Trip the recorder
            # with the verdict, and with the journal's reason when it can
            # name the record that broke its chain.
            ctx = {"channel": channel,
                   "verdict": {k: bool(v) for k, v in out.items()}}
            if ch.journal is not None:
                jok, why = ch.journal.verify_chain_reason()
                if not jok:
                    ctx["journal_reason"] = why
            self._fault("verify_contract", **ctx)
        return out

    def verify_all(self) -> dict[int, dict]:
        """Per-channel :meth:`verify` verdicts for every channel."""
        return {c: self.verify(c) for c in range(self.cfg.n_channels)}
