"""End-to-end FastFabric engine: client -> endorse -> order -> commit ->
store (port of repro.core.engine, one channel, per-block commits).

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

Not ported yet: the window committer, resize epochs, several channels, and
observability.
"""

from __future__ import annotations

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
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.storage import journal as state_journal
from repro_torch.storage import recovery, snapshot


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
    kernels then run). ``metrics`` (an obs ``Registry``) receives the
    durability layer's journal and snapshot metrics."""

    def __init__(self, cfg: EngineConfig = FASTFABRIC, *, device=None,
                 metrics=None):
        if cfg.snapshot_every_blocks and not (
                cfg.store_blocks and cfg.peer.journal and cfg.peer.hash_state):
            raise ValueError(
                "snapshot_every_blocks requires store_blocks=True and a "
                "peer config with journal=True and hash_state=True (P-I): "
                "snapshots cover the hash-table state and recovery replays "
                "the journal the storage role materializes")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self.peer_state = committer.create_peer_state(
            cfg.dims, n_buckets=cfg.n_buckets, slots=cfg.slots,
            hash_state=cfg.peer.hash_state, device=self.device)
        self.endorser_state = ws.create(cfg.n_buckets, cfg.slots,
                                        cfg.dims.vw, device=self.device)
        self.log_head = torch.zeros((2,), dtype=u32.WORD, device=self.device)
        self.next_block_no = 0
        # Sticky: some commit dropped a write on a full bucket.
        self.overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        # The overflow bitmask a restart re-latched from its snapshot.
        self.restored_overflow_bits = 0
        # Resize epochs the chain replay must cross: (boundary block, new
        # bucket count), from the journal's re-anchor records on restore.
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
                cfg.dims, spill_dir=cfg.journal_dir, metrics=self.metrics)
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
        window, and the endorser replica updates after it.
        """
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
        t0 = time.perf_counter()

        blocks = orderer.order_batch(wire, txb.tx_id, txb.client,
                                     self.log_head, cfg.orderer)
        self.log_head = blocks.log_head
        self._sync()
        t_order = time.perf_counter()

        # Commit block by block; each block leaves for the store as soon as
        # it is committed (its head, hash and validity are fresh tensors).
        retired = []
        for b in range(blocks.wire.shape[0]):
            bno = self.next_block_no
            self.next_block_no += 1
            prev_head = self.peer_state.ledger_head
            res = committer.commit_block(self.peer_state, blocks.wire[b],
                                         cfg.dims, cfg.peer)
            self.peer_state = res.state
            self.overflow = self.overflow | res.overflow
            retired.append(self._ship(blocks.wire[b], bno, prev_head,
                                      res.block_hash, res.valid))
        self._sync()
        t_commit = time.perf_counter()

        n_valid = self._endorser_replay(retired)
        self._sync()
        t_replay = time.perf_counter()
        self._maybe_snapshot()
        self.total_valid += n_valid
        self.total_txs += n
        return RoundStats(
            n_txs=n, n_blocks=blocks.wire.shape[0], n_valid=n_valid,
            wall_s=t_commit - t0, order_s=t_order - t0,
            commit_s=t_commit - t_order, replay_s=t_replay - t_commit)

    def _endorser_replay(self, retired: list) -> int:
        """Endorser replica updates for the round's retired blocks; returns
        the number of valid transactions."""
        n_valid = 0
        for wire_b, valid in retired:
            dec = unmarshal.unmarshal(wire_b, self.cfg.dims)
            self.endorser_state = endorser.apply_validated(
                self.endorser_state, dec.txb, valid)
            n_valid += int(valid.sum())
        return n_valid

    def _ship(self, wire_b, bno: int, prev_head, block_hash, valid):
        """A block leaves the pipeline: async handoff to the storage role."""
        if self.store is not None:
            self.store.submit(bno, prev_head, block_hash, wire_b, valid)
        return wire_b, valid

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
        ps = self.peer_state
        snap = snapshot.take(
            ps.hash_state, block_no=tip, journal_head=ps.journal_head,
            ledger_head=ps.ledger_head, n_shards=cfg.snapshot_shards,
            overflow_bits=self.overflow_bits(),
            reanchor_head=self.journal.reanchor_head)
        self.snapshots.append(snap)
        if cfg.snapshot_dir is not None:
            snapshot.save(cfg.snapshot_dir, snap, registry=self.metrics)
            snapshot.gc(cfg.snapshot_dir, keep=2, registry=self.metrics)
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
    def restore(cls, cfg: EngineConfig, *, device=None, metrics=None
                ) -> "FabricEngine":
        """Restart a peer on ``device`` (default: the card) from its
        persisted snapshots and journal spill (``journal_dir`` and
        ``snapshot_dir`` required).

        When the newest complete snapshot covers the journal tip, its heads
        restore directly. When it TRAILS the tip, the journal replays the
        suffix's state and the ``block_dir`` spill rebuilds its ledger
        head: the spilled blocks must chain from the snapshot's head, and
        they re-seed the store so ``verify()`` replays the same suffix. The
        persisted sticky overflow bitmask is re-latched. As in the
        reference, the orderer's ``log_head`` restarts at genesis.
        """
        if cfg.journal_dir is None or cfg.snapshot_dir is None:
            raise recovery.RecoveryError(
                "restore requires journal_dir and snapshot_dir")
        eng = cls(cfg, device=device, metrics=metrics)
        eng._restore_channel()
        return eng

    def _restore_channel(self) -> None:
        cfg = self.cfg
        jrnl = state_journal.StateJournal.load(cfg.dims, cfg.journal_dir,
                                               metrics=self.metrics)
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
        self.restored_overflow_bits = rec.overflow_bits
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
        a full bucket, ORed with the bits a restart re-latched."""
        return int(bool(self.overflow)) | self.restored_overflow_bits

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
        ps = self.peer_state
        peer = u32.to_numpy(ws.state_digest(ps.hash_state)) if hashed else None
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
                                       u32.to_numpy(ps.journal_head)))
            except recovery.RecoveryError:
                out["recovery_ok"] = False
        if hashed:
            out["replica_ok"] = bool(np.array_equal(
                u32.to_numpy(ws.state_digest(self.endorser_state)), peer))
        return out
