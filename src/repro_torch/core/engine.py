"""End-to-end FastFabric engine: client -> endorse -> order -> commit ->
store (port of repro.core.engine, one channel, per-block commits).

  client (synthetic proposals, numpy: both packages see the same ones)
    -> endorser (transfer chaincode on the replica; MAC tags)
    -> orderer (Fabric 1.2 or O-I/O-II; blocks of ``block_size``)
    -> committer peer (Fabric 1.2, P-I, P-I+II or P-I+II+III)
    -> block store (writer thread, off the critical path)
    -> endorser replica update

Not ported yet: the window committer, snapshots and the journal, resize
epochs, several channels, and observability.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (committer, endorser, ledger, orderer, types,
                              u32, unmarshal)
from repro_torch.core import world_state as ws


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dims: types.FabricDims = types.TEST_DIMS
    orderer: orderer.OrdererConfig = orderer.OrdererConfig()
    peer: committer.PeerConfig = committer.FASTFABRIC_PEER
    n_buckets: int = 1 << 12
    slots: int = 8
    n_endorsers: int = 3
    store_blocks: bool = True


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
    kernels then run)."""

    def __init__(self, cfg: EngineConfig = FASTFABRIC, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.peer_state = committer.create_peer_state(
            cfg.dims, n_buckets=cfg.n_buckets, slots=cfg.slots,
            hash_state=cfg.peer.hash_state, device=self.device)
        self.endorser_state = ws.create(cfg.n_buckets, cfg.slots,
                                        cfg.dims.vw, device=self.device)
        self.log_head = torch.zeros((2,), dtype=u32.WORD, device=self.device)
        self.next_block_no = 0
        # Sticky: some commit dropped a write on a full bucket.
        self.overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        self.store = ledger.BlockStore() if cfg.store_blocks else None
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

    # -- checks ----------------------------------------------------------------

    def overflowed(self) -> bool:
        return bool(self.overflow)

    def verify(self) -> dict:
        """Drain storage, verify the chain, and check that no commit
        overflowed a bucket. A peer with the hash table (P-I) also replays
        the chain into a fresh table and compares the replay and the
        endorser replica with it, by digest; the sorted store of the
        baseline is not compared, as in the reference. ``recovery_ok``
        stays True: without a journal there is no recovery path to prove."""
        out = {"chain_ok": True, "replica_ok": True, "replay_ok": True,
               "recovery_ok": True, "overflow_ok": not self.overflowed()}
        hashed = self.cfg.peer.hash_state
        peer = ws.state_digest(self.peer_state.hash_state) if hashed else None
        if self.store is not None:
            self.store.drain()
            out["chain_ok"] = self.store.verify_chain()
            if hashed:
                replayed = self.store.replay_state(
                    self.cfg.dims, self.cfg.n_buckets, self.cfg.slots,
                    device=self.device)
                out["replay_ok"] = bool(torch.equal(
                    ws.state_digest(replayed), peer))
        if hashed:
            out["replica_ok"] = bool(torch.equal(
                ws.state_digest(self.endorser_state), peer))
        return out
