"""Committer peer: the validation/commit pipeline, Opt P-I..P-III (port of
repro.core.committer).

Per block: syntactic check (payload checksum), endorsement MACs (sig_mac
kernel), read-set lookup (hash-table kernel, or a bisection of the sorted
store), MVCC (mvcc_validate kernel), commit of the valid writes (the
vectorized commit, the sequential commit kernel, or the sorted store's
merge), and the ledger and journal heads.

* P-III (``cache=True``, :func:`commit_block_fused`) decodes the block once
  and the stages share the decoded block.
* The baseline (``cache=False``) runs the stages as separate functions,
  :func:`stage_syntax`, :func:`stage_endorse` and :func:`stage_mvcc_commit`,
  each decoding the wire again, as Fabric 1.2's modules exchange protobuf.
* Without P-II (``parallel=False``) the endorsements are checked one
  transaction at a time; ``tx_par > 0`` checks tiles of that many.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import crypto, ledger, mvcc, types, u32, unmarshal
from repro_torch.core import world_state as ws
from repro_torch.storage import journal as state_journal

@dataclasses.dataclass(frozen=True)
class PeerConfig:
    """Cumulative optimization flags (paper's Opt P-I/P-II/P-III)."""

    hash_state: bool = True  # P-I: hash table world state (else sorted store)
    parallel: bool = True  # P-II: whole-block validation (else per tx)
    cache: bool = True  # P-III: decode once (else re-decode per stage)
    sequential_commit: bool = False  # paper-faithful serial state update
    tx_par: int = 0  # 0 = whole block at once; else tile width (Fig 7 knob)
    journal: bool = True  # journal head on the commit path

    @property
    def name(self) -> str:
        if not (self.hash_state or self.parallel or self.cache):
            return "fabric-1.2"
        tags = [t for t, on in (("P-I", self.hash_state),
                                ("P-II", self.parallel),
                                ("P-III", self.cache)) if on]
        return "+".join(tags)


FABRIC_V12_PEER = PeerConfig(
    hash_state=False, parallel=False, cache=False, sequential_commit=True,
    journal=False,
)
OPT_P1 = dataclasses.replace(FABRIC_V12_PEER, hash_state=True, journal=True)
OPT_P2 = dataclasses.replace(OPT_P1, parallel=True)
OPT_P3 = dataclasses.replace(OPT_P2, cache=True, sequential_commit=False)
FASTFABRIC_PEER = OPT_P3


class PeerState(NamedTuple):
    """World state + authentication heads, threaded through block commits.
    The hash table is updated in place; the sorted store and the heads are
    new tensors per block. ``sorted_state`` exists only for a peer without
    P-I (``hash_state=False``); its hash table then stays empty.
    """

    hash_state: ws.HashState
    sorted_state: ws.SortedState | None
    ledger_head: torch.Tensor  # (2,) u32
    block_no: torch.Tensor  # () u32
    journal_head: torch.Tensor  # (2,) u32


def create_peer_state(dims: types.FabricDims, *, n_buckets: int = 1 << 12,
                      slots: int = 8, hash_state: bool = True, device=None
                      ) -> PeerState:
    """Fresh peer state on ``device`` (default: the card; raises without
    one unless ``device='cpu'``). ``hash_state=False`` adds the sorted
    store, of capacity ``n_buckets * slots``."""
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=u32.WORD, device=dev)
    sorted_state = (None if hash_state else
                    ws.sorted_create(n_buckets * slots, dims.vw, dev))
    return PeerState(hash_state=ws.create(n_buckets, slots, dims.vw, dev),
                     sorted_state=sorted_state, ledger_head=z(2),
                     block_no=z(), journal_head=z(2))


class BlockResult(NamedTuple):
    state: PeerState
    valid: torch.Tensor  # (B,) bool
    block_hash: torch.Tensor  # (2,) u32
    overflow: torch.Tensor  # () bool


def _verify_endorsements(txb: types.TxBatch, parallel: bool, tx_par: int
                         ) -> torch.Tensor:
    """(B,) bool: every endorsement tag verifies. One MAC launch a block:
    the whole block at once (P-II), tiles of ``tx_par`` transactions in
    order, or, without P-II, one transaction a step in order, the
    baseline's serial validation as ordered steps on the card. All three
    give the same bits."""
    if parallel and tx_par <= 0:
        return crypto.verify_tags(txb)
    return crypto.verify_tags(txb, step=tx_par if parallel else 1)


def _advance_journal_head(state: PeerState, txb: types.TxBatch, valid,
                          journal: bool) -> torch.Tensor:
    """Fold this block's validated write sets into the journal head."""
    if not journal:
        return state.journal_head
    return state_journal.update_head(
        state.journal_head, state.block_no,
        state_journal.write_set_digest(txb.write_keys, txb.write_vals, valid))


def _mvcc_commit(state: PeerState, wire, txb: types.TxBatch, checksum_ok,
                 endorse_ok, hash_state: bool, sequential_commit: bool,
                 journal: bool):
    """MVCC validation + state commit + ledger append on a decoded block.
    Returns (new state, valid, block hash, overflow)."""
    flat_reads = txb.read_keys.reshape(-1, 2)
    if hash_state:
        cur = ws.lookup(state.hash_state, flat_reads).versions
    else:
        cur = ws.sorted_lookup(state.sorted_state, flat_reads).versions
    res = mvcc.validate(txb, cur.reshape(txb.batch, -1),
                        checksum_ok=checksum_ok, endorse_ok=endorse_ok)
    sstate = state.sorted_state
    if hash_state:
        overflow = ws.commit(state.hash_state, txb.write_keys,
                             txb.write_vals, res.valid,
                             sequential=sequential_commit).overflow
    else:
        sstate = ws.sorted_commit(sstate, txb.write_keys, txb.write_vals,
                                  res.valid)
        overflow = torch.zeros((), dtype=torch.bool, device=wire.device)
    digest = ledger.block_body_digest(wire, res.valid)
    bh = ledger.append_hash(state.ledger_head, state.block_no, digest)
    jh = _advance_journal_head(state, txb, res.valid, journal)
    new_state = state._replace(sorted_state=sstate, ledger_head=bh,
                               block_no=u32.add(state.block_no, 1),
                               journal_head=jh)
    return new_state, res.valid, bh, overflow


def stage_syntax(wire: torch.Tensor, dims: types.FabricDims) -> torch.Tensor:
    """Stage 1: syntactic verification (decodes the block). (B,) bool."""
    return unmarshal.unmarshal(wire, dims).checksum_ok


def stage_endorse(wire: torch.Tensor, dims: types.FabricDims, parallel: bool,
                  tx_par: int) -> torch.Tensor:
    """Stage 2: endorsement policy validation (decodes again). (B,) bool."""
    return _verify_endorsements(unmarshal.unmarshal(wire, dims).txb,
                                parallel, tx_par)


def stage_mvcc_commit(state: PeerState, wire: torch.Tensor, checksum_ok,
                      endorse_ok, dims: types.FabricDims, hash_state: bool,
                      sequential_commit: bool, journal: bool):
    """Stages 3+4: MVCC validation + state commit + ledger append, on a
    third decode of the block. Returns (new state, valid, block hash,
    overflow)."""
    txb = unmarshal.unmarshal(wire, dims).txb
    return _mvcc_commit(state, wire, txb, checksum_ok, endorse_ok,
                        hash_state, sequential_commit, journal)


def commit_block_fused(state: PeerState, wire: torch.Tensor,
                       dims: types.FabricDims, cfg: PeerConfig):
    """P-III path: one decode; the stages share the decoded block.
    Returns (new state, valid, block hash, overflow)."""
    dec = unmarshal.unmarshal(wire, dims)
    endorse_ok = _verify_endorsements(dec.txb, cfg.parallel, cfg.tx_par)
    return _mvcc_commit(state, wire, dec.txb, dec.checksum_ok, endorse_ok,
                        cfg.hash_state, cfg.sequential_commit, cfg.journal)


def commit_block(state: PeerState, wire: torch.Tensor,
                 dims: types.FabricDims, cfg: PeerConfig) -> BlockResult:
    """Run one block through the validation pipeline under ``cfg``: the
    fused single-decode path under P-III, else the three stages, each
    decoding the wire again."""
    if cfg.cache:
        new_state, valid, bh, ovf = commit_block_fused(state, wire, dims, cfg)
    else:
        checksum_ok = stage_syntax(wire, dims)
        endorse_ok = stage_endorse(wire, dims, cfg.parallel, cfg.tx_par)
        new_state, valid, bh, ovf = stage_mvcc_commit(
            state, wire, checksum_ok, endorse_ok, dims, cfg.hash_state,
            cfg.sequential_commit, cfg.journal)
    return BlockResult(state=new_state, valid=valid, block_hash=bh,
                       overflow=ovf)
