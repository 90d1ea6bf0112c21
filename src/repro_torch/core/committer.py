"""Committer peer: the validation/commit pipeline, Opt P-I..P-III (port of
repro.core.committer, the fused P-III path).

Per block: decode once, verify the endorsement MACs (sig_mac kernel), look
up the read set (hash-table kernel), run MVCC (mvcc_validate kernel), commit
the valid writes to the hash table, and advance the ledger and journal
heads. The staged baseline (``stage_*``), the sorted store, tiled/serial
endorsement checks and the sequential commit belong to the next slice of the
port; their configurations raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import crypto, ledger, mvcc, types, u32, unmarshal
from repro_torch.core import world_state as ws
from repro_torch.storage import journal as state_journal

_NEXT_SLICE = "the baseline-ladder slice of the port (FABRIC_V12/OPT_P1/OPT_P2)"


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


def check_supported(cfg: PeerConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration this slice of the
    port does not run."""
    missing = [what for what, off in (
        ("cache=False (the staged stage_* committer)", not cfg.cache),
        ("hash_state=False (the sorted store)", not cfg.hash_state),
        ("sequential_commit=True (commit_sequential and its kernel)",
         cfg.sequential_commit),
        ("parallel=False or tx_par>0 (serial or tiled endorsement checks)",
         not cfg.parallel or cfg.tx_par > 0),
    ) if off]
    if missing:
        raise NotImplementedError(
            f"PeerConfig {cfg.name}: {'; '.join(missing)} belongs to "
            f"{_NEXT_SLICE}")


class PeerState(NamedTuple):
    """World state + authentication heads, threaded through block commits.
    The hash table is updated in place; the heads are new tensors per block.
    """

    hash_state: ws.HashState
    ledger_head: torch.Tensor  # (2,) u32
    block_no: torch.Tensor  # () u32
    journal_head: torch.Tensor  # (2,) u32


def create_peer_state(dims: types.FabricDims, *, n_buckets: int = 1 << 12,
                      slots: int = 8, device=None) -> PeerState:
    """Fresh peer state on ``device`` (default: the card; raises without
    one unless ``device='cpu'``)."""
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=u32.WORD, device=dev)
    return PeerState(hash_state=ws.create(n_buckets, slots, dims.vw, dev),
                     ledger_head=z(2), block_no=z(), journal_head=z(2))


class BlockResult(NamedTuple):
    state: PeerState
    valid: torch.Tensor  # (B,) bool
    block_hash: torch.Tensor  # (2,) u32
    overflow: torch.Tensor  # () bool


def _verify_endorsements(txb: types.TxBatch, parallel: bool, tx_par: int
                         ) -> torch.Tensor:
    if parallel and tx_par <= 0:
        return crypto.verify_tags(txb)
    raise NotImplementedError(
        f"serial or tiled endorsement checks belong to {_NEXT_SLICE}")


def _advance_journal_head(state: PeerState, txb: types.TxBatch, valid,
                          journal: bool) -> torch.Tensor:
    """Fold this block's validated write sets into the journal head."""
    if not journal:
        return state.journal_head
    return state_journal.update_head(
        state.journal_head, state.block_no,
        state_journal.write_set_digest(txb.write_keys, txb.write_vals, valid))


def commit_block_fused(state: PeerState, wire: torch.Tensor,
                       dims: types.FabricDims, cfg: PeerConfig):
    """P-III path: one decode; the stages share the decoded block.
    Returns (new state, valid, block hash, overflow)."""
    dec = unmarshal.unmarshal(wire, dims)
    txb = dec.txb
    endorse_ok = _verify_endorsements(txb, cfg.parallel, cfg.tx_par)
    cur = ws.lookup(state.hash_state, txb.read_keys.reshape(-1, 2)
                    ).versions.reshape(txb.batch, -1)
    res = mvcc.validate(txb, cur, checksum_ok=dec.checksum_ok,
                        endorse_ok=endorse_ok)
    cres = ws.commit(state.hash_state, txb.write_keys, txb.write_vals,
                     res.valid, sequential=cfg.sequential_commit)
    digest = ledger.block_body_digest(wire, res.valid)
    bh = ledger.append_hash(state.ledger_head, state.block_no, digest)
    jh = _advance_journal_head(state, txb, res.valid, cfg.journal)
    new_state = PeerState(hash_state=cres.state, ledger_head=bh,
                          block_no=u32.add(state.block_no, 1),
                          journal_head=jh)
    return new_state, res.valid, bh, cres.overflow


def commit_block(state: PeerState, wire: torch.Tensor,
                 dims: types.FabricDims, cfg: PeerConfig) -> BlockResult:
    """Run one block through the validation pipeline under ``cfg``."""
    check_supported(cfg)
    new_state, valid, bh, ovf = commit_block_fused(state, wire, dims, cfg)
    return BlockResult(state=new_state, valid=valid, block_hash=bh,
                       overflow=ovf)
