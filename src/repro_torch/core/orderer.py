"""Ordering service: Fabric 1.2 baseline vs FastFabric Opt O-I / O-II (port
of repro.core.orderer).

* Baseline: full marshaled transactions go through consensus and proposals
  are admitted one at a time.
* O-I: only transaction IDs enter consensus; payloads are reassembled by an
  ID -> payload hash join once the ordered IDs come back.
* O-II: admission runs over all proposals at once.

The consensus log is a chain hash over everything published. The order is a
deterministic interleave of client streams: a stable sort of an ID hash,
taken on the UNSIGNED value of the hash (a sort of the int32 storage would
give another order and other blocks).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import crypto, hashing, u32, unmarshal


@dataclasses.dataclass(frozen=True)
class OrdererConfig:
    """Feature flags. Fabric 1.2 = both False; FastFabric = both True."""

    separate_metadata: bool = True  # Opt O-I
    pipelined: bool = True  # Opt O-II
    block_size: int = 100

    @property
    def name(self) -> str:
        tags = [t for t, on in (("O-I", self.separate_metadata),
                                ("O-II", self.pipelined)) if on]
        return "+".join(tags) if tags else "fabric-1.2"


class OrderedBlocks(NamedTuple):
    """One ordering round: blocks of marshaled transactions."""

    wire: torch.Tensor  # (n_blocks, block_size, WB) u8
    tx_ids: torch.Tensor  # (n_blocks, block_size, 2) u32
    log_head: torch.Tensor  # (2,) u32 consensus log chain hash
    auth_ok: torch.Tensor  # (N,) bool per-proposal admission flag
    join_ok: torch.Tensor  # (N,) bool ID -> payload reassembly hit, in order


# Registered clients (membership service provider table size).
N_REGISTERED = 1 << 16


def _admission(tx_id: torch.Tensor, client: torch.Tensor,
               step: int | None = None):
    """Client authorization at admission: registry membership plus an
    admission MAC over the header, stamped into the published words.
    ``step`` proposals a step on the card (1: one at a time, in order).
    Returns (stamp (N,) u32, auth_ok (N,) bool)."""
    r, s = crypto.endorser_keys(1, device=tx_id.device)
    words = torch.stack([tx_id[..., 0], tx_id[..., 1], client], dim=-1)
    tag = crypto.poly_mac(words.reshape(-1, 3), r[0], s[0], step)
    return tag.reshape(client.shape), u32.lt(client, N_REGISTERED)


def consensus_order(tx_ids: torch.Tensor) -> torch.Tensor:
    """Deterministic total order (N,): stable argsort of an ID hash."""
    mix = hashing.hash_u32(tx_ids[:, 0] ^ hashing.hash_u32(tx_ids[:, 1]))
    return torch.argsort(u32.to_u64(mix), stable=True)


def _log_chain(head: torch.Tensor, words: torch.Tensor, *, serial: bool
               ) -> torch.Tensor:
    """Replicate ``words`` (N, W) through the consensus log chain hash.

    ``serial`` hashes one row at a time into the head (baseline one-by-one
    admission); otherwise the rows are hashed together and their digests
    folded into the head in one sequential pass (a single leader append).
    """
    if serial:
        # Both lanes of the head in one chain: row i, seeded by head[i].
        for row in words:
            head = hashing.hash_words(row.expand(2, -1), seed=head)
        return head
    return hashing.fold(head, hashing.hash_words(words, seed=hashing.SEED_A))


def order_batch(wire: torch.Tensor, tx_ids: torch.Tensor,
                clients: torch.Tensor, log_head: torch.Tensor,
                cfg: OrdererConfig) -> OrderedBlocks:
    """Order one round of N proposals into N / block_size blocks."""
    n, wb = wire.shape
    if n % cfg.block_size:
        raise ValueError(f"round size {n} not a multiple of {cfg.block_size}")

    # Admission: every proposal at once (O-II), or one at a time, in order
    # (one launch whose steps are the proposals).
    stamp, auth_ok = _admission(tx_ids, clients,
                                step=None if cfg.pipelined else 1)

    # Publish to the consensus log, admission-stamped.
    if cfg.separate_metadata:
        published = torch.stack([tx_ids[:, 0] ^ stamp, tx_ids[:, 1]], dim=1)
    else:
        published = unmarshal.wire_words(wire).clone()
        published[:, 0] ^= stamp
    log_head = _log_chain(log_head, published, serial=not cfg.pipelined)

    # Consensus decides the order; reassemble ID -> payload (O-I).
    order = consensus_order(tx_ids)
    ordered_ids = tx_ids[order]
    if cfg.separate_metadata:
        join = hash_join(ordered_ids, tx_ids)
        ordered_wire = wire[join.idx.long()]
        # A reassembly miss never ships a wrong payload: the tx keeps its
        # slot but its checksum word is inverted, so the committer's
        # syntactic check flags it invalid.
        cb = 4 * unmarshal.CHECKSUM_WORD
        check = ordered_wire[:, cb:cb + 4]
        ordered_wire[:, cb:cb + 4] = torch.where(join.found[:, None], check,
                                                 ~check)
        join_ok = join.found
    else:
        ordered_wire = wire[order]
        join_ok = torch.ones((n,), dtype=torch.bool, device=wire.device)

    nb = n // cfg.block_size
    return OrderedBlocks(
        wire=ordered_wire.reshape(nb, cfg.block_size, wb),
        tx_ids=ordered_ids.reshape(nb, cfg.block_size, 2),
        log_head=log_head,
        auth_ok=auth_ok,
        join_ok=join_ok,
    )


class JoinResult(NamedTuple):
    idx: torch.Tensor  # (N,) int32 row of the store; 0 when not found
    found: torch.Tensor  # (N,) bool: query ID present in the store


def hash_join(query_ids: torch.Tensor, store_ids: torch.Tensor) -> JoinResult:
    """For each query ID, its row in ``store_ids``: sort the store by the
    unsigned (id0, id1) pair, then an exact pair search. Misses are reported
    in ``found``, never as an arbitrary row."""
    order = torch.argsort(u32.pair_key(store_ids[:, 0], store_ids[:, 1]),
                          stable=True)
    s_hi = store_ids[order, 0]
    s_lo = store_ids[order, 1]
    pos = hashing.lex_searchsorted(s_hi, s_lo, query_ids[:, 0],
                                   query_ids[:, 1])
    sel = pos.clamp(0, s_hi.shape[0] - 1).long()
    found = ((s_hi[sel] == query_ids[:, 0]) & (s_lo[sel] == query_ids[:, 1])
             & (pos < s_hi.shape[0]))
    return JoinResult(idx=order[sel].to(torch.int32), found=found)
