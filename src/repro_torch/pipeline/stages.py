"""Validation stages shared by the depth-1 and the windowed fabric step
(port of repro.pipeline.stages).

Both steps run the same math a block, so a window of D blocks is
bit-identical to D depth-1 steps:

  1. :func:`stage_syntax`      -- wire words, payload checksum, decode;
  2. :func:`stage_endorse`     -- endorsement MACs (K1, one launch);

then the read-set probe (:func:`stage_read`, K2), MVCC and the commit
(:func:`stage_mvcc_commit`: K4, one call for every channel's block,
``mvcc.validate_blocks``; the commit vectorized, or K3 under a sequential
commit), plus the per-block head folds: the consensus log, the ledger and
the state journal. Under ``cfg.shard_state`` the read and the commit route
over the table's bucket shards (launch/state_sharding).
"""

from __future__ import annotations

import torch

from repro_torch.core import (crypto, hashing, mvcc, orderer, types, u32,
                              unmarshal)
from repro_torch.core import world_state as ws
from repro_torch.launch import state_sharding
from repro_torch.storage import journal as state_journal


# -- head folds ----------------------------------------------------------------


def fold_log_chain(head: torch.Tensor, digests: torch.Tensor) -> torch.Tensor:
    """Chain row digests (N,) into the (2,) head, one after another."""
    return hashing.fold(head, digests)


def fold_log_tree(head: torch.Tensor, digests: torch.Tensor) -> torch.Tensor:
    """Pairwise reduction of the digests (an odd level repeats its last),
    O(log N) deep, folded into the head at the root."""
    d = digests
    while d.shape[0] > 1:
        if d.shape[0] % 2:
            d = torch.cat([d, d[-1:]])
        d = hashing.combine(d[0::2], d[1::2])
    return hashing.combine(head, d[0])


def fold_log_head(log_head: torch.Tensor, log_mat: torch.Tensor, cfg, *,
                  material_is_digests: bool = False) -> torch.Tensor:
    """Advance the consensus log head over one block's replicated rows.

    O-II (``cfg.pipelined``) hashes the rows at once and folds the digests
    (a chain, or a tree under ``cfg.tree_hash``); ``material_is_digests``
    says ``log_mat`` holds them already. The baseline hashes each row
    seeded by the head, one row at a time (the orderer's serial chain)."""
    if cfg.pipelined:
        digests = (log_mat if material_is_digests
                   else hashing.hash_words(log_mat, seed=hashing.SEED_A))
        fold = fold_log_tree if cfg.tree_hash else fold_log_chain
        return fold(log_head, digests)
    return orderer._log_chain(log_head, log_mat, serial=True)


def ledger_fold(cfg):
    """The ledger head's fold of ordered-row digests under ``cfg``."""
    return fold_log_tree if cfg.tree_hash else fold_log_chain


def fold_ledger_head(ledger_head: torch.Tensor, ordered_words: torch.Tensor,
                     valid: torch.Tensor, cfg) -> torch.Tensor:
    """Ledger append over the ordered block: row digests with the validity
    bits."""
    d = hashing.hash_words(ordered_words, seed=hashing.SEED_A)
    return ledger_fold(cfg)(ledger_head, d ^ valid.to(u32.WORD))


def advance_journal_head(journal_head: torch.Tensor, block_no,
                         txb: types.TxBatch, valid: torch.Tensor
                         ) -> torch.Tensor:
    """Fold one block's validated write sets into the state-journal head."""
    return state_journal.journal_head_update(
        journal_head, block_no, txb.write_keys, txb.write_vals, valid)


# -- stages --------------------------------------------------------------------


def stage_syntax(wire: torch.Tensor, dims: types.FabricDims):
    """Syntactic check where the block was ingested: (B, WB) u8 ->
    (words (B, W), txb, checksum_ok (B,) bool)."""
    dec = unmarshal.unmarshal(wire, dims)
    return unmarshal.wire_words(wire), dec.txb, dec.checksum_ok


def stage_endorse(txb: types.TxBatch) -> torch.Tensor:
    """Endorsement check of every tag (worst case), one K1 launch. (B,)."""
    return crypto.verify_tags(txb)


def decode_published(words: torch.Tensor, dims: types.FabricDims
                     ) -> types.TxBatch:
    """Decode replicated consensus rows: the O-I prefix, or the baseline's
    whole rows, which begin with it (the reference decodes those through
    the wire bytes to the same words)."""
    return unmarshal.unmarshal_prefix(words, dims)


def stage_read(table: ws.HashState, keys: torch.Tensor, cfg, n_shards: int
               ) -> torch.Tensor:
    """Committed versions of a flat (K, 2) key batch in a channel's table:
    one K2 probe, or under ``cfg.shard_state`` the routed probe over its
    ``n_shards`` shards (one K2 probe a shard)."""
    if cfg.shard_state:
        return state_sharding.sharded_lookup(
            state_sharding.shard_views(table, n_shards), keys,
            table.n_buckets, n_shards).versions
    return ws.lookup(table, keys).versions


def stage_mvcc_commit(tables: list, txb: types.TxBatch, ok_ord, cur, cfg, *,
                      n_shards: int = 1, channel=None):
    """MVCC of the C channels' ordered blocks (``txb`` fields (C, B, ...),
    ``ok_ord`` (C, B), read versions ``cur`` (C, B, RK)) in one K4 call,
    then each channel's commit of its valid write sets into ``tables[c]``,
    in place: vectorized or, under ``cfg.sequential_commit``, one K3
    launch (a shard, under ``cfg.shard_state``). Returns (valid (C, B),
    the blocks' overflow lanes (C, LANES): bit m == shard m dropped a
    write on a full bucket; bit 0 for a replicated table)."""
    valid = mvcc.validate_blocks(txb, cur, checksum_ok=ok_ord).valid
    bits = []
    for c, st in enumerate(tables):
        if cfg.shard_state:
            cres = state_sharding.sharded_commit(
                state_sharding.shard_views(st, n_shards), txb.write_keys[c],
                txb.write_vals[c], valid[c], st.n_buckets, n_shards,
                sequential=cfg.sequential_commit)
            ovf = cres.shard_overflow
        else:
            ovf = ws.commit(st, txb.write_keys[c], txb.write_vals[c],
                            valid[c], sequential=cfg.sequential_commit
                            ).overflow[None]
        bits.append(state_sharding.overflow_bits(ovf, channel=channel))
    return valid, torch.stack(bits)
