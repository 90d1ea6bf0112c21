"""Fill/steady/drain schedule of a (C, D, ...) window of blocks of C
channels on one device (port of repro.pipeline.schedule).

  FILL    -- the work that batches across blocks and channels: the
             checksum, decode and endorsement MACs of all C * D * B
             transactions at once (one K1 launch) and the window decode;
             then ONE probe a channel of its read and write keys (one K2
             launch a channel, or a shard of it when the state is
             bucket-sharded: :mod:`.batched_mvcc`); then block 0's
             prepare stage on every channel.
  STEADY  -- for each block position i: the VALIDATE stage of every
             channel's block i (in-window version repair, then MVCC of the
             C blocks in ONE K4 call, ``mvcc.validate_blocks``: the blocks
             of different channels are independent, while block i of a
             channel needs the write plans of its blocks before i; then a
             channel at a time the write plan and the log, ledger and
             journal heads), then block i+1's PREPARE stage (consensus
             order, ordered views, digests). The reference overlaps the two
             inside a scan and vmaps the channels; here they follow each
             other on one stream, with the same results.
  DRAIN   -- the fused window commit of each channel: its planned write log
             applied with one scatter (``world_state.commit_window``), or
             one a shard on the owned entries
             (``state_sharding.commit_window_routed``).

No block touches the table before the drain: the planner replays each
block's commit (insert or update, slot budget, overflow) against the fill
and the log, so the validity bits, heads, overflow lanes and table equal D
depth-1 steps, also when blocks overflow their buckets. The port's MVCC
kernel builds its conflict words itself, so the prepare stage computes no
conflict matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashing, mvcc, orderer, types, u32, unmarshal
from repro_torch.core import world_state as ws
from repro_torch.launch import fabric_step as fs
from repro_torch.launch import state_sharding
from repro_torch.pipeline import batched_mvcc, stages


class Prepared(NamedTuple):
    """One block's prepare-stage output."""

    txb: types.TxBatch  # ordered, (B, ...) fields
    ok_ord: torch.Tensor  # (B,) checksum and endorsement flags, ordered
    cur_ord: torch.Tensor  # (B, RK) fill read versions, ordered
    wv_ord: torch.Tensor  # (B, WK) fill write-key versions, ordered
    free_ord: torch.Tensor  # (B, WK) fill bucket free slots, ordered
    inv: torch.Tensor  # (B,) inverse of the order (back to ingest)
    ledger_mat: torch.Tensor  # (B,) ordered-row digests for the ledger
    log_mat: torch.Tensor  # (B,) row digests, or (B, W) rows (serial fold)


def make_window_body(dims: types.FabricDims, cfg, depth: int, *,
                     n_shards: int = 1, channel=None):
    """The body of a depth-``depth`` window step for C channels.

    ``body(keys, versions, values, log_head, ledger_head, journal_head,
    block_no, overflow, wire, ids)`` takes the tables (C, NB, S, ...),
    heads (C, 2), block numbers (C,), overflow lanes (C, LANES), ``wire``
    (C, D, B, WB) u8 and ``ids`` (C, D, B, 2); it commits into the tables
    in place and returns (keys, versions, values, heads..., block_no,
    overflow, valid (C, D, B)), ``valid`` in ingest order. Under
    ``cfg.shard_state`` each table is ``n_shards`` bucket shards: the fill
    and the drain route over them, and a dropped write sets its owner
    shard's overflow bit. ``channel`` names the channel(s) in errors.
    """
    msize = n_shards if cfg.shard_state else 1
    spw = (unmarshal.struct_prefix_words(dims)
           if cfg.separate_metadata else None)
    fold_ledger = stages.ledger_fold(cfg)

    def prepare(log_rows, ids_b, ok_b, cur_b, wv_b, free_b, txb_b
                ) -> Prepared:
        order = orderer.consensus_order(ids_b)
        ordered_words = log_rows[order]
        # O-II hashes the rows now; the baseline's serial chain is seeded
        # by the head, so it needs the rows themselves at fold time.
        log_mat = (hashing.hash_words(log_rows, seed=hashing.SEED_A)
                   if cfg.pipelined else log_rows)
        return Prepared(
            txb=types.TxBatch(*(a[order] for a in txb_b)),
            ok_ord=ok_b[order], cur_ord=cur_b[order], wv_ord=wv_b[order],
            free_ord=free_b[order], inv=torch.argsort(order),
            ledger_mat=hashing.hash_words(ordered_words,
                                          seed=hashing.SEED_A),
            log_mat=log_mat)

    def body(keys, vers, vals, log_head, ledger_head, journal_head,
             block_no, overflow, wire, ids):
        nch, d, b, wb = wire.shape
        if d != depth:
            raise ValueError(f"window body of depth {depth} got {d} blocks")
        nb = keys.shape[1]
        dev = wire.device

        # ---- FILL: syntax and endorsement over every channel's window ----
        words, txb_loc, checksum_ok = stages.stage_syntax(
            wire.reshape(nch * d * b, wb), dims)
        ok = (checksum_ok & stages.stage_endorse(txb_loc)).reshape(
            nch, d, b)
        published = words[:, :spw] if cfg.separate_metadata else words
        txb_all = stages.decode_published(published, dims)
        log_rows = published.reshape(nch, d, b, -1)
        txb_cdb = types.TxBatch(*(a.reshape(nch, d, b, *a.shape[1:])
                                  for a in txb_all))
        fills = []
        for c in range(nch):
            fill = batched_mvcc.gather_window_state(
                fs.table(keys, vers, vals, c),
                txb_cdb.read_keys[c].reshape(d * b, -1, 2),
                txb_cdb.write_keys[c].reshape(d * b, -1, 2),
                cfg.shard_state, n_buckets_global=nb, n_shards=msize)
            fills.append(tuple(x.reshape(d, b, -1) for x in fill))

        def prepare_block(c, i):
            cur, wv, free = fills[c]
            return prepare(log_rows[c, i], ids[c, i], ok[c, i], cur[i],
                           wv[i], free[i],
                           types.TxBatch(*(a[c, i] for a in txb_cdb)))

        # Each channel's window write log, block-major, written a block's
        # row at a time (a copy: no row aliases a prepared block).
        lsz = b * dims.wk
        wl_keys = torch.zeros((nch, d, lsz, 2), dtype=u32.WORD, device=dev)
        wl_vals = torch.zeros((nch, d, lsz, dims.vw), dtype=u32.WORD,
                              device=dev)
        wl_bumps = torch.zeros((nch, d, lsz), dtype=torch.bool, device=dev)
        wl_new = torch.zeros((nch, d, lsz), dtype=torch.bool, device=dev)

        log_head, ledger_head, journal_head, block_no, overflow = (
            list(x) for x in (log_head, ledger_head, journal_head, block_no,
                              overflow))
        valids = [[] for _ in range(nch)]
        preps = [prepare_block(c, 0) for c in range(nch)]
        for bt in range(d):
            # ---- VALIDATE block bt of every channel against its fill and
            # its log so far: one MVCC call for the C blocks ---------------
            cur = torch.stack([
                u32.add(p.cur_ord, batched_mvcc.version_adjustment(
                    p.txb.read_keys, wl_keys[c, :bt], wl_bumps[c, :bt]))
                for c, p in enumerate(preps)])
            txb_bt = types.TxBatch(*(torch.stack(f) for f in zip(
                *(p.txb for p in preps))))
            valid_bt = mvcc.validate_blocks(
                txb_bt, cur,
                checksum_ok=torch.stack([p.ok_ord for p in preps])).valid
            for c, prep in enumerate(preps):
                valid = valid_bt[c]
                log_head[c] = stages.fold_log_head(
                    log_head[c], prep.log_mat, cfg,
                    material_is_digests=cfg.pipelined)
                ledger_head[c] = fold_ledger(
                    ledger_head[c], prep.ledger_mat ^ valid.to(u32.WORD))
                journal_head[c] = stages.advance_journal_head(
                    journal_head[c], block_no[c], prep.txb, valid)
                plan = batched_mvcc.plan_block_writes(
                    prep.txb.write_keys, valid, cfg.sequential_commit,
                    prep.wv_ord, prep.free_ord, wl_keys[c, :bt],
                    wl_bumps[c, :bt], wl_new[c, :bt], n_buckets_global=nb)
                wl_keys[c, bt] = plan.keys
                wl_vals[c, bt] = prep.txb.write_vals.reshape(lsz, -1)
                wl_bumps[c, bt] = plan.bumps
                wl_new[c, bt] = plan.new
                overflow[c] = overflow[c] | state_sharding.dropped_write_bits(
                    plan.keys, plan.dropped, nb, msize, channel=channel)
                block_no[c] = u32.add(block_no[c], 1)
                valids[c].append(valid[prep.inv])
            # ---- PREPARE block bt + 1 of every channel -------------------
            if bt + 1 < d:
                preps = [prepare_block(c, bt + 1) for c in range(nch)]

        # ---- DRAIN: one fused commit of each channel's write log ---------
        for c in range(nch):
            log = (wl_keys[c].reshape(-1, 2), wl_vals[c].reshape(-1, dims.vw),
                   wl_bumps[c].reshape(-1), wl_new[c].reshape(-1))
            tab = fs.table(keys, vers, vals, c)
            if cfg.shard_state:
                state_sharding.commit_window_routed(
                    state_sharding.shard_views(tab, msize), *log, nb, msize)
            else:
                ws.commit_window(tab, *log)
        stack = torch.stack
        return (keys, vers, vals, stack(log_head), stack(ledger_head),
                stack(journal_head), stack(block_no), stack(overflow),
                stack([stack(v) for v in valids]))

    return body
