"""Fill/steady/drain schedule of a (D, ...) window of blocks on one device
(port of repro.pipeline.schedule).

  FILL    -- the work that batches across blocks: the checksum, decode and
             endorsement MACs of all D * B transactions at once (one K1
             launch), the window decode and ONE probe of every read and
             write key (one K2 launch, :mod:`.batched_mvcc`); then block
             0's prepare stage.
  STEADY  -- for each block i: its VALIDATE stage (in-window version
             repair, MVCC with one K4 launch, write plan, the log, ledger
             and journal heads), then block i+1's PREPARE stage (consensus
             order, ordered views, digests). The reference overlaps the two
             inside a scan; here they follow each other on one stream,
             with the same results.
  DRAIN   -- the fused window commit: the planned write log applied with
             one scatter (``world_state.commit_window``).

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
                     channel=None):
    """The body of a depth-``depth`` window step for one channel.

    ``body(keys, versions, values, log_head, ledger_head, journal_head,
    block_no, overflow, wire, ids)`` takes the table (NB, S, ...), heads
    (2,), block number (), overflow lanes (LANES,), ``wire`` (D, B, WB) u8
    and ``ids`` (D, B, 2); it commits into the table in place and returns
    (keys, versions, values, heads..., block_no, overflow, valid (D, B)),
    ``valid`` in ingest order. ``channel`` names the channel in errors.
    """
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
        d, b, wb = wire.shape
        if d != depth:
            raise ValueError(f"window body of depth {depth} got {d} blocks")
        st = ws.HashState(keys=keys, versions=vers, values=vals)
        nb = st.n_buckets
        dev = wire.device

        # ---- FILL: syntax and endorsement over the whole window ----------
        words, txb_loc, checksum_ok = stages.stage_syntax(
            wire.reshape(d * b, wb), dims)
        ok = (checksum_ok & stages.stage_endorse(txb_loc)).reshape(d, b)
        published = words[:, :spw] if cfg.separate_metadata else words
        txb_win = stages.decode_published(published, dims)
        fill = batched_mvcc.gather_window_state(st, txb_win.read_keys,
                                                txb_win.write_keys)
        log_rows = published.reshape(d, b, -1)
        cur_win = fill.read_vers.reshape(d, b, -1)
        wv_win = fill.write_vers.reshape(d, b, -1)
        free_win = fill.write_free.reshape(d, b, -1)
        txb_dw = types.TxBatch(*(a.reshape(d, b, *a.shape[1:])
                                 for a in txb_win))

        def prepare_block(i):
            return prepare(log_rows[i], ids[i], ok[i], cur_win[i], wv_win[i],
                           free_win[i], types.TxBatch(*(a[i] for a in txb_dw)))

        # The window write log, block-major, written a block's row at a
        # time (a copy: no row aliases a prepared block).
        lsz = b * dims.wk
        wl_keys = torch.zeros((d, lsz, 2), dtype=u32.WORD, device=dev)
        wl_vals = torch.zeros((d, lsz, dims.vw), dtype=u32.WORD, device=dev)
        wl_bumps = torch.zeros((d, lsz), dtype=torch.bool, device=dev)
        wl_new = torch.zeros((d, lsz), dtype=torch.bool, device=dev)

        valids = []
        prep = prepare_block(0)
        for bt in range(d):
            # ---- VALIDATE block bt against the fill and the log so far ----
            adj = batched_mvcc.version_adjustment(
                prep.txb.read_keys, wl_keys[:bt], wl_bumps[:bt])
            valid = mvcc.validate(prep.txb, u32.add(prep.cur_ord, adj),
                                  checksum_ok=prep.ok_ord).valid
            log_head = stages.fold_log_head(
                log_head, prep.log_mat, cfg,
                material_is_digests=cfg.pipelined)
            ledger_head = fold_ledger(ledger_head,
                                      prep.ledger_mat ^ valid.to(u32.WORD))
            journal_head = stages.advance_journal_head(
                journal_head, block_no, prep.txb, valid)
            plan = batched_mvcc.plan_block_writes(
                prep.txb.write_keys, valid, cfg.sequential_commit,
                prep.wv_ord, prep.free_ord, wl_keys[:bt], wl_bumps[:bt],
                wl_new[:bt], n_buckets_global=nb)
            wl_keys[bt] = plan.keys
            wl_vals[bt] = prep.txb.write_vals.reshape(lsz, -1)
            wl_bumps[bt] = plan.bumps
            wl_new[bt] = plan.new
            overflow = overflow | state_sharding.dropped_write_bits(
                plan.keys, plan.dropped, nb, 1, channel=channel)
            block_no = u32.add(block_no, 1)
            valids.append(valid[prep.inv])
            # ---- PREPARE block bt + 1 ------------------------------------
            if bt + 1 < d:
                prep = prepare_block(bt + 1)

        # ---- DRAIN: one fused commit of the window's write log -----------
        st = ws.commit_window(st, wl_keys.reshape(-1, 2),
                              wl_vals.reshape(-1, dims.vw),
                              wl_bumps.reshape(-1), wl_new.reshape(-1))
        return (st.keys, st.versions, st.values, log_head, ledger_head,
                journal_head, block_no, overflow, torch.stack(valids))

    return body
