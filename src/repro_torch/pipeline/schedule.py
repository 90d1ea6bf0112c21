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

Over a mesh (:func:`make_mesh_window_body`) each data row runs the window
as the reference's ``shard_map`` body does: every model rank ingests its
B/M rows of each block (one K1 launch a rank), ONE consensus gather a
window brings the published rows, ids and flags to every rank, each rank
decodes and fills (one K2 probe of its replica a channel, or its shard's
part of ONE routed fill gather a window), runs the same steady stage and
drains into its replica or the entries its shard owns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashing, mvcc, orderer, types, u32
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


def _steady(dims: types.FabricDims, cfg, state, log_rows, ids, ok,
            txb_cdb, fills, nb: int, msize: int, channel):
    """The STEADY stage of a window of C channels on one replica: for each
    block position, the version repair and ONE MVCC call for the C blocks,
    then each channel's heads and write plan; then the next position's
    prepare. Returns (log, ledger and journal heads (C, 2), block numbers
    (C,), overflow lanes (C, LANES), the window write logs (keys, values,
    bumps, new) (C, D, L, ...), valid (C, D, B) in ingest order)."""
    nch, d, b = ids.shape[:3]
    dev = ids.device
    fold_ledger = stages.ledger_fold(cfg)

    def prepare(c, i) -> Prepared:
        cur, wv, free = fills[c]
        order = orderer.consensus_order(ids[c, i])
        rows = log_rows[c, i]
        # O-II hashes the rows now; the baseline's serial chain is seeded
        # by the head, so it needs the rows themselves at fold time.
        return Prepared(
            txb=types.TxBatch(*(a[c, i][order] for a in txb_cdb)),
            ok_ord=ok[c, i][order], cur_ord=cur[i][order],
            wv_ord=wv[i][order], free_ord=free[i][order],
            inv=torch.argsort(order),
            ledger_mat=hashing.hash_words(rows[order], seed=hashing.SEED_A),
            log_mat=(hashing.hash_words(rows, seed=hashing.SEED_A)
                     if cfg.pipelined else rows))

    # Each channel's window write log, block-major, written a block's row
    # at a time (a copy: no row aliases a prepared block).
    lsz = b * dims.wk
    wl_keys = torch.zeros((nch, d, lsz, 2), dtype=u32.WORD, device=dev)
    wl_vals = torch.zeros((nch, d, lsz, dims.vw), dtype=u32.WORD,
                          device=dev)
    wl_bumps = torch.zeros((nch, d, lsz), dtype=torch.bool, device=dev)
    wl_new = torch.zeros((nch, d, lsz), dtype=torch.bool, device=dev)

    log_head, ledger_head, journal_head, block_no, overflow = (
        list(x) for x in (state.log_head, state.ledger_head,
                          state.journal_head, state.block_no,
                          state.overflow))
    valids = [[] for _ in range(nch)]
    preps = [prepare(c, 0) for c in range(nch)]
    for bt in range(d):
        # ---- VALIDATE block bt of every channel against its fill and its
        # log so far: one MVCC call for the C blocks ---------------------
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
        # ---- PREPARE block bt + 1 of every channel -----------------------
        if bt + 1 < d:
            preps = [prepare(c, bt + 1) for c in range(nch)]
    stack = torch.stack
    logs = [(wl_keys[c].reshape(-1, 2), wl_vals[c].reshape(-1, dims.vw),
             wl_bumps[c].reshape(-1), wl_new[c].reshape(-1))
            for c in range(nch)]
    return (stack(log_head), stack(ledger_head), stack(journal_head),
            stack(block_no), stack(overflow), logs,
            stack([stack(v) for v in valids]))


def _decode(published: torch.Tensor, dims: types.FabricDims
            ) -> types.TxBatch:
    """The window decode of published rows (C, D, B, P), in ingest order,
    as (C, D, B, ...) fields."""
    lead = tuple(published.shape[:-1])
    return types.TxBatch(*(a.reshape(*lead, *a.shape[1:]) for a in
                           stages.decode_published(
                               published.reshape(-1, published.shape[-1]),
                               dims)))


def _check_depth(wire, depth: int) -> None:
    if wire.shape[1] != depth:
        raise ValueError(f"window body of depth {depth} got "
                         f"{wire.shape[1]} blocks")


def make_window_body(dims: types.FabricDims, cfg, depth: int, *,
                     n_shards: int = 1, channel=None):
    """The body of a depth-``depth`` window step for C channels.

    ``body(state, wire, ids) -> (state, valid)`` takes a
    :class:`~repro_torch.launch.fabric_step.FabricMeshState` (tables
    (C, NB, S, ...)), ``wire`` (C, D, B, WB) u8 and ``ids`` (C, D, B, 2);
    it commits into the tables in place and returns the new state and
    ``valid`` (C, D, B) in ingest order. Under ``cfg.shard_state`` each
    table is ``n_shards`` bucket shards: the fill and the drain route over
    them, and a dropped write sets its owner shard's overflow bit.
    ``channel`` names the channel(s) in errors.
    """
    msize = n_shards if cfg.shard_state else 1

    def body(state, wire, ids):
        _check_depth(wire, depth)
        nch, d, b = ids.shape[:3]
        nb = state.keys.shape[1]
        # ---- FILL: syntax and endorsement over every channel's window,
        # the decode, then one probe a channel ------------------------------
        log_rows, ok = fs.ingest(wire, dims, cfg)
        txb_cdb = _decode(log_rows, dims)
        tables = [fs.table(state.keys, state.versions, state.values, c)
                  for c in range(nch)]
        fills = [tuple(x.reshape(d, b, -1)
                       for x in batched_mvcc.gather_window_state(
                           tab, txb_cdb.read_keys[c].reshape(d * b, -1, 2),
                           txb_cdb.write_keys[c].reshape(d * b, -1, 2),
                           cfg.shard_state, n_buckets_global=nb,
                           n_shards=msize))
                 for c, tab in enumerate(tables)]
        *heads, logs, valid = _steady(dims, cfg, state, log_rows, ids, ok,
                                      txb_cdb, fills, nb, msize, channel)
        # ---- DRAIN: one fused commit of each channel's write log ---------
        for tab, log in zip(tables, logs):
            if cfg.shard_state:
                state_sharding.commit_window_routed(
                    state_sharding.shard_views(tab, msize), *log, nb, msize)
            else:
                ws.commit_window(tab, *log)
        return fs.FabricMeshState(state.keys, state.versions, state.values,
                                  *heads), valid

    return body


def make_mesh_window_body(dims: types.FabricDims, cfg, depth: int, mesh, *,
                          channel=None):
    """One data row's window over its M model ranks, for
    ``fabric_step.on_mesh``: ``row(d, ranks, wire, ids)`` takes the row's
    rank states and its channels' windows (C_loc, D, B, WB) /
    (C_loc, D, B, 2) on any device, and returns the new rank states and
    each rank's validity slice (C_loc, D, B/M) on its device."""
    msize = mesh.model_size

    def row(d, ranks, wire, ids):
        _check_depth(wire, depth)
        devs = mesh.row(d)
        nch, dd, b = ids.shape[:3]
        sl = fs.rank_slices(b, msize)
        # ---- FILL: each rank's rows, ONE consensus gather a window -------
        ing = [fs.ingest(wire[:, :, sl[m]].to(dev), dims, cfg)
               for m, dev in enumerate(devs)]
        log = mesh.all_gather(d, [p for p, _ in ing], 2, "consensus")
        idg = mesh.all_gather(d, [ids[:, :, sl[m]].to(dev)
                                  for m, dev in enumerate(devs)],
                              2, "consensus")
        okg = mesh.all_gather(d, [o for _, o in ing], 2, "consensus")
        txbs = [_decode(x, dims) for x in log]
        tabs = [[fs.table(r.keys, r.versions, r.values, c)
                 for c in range(nch)] for r in ranks]
        n = dd * b
        keys = [[batched_mvcc.fill_keys(
            t.read_keys[c].reshape(n, -1, 2),
            t.write_keys[c].reshape(n, -1, 2)) for c in range(nch)]
            for t in txbs]
        nr = n * dims.rk
        if cfg.shard_state:
            # ONE routed fill gather a window: every channel's versions and
            # free counts in one vector a rank, summed over the row.
            nb = ranks[0].keys.shape[1] * msize
            parts = []
            for m in range(msize):
                parts.append(torch.cat([x for c in range(nch) for x in
                                        state_sharding.rank_fill(
                                            tabs[m][c], m, *keys[m][c], nb,
                                            msize)]))
            summed = mesh.psum(d, parts, "routed_read")
            sizes = [n * (dims.rk + dims.wk), n * dims.wk] * nch
            fills = [[batched_mvcc.as_fill(v, f, n, nr) for v, f in zip(
                *[iter(torch.split(x, sizes))] * 2)] for x in summed]
        else:
            nb = ranks[0].keys.shape[1]
            fills = [[batched_mvcc.as_fill(
                ws.lookup(tabs[m][c], keys[m][c][0]).versions,
                ws.bucket_free_slots(tabs[m][c], keys[m][c][1]), n, nr)
                for c in range(nch)] for m in range(msize)]
        out, mine = [], []
        for m, r in enumerate(ranks):
            *heads, logs, valid = _steady(
                dims, cfg, r, log[m], idg[m], okg[m], txbs[m],
                [tuple(x.reshape(dd, b, -1) for x in f) for f in fills[m]],
                nb, msize if cfg.shard_state else 1, channel)
            # ---- DRAIN: the replica's fused commit, or the owned entries
            for tab, lg in zip(tabs[m], logs):
                if cfg.shard_state:
                    state_sharding.rank_commit_window(tab, m, *lg, nb, msize)
                else:
                    ws.commit_window(tab, *lg)
            out.append(fs.FabricMeshState(r.keys, r.versions, r.values,
                                          *heads))
            mine.append(valid[:, :, sl[m]])
        return out, mine

    return row
