"""Cold-start recovery: latest snapshot + journal suffix, fully verified
(port of repro.storage.recovery).

Load the newest snapshot and verify its shard digests and tree head,
verify the journal's digest chains from the snapshot's heads forward
(block records and resize re-anchor records), then replay only that
suffix, crossing resize boundaries and proving each rebuilt table against
its re-anchor's digest-tree head. The recovered peer matches the crashed
one when its ``state_digest`` and journal head equal the live values
(``FabricEngine.verify``'s ``recovery_ok``); the sticky overflow bitmask
persisted in the manifest and the re-anchor records is re-latched.
Everything on the state runs on the device recovery targets.

:func:`recover_shard` is the sharded peer's path: it rebuilds ONE bucket
shard from the snapshot parts that feed it and the journal suffix, with
write sets masked to the owned bucket ranges, across grow and shrink
re-anchors, without the full table. An aligned bucket range behaves as a
shard-local table (the low bucket bits are its local index), so the
partial replay equals the live shard array for array. Each epoch holds a
LIST of ranges: a grow's preimage of an aligned range is one aligned
range, a shrink's is two sibling ranges, which fuse at the boundary in
ascending order, so even a lossy shrink drops the slots the full table
drops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core import ledger, types, u32
from repro_torch.core import world_state as ws
from repro_torch.storage import journal as journal_mod
from repro_torch.storage import snapshot as snapshot_mod


class RecoveryError(RuntimeError):
    """Snapshot or journal failed authentication (or coverage is missing)."""


class RecoveryResult(NamedTuple):
    state: ws.HashState  # recovered world state, on the target device
    block_no: int  # last block reflected in ``state``
    journal_head: np.ndarray  # (2,) u32 journal head after replay
    state_digest: np.ndarray  # (2,) u32 digest of the recovered state
    snapshot_block_no: int  # -1 if recovered from genesis
    replayed_records: int  # journal suffix length
    n_buckets: int  # final layout (resize epochs in the suffix applied)
    overflow_bits: int  # sticky per-shard overflow bitmask, re-latched
    crossed_reanchors: int  # resize epochs crossed during replay


def recover(
    jrnl: journal_mod.StateJournal,
    *,
    snapshot: snapshot_mod.Snapshot | None = None,
    snapshot_dir: str | None = None,
    n_buckets: int,
    slots: int,
    value_width: int,
    channel: int = 0,
    device=None,
) -> RecoveryResult:
    """Rebuild the world state on ``device`` (default: the card) from
    ``snapshot`` (or the newest complete one in ``snapshot_dir``'s channel
    directory, or genesis) + the journal suffix after it.

    Raises :class:`RecoveryError` if the snapshot digests do not match its
    arrays, a journal chain does not verify from the snapshot's anchors, a
    re-anchor's rebuilt table does not match its tree head, or the journal
    was pruned past the snapshot. ``n_buckets`` is the GENESIS layout.
    """
    dev = resolve_device(device)
    if snapshot is None and snapshot_dir is not None:
        snapshot = snapshot_mod.latest(ledger.channel_dir(snapshot_dir,
                                                          channel))
    if snapshot is not None:
        if not snapshot_mod.verify(snapshot, dev):
            raise RecoveryError(
                f"snapshot at block {snapshot.block_no}: shard digest / "
                "tree head mismatch (corrupt or tampered)")
        state = snapshot_mod.to_state(snapshot, dev)
        after = snapshot.block_no
        anchor = np.asarray(snapshot.journal_head)
        reanchor_anchor = np.asarray(snapshot.manifest.reanchor_head)
        overflow_bits = snapshot.manifest.overflow_bits
    else:
        state = ws.create(n_buckets, slots, value_width, dev)
        after = -1
        anchor = journal_mod.GENESIS_HEAD
        reanchor_anchor = journal_mod.GENESIS_HEAD
        overflow_bits = 0

    if jrnl.base_block_no > after:
        raise RecoveryError(
            f"journal pruned up to block {jrnl.base_block_no} but recovery "
            f"needs records after block {after} (no covering snapshot)")
    if not jrnl.verify_chain(base_head=anchor, after_block_no=after,
                             reanchor_base=reanchor_anchor):
        raise RecoveryError(
            f"journal chain does not authenticate after block {after} "
            "(corrupt, tampered, or missing records)")

    suffix = jrnl.suffix(after)
    reanchors = jrnl.suffix_reanchors(after)
    try:
        rep = jrnl.replay(state, after_block_no=after, check_reanchors=True)
    except ValueError as e:
        raise RecoveryError(str(e)) from e
    state = rep.state
    for rec in reanchors:
        overflow_bits |= rec.overflow_bits
    # The merged replay cannot say which shard dropped a write: it latches
    # bit 0, so health (bits != 0) stays honest.
    overflow_bits |= int(rep.overflow)
    head = suffix[-1].head if suffix else anchor
    return RecoveryResult(
        state=state,
        block_no=suffix[-1].block_no if suffix else after,
        journal_head=np.asarray(head),
        state_digest=u32.to_numpy(ws.state_digest(state)),
        snapshot_block_no=snapshot.block_no if snapshot is not None else -1,
        replayed_records=len(suffix),
        n_buckets=state.n_buckets,
        overflow_bits=int(overflow_bits),
        crossed_reanchors=len(reanchors))


# -- per-shard recovery (a sharded peer: one bucket shard a host) ---------------


class ShardRecoveryResult(NamedTuple):
    state: ws.HashState  # the recovered LOCAL bucket shard
    shard: int
    n_shards: int
    block_no: int
    journal_head: np.ndarray  # (2,) u32, the (global) journal head
    shard_digest: np.ndarray  # (2,) u32 content digest of the shard
    loaded_parts: int  # snapshot shard files read (<< n_shards)
    replayed_records: int
    crossed_reanchors: int


def _range_schedule(shard: int, n_shards: int, nbs: list) -> list:
    """Per epoch, the aligned (start, size) global bucket ranges that feed
    ``shard``'s final range, walked BACKWARD from the last epoch; ``nbs``
    is the global bucket count of each epoch (the snapshot's layout first).

    A grow maps old bucket g to g or g + nb_old, so the preimage of an
    aligned range [a, a+s) is [a mod nb_old, +s), still aligned (capped at
    the whole older table). A shrink folds g onto g mod nb_new, so the
    preimage is the two siblings [a, +s) and [a + nb_new, +s)."""
    nb_loc_final = nbs[-1] // n_shards
    ranges = [(shard * nb_loc_final, nb_loc_final)]
    out = [ranges]
    for k in range(len(nbs) - 2, -1, -1):
        nb_old, nb_new = nbs[k], nbs[k + 1]
        prev = []
        if nb_new >= nb_old:  # grow boundary: drop a key bit
            for a, s in ranges:
                size = min(s, nb_old)
                start = a % nb_old
                start -= start % size  # keep the range aligned to its size
                prev.append((start, size))
        else:  # shrink boundary: the two sibling preimages
            for a, s in ranges:
                prev += [(a, s), (a + nb_new, s)]
        ranges = sorted(set(prev))
        out.append(ranges)
    return out[::-1]


def _masked(st: ws.HashState, n_buckets: int, size: int, start: int
            ) -> ws.HashState:
    """``st`` with every key outside the aligned global range
    [start, start + size) of a ``n_buckets`` table blanked to EMPTY."""
    mine = ws.shard_of(n_buckets, n_buckets // size, st.keys) == start // size
    return st._replace(keys=torch.where(mine[..., None], st.keys, 0))


def recover_shard(jrnl: journal_mod.StateJournal, *, snapshot_dir: str,
                  shard: int, device=None) -> ShardRecoveryResult:
    """Recover ONE bucket shard on ``device`` (default: the card) from the
    per-shard snapshot files in ``snapshot_dir`` and the journal suffix,
    across grow and shrink re-anchors, loading only the parts its ranges
    need.

    At a shrink boundary the low and high sibling fragments concatenate in
    ascending global order and compact to the new range; at a grow boundary
    each new range masks and compacts the fragment covering its preimage.
    Raises :class:`RecoveryError` if the snapshot is missing or a part's
    digest does not match, the journal chain does not authenticate or was
    pruned past the snapshot, or the shard count changes in the suffix."""
    dev = resolve_device(device)
    man = snapshot_mod.latest_manifest(snapshot_dir)
    if man is None:
        raise RecoveryError(f"no complete snapshot in {snapshot_dir}")
    if jrnl.base_block_no > man.block_no:
        raise RecoveryError(
            f"journal pruned up to block {jrnl.base_block_no} past the "
            f"snapshot at block {man.block_no}")
    if not jrnl.verify_chain(
            base_head=np.asarray(man.journal_head),
            after_block_no=man.block_no,
            reanchor_base=np.asarray(man.reanchor_head)):
        raise RecoveryError(
            f"journal chain does not authenticate after block {man.block_no}")
    reanchors = jrnl.suffix_reanchors(man.block_no)
    if any(r.n_shards != man.n_shards for r in reanchors):
        raise RecoveryError("shard count changed across the suffix")
    m = man.n_shards
    if not 0 <= shard < m:
        raise RecoveryError(f"shard {shard} out of range for {m} shards")

    # The ranges feeding the shard, per epoch; epoch 0's name the snapshot
    # parts to load.
    nbs = [man.n_buckets] + [r.new_n_buckets for r in reanchors]
    sched = _range_schedule(shard, m, nbs)
    nb_loc0 = man.n_buckets // m
    loaded = 0

    def load_range(start: int, size: int) -> ws.HashState:
        nonlocal loaded
        lo, cnt = start // nb_loc0, max(size // nb_loc0, 1)
        parts = []
        for p in range(lo, lo + cnt):
            part = snapshot_mod.load_shard(snapshot_dir, man.block_no, p)
            if not snapshot_mod.verify_shard(man, part, dev):
                raise RecoveryError(
                    f"snapshot shard {p} at block {man.block_no}: digest "
                    "mismatch (corrupt or tampered)")
            parts.append(part)
        loaded += cnt
        st = ws.HashState(*(u32.from_numpy(np.concatenate(
            [getattr(p, name) for p in parts]), dev)
            for name in ("keys", "versions", "values")))
        if size < nb_loc0:
            # A shrink's sibling narrower than a part: mask to the range and
            # compact down.
            st = ws.resize(_masked(st, man.n_buckets, size, start),
                           size).state
        return st

    # Fragments by range start: each covers an aligned global range, so it
    # behaves as one shard of a coarser partition (nb // size shards).
    frags = {a: load_range(a, s) for a, s in sched[0]}
    epoch = 0
    by_boundary: dict = {}
    for k, r in enumerate(reanchors):
        by_boundary.setdefault(r.block_no, []).append((k, r))

    def cross(frags, epoch, boundary):
        for k, r in by_boundary.pop(boundary, ()):
            if r.old_n_buckets != nbs[k]:
                raise RecoveryError(
                    f"re-anchor at block {r.block_no} expects "
                    f"{r.old_n_buckets} buckets, epoch has {nbs[k]}")
            new_nb = r.new_n_buckets
            old_size = sched[k][0][1]
            nxt = {}
            for new_start, new_size in sched[k + 1]:
                if new_nb < nbs[k]:
                    # Shrink: fuse the siblings in ascending global order,
                    # then rehash down; the flat order is the full table's.
                    low, high = frags[new_start], frags[new_start + new_nb]
                    fused = ws.HashState(*(torch.cat([a, b])
                                           for a, b in zip(low, high)))
                    nxt[new_start] = ws.resize(fused, new_size).state
                else:
                    # Grow: the fragment covering the preimage gives the new
                    # range its keys.
                    pre = new_start % nbs[k]
                    pre -= pre % old_size
                    nxt[new_start] = ws.resize(
                        _masked(frags[pre], new_nb, new_size, new_start),
                        new_size).state
            frags = nxt
            epoch = k + 1
        return frags, epoch

    suffix = jrnl.suffix(man.block_no)
    for rec in suffix:
        frags, epoch = cross(frags, epoch, rec.block_no - 1)
        nb = nbs[epoch]
        size = sched[epoch][0][1]
        wk = u32.from_numpy(rec.write_keys, dev)
        wv = u32.from_numpy(rec.write_vals, dev)
        va = torch.from_numpy(np.array(rec.valid, bool)).to(dev)
        for start, _ in sched[epoch]:
            mine = ws.shard_of(nb, nb // size, wk) == start // size
            ws.commit_vectorized(frags[start],
                                 torch.where(mine[..., None], wk, 0), wv, va)
        frags, epoch = cross(frags, epoch, rec.block_no)
    for boundary in sorted(by_boundary):
        frags, epoch = cross(frags, epoch, boundary)

    # The final schedule entry IS the target shard's range.
    (state,) = frags.values()
    head = suffix[-1].head if suffix else np.asarray(man.journal_head)
    return ShardRecoveryResult(
        state=state, shard=shard, n_shards=m,
        block_no=suffix[-1].block_no if suffix else man.block_no,
        journal_head=np.asarray(head),
        shard_digest=u32.to_numpy(ws.state_digest(state)),
        loaded_parts=loaded, replayed_records=len(suffix),
        crossed_reanchors=len(reanchors))


def full_replay(store, dims: types.FabricDims, *, n_buckets: int,
                slots: int, device=None) -> RecoveryResult:
    """The baseline recovery: verify and replay the whole block chain of a
    ``BlockStore`` on ``device`` (default: the card)."""
    if store.base_block_no >= 0:
        raise RecoveryError(
            f"chain pruned up to block {store.base_block_no}: full replay "
            "from genesis would miss the compacted prefix (recover via "
            "snapshot + journal instead)")
    if not store.verify_chain():
        raise RecoveryError("block chain does not authenticate")
    state = store.replay_state(dims, n_buckets, slots, device=device)
    return RecoveryResult(
        state=state,
        block_no=store.chain[-1].block_no if store.chain else -1,
        journal_head=journal_mod.GENESIS_HEAD,
        state_digest=u32.to_numpy(ws.state_digest(state)),
        snapshot_block_no=-1,
        replayed_records=len(store.chain),
        n_buckets=state.n_buckets,
        overflow_bits=0,
        crossed_reanchors=0)
