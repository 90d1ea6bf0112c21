"""World state (port of repro.core.world_state): the FastFabric in-memory
hash table (Opt P-I) and the LevelDB-like sorted store of the Fabric 1.2
baseline.

Hash table: keys are paired u32 hashes; (0, *) marks an empty slot.
Versions: 0 means absent, a first commit writes version 1. Probes and the
sequential commit go through the hash-table kernels (kernels/hash_table).
Unlike the JAX package, whose commits return new arrays (and donate the
old), :func:`commit_vectorized` and :func:`commit_sequential` update the
table's tensors IN PLACE and return the same :class:`HashState`: a
2^20-bucket table is 224 MiB, and a copy per block would move more bytes
than the block does.

The block pipeline (pipeline/) applies a window's planned writes with
:func:`commit_window`, one fused scatter (plain torch, as the reference's
is an XLA scatter; its probe is the hash-table kernel), and budgets inserts
with :func:`bucket_free_slots`.

Resize epochs and shards: :func:`resize` rehashes the table into a new
bucket count (journal replay crosses the re-anchor records it leaves), and
:func:`split_table` / :func:`tree_head` give the high-bit shard partition
and its digest tree, which snapshot manifests commit to;
:func:`shard_occupancy` / :func:`shard_min_free` / :func:`hot_shard` are
the resize policy's signals (plain reductions, as in the JAX package).

Sorted store: a sorted run searched by bisection; each commit merges the
block's writes and re-sorts the whole run (:func:`sorted_commit`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hashing, u32
from repro_torch.kernels.hash_table import ops as ht_ops


class HashState(NamedTuple):
    """Bucketed open-addressing table, bucket-major struct of arrays:
    ``keys`` (NB, S, 2), ``versions`` (NB, S), ``values`` (NB, S, VW)."""

    keys: torch.Tensor
    versions: torch.Tensor
    values: torch.Tensor

    @property
    def n_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def slots(self) -> int:
        return self.keys.shape[1]

    @property
    def value_width(self) -> int:
        return self.values.shape[2]


def create(n_buckets: int, slots: int, value_width: int, device=None
           ) -> HashState:
    """Empty table on ``device`` (default: the card; raises without one
    unless ``device='cpu'``)."""
    if n_buckets & (n_buckets - 1):
        raise ValueError("n_buckets must be a power of two")
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=u32.WORD, device=dev)
    return HashState(keys=z(n_buckets, slots, 2),
                     versions=z(n_buckets, slots),
                     values=z(n_buckets, slots, value_width))


def bucket_of(state_or_nb, keys: torch.Tensor) -> torch.Tensor:
    """Bucket index of paired keys (..., 2) -> (...,) int32, a power-of-2
    mask (non-negative: NB <= 2^31)."""
    nb = state_or_nb if isinstance(state_or_nb, int) else state_or_nb.n_buckets
    return keys[..., 0] & (nb - 1)


# -- bucket shards and resize epochs ------------------------------------------
# Shard m owns the contiguous bucket range [m * nb_loc, (m+1) * nb_loc): the
# HIGH bits of the global bucket index, so a reshape of the table to
# (n_shards, nb_loc, ...) is the partition, and a shard-local probe with
# nb_loc buckets (bucket_of masks the LOW bits) lands on the right bucket.


def shard_buckets(n_buckets: int, n_shards: int) -> int:
    """Buckets per shard; validates the (power-of-two) partition."""
    if n_shards < 1 or n_shards & (n_shards - 1):
        raise ValueError(f"n_shards={n_shards} must be a power of two")
    if n_buckets % n_shards:
        raise ValueError(
            f"n_buckets={n_buckets} not divisible by n_shards={n_shards}")
    nb_loc = n_buckets // n_shards
    if nb_loc & (nb_loc - 1):
        raise ValueError("buckets per shard must stay a power of two")
    return nb_loc


def shard_of(n_buckets: int, n_shards: int, keys: torch.Tensor
             ) -> torch.Tensor:
    """Owner shard of paired keys (..., 2) -> (...,) int32."""
    nb_loc = shard_buckets(n_buckets, n_shards)
    return bucket_of(n_buckets, keys) // nb_loc


def split_table(tkeys, tvers, tvals, n_shards: int):
    """(NB, ...) table arrays -> (M, NB/M, ...) shard-major views, for
    tensors and numpy arrays alike: the reshape IS the partition."""
    nb_loc = shard_buckets(tkeys.shape[0], n_shards)
    return tuple(a.reshape(n_shards, nb_loc, *a.shape[1:])
                 for a in (tkeys, tvers, tvals))


def merge_table(skeys, svers, svals):
    """Inverse of :func:`split_table`: (M, NB/M, ...) -> (NB, ...)."""
    return tuple(a.reshape(-1, *a.shape[2:]) for a in (skeys, svers, svals))


class ResizeResult(NamedTuple):
    state: HashState
    overflow: torch.Tensor  # () bool: a merged bucket exceeded its slots
    # (only when SHRINKING; the extras are dropped)


def resize(state: HashState, new_n_buckets: int) -> ResizeResult:
    """Rehash the table into ``new_n_buckets`` buckets (a power of two), on
    the table's device; returns a new table.

    Entries regroup by their new bucket and compact in flat order (old
    bucket ascending, slot ascending), which for a grow is the insertion
    order a fresh run on the bigger table would have used. A shrink merges
    buckets g and g + new_n_buckets; entries past ``slots`` in a merged
    bucket are dropped and reported as ``overflow``.
    """
    if new_n_buckets < 1 or new_n_buckets & (new_n_buckets - 1):
        raise ValueError("n_buckets must be a power of two")
    nb, s, vw = state.n_buckets, state.slots, state.value_width
    k = nb * s
    dev = state.keys.device
    fk = state.keys.reshape(k, 2)
    occ = fk[:, 0] != hashing.EMPTY_KEY
    newb = torch.where(occ, (fk[:, 0] & (new_n_buckets - 1)).long(),
                       new_n_buckets)
    # Group by destination bucket, stable in flat order (the reference's
    # lexsort); the rank within the group is the destination slot.
    order = torch.argsort(newb, stable=True)
    sb = newb[order]
    rank = (torch.arange(k, device=dev)
            - torch.searchsorted(sb, sb, side="left"))
    live = sb < new_n_buckets
    overflow = (live & (rank >= s)).any()
    keep = live & (rank < s)
    dest = sb[keep] * s + rank[keep]
    src = order[keep]

    def scat(arr, width):
        out = torch.zeros((new_n_buckets * s, *width), dtype=u32.WORD,
                          device=dev)
        out[dest] = arr.reshape(k, *width)[src]
        return out.reshape(new_n_buckets, s, *width)

    return ResizeResult(
        HashState(keys=scat(state.keys, (2,)),
                  versions=scat(state.versions, ()),
                  values=scat(state.values, (vw,))),
        overflow)


def shard_occupancy(state: HashState, n_shards: int) -> torch.Tensor:
    """Occupied entries per high-bit bucket shard, (M,) int64: the resize
    policy's fill signal."""
    shard_buckets(state.n_buckets, n_shards)
    occ = (state.keys[..., 0] != hashing.EMPTY_KEY).sum(dim=1)  # (NB,)
    return occ.reshape(n_shards, -1).sum(dim=1)


def shard_min_free(state: HashState, n_shards: int) -> torch.Tensor:
    """Fewest empty slots of any bucket, per shard, (M,) int64. Overflow
    strikes when a single bucket fills, so this (not mean occupancy) is
    the early-warning signal a grow policy watches."""
    shard_buckets(state.n_buckets, n_shards)
    free = (state.keys[..., 0] == hashing.EMPTY_KEY).sum(dim=1)  # (NB,)
    return free.reshape(n_shards, -1).amin(dim=1)


def hot_shard(overflow_bits: int, occupancy) -> int:
    """The shard a grow should relieve: the first latched overflow bit if
    any, else the fullest shard by occupancy ((M,) counts, host or
    device; the first of equals)."""
    if overflow_bits:
        return (overflow_bits & -overflow_bits).bit_length() - 1
    if isinstance(occupancy, torch.Tensor):
        occupancy = occupancy.cpu().numpy()
    return int(np.argmax(occupancy))


def tree_head(state: HashState, n_shards: int) -> torch.Tensor:
    """(2,) u32 digest-tree head of a table under the ``n_shards`` high-bit
    partition: per-shard :func:`state_digest` folded by
    :func:`shard_digest_tree`. Snapshot manifests and journal re-anchor
    records commit to it."""
    sk, sv, sva = split_table(state.keys, state.versions, state.values,
                              n_shards)
    return shard_digest_tree(torch.stack([
        state_digest(HashState(sk[m], sv[m], sva[m]))
        for m in range(n_shards)]))


def shard_digest_tree(digests: torch.Tensor) -> torch.Tensor:
    """Fold of per-shard digests (M, 2) -> (2,) in shard order, pairwise
    with :func:`hashing.combine` (an odd level repeats its last digest):
    it binds the shard layout, which the XOR-fold state digest does not."""
    d = digests
    while d.shape[0] > 1:
        if d.shape[0] % 2:
            d = torch.cat([d, d[-1:]])
        d = torch.stack([hashing.combine(d[0::2, 0], d[1::2, 0]),
                         hashing.combine(d[0::2, 1], d[1::2, 1])], dim=-1)
    return d[0]


class Lookup(NamedTuple):
    found: torch.Tensor  # (B,) bool
    versions: torch.Tensor  # (B,) u32; 0 if absent
    values: torch.Tensor  # (B, VW) u32; 0 if absent
    slots: torch.Tensor  # (B,) int32 slot within bucket (0 if absent)


def lookup(state: HashState, keys: torch.Tensor) -> Lookup:
    """Batched probe of (B, 2) paired keys; a key (0, *) never matches."""
    return Lookup(*ht_ops.lookup(state.keys, state.versions, state.values,
                                 keys.contiguous()))


def same_key_matrix(fk: torch.Tensor) -> torch.Tensor:
    """same[i, j] = flat writes i and j carry the same paired key. (K, K)."""
    return ((fk[:, 0][None, :] == fk[:, 0][:, None])
            & (fk[:, 1][None, :] == fk[:, 1][:, None]))


def earlier_mask(k: int, device=None) -> torch.Tensor:
    """Strict lower triangle: earlier[i, j] = j precedes i in write order."""
    return torch.ones((k, k), dtype=torch.bool, device=device).tril(-1)


def bucket_free_slots(state: HashState, keys: torch.Tensor) -> torch.Tensor:
    """Empty-slot count of each key's bucket, (..., 2) -> (...,) int32: the
    window write planner's slot budget (pipeline/batched_mvcc)."""
    per_bucket = (state.keys[..., 0] == hashing.EMPTY_KEY).sum(dim=1)
    return per_bucket[bucket_of(state, keys).long()].to(torch.int32)


class CommitResult(NamedTuple):
    state: HashState
    overflow: torch.Tensor  # () bool: a bucket ran out of slots


def _flatten_writes(write_keys, write_vals, active):
    """(B, WK, 2)/(B, WK, VW)/(B,) -> flat (K, 2)/(K, VW)/(K,)."""
    bsz, wk, _ = write_keys.shape
    fk = write_keys.reshape(bsz * wk, 2)
    fv = write_vals.reshape(bsz * wk, -1)
    act = active.repeat_interleave(wk) & (fk[:, 0] != hashing.EMPTY_KEY)
    return fk, fv, act


def commit_vectorized(state: HashState, write_keys, write_vals, active
                      ) -> CommitResult:
    """Conflict-free block commit via intra-batch slot ranking, in place.

    Active writes are expected to carry pairwise-distinct keys (MVCC
    guarantees it for valid transactions); of duplicate active keys the
    first wins. A new key takes the rank-th empty slot of its bucket, rank
    counted among the new keys of that bucket; one that finds no slot is
    dropped and reported as ``overflow``.
    """
    fk, fv, act = _flatten_writes(write_keys, write_vals, active)
    k = fk.shape[0]
    dev = fk.device
    look = lookup(state, fk)
    b = bucket_of(state, fk).long()

    earlier = earlier_mask(k, dev)
    dup = (same_key_matrix(fk) & earlier & act[None, :]).any(dim=1) & act
    act = act & ~dup
    is_update = look.found & act
    is_new = act & ~look.found
    same_bucket = b[None, :] == b[:, None]
    rank = (same_bucket & earlier & is_new[None, :]).sum(dim=1)  # (K,)

    empty = state.keys[b][..., 0] == hashing.EMPTY_KEY  # (K, S)
    cum = torch.cumsum(empty.to(torch.int64), dim=1)
    want = rank + 1
    new_slot = torch.argmax((cum == want[:, None]).to(u32.WORD), dim=1)
    fits = cum[:, -1] >= want
    overflow = (is_new & ~fits).any()

    slot = torch.where(is_update, look.slots.long(), new_slot)
    do = is_update | (is_new & fits)
    new_ver = torch.where(is_update, u32.add(look.versions, 1), 1)
    # Only applied writes are written: a stale write-back at a guessed slot
    # (argmax of an all-false mask is 0) would clobber a same-bucket insert.
    flat = (b * state.slots + slot)[do]
    state.keys.view(-1, 2)[flat] = fk[do]
    state.versions.view(-1)[flat] = new_ver[do].to(u32.WORD)
    state.values.view(-1, state.value_width)[flat] = fv[do]
    return CommitResult(state, overflow)


def commit_sequential(state: HashState, write_keys, write_vals, active
                      ) -> CommitResult:
    """Paper-faithful sequential insert-or-update, one write at a time in
    flat order, through the hash-table commit kernel, in place: a matched
    key gets version + 1, a new key the first empty slot of its bucket and
    version 1, and a write that finds neither is dropped and reported as
    ``overflow``. Duplicate keys apply in turn (no first-wins dedup)."""
    fk, fv, act = _flatten_writes(write_keys, write_vals, active)
    overflow = ht_ops.commit(state.keys, state.versions, state.values,
                             fk.contiguous(), fv.contiguous(), act)
    return CommitResult(state, overflow)


def commit(state, write_keys, write_vals, active, *, sequential=False
           ) -> CommitResult:
    fn = commit_sequential if sequential else commit_vectorized
    return fn(state, write_keys, write_vals, active)


def commit_window(state: HashState, log_keys: torch.Tensor,
                  log_vals: torch.Tensor, log_bumps: torch.Tensor,
                  log_new: torch.Tensor) -> HashState:
    """Apply a whole window's write log in one scatter, in place.

    The block pipeline (pipeline/schedule) plans D blocks' writes and
    applies them here at once. The log is flat and block-major (block order
    is apply order; within a block, flat write order): ``log_keys`` (L, 2),
    ``log_vals`` (L, VW), ``log_bumps`` (L,) bool, the writes that advanced
    their key's version (valid, non-empty, not deduplicated, not dropped by
    overflow), and ``log_new`` (L,) bool, the bumps that took a new slot (at
    most one per key).

    Valid write sets are disjoint within a block but not across blocks, so
    a last-writer-wins reduction comes first: a key's final version is its
    window-start version plus its bumps, its value the last bump's, its
    slot the window-start slot or the rank-th empty slot of its bucket in
    ``log_new`` order, the slot the per-block commits would have given it.
    Only each key's last bump is written (as :func:`commit_vectorized`
    writes only applied writes): the card's scatter orders no duplicates.
    """
    lk = log_keys
    dev = lk.device
    nonempty = lk[:, 0] != hashing.EMPTY_KEY
    bumps = log_bumps & nonempty
    new = log_new & nonempty
    look = lookup(state, lk)
    b = bucket_of(state, lk).long()

    same_key = same_key_matrix(lk) & nonempty[None, :]
    n = lk.shape[0]
    earlier = earlier_mask(n, dev)
    later = torch.ones((n, n), dtype=torch.bool, device=dev).triu(1)
    # Per entry: its key's bumps over the window, and whether it is the
    # key's last bump (the survivor).
    total = (same_key & bumps[None, :]).sum(dim=1)
    lww = bumps & ~(same_key & later & bumps[None, :]).any(dim=1)

    # In-window inserts take their bucket's window-start empty slots in log
    # order; the slot reaches every entry of the key through a masked max.
    rank = ((b[None, :] == b[:, None]) & earlier & new[None, :]).sum(dim=1)
    empty = state.keys[b][..., 0] == hashing.EMPTY_KEY  # (L, S)
    cum = torch.cumsum(empty.to(torch.int64), dim=1)
    slot_new = torch.argmax((cum == (rank + 1)[:, None]).to(u32.WORD), dim=1)
    ins_slot = torch.where(same_key & new[None, :], slot_new[None, :],
                           0).amax(dim=1)
    slot = torch.where(look.found, look.slots.long(), ins_slot)
    new_ver = u32.add(look.versions, total)

    flat = (b * state.slots + slot)[lww]
    state.keys.view(-1, 2)[flat] = lk[lww]
    state.versions.view(-1)[flat] = new_ver[lww]
    state.values.view(-1, state.value_width)[flat] = log_vals[lww]
    return state


def occupancy(state: HashState) -> torch.Tensor:
    return (state.keys[..., 0] != hashing.EMPTY_KEY).sum()


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of all elements (torch has no xor reduction): halve and xor."""
    x = x.reshape(-1)
    if x.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] ^ x[1::2]
    return x[0]


def state_digest(state: HashState) -> torch.Tensor:
    """Order-independent digest of the occupied entries, (2,) u32: an XOR
    fold of per-entry content hashes, so it does not depend on layout."""
    occ = state.keys[..., 0] != hashing.EMPTY_KEY  # (NB, S)
    entry = torch.cat([state.keys, state.versions[..., None], state.values],
                      dim=-1)  # (NB, S, 3+VW)
    return torch.stack([
        _xor_fold(torch.where(occ, hashing.hash_words(entry, seed=seed), 0))
        for seed in (hashing.SEED_A, hashing.SEED_B)
    ])


# -- LevelDB-like sorted store: the Fabric 1.2 baseline state database ------

_DEAD = u32.s32(0xFFFFFFFF)  # key word of a dead entry; dead entries sort last


class SortedState(NamedTuple):
    """Log-structured sorted store: entries lexsorted by the unsigned
    (key_hi, key_lo) pair, ``count`` live ones first and dead ones (key
    (DEAD, DEAD)) after them. Reads bisect; commits merge the write batch
    into the run and chain its words into a write-ahead-log head."""

    key_hi: torch.Tensor  # (N,) u32
    key_lo: torch.Tensor  # (N,) u32
    versions: torch.Tensor  # (N,) u32
    values: torch.Tensor  # (N, VW) u32
    count: torch.Tensor  # () int32, unclamped: inserts past N are cut
    wal_head: torch.Tensor  # (2,) u32 write-ahead-log chain hash

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]


def sorted_create(capacity: int, value_width: int, device=None
                  ) -> SortedState:
    """Empty store on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return SortedState(
        key_hi=u32.full((capacity,), _DEAD, dev),
        key_lo=u32.full((capacity,), _DEAD, dev),
        versions=torch.zeros((capacity,), dtype=u32.WORD, device=dev),
        values=torch.zeros((capacity, value_width), dtype=u32.WORD,
                           device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        wal_head=torch.zeros((2,), dtype=u32.WORD, device=dev),
    )


def sorted_lookup(state: SortedState, keys: torch.Tensor) -> Lookup:
    """Exact search for (B, 2) paired keys; ``slots`` is the clamped left
    insertion point, the entry a hit reads. A key whose first word is empty
    or DEAD never matches."""
    pos = hashing.lex_searchsorted(state.key_hi, state.key_lo, keys[:, 0],
                                   keys[:, 1])
    idx = pos.clamp(0, state.capacity - 1).long()
    hit = ((state.key_hi[idx] == keys[:, 0])
           & (state.key_lo[idx] == keys[:, 1])
           & (pos < state.capacity)
           & (keys[:, 0] != _DEAD)
           & (keys[:, 0] != hashing.EMPTY_KEY))
    return Lookup(found=hit,
                  versions=torch.where(hit, state.versions[idx], 0),
                  values=torch.where(hit[:, None], state.values[idx], 0),
                  slots=idx.to(torch.int32))


def sorted_commit(state: SortedState, write_keys, write_vals, active
                  ) -> SortedState:
    """Merge the write batch into the sorted run + WAL chain hash; returns
    a new store.

    As in the reference, every write, active or not, writes its lookup slot:
    the new version and value if it is an active update, else the slot's
    pre-block contents. Where several writes share a slot the last one in
    flat order decides (the reference's CPU scatter), so an inactive or
    new-key write after an update at the same slot undoes that update.
    """
    fk, fv, act = _flatten_writes(write_keys, write_vals, active)
    k = fk.shape[0]
    dev = fk.device
    earlier = earlier_mask(k, dev)
    act = act & ~(same_key_matrix(fk) & earlier & act[None, :]).any(dim=1)

    # WAL: both seeds' chains over the K x (2+VW) flat words in one pass.
    wal = torch.cat([fk, fv], dim=1).reshape(1, -1).expand(2, -1)
    wal_head = hashing.hash_words(wal, seed=state.wal_head)

    look = sorted_lookup(state, fk)
    is_update = look.found & act
    is_new = act & ~look.found
    slot = look.slots.long()
    # Every write at a slot stores what the slot's last write decides, so
    # the duplicate indices of the scatter below all carry one value.
    same_slot = slot[None, :] == slot[:, None]
    last = torch.where(same_slot, torch.arange(k, device=dev), -1).amax(dim=1)
    upd = is_update[last]
    old_vers = state.versions[slot]
    upd_vers = torch.where(upd, u32.add(old_vers, 1), old_vers)
    upd_vals = torch.where(upd[:, None], fv[last], state.values[slot])

    # Inserts: append the new keys, then a stable re-sort of the whole run
    # (compaction), cut to capacity.
    all_hi = torch.cat([state.key_hi, torch.where(is_new, fk[:, 0], _DEAD)])
    all_lo = torch.cat([state.key_lo, torch.where(is_new, fk[:, 1], _DEAD)])
    all_vers = torch.cat([state.versions, is_new.to(u32.WORD)])
    all_vals = torch.cat([state.values, torch.where(is_new[:, None], fv, 0)])
    all_vers[slot] = upd_vers
    all_vals[slot] = upd_vals
    order = torch.argsort(u32.pair_key(all_hi, all_lo), stable=True
                          )[:state.capacity]
    return SortedState(
        key_hi=all_hi[order], key_lo=all_lo[order],
        versions=all_vers[order], values=all_vals[order],
        count=state.count + is_new.sum(dtype=torch.int32),
        wal_head=wal_head)
