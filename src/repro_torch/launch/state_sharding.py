"""Bucket-sharded world state: routed lookups, fills, commits, the
butterfly resize and the sticky overflow bitmask (port of
repro.launch.state_sharding).

Shard m of a table of NB global buckets owns the contiguous bucket range
[m * nb_loc, (m + 1) * nb_loc), nb_loc = NB / M: the HIGH bits of the
global bucket index (``world_state.shard_of``). So the shard tables are
views of the global (NB, S, ...) tensors (:func:`shard_views`), a commit
into a shard writes through to the global table, and a shard-local probe
with nb_loc buckets masks a key to the LOW bits, which is its local
bucket when the shard owns it.

The reference runs these functions inside ``shard_map`` over the mesh
``model`` axis, one shard a rank. Here each function takes the M shard
tables as a list and computes what every rank holds after its
collective: every shard does its rank's work on its own table (a routed
probe is one K2 probe a shard over the whole key batch, masked by
owner), a masked ``psum`` becomes the owner's result picked from the
shards' masked results (each key has exactly one owner, so the sum is a
select), an ``all_gather`` a stack, and the butterfly ``ppermute``s of a
resize the choice of the old shard pair each new shard rebuilds from
(:func:`_butterfly_perms`). Each shard's work runs on its table's device
and the results come back to the device of the keys, so the shards may
lie on different devices.

The ``rank_*`` functions are one rank's part of a routed read or commit,
for the mesh step (launch/fabric_step), which runs each rank on its own
device and reduces the parts with the mesh's collectives; the list
functions here are built from them.

Concatenating the shard tables in order gives the replicated table array
for array, because writes to one bucket always share an owner: a sharded
step equals the replicated one in every state tensor, head and validity
bit, and its overflow bits name the shards that dropped a write.

Bit m of the sticky overflow mask is set once shard m dropped a write on a
full bucket; the mask rides the mesh state as ``OVERFLOW_LANES`` u32 words
(lane l holds shard bits [32 l, 32 l + 32)), and host code folds it into
one int.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core import world_state as ws

OVERFLOW_LANES = 2
MAX_OVERFLOW_SHARDS = 32 * OVERFLOW_LANES


def check_shard_count(n_shards: int, *, channel=None) -> None:
    """Refuse more shards than the overflow bitmask has bits. ``channel``
    names the channel(s) in the error."""
    if n_shards > MAX_OVERFLOW_SHARDS:
        where = "" if channel is None else f" (channel {channel})"
        raise ValueError(
            f"overflow bitmask supports <= {MAX_OVERFLOW_SHARDS} shards, "
            f"got {n_shards}{where}")


def overflow_bits(shard_overflow: torch.Tensor, *, channel=None
                  ) -> torch.Tensor:
    """Per-shard overflow (M,) bool -> bitmask lanes (LANES,) u32.
    ``channel`` names the channel(s) in the too-many-shards error."""
    m = shard_overflow.shape[0]
    check_shard_count(m, channel=channel)
    idx = torch.arange(m, device=shard_overflow.device)
    word = shard_overflow.to(torch.int64) << (idx % 32)  # (M,)
    lane = (idx // 32)[:, None] == torch.arange(
        OVERFLOW_LANES, device=idx.device)  # (M, LANES)
    return (word[:, None] * lane).sum(dim=0).to(u32.WORD)


def dropped_write_bits(keys: torch.Tensor, dropped: torch.Tensor,
                       n_buckets_global: int, n_shards: int, *,
                       channel=None) -> torch.Tensor:
    """Bitmask lanes (LANES,) of the shards owning a dropped write: ``keys``
    (L, 2) and ``dropped`` (L,) bool are a block's write plan
    (pipeline/batched_mvcc.plan_block_writes)."""
    owner = ws.shard_of(n_buckets_global, n_shards, keys).long()  # (L,)
    onehot = ((owner[:, None] == torch.arange(n_shards, device=keys.device))
              & dropped[:, None]).any(dim=0)  # (M,)
    return overflow_bits(onehot, channel=channel)


def bits_to_int(lanes) -> int:
    """Lane words (LANES,), a tensor or u32 array, -> one Python int."""
    arr = (u32.to_numpy(lanes) if isinstance(lanes, torch.Tensor)
           else np.asarray(lanes)).reshape(-1).astype(np.uint64)
    return int(sum(int(w) << (32 * i) for i, w in enumerate(arr)))


def int_to_lanes(bits: int) -> np.ndarray:
    """One Python int -> lane words (LANES,) u32."""
    return np.array([(bits >> (32 * i)) & u32.MASK
                     for i in range(OVERFLOW_LANES)], dtype=np.uint32)


# -- shard tables and routing ----------------------------------------------------

# The single-device shard views of world_state, re-exported as the
# reference re-exports them: the reshape IS the partition.
split_table = ws.split_table
merge_table = ws.merge_table


def shard_views(table: ws.HashState, n_shards: int) -> list:
    """The ``n_shards`` shard tables of a global table: views, so commits
    into them commit into ``table``."""
    sk, sv, sva = split_table(table.keys, table.versions, table.values,
                              n_shards)
    return [ws.HashState(sk[m], sv[m], sva[m]) for m in range(n_shards)]


def owned_mask(keys: torch.Tensor, n_buckets_global: int, n_shards: int,
               shard: int) -> torch.Tensor:
    """Mask of paired keys (..., 2) owned by ``shard`` -> (...,) bool."""
    return ws.shard_of(n_buckets_global, n_shards, keys) == shard


def _routed(shards: list, keys: torch.Tensor, n_buckets_global: int, probe):
    """Run ``probe(shard_table, keys)`` on every shard, on its device, and
    pick each key's owner's results: the masked psum of the reference.
    ``probe`` returns a tuple of tensors with the key dims leading."""
    n_shards = len(shards)
    owner = ws.shard_of(n_buckets_global, n_shards, keys)
    out = None
    for m, st in enumerate(shards):
        res = [r.to(keys.device) for r in probe(st, keys.to(st.keys.device))]
        mine = owner == m
        if out is None:
            out = [torch.where(_bcast(mine, r), r, torch.zeros_like(r))
                   for r in res]
        else:
            out = [torch.where(_bcast(mine, r), r, o)
                   for r, o in zip(res, out)]
    return out


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(*mask.shape, *([1] * (like.dim() - mask.dim())))


def sharded_lookup(shards: list, keys: torch.Tensor, n_buckets_global: int,
                   n_shards: int) -> ws.Lookup:
    """Routed probe of (B, 2) keys over the shard tables, one K2 probe a
    shard; ``slots`` are the owner shard's local slots."""
    _check(shards, n_buckets_global, n_shards)
    return ws.Lookup(*_routed(shards, keys, n_buckets_global,
                              lambda st, k: tuple(ws.lookup(st, k))))


def rank_versions(local: ws.HashState, rank: int, keys: torch.Tensor,
                  n_buckets_global: int, n_shards: int) -> torch.Tensor:
    """Rank ``rank``'s part of the routed version read of a flat (K, 2) key
    batch: the versions of the keys its shard ``local`` owns, 0 for the
    others (one K2 probe, on the shard's device, where the keys must
    lie)."""
    mine = owned_mask(keys, n_buckets_global, n_shards, rank)
    return torch.where(mine, ws.lookup(local, keys).versions, 0)


def rank_fill(local: ws.HashState, rank: int, keys: torch.Tensor,
              free_keys: torch.Tensor, n_buckets_global: int, n_shards: int
              ) -> tuple:
    """Rank ``rank``'s part of the window fill: :func:`rank_versions` of
    ``keys`` (K, 2) and the empty-slot counts of the owned buckets of
    ``free_keys`` (F, 2), 0 elsewhere. Returns (versions (K,), free (F,)
    int32)."""
    mine = owned_mask(free_keys, n_buckets_global, n_shards, rank)
    free = torch.where(mine, ws.bucket_free_slots(local, free_keys), 0)
    return (rank_versions(local, rank, keys, n_buckets_global, n_shards),
            free)


def _sum_to(device, parts: list) -> torch.Tensor:
    """The masked parts summed on ``device``: each element is non-zero on
    its owner's part at most, so the sum is the owner's pick."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def sharded_lookup_versions(shards: list, keys: torch.Tensor,
                            n_buckets_global: int, n_shards: int
                            ) -> torch.Tensor:
    """Routed versions of a flat (K, 2) key batch -> (K,) u32 on the keys'
    device: the MVCC read check needs only versions (one gather where the
    reference has three)."""
    _check(shards, n_buckets_global, n_shards)
    return _sum_to(keys.device, [
        rank_versions(st, m, keys.to(st.keys.device), n_buckets_global,
                      n_shards) for m, st in enumerate(shards)])


def sharded_window_fill(shards: list, keys: torch.Tensor,
                        free_keys: torch.Tensor, n_buckets_global: int,
                        n_shards: int):
    """The window fill's routed gather: versions of a flat (K, 2) key batch
    and the empty-slot counts of the buckets of a flat (F, 2) key batch,
    one K2 probe a shard. Returns (versions (K,) u32, free (F,) int32) on
    the keys' device."""
    _check(shards, n_buckets_global, n_shards)
    parts = [rank_fill(st, m, keys.to(st.keys.device),
                       free_keys.to(st.keys.device), n_buckets_global,
                       n_shards) for m, st in enumerate(shards)]
    return (_sum_to(keys.device, [v for v, _ in parts]),
            _sum_to(keys.device, [f for _, f in parts]))


def _check(shards: list, n_buckets_global: int, n_shards: int) -> None:
    if (len(shards) != n_shards
            or shards[0].n_buckets * n_shards != n_buckets_global):
        raise ValueError(
            f"{len(shards)} shards of {shards[0].n_buckets} buckets are not "
            f"a {n_shards}-way partition of {n_buckets_global} buckets")


class RoutedCommitResult(NamedTuple):
    state: list  # the shard tables, committed in place
    overflow: torch.Tensor  # () bool: some shard dropped a write
    shard_overflow: torch.Tensor  # (M,) bool: which shards did


def _blank_unowned(keys: torch.Tensor, mine: torch.Tensor) -> torch.Tensor:
    """Keys (..., 2) with the ones ``mine`` leaves out set to EMPTY, which
    every commit skips."""
    return torch.where(mine[..., None], keys, 0)


def rank_commit(local: ws.HashState, rank: int, write_keys: torch.Tensor,
                write_vals: torch.Tensor, active: torch.Tensor,
                n_buckets_global: int, n_shards: int, *,
                sequential: bool = False) -> torch.Tensor:
    """Rank ``rank``'s part of a routed commit, in place on its shard
    ``local``: the block's write sets (B, WK, 2) / (B, WK, VW) / (B,) on the
    shard's device, with the write keys it does not own blanked to EMPTY
    (``active`` stays per transaction, so a transaction whose writes
    straddle shards commits each write on its owner). Returns the shard's
    () bool overflow flag."""
    mine = owned_mask(write_keys, n_buckets_global, n_shards, rank)
    return ws.commit(local, _blank_unowned(write_keys, mine), write_vals,
                     active, sequential=sequential).overflow


def sharded_commit(shards: list, write_keys: torch.Tensor,
                   write_vals: torch.Tensor, active: torch.Tensor,
                   n_buckets_global: int, n_shards: int, *,
                   sequential: bool = False) -> RoutedCommitResult:
    """Apply a block's validated write sets on the owning shards only, in
    place (:func:`rank_commit` on every shard, on its device); the flags
    land on the write keys' device. A sequential commit is one K3 launch a
    shard."""
    _check(shards, n_buckets_global, n_shards)
    flags = []
    for m, st in enumerate(shards):
        dev = st.keys.device
        flags.append(rank_commit(
            st, m, write_keys.to(dev), write_vals.to(dev), active.to(dev),
            n_buckets_global, n_shards, sequential=sequential
        ).to(write_keys.device))
    shard_ovf = torch.stack(flags)
    return RoutedCommitResult(state=shards, overflow=shard_ovf.any(),
                              shard_overflow=shard_ovf)


def rank_commit_window(local: ws.HashState, rank: int,
                       log_keys: torch.Tensor, log_vals: torch.Tensor,
                       log_bumps: torch.Tensor, log_new: torch.Tensor,
                       n_buckets_global: int, n_shards: int) -> None:
    """Rank ``rank``'s part of the fused window commit, in place on its
    shard: the window log with the entries it does not own blanked and
    their bump and new flags cleared, so its scatter touches only its own
    buckets."""
    mine = owned_mask(log_keys, n_buckets_global, n_shards, rank)
    ws.commit_window(local, _blank_unowned(log_keys, mine), log_vals,
                     log_bumps & mine, log_new & mine)


def commit_window_routed(shards: list, log_keys: torch.Tensor,
                         log_vals: torch.Tensor, log_bumps: torch.Tensor,
                         log_new: torch.Tensor, n_buckets_global: int,
                         n_shards: int) -> list:
    """Owner-shard :func:`world_state.commit_window`, in place:
    :func:`rank_commit_window` on every shard, on its device."""
    _check(shards, n_buckets_global, n_shards)
    for m, st in enumerate(shards):
        dev = st.keys.device
        rank_commit_window(st, m, log_keys.to(dev), log_vals.to(dev),
                           log_bumps.to(dev), log_new.to(dev),
                           n_buckets_global, n_shards)
    return shards


class RoutedResizeResult(NamedTuple):
    state: list  # the NEW shard tables
    overflow: torch.Tensor  # () bool: some shard dropped entries (shrink)
    shard_overflow: torch.Tensor  # (M,) bool: which shards did


def _butterfly_perms(n_shards: int, grow: bool):
    """The two (source, destination) permutations of a halve/double step.

    Growing, new shard j (and its high twin j + M/2) rebuilds from the
    ADJACENT old pair (2j, 2j+1); shrinking, new shard j rebuilds from the
    old pair (j//2, j//2 + M/2)."""
    h = n_shards // 2
    if grow:
        pa = ([(2 * j, j) for j in range(h)]
              + [(2 * j + 1, j + h) for j in range(h)])
        pb = ([(2 * j + 1, j) for j in range(h)]
              + [(2 * j, j + h) for j in range(h)])
    else:
        pa = ([(j, 2 * j) for j in range(h)]
              + [(j + h, 2 * j + 1) for j in range(h)])
        pb = ([(j, 2 * j + 1) for j in range(h)]
              + [(j + h, 2 * j) for j in range(h)])
    return pa, pb


def butterfly_sources(n_shards: int, grow: bool) -> list:
    """For each new shard, the old shard pair it rebuilds from, in
    ascending old-global-bucket order: what the two ppermutes of
    :func:`_butterfly_perms` deliver to that rank, low source first."""
    pa, pb = _butterfly_perms(n_shards, grow)
    src_a = {dst: src for src, dst in pa}
    src_b = {dst: src for src, dst in pb}
    out = []
    for r in range(n_shards):
        # Growing, a rank below M/2 got the low source through pa;
        # shrinking, an even rank did. The twin got them swapped.
        lo_is_a = r < n_shards // 2 if grow else r % 2 == 0
        a, b = src_a[r], src_b[r]
        out.append((a, b) if lo_is_a else (b, a))
    return out


def resize_sharded(shards: list, new_nb_loc: int, n_buckets_global: int,
                   n_shards: int, *, device=None, moved=None
                   ) -> RoutedResizeResult:
    """Halve or double every shard's bucket count.

    Under the high-bit partition a global doubling sends the keys of the
    adjacent old shard pair (2j, 2j+1) onto new shards j and j + M/2 (the
    new top bucket bit is the new top shard bit), and a halving sends the
    old pair (j//2, j//2 + M/2) onto new shard j. Each new shard
    concatenates its old pair in ascending global-bucket order, keeps the
    keys it owns under the new layout and compacts with
    :func:`world_state.resize`, so the result equals ``world_state.resize``
    of the merged table, split, array for array; a shrink that overflows a
    merged bucket drops the same entries and sets its shard's flag.
    ``new_nb_loc`` must be 2x or x/2 the current local bucket count. New
    shard r is built on old shard r's device; the flags land on ``device``
    (default: shard 0's). ``moved`` (a Counter) adds under ``"resize"``
    the bytes of the old shards a new shard takes from another rank."""
    _check(shards, n_buckets_global, n_shards)
    nb_loc = shards[0].n_buckets
    if new_nb_loc not in (2 * nb_loc, nb_loc // 2):
        raise ValueError(
            f"resize_sharded steps by 2x only: nb_loc={nb_loc} -> "
            f"{new_nb_loc}")
    grow = new_nb_loc == 2 * nb_loc
    new_nb_glob = n_buckets_global * 2 if grow else n_buckets_global // 2
    ws.shard_buckets(new_nb_glob, n_shards)  # validate the new partition

    device = shards[0].keys.device if device is None else device
    if n_shards == 1:
        res = ws.resize(shards[0], new_nb_loc)
        return RoutedResizeResult(state=[res.state], overflow=res.overflow,
                                  shard_overflow=res.overflow[None])

    out, flags = [], []
    for r, (lo, hi) in enumerate(butterfly_sources(n_shards, grow)):
        dev = shards[r].keys.device
        pair = ws.HashState(*(torch.cat([a.to(dev), b.to(dev)])
                              for a, b in zip(shards[lo], shards[hi])))
        if moved is not None:
            moved["resize"] += sum(t.numel() * t.element_size()
                                   for src in (lo, hi) if src != r
                                   for t in shards[src])
        mine = owned_mask(pair.keys, new_nb_glob, n_shards, r)
        res = ws.resize(pair._replace(keys=_blank_unowned(pair.keys, mine)),
                        new_nb_loc)
        out.append(res.state)
        flags.append(res.overflow.to(device))
    shard_ovf = torch.stack(flags)
    return RoutedResizeResult(state=out, overflow=shard_ovf.any(),
                              shard_overflow=shard_ovf)


def sharded_digest(shards: list, device=None) -> torch.Tensor:
    """(2,) head of the sharded state on ``device`` (default: shard 0's):
    each shard's digest on its own device, gathered there in shard order
    and folded by the digest tree."""
    dev = shards[0].keys.device if device is None else device
    return ws.shard_digest_tree(torch.stack(
        [ws.state_digest(st).to(dev) for st in shards]))


def sharded_state_digest(shards: list, device=None) -> torch.Tensor:
    """(2,) :func:`world_state.state_digest` of the table the shards make
    up, on ``device`` (default: shard 0's): the XOR of the shards'
    digests, each computed on its own device."""
    dev = shards[0].keys.device if device is None else device
    out = ws.state_digest(shards[0]).to(dev)
    for st in shards[1:]:
        out = out ^ ws.state_digest(st).to(dev)
    return out
