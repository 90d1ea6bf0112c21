"""The window's batched state fill and its exact write planner (port of
repro.pipeline.batched_mvcc).

A window of D blocks probes the table once (:func:`gather_window_state`:
the read and write keys of all D * B transactions in one K2 launch, or one
a shard when the state is bucket-sharded, plus the free slots of every
write key's bucket), and then reconstructs what a
per-block probe would have returned at each block's commit point:

  version after block t-1  ==  version at the fill  +  the APPLIED valid
  writes to that key by the window's blocks 0..t-1,

since every applied write bumps a version by one. "Applied" follows the
commit in use (the vectorized commit applies the first of duplicate keys
in a block, the sequential one every occurrence) and leaves out inserts
dropped on a full bucket: :func:`plan_block_writes` replays the commit's
insert-fits decision against the fill's free slots, so a dropped insert
bumps nothing and the window stays bit-identical to D depth-1 steps, also
when its blocks overflow. The schedule applies the planned log with one
fused scatter (``world_state.commit_window``) after the last block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashing, u32
from repro_torch.core import world_state as ws
from repro_torch.launch import state_sharding


class WindowFill(NamedTuple):
    """The table at the window's start, for its N = D * B transactions."""

    read_vers: torch.Tensor  # (N, RK) u32 versions of the read keys
    write_vers: torch.Tensor  # (N, WK) u32 versions of the write keys
    write_free: torch.Tensor  # (N, WK) int32 empty slots of each write
    # key's bucket (the planner's slot budget)


def fill_keys(read_keys: torch.Tensor, write_keys: torch.Tensor) -> tuple:
    """The fill's probe keys: the read keys (N, RK, 2) and write keys
    (N, WK, 2) flat and together, and the write keys flat, whose buckets'
    free slots the fill counts."""
    wflat = write_keys.reshape(-1, 2)
    return torch.cat([read_keys.reshape(-1, 2), wflat]), wflat


def as_fill(vers: torch.Tensor, free: torch.Tensor, n: int, n_read: int
            ) -> WindowFill:
    """A :class:`WindowFill` of ``n`` transactions from the probe of
    :func:`fill_keys`' keys, the first ``n_read`` of them read keys."""
    return WindowFill(read_vers=vers[:n_read].reshape(n, -1),
                      write_vers=vers[n_read:].reshape(n, -1),
                      write_free=free.reshape(n, -1))


def gather_window_state(local: ws.HashState, read_keys: torch.Tensor,
                        write_keys: torch.Tensor, shard_state: bool = False,
                        *, n_buckets_global: int = None, n_shards: int = 1
                        ) -> WindowFill:
    """One probe of a window's read keys (N, RK, 2) and write keys
    (N, WK, 2) together, in ingest order, and the free slots of the write
    keys' buckets. ``local`` is the channel's table; with ``shard_state``
    the reads, writes and free counts go through one routed
    ``sharded_window_fill`` over its ``n_shards`` shards of
    ``n_buckets_global`` buckets in all."""
    allk, wflat = fill_keys(read_keys, write_keys)
    if shard_state:
        vers, free = state_sharding.sharded_window_fill(
            state_sharding.shard_views(local, n_shards), allk, wflat,
            n_buckets_global, n_shards)
    else:
        vers = ws.lookup(local, allk).versions
        free = ws.bucket_free_slots(local, wflat)
    return as_fill(vers, free, read_keys.shape[0],
                   read_keys.shape[0] * read_keys.shape[1])


def version_adjustment(read_keys: torch.Tensor, wlog_keys: torch.Tensor,
                       wlog_bumps: torch.Tensor) -> torch.Tensor:
    """Applied earlier in-window writes of each key, (B, K, 2) -> (B, K)
    u32, to add to the fill's versions. ``wlog_keys`` (..., 2) and
    ``wlog_bumps`` (...,) are the window write log so far (bump flags
    already leave out dropped writes)."""
    lk = wlog_keys.reshape(-1, 2)
    lb = wlog_bumps.reshape(-1)
    eq = ((read_keys[..., None, 0] == lk[:, 0])
          & (read_keys[..., None, 1] == lk[:, 1])
          & (lk[:, 0] != hashing.EMPTY_KEY) & lb)  # (B, K, L)
    return eq.sum(dim=-1).to(u32.WORD)


class BlockWritePlan(NamedTuple):
    """One block's write outcomes, flat: its row of the window write log."""

    keys: torch.Tensor  # (B*WK, 2)
    bumps: torch.Tensor  # (B*WK,) bool: writes that advance the version
    new: torch.Tensor  # (B*WK,) bool: bumps that take a new slot
    dropped: torch.Tensor  # (B*WK,) bool: writes dropped by overflow


def plan_block_writes(write_keys: torch.Tensor, valid: torch.Tensor,
                      sequential: bool, fill_vers: torch.Tensor,
                      fill_free: torch.Tensor, wl_keys: torch.Tensor,
                      wl_bumps: torch.Tensor, wl_new: torch.Tensor, *,
                      n_buckets_global: int) -> BlockWritePlan:
    """Replay one block's commit decisions against the fill and the log.

    ``write_keys`` (B, WK, 2) and ``valid`` (B,) are the ordered block's
    write sets and validity bits, ``fill_vers`` / ``fill_free`` (B, WK) its
    write keys' fill versions and bucket free slots, ``wl_*`` the log of
    the window's earlier blocks. As the commit in use decides:

      * a key EXISTS here iff its fill version plus its applied bumps is
        not 0 (versions never decrease; 0 is absent), and then applies;
      * a NEW key's insert fits iff its rank among the block's new keys of
        its bucket is below the bucket's fill free slots less the slots
        earlier in-window inserts took; an unfit insert is dropped;
      * of duplicate active keys in the block the vectorized commit applies
        the first, the sequential one every occurrence of an applied key.
    """
    wk = write_keys.shape[1]
    fk = write_keys.reshape(-1, 2)
    k = fk.shape[0]
    dev = fk.device
    act = valid.repeat_interleave(wk) & (fk[:, 0] != hashing.EMPTY_KEY)

    same_key = ws.same_key_matrix(fk)
    earlier = ws.earlier_mask(k, dev)
    first = act & ~(same_key & earlier & act[None, :]).any(dim=1)
    eff = act if sequential else first

    # The key's version right before this block: an unsigned test on the
    # wrapped sum (!= 0, not a signed > 0).
    adj = version_adjustment(write_keys, wl_keys, wl_bumps).reshape(-1)
    exists = u32.add(fill_vers.reshape(-1), adj) != 0

    # Slot budget: fill free slots less the slots in-window inserts took.
    bucket = ws.bucket_of(n_buckets_global, fk)
    lbuck = ws.bucket_of(n_buckets_global, wl_keys.reshape(-1, 2))
    used = ((bucket[:, None] == lbuck[None, :])
            & wl_new.reshape(-1)[None, :]).sum(dim=1)
    remaining = fill_free.reshape(-1).long() - used

    is_new_first = first & ~exists
    same_bucket = bucket[None, :] == bucket[:, None]
    rank = (same_bucket & earlier & is_new_first[None, :]).sum(dim=1)
    fits = rank < remaining
    first_applied = first & (exists | fits)
    # An occurrence applies iff its key's first occurrence did.
    key_ok = (same_key & first_applied[None, :]).any(dim=1)
    return BlockWritePlan(keys=fk, bumps=eff & key_ok,
                          new=is_new_first & fits, dropped=eff & ~key_ok)
