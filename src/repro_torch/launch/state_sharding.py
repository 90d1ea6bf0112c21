"""The sticky overflow bitmask of the fabric step (port of the single-shard
part of repro.launch.state_sharding).

Bit m of the mask is set once shard m dropped a write on a full bucket;
the mask rides the mesh state as ``OVERFLOW_LANES`` u32 words (lane l holds
shard bits [32 l, 32 l + 32)), and host code folds it into one int. This
port holds the state in one shard (bit 0); the routed lookups, commits and
resizes of a bucket-sharded state are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core import world_state as ws

OVERFLOW_LANES = 2
MAX_OVERFLOW_SHARDS = 32 * OVERFLOW_LANES


def overflow_bits(shard_overflow: torch.Tensor, *, channel=None
                  ) -> torch.Tensor:
    """Per-shard overflow (M,) bool -> bitmask lanes (LANES,) u32.
    ``channel`` names the channel(s) in the too-many-shards error."""
    m = shard_overflow.shape[0]
    if m > MAX_OVERFLOW_SHARDS:
        where = "" if channel is None else f" (channel {channel})"
        raise ValueError(
            f"overflow bitmask supports <= {MAX_OVERFLOW_SHARDS} shards, "
            f"got {m}{where}")
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
