"""World state: the FastFabric in-memory hash table, Opt P-I (port of the
hash-table half of repro.core.world_state).

Keys are paired u32 hashes; (0, *) marks an empty slot. Versions: 0 means
absent, a first commit writes version 1. Probes go through the hash-table
kernel (kernels/hash_table).

Unlike the JAX package, whose commits return new arrays (and donate the
old), :func:`commit_vectorized` updates the table's tensors IN PLACE and
returns the same :class:`HashState`: a 2^20-bucket table is 224 MiB, and a
copy per block would move more bytes than the block does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    """Empty table on ``device``."""
    if n_buckets & (n_buckets - 1):
        raise ValueError("n_buckets must be a power of two")
    z = lambda *shape: torch.zeros(shape, dtype=u32.WORD, device=device)
    return HashState(keys=z(n_buckets, slots, 2),
                     versions=z(n_buckets, slots),
                     values=z(n_buckets, slots, value_width))


def bucket_of(state_or_nb, keys: torch.Tensor) -> torch.Tensor:
    """Bucket index of paired keys (..., 2) -> (...,) int32, a power-of-2
    mask (non-negative: NB <= 2^31)."""
    nb = state_or_nb if isinstance(state_or_nb, int) else state_or_nb.n_buckets
    return keys[..., 0] & (nb - 1)


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


def commit(state, write_keys, write_vals, active, *, sequential=False
           ) -> CommitResult:
    if sequential:
        raise NotImplementedError(
            "commit_sequential (and its kernel, hash_table.commit) belongs "
            "to the baseline-ladder slice of the port (OPT_P1/OPT_P2)")
    return commit_vectorized(state, write_keys, write_vals, active)


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
