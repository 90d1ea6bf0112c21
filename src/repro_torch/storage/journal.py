"""Append-only, digest-chained journal of validated write sets (port of
repro.storage.journal).

Instead of an authenticated structure over the world state, a running hash
is updated with the stream of state updates, and the updates are written
to a journal. Two halves, as in :mod:`repro_torch.core.ledger`:

* :func:`write_set_digest` + :func:`update_head`, the on-path part: the
  committer folds each block's write sets and validity flags into the
  (2,) u32 ``PeerState.journal_head``.
* :class:`StateJournal`, the off-path part: the storage role's writer
  thread hands it each validated block as host arrays; it slices out the
  write sets, recomputes the head chain and keeps the records, optionally
  spilled as ``journal_%08d.npz`` files. Recovery replays a suffix of the
  records onto a snapshot (:mod:`repro_torch.storage.recovery`).

A resize epoch adds a re-anchor record on a parallel chain
(``reanchor_head``, tag ``_REANCHOR_TAG``): it binds the main head at its
boundary, the layout change, the post-resize digest-tree head and the
sticky overflow bitmask, and :meth:`StateJournal.replay` applies the
recorded resizes at their boundaries.

The journal's own hashing (heads, verification) runs on CPU tensors made
from its host records. The spill files are the JAX package's format: the
same names and keys, words as ``uint32``, ``valid`` as ``bool``, so a
journal written by either package loads in the other.
"""

from __future__ import annotations

import glob
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing, types, u32, unmarshal
from repro_torch.core import world_state as ws
from repro_torch.obs.metrics import NULL_REGISTRY

GENESIS_HEAD = np.zeros((2,), np.uint32)

_JOURNAL_TAG = 0x4A524E4C  # "JRNL"
_REANCHOR_TAG = 0x52414E43  # "RANC"


def write_set_digest(write_keys: torch.Tensor, write_vals: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Content digest of a block's write sets + validity flags, (2,) u32,
    order-dependent over transactions."""
    n = write_keys.shape[0]
    words = torch.cat([write_keys.reshape(n, -1), write_vals.reshape(n, -1)],
                      dim=1)
    d1 = hashing.hash_words(words, seed=hashing.SEED_A)  # (N,)
    d2 = hashing.hash_words(words, seed=hashing.SEED_B)
    v = valid.to(u32.WORD)
    return torch.stack([
        hashing.hash_words((d1 ^ v)[None, :], seed=hashing.SEED_A)[0],
        hashing.hash_words((d2 ^ (v << 1))[None, :], seed=hashing.SEED_B)[0],
    ])


def _chain(words: torch.Tensor) -> torch.Tensor:
    """(2,) u32 head of one row of words, one hash per seed."""
    return torch.stack([hashing.hash_words(words[None, :],
                                           seed=hashing.SEED_A)[0],
                        hashing.hash_words(words[None, :],
                                           seed=hashing.SEED_B)[0]])


def update_head(prev_head: torch.Tensor, block_no, ws_digest: torch.Tensor
                ) -> torch.Tensor:
    """Chain: H(tag || prev || block_no || write-set digest). (2,) u32.
    ``block_no`` is an int or a 0-d word tensor."""
    dev = prev_head.device
    if not isinstance(block_no, torch.Tensor):
        block_no = torch.tensor(u32.s32(block_no), dtype=u32.WORD,
                                device=dev)
    tag = u32.full((1,), _JOURNAL_TAG, dev)
    return _chain(torch.cat([tag, prev_head,
                             block_no.reshape(1).to(u32.WORD), ws_digest]))


def journal_head_update(prev_head, block_no, write_keys, write_vals, valid
                        ) -> torch.Tensor:
    """One head update, as the commit path makes it for a block."""
    return update_head(prev_head, block_no,
                       write_set_digest(write_keys, write_vals, valid))


def reanchor_head_update(prev_reanchor, prev_head, block_no, old_n_buckets,
                         new_n_buckets, n_shards, tree_head, overflow_bits
                         ) -> np.ndarray:
    """Re-anchor chain link, (2,) u32 numpy (host side; resizes are rare).

    H(tag || prev_reanchor || main head at the boundary || boundary block
    + 1 || old/new layout || post-resize tree head || overflow bitmask as
    lo/hi words).
    """
    bits = int(overflow_bits)
    words = np.concatenate([
        np.array([_REANCHOR_TAG], np.uint32),
        np.asarray(prev_reanchor, np.uint32),
        np.asarray(prev_head, np.uint32),
        np.array([block_no + 1, old_n_buckets, new_n_buckets, n_shards],
                 np.uint32),
        np.asarray(tree_head, np.uint32),
        np.array([bits & u32.MASK, (bits >> 32) & u32.MASK], np.uint32),
    ])
    return u32.to_numpy(_chain(u32.from_numpy(words)))


def _host_bool(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=bool)


def _record_head(prev: np.ndarray, block_no: int, write_keys: np.ndarray,
                 write_vals: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The head a record's fields chain to from ``prev``, on the CPU."""
    return u32.to_numpy(journal_head_update(
        u32.from_numpy(prev), block_no, u32.from_numpy(write_keys),
        u32.from_numpy(write_vals), torch.from_numpy(np.array(valid, bool))))


class ReanchorRecord(NamedTuple):
    """One resize epoch, applying AFTER block ``block_no`` (-1: before any
    block). ``prev_head`` is the MAIN journal head at that boundary;
    ``head`` chains re-anchors among themselves from ``prev_reanchor``."""

    block_no: int
    old_n_buckets: int
    new_n_buckets: int
    n_shards: int
    tree_head: np.ndarray  # (2,) u32, tree_head of the new table
    overflow_bits: int  # sticky per-shard overflow bitmask at the boundary
    prev_head: np.ndarray  # (2,) u32
    prev_reanchor: np.ndarray  # (2,) u32
    head: np.ndarray  # (2,) u32


class ReplayResult(NamedTuple):
    """The rebuilt state, and whether a replayed commit or shrink dropped a
    write on a full bucket."""

    state: ws.HashState
    overflow: bool


class JournalRecord(NamedTuple):
    """One journaled block, host numpy arrays:
    ``head == update_head(prev_head, block_no, digest(writes))``."""

    block_no: int
    write_keys: np.ndarray  # (B, WK, 2) u32
    write_vals: np.ndarray  # (B, WK, VW) u32
    valid: np.ndarray  # (B,) bool
    prev_head: np.ndarray  # (2,) u32
    head: np.ndarray  # (2,) u32


class StateJournal:
    """Host-side journal: ordered records + running head.

    Appends come from the storage role's writer thread; reads follow
    ``BlockStore.drain()``. With ``spill_dir`` every record is also written
    as ``journal_XXXXXXXX.npz`` (and each re-anchor as
    ``reanchor_XXXXXXXX_SSSS.npz``), from which :meth:`load` rebuilds the
    journal on a cold start. ``metrics`` (an obs ``Registry``) receives
    ``journal.appends``, ``journal.bytes``, ``journal.append.latency`` and
    ``journal.reanchors``.
    """

    def __init__(self, dims: types.FabricDims, *, spill_dir: str | None = None,
                 metrics=None):
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self.dims = dims
        self._metrics = metrics if metrics is not None else NULL_REGISTRY
        self.records: list[JournalRecord] = []
        self.head = GENESIS_HEAD.copy()
        # Pruning base: records up to base_block_no are covered by a
        # snapshot; the chain re-anchors at base_head.
        self.base_block_no = -1
        self.base_head = GENESIS_HEAD.copy()
        self.reanchors: list[ReanchorRecord] = []
        self.reanchor_head = GENESIS_HEAD.copy()
        self.base_reanchor_head = GENESIS_HEAD.copy()
        self._spill_dir = spill_dir

    # -- append path (storage-role thread) ----------------------------------

    def append_block(self, block_no: int, wire, valid) -> JournalRecord:
        """Journal a validated block given as host arrays: ``wire`` (B, 4P)
        u8 and ``valid`` (B,) bool."""
        wk, wv = unmarshal.write_sets(torch.from_numpy(np.array(wire)),
                                      self.dims)
        return self.append_writes(block_no, wk, wv, valid)

    def append_writes(self, block_no: int, write_keys, write_vals, valid
                      ) -> JournalRecord:
        """Journal a block's write sets (tensors of int32 words on any
        device, or u32 arrays) and validity flags."""
        t0 = time.perf_counter()
        wk, wv = u32.host_copy(write_keys), u32.host_copy(write_vals)
        ok = _host_bool(valid)
        prev = self.head
        rec = JournalRecord(block_no=int(block_no), write_keys=wk,
                            write_vals=wv, valid=ok, prev_head=prev,
                            head=_record_head(prev, block_no, wk, wv, ok))
        self.records.append(rec)
        self.head = rec.head
        self._metrics.counter("journal.appends").inc()
        self._metrics.counter("journal.bytes").inc(
            wk.nbytes + wv.nbytes + ok.nbytes)
        self._metrics.histogram("journal.append.latency").record(
            time.perf_counter() - t0)
        if self._spill_dir is not None:
            np.savez(
                f"{self._spill_dir}/journal_{rec.block_no:08d}.npz",
                block_no=np.uint32(rec.block_no), write_keys=wk,
                write_vals=wv, valid=ok, prev_head=rec.prev_head,
                head=rec.head)
        return rec

    def append_reanchor(self, block_no: int, *, old_n_buckets: int,
                        new_n_buckets: int, n_shards: int, tree_head,
                        overflow_bits: int = 0) -> ReanchorRecord:
        """Commit a resize epoch at the CURRENT boundary, after the last
        appended block (drain the storage role first)."""
        tip = self.records[-1].block_no if self.records else self.base_block_no
        if block_no != tip:
            raise ValueError(
                f"re-anchor at block {block_no} but journal tip is {tip} "
                "(drain the storage role before resizing)")
        prev_r = self.reanchor_head
        tree = u32.host_copy(tree_head)
        head = reanchor_head_update(prev_r, self.head, block_no,
                                    old_n_buckets, new_n_buckets, n_shards,
                                    tree, overflow_bits)
        rec = ReanchorRecord(
            block_no=int(block_no), old_n_buckets=int(old_n_buckets),
            new_n_buckets=int(new_n_buckets), n_shards=int(n_shards),
            tree_head=tree, overflow_bits=int(overflow_bits),
            prev_head=self.head.copy(), prev_reanchor=prev_r, head=head)
        self.reanchors.append(rec)
        self.reanchor_head = head
        self._metrics.counter("journal.reanchors").inc()
        if self._spill_dir is not None:
            seq = sum(r.block_no == rec.block_no for r in self.reanchors) - 1
            np.savez(
                f"{self._spill_dir}/reanchor_{rec.block_no + 1:08d}_"
                f"{seq:04d}.npz",
                block_no=np.int64(rec.block_no),
                old_n_buckets=np.uint32(rec.old_n_buckets),
                new_n_buckets=np.uint32(rec.new_n_buckets),
                n_shards=np.uint32(rec.n_shards), tree_head=rec.tree_head,
                overflow_bits=np.uint64(rec.overflow_bits),
                prev_head=rec.prev_head, prev_reanchor=rec.prev_reanchor,
                head=rec.head)
        return rec

    # -- authentication ------------------------------------------------------

    def verify_chain(self, *, base_head: np.ndarray | None = None,
                     after_block_no: int | None = None,
                     reanchor_base: np.ndarray | None = None) -> bool:
        """Recompute both digest chains over the retained records (from the
        prune base), or over the suffix after ``after_block_no`` from a
        trusted ``base_head`` (a snapshot's journal head) and
        ``reanchor_base`` (its re-anchor head)."""
        ok, _ = self.verify_chain_reason(
            base_head=base_head, after_block_no=after_block_no,
            reanchor_base=reanchor_base)
        return ok

    def verify_chain_reason(self, *, base_head: np.ndarray | None = None,
                            after_block_no: int | None = None,
                            reanchor_base: np.ndarray | None = None
                            ) -> tuple[bool, str | None]:
        """:meth:`verify_chain` with the first failing record and check:
        ``(ok, reason)``, ``reason`` None when the chain verifies."""
        if after_block_no is None:
            after_block_no = self.base_block_no
            prev = self.base_head if base_head is None else base_head
        else:
            if base_head is None:
                raise ValueError("after_block_no requires a base_head anchor")
            prev = base_head
        head_at = {after_block_no: np.asarray(prev)}
        expect_no = after_block_no + 1
        for rec in self.suffix(after_block_no):
            if rec.block_no != expect_no:
                return False, (
                    f"record gap: expected block {expect_no}, found "
                    f"{rec.block_no}")
            if not np.array_equal(rec.prev_head, prev):
                return False, (
                    f"record {rec.block_no}: prev_head does not chain "
                    "from the preceding head")
            recomputed = _record_head(
                np.asarray(prev, np.uint32), rec.block_no,
                np.asarray(rec.write_keys, np.uint32),
                np.asarray(rec.write_vals, np.uint32),
                np.asarray(rec.valid, bool))
            if not np.array_equal(recomputed, rec.head):
                return False, (
                    f"record {rec.block_no}: recomputed head mismatch "
                    "(write set or validity bits tampered)")
            prev = rec.head
            head_at[rec.block_no] = rec.head
            expect_no += 1
        prev_r = (self.base_reanchor_head if reanchor_base is None
                  else np.asarray(reanchor_base))
        for rec in self.suffix_reanchors(after_block_no):
            if rec.block_no not in head_at:
                return False, (
                    f"re-anchor at block {rec.block_no}: boundary not in "
                    "the verified suffix")
            if not np.array_equal(rec.prev_head, head_at[rec.block_no]):
                return False, (
                    f"re-anchor at block {rec.block_no}: does not bind "
                    "to the main head at its boundary")
            if not np.array_equal(rec.prev_reanchor, prev_r):
                return False, (
                    f"re-anchor at block {rec.block_no}: does not chain "
                    "from the preceding re-anchor head")
            recomputed = reanchor_head_update(
                prev_r, rec.prev_head, rec.block_no, rec.old_n_buckets,
                rec.new_n_buckets, rec.n_shards, rec.tree_head,
                rec.overflow_bits)
            if not np.array_equal(recomputed, rec.head):
                return False, (
                    f"re-anchor at block {rec.block_no}: recomputed "
                    "re-anchor head mismatch (epoch record tampered)")
            prev_r = rec.head
        return True, None

    # -- replay / compaction -------------------------------------------------

    def suffix(self, after_block_no: int) -> list[JournalRecord]:
        return [r for r in self.records if r.block_no > after_block_no]

    def suffix_reanchors(self, after_block_no: int) -> list[ReanchorRecord]:
        """Re-anchors strictly after ``after_block_no`` (a snapshot at
        boundary b covers a resize at b), except that a pre-genesis resize
        (boundary -1) belongs to the suffix from genesis."""
        return [r for r in self.reanchors
                if r.block_no > after_block_no
                or (r.block_no == -1 and after_block_no == -1)]

    def replay(self, state: ws.HashState, *, after_block_no: int = -1,
               check_reanchors: bool = False) -> ReplayResult:
        """Apply the journaled write sets after ``after_block_no``, in block
        order, onto ``state`` on its device (updated in place between
        resizes), crossing resize epochs: each re-anchor record in the
        suffix applies ``world_state.resize`` at its boundary. Each record
        is one vectorized commit (MVCC makes a block's valid write sets
        disjoint). With ``check_reanchors`` every rebuilt table is held
        against its record's digest-tree head (raises ``ValueError``)."""
        dev = state.keys.device
        by_boundary: dict[int, list[ReanchorRecord]] = {}
        for r in self.suffix_reanchors(after_block_no):
            by_boundary.setdefault(r.block_no, []).append(r)
        ovf = torch.zeros((), dtype=torch.bool, device=dev)

        def cross(state, ovf, boundary):
            for r in by_boundary.pop(boundary, ()):
                if r.old_n_buckets != state.n_buckets:
                    raise ValueError(
                        f"re-anchor at block {r.block_no} expects "
                        f"{r.old_n_buckets} buckets, state has "
                        f"{state.n_buckets}")
                res = ws.resize(state, r.new_n_buckets)
                state, ovf = res.state, ovf | res.overflow
                if check_reanchors:
                    tree = u32.to_numpy(ws.tree_head(state, r.n_shards))
                    if not np.array_equal(tree, r.tree_head):
                        raise ValueError(
                            f"re-anchor at block {r.block_no}: rebuilt "
                            "digest tree head does not match the record")
            return state, ovf

        for rec in self.suffix(after_block_no):
            state, ovf = cross(state, ovf, rec.block_no - 1)
            res = ws.commit_vectorized(
                state, u32.from_numpy(rec.write_keys, dev),
                u32.from_numpy(rec.write_vals, dev),
                torch.from_numpy(np.array(rec.valid, bool)).to(dev))
            state, ovf = res.state, ovf | res.overflow
            state, ovf = cross(state, ovf, rec.block_no)
        for boundary in sorted(by_boundary):  # resizes at the tip
            state, ovf = cross(state, ovf, boundary)
        return ReplayResult(state=state, overflow=bool(ovf))

    def prune_upto(self, block_no: int) -> int:
        """Drop the records (and re-anchors) a snapshot at ``block_no``
        covers, from memory and from the spill directory; returns the
        number of block records dropped. Call with the storage role
        drained."""
        dropped_r = [r for r in self.reanchors if r.block_no <= block_no]
        if dropped_r:
            self.reanchors = self.suffix_reanchors(block_no)
            self.base_reanchor_head = dropped_r[-1].head
            if self._spill_dir is not None:
                for path in sorted(glob.glob(
                        os.path.join(self._spill_dir, "reanchor_*.npz"))):
                    with np.load(path) as z:
                        covered = int(z["block_no"]) <= block_no
                    if covered:
                        os.remove(path)
        dropped = [r for r in self.records if r.block_no <= block_no]
        if dropped:
            self.records = self.suffix(block_no)
            self.base_block_no = dropped[-1].block_no
            self.base_head = dropped[-1].head
            if self._spill_dir is not None:
                for rec in dropped:
                    path = os.path.join(self._spill_dir,
                                        f"journal_{rec.block_no:08d}.npz")
                    if os.path.exists(path):
                        os.remove(path)
        return len(dropped)

    # -- cold-start reload ---------------------------------------------------

    @classmethod
    def load(cls, dims: types.FabricDims, spill_dir: str, *, metrics=None
             ) -> "StateJournal":
        """Rebuild a journal from its spill directory: block records and
        re-anchor records (named by boundary + 1, so a pre-genesis one
        sorts first). Reloaded records do not count as appends."""
        j = cls(dims, spill_dir=None, metrics=metrics)
        for p in sorted(glob.glob(os.path.join(spill_dir, "journal_*.npz"))):
            with np.load(p) as z:
                rec = JournalRecord(
                    block_no=int(z["block_no"]), write_keys=z["write_keys"],
                    write_vals=z["write_vals"],
                    valid=z["valid"].astype(bool), prev_head=z["prev_head"],
                    head=z["head"])
            if not j.records:
                j.base_block_no = rec.block_no - 1
                j.base_head = rec.prev_head.copy()
            j.records.append(rec)
            j.head = rec.head
        for p in sorted(glob.glob(os.path.join(spill_dir, "reanchor_*.npz"))):
            with np.load(p) as z:
                rec = ReanchorRecord(
                    block_no=int(z["block_no"]),
                    old_n_buckets=int(z["old_n_buckets"]),
                    new_n_buckets=int(z["new_n_buckets"]),
                    n_shards=int(z["n_shards"]), tree_head=z["tree_head"],
                    overflow_bits=int(z["overflow_bits"]),
                    prev_head=z["prev_head"],
                    prev_reanchor=z["prev_reanchor"], head=z["head"])
            if not j.reanchors:
                j.base_reanchor_head = rec.prev_reanchor.copy()
            j.reanchors.append(rec)
            j.reanchor_head = rec.head
        j._spill_dir = spill_dir
        return j
