"""Shard-aware world-state snapshots: per-shard files + a manifest (port of
repro.storage.snapshot).

A snapshot freezes the hash-table world state as of a block, with the
authentication heads current at that block (ledger chain hash, journal
head, journal re-anchor head). On disk:

* ``shard_XXXXXXXX_MMMM.npz``: one bucket shard's arrays (the high-bit
  partition of ``world_state.split_table``), written first;
* ``manifest_XXXXXXXX.npz``: layout, per-shard digests, their digest-tree
  head, the XOR-fold state digest, the heads and the sticky overflow
  bitmask, written LAST (tmp file + rename).

Manifest-last makes the snapshot atomic: :func:`latest` only considers
blocks whose manifest loads and whose shard files all exist, files that
match neither name pattern are ignored, and :func:`gc` drops a manifest
before its shards. The digests are computed where the table lives
(:func:`take`) or on the device recovery targets (:func:`verify`); the
arrays and files are host numpy in the JAX package's format (u32 words),
so a snapshot written by either package loads in the other.
"""

from __future__ import annotations

import os
import re
import time
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import u32
from repro_torch.core import world_state as ws
from repro_torch.obs.metrics import NULL_REGISTRY

_MANIFEST_RE = re.compile(r"^manifest_(\d{8})\.npz$")
_SHARD_RE = re.compile(r"^shard_(\d{8})_(\d{4})\.npz$")


class Manifest(NamedTuple):
    """The snapshot commitment: layout + digests + heads + health flag."""

    block_no: int
    journal_head: np.ndarray  # (2,) u32, journal head after block_no
    ledger_head: np.ndarray  # (2,) u32, chain hash after block_no
    reanchor_head: np.ndarray  # (2,) u32, journal re-anchor chain head
    state_digest: np.ndarray  # (2,) u32, XOR-fold full-table digest
    n_buckets: int
    slots: int
    value_width: int
    n_shards: int
    shard_digests: np.ndarray  # (M, 2) u32
    tree_head: np.ndarray  # (2,) u32, shard_digest_tree(shard_digests)
    overflow_bits: int  # sticky per-shard overflow bitmask

    @property
    def overflow(self) -> bool:
        return bool(self.overflow_bits)


class ShardPart(NamedTuple):
    """One bucket shard's arrays (shard m owns buckets [m*NB/M, (m+1)*NB/M))."""

    shard: int
    keys: np.ndarray  # (NB/M, S, 2) u32
    versions: np.ndarray  # (NB/M, S) u32
    values: np.ndarray  # (NB/M, S, VW) u32


class Snapshot(NamedTuple):
    """Manifest + every shard part, in memory."""

    manifest: Manifest
    shards: tuple  # tuple[ShardPart, ...], in shard order

    @property
    def block_no(self) -> int:
        return self.manifest.block_no

    @property
    def journal_head(self) -> np.ndarray:
        return self.manifest.journal_head

    @property
    def ledger_head(self) -> np.ndarray:
        return self.manifest.ledger_head

    @property
    def state_digest(self) -> np.ndarray:
        return self.manifest.state_digest


def _shard_digest(keys, versions, values) -> torch.Tensor:
    return ws.state_digest(ws.HashState(keys, versions, values))


def take(state, *, block_no: int, journal_head, ledger_head,
         n_shards: int = 1, overflow_bits: int = 0,
         reanchor_head=None) -> Snapshot:
    """Snapshot ``state`` as ``n_shards`` host parts + manifest. ``state``
    is one table, split into its shard views, or the list of its
    ``n_shards`` shard tables, which may lie on different devices. Each
    shard's digest is computed on its shard's device and its part copied to
    the host from there; the tree head folds the digests on shard 0's
    device. Call between rounds, off the timed window."""
    if isinstance(state, ws.HashState):
        shards = [ws.HashState(*t) for t in zip(*ws.split_table(
            state.keys, state.versions, state.values, n_shards))]
    else:
        shards = list(state)
        if len(shards) != n_shards:
            raise ValueError(f"{len(shards)} shard tables for a snapshot "
                             f"of {n_shards} shards")
    dev = shards[0].keys.device
    digests = torch.stack([_shard_digest(*st).to(dev) for st in shards])
    tree = u32.to_numpy(ws.shard_digest_tree(digests))
    shard_digests = u32.to_numpy(digests)
    parts = tuple(ShardPart(shard=m, keys=u32.host_copy(st.keys),
                            versions=u32.host_copy(st.versions),
                            values=u32.host_copy(st.values))
                  for m, st in enumerate(shards))
    nb = sum(st.n_buckets for st in shards)
    manifest = Manifest(
        block_no=int(block_no),
        journal_head=u32.host_copy(journal_head),
        ledger_head=u32.host_copy(ledger_head),
        reanchor_head=(np.zeros(2, np.uint32) if reanchor_head is None
                       else u32.host_copy(reanchor_head)),
        # XOR decomposition: the full-table digest without a second pass.
        state_digest=np.bitwise_xor.reduce(shard_digests, axis=0),
        n_buckets=nb, slots=shards[0].slots,
        value_width=shards[0].value_width, n_shards=int(n_shards),
        shard_digests=shard_digests, tree_head=tree,
        overflow_bits=int(overflow_bits))
    return Snapshot(manifest=manifest, shards=parts)


def to_state(snap: Snapshot, device=None) -> ws.HashState:
    """The merged table on ``device`` (default: the card): the shard parts
    concatenated in order ARE the high-bit partition."""
    dev = resolve_device(device)
    merged = lambda name: (getattr(snap.shards[0], name)
                           if len(snap.shards) == 1 else np.concatenate(
                               [getattr(p, name) for p in snap.shards]))
    return ws.HashState(*(u32.from_numpy(merged(name), dev)
                          for name in ("keys", "versions", "values")))


def verify_shard(manifest: Manifest, part: ShardPart, device=None) -> bool:
    """Recompute one shard's digest on ``device`` (default: the card)
    against the manifest."""
    dev = resolve_device(device)
    got = _shard_digest(*(u32.from_numpy(a, dev) for a in (
        part.keys, part.versions, part.values)))
    return bool(np.array_equal(u32.to_numpy(got),
                               manifest.shard_digests[part.shard]))


def verify(snap: Snapshot, device=None) -> bool:
    """Every shard digest (recomputed on ``device``, default: the card),
    the tree head, and the XOR decomposition down to the full-table
    digest."""
    dev = resolve_device(device)
    man = snap.manifest
    if len(snap.shards) != man.n_shards:
        return False
    if not all(verify_shard(man, p, dev) for p in snap.shards):
        return False
    tree = ws.shard_digest_tree(u32.from_numpy(man.shard_digests, dev))
    if not np.array_equal(u32.to_numpy(tree), man.tree_head):
        return False
    full = np.bitwise_xor.reduce(man.shard_digests, axis=0)
    return bool(np.array_equal(full, man.state_digest))


# -- persistence: shard files first, manifest last (atomic unit) ------------


def path_for(directory: str, block_no: int) -> str:
    return os.path.join(directory, f"manifest_{block_no:08d}.npz")


def shard_path_for(directory: str, block_no: int, shard: int) -> str:
    return os.path.join(directory, f"shard_{block_no:08d}_{shard:04d}.npz")


def _atomic_savez(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save(directory: str, snap: Snapshot, *, registry=None) -> str:
    """Persist every shard part (tmp + rename each), THEN the manifest:
    until the manifest lands the snapshot does not exist to readers."""
    reg = registry if registry is not None else NULL_REGISTRY
    t0 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    man = snap.manifest
    nbytes = 0
    for part in snap.shards:
        nbytes += part.keys.nbytes + part.versions.nbytes + part.values.nbytes
        _atomic_savez(
            shard_path_for(directory, man.block_no, part.shard),
            shard=np.uint32(part.shard), block_no=np.int64(man.block_no),
            keys=part.keys, versions=part.versions, values=part.values)
    final = path_for(directory, man.block_no)
    _atomic_savez(
        final,
        block_no=np.int64(man.block_no),
        journal_head=man.journal_head,
        ledger_head=man.ledger_head,
        reanchor_head=man.reanchor_head,
        state_digest=man.state_digest,
        n_buckets=np.uint32(man.n_buckets),
        slots=np.uint32(man.slots),
        value_width=np.uint32(man.value_width),
        n_shards=np.uint32(man.n_shards),
        shard_digests=man.shard_digests,
        tree_head=man.tree_head,
        overflow_bits=np.uint64(man.overflow_bits))
    reg.counter("snapshot.saves").inc()
    reg.counter("snapshot.bytes").inc(nbytes)
    reg.histogram("snapshot.save.latency").record(time.perf_counter() - t0)
    return final


def load_manifest(path: str) -> Manifest:
    with np.load(path) as z:
        return Manifest(
            block_no=int(z["block_no"]),
            journal_head=z["journal_head"],
            ledger_head=z["ledger_head"],
            reanchor_head=z["reanchor_head"],
            state_digest=z["state_digest"],
            n_buckets=int(z["n_buckets"]),
            slots=int(z["slots"]),
            value_width=int(z["value_width"]),
            n_shards=int(z["n_shards"]),
            shard_digests=z["shard_digests"],
            tree_head=z["tree_head"],
            overflow_bits=int(z["overflow_bits"]))


def load_shard(directory: str, block_no: int, shard: int) -> ShardPart:
    """One shard's arrays."""
    with np.load(shard_path_for(directory, block_no, shard)) as z:
        return ShardPart(shard=int(z["shard"]), keys=z["keys"],
                         versions=z["versions"], values=z["values"])


def load(directory: str, block_no: int | None = None, *,
         registry=None) -> Snapshot:
    """Manifest + every shard part; with no ``block_no``, the newest
    complete snapshot."""
    reg = registry if registry is not None else NULL_REGISTRY
    t0 = time.perf_counter()
    if block_no is None:
        blocks = list_blocks(directory)
        if not blocks:
            raise FileNotFoundError(f"no complete snapshot in {directory}")
        block_no = blocks[-1]
    man = load_manifest(path_for(directory, block_no))
    parts = tuple(load_shard(directory, block_no, m)
                  for m in range(man.n_shards))
    reg.counter("snapshot.loads").inc()
    reg.histogram("snapshot.load.latency").record(time.perf_counter() - t0)
    return Snapshot(manifest=man, shards=parts)


def _complete(directory: str, block_no: int) -> bool:
    """Complete iff the manifest loads and every shard file it names
    exists: the rule that makes torn saves invisible."""
    try:
        man = load_manifest(path_for(directory, block_no))
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return False
    return all(os.path.exists(shard_path_for(directory, block_no, m))
               for m in range(man.n_shards))


def list_blocks(directory: str) -> list[int]:
    """Block numbers of COMPLETE snapshots, ascending; foreign files, torn
    manifests and missing shard parts are ignored."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _MANIFEST_RE.match(name)
        if m and _complete(directory, int(m.group(1))):
            out.append(int(m.group(1)))
    return sorted(out)


def latest(directory: str) -> Snapshot | None:
    blocks = list_blocks(directory)
    return load(directory, blocks[-1]) if blocks else None


def latest_manifest(directory: str) -> Manifest | None:
    blocks = list_blocks(directory)
    return load_manifest(path_for(directory, blocks[-1])) if blocks else None


def gc(directory: str, *, keep: int = 2, registry=None) -> None:
    """Drop all but the newest ``keep`` complete snapshots, manifest first,
    then its shards. Shards orphaned by an earlier torn gc go too; foreign
    files, and the parts of a save in flight (a block past the newest
    manifest), stay."""
    if not os.path.isdir(directory):
        return
    reg = registry if registry is not None else NULL_REGISTRY
    t0 = time.perf_counter()
    blocks = list_blocks(directory)
    keep_set = set(blocks[-keep:]) if keep else set()
    newest = blocks[-1] if blocks else -1
    dropped = 0
    for name in sorted(os.listdir(directory)):
        m = _MANIFEST_RE.match(name)
        if m and int(m.group(1)) not in keep_set:
            _rm(os.path.join(directory, name))
            dropped += 1
    for name in sorted(os.listdir(directory)):
        m = _SHARD_RE.match(name)
        if m and int(m.group(1)) not in keep_set and int(m.group(1)) <= newest:
            _rm(os.path.join(directory, name))
    if dropped:
        reg.counter("snapshot.gc.dropped").inc(dropped)
        reg.histogram("snapshot.gc.latency").record(time.perf_counter() - t0)


def _rm(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
