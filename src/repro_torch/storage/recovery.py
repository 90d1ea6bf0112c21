"""Cold-start recovery: latest snapshot + journal suffix, fully verified
(port of ``recover`` and ``full_replay`` of repro.storage.recovery).

Load the newest snapshot and verify its shard digests and tree head,
verify the journal's digest chains from the snapshot's heads forward
(block records and resize re-anchor records), then replay only that
suffix, crossing resize boundaries and proving each rebuilt table against
its re-anchor's digest-tree head. The recovered peer matches the crashed
one when its ``state_digest`` and journal head equal the live values
(``FabricEngine.verify``'s ``recovery_ok``); the sticky overflow bitmask
persisted in the manifest and the re-anchor records is re-latched.
Everything on the state runs on the device recovery targets.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

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
