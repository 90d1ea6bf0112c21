"""Hash-chained ledger + the decoupled block store, Opt P-II storage role
(port of repro.core.ledger).

``append_hash`` is the on-path part: the committer computes each block's
chain hash. ``BlockStore`` is the off-path storage role: a writer thread
receives validated blocks, copies them to the host, spills them, feeds the
state journal and keeps the chain, from which ``verify_chain``
re-authenticates every block and ``replay_state`` rebuilds the world
state. ``prune_upto`` compacts the chain up to a snapshot; the chain then
re-anchors at the last pruned block's hash (``base_hash``). One store
multiplexes every channel of an engine: each channel has its own chain,
pruning base, journal and spill directory (:func:`channel_dir`).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hashing, types, u32, unmarshal, world_state


def channel_dir(base: str, channel: int) -> str:
    """Where channel ``channel``'s files live under ``base``: channel 0 IS
    ``base``; other channels nest one level down."""
    if channel == 0:
        return base
    return os.path.join(base, f"channel_{channel:04d}")


def load_spilled_blocks(spill_dir: str, start_block: int,
                        channel: int = 0) -> list["StoredBlock"]:
    """A channel's spilled blocks from ``start_block`` upward, until the
    first gap (the restore path rebuilds a snapshot's trailing suffix from
    them)."""
    d = channel_dir(spill_dir, channel)
    out: list[StoredBlock] = []
    bno = start_block
    while True:
        path = os.path.join(d, f"block_{bno:08d}.npz")
        if not os.path.exists(path):
            return out
        with np.load(path) as z:
            out.append(StoredBlock(block_no=bno, prev_hash=z["prev_hash"],
                                   block_hash=z["block_hash"], wire=z["wire"],
                                   valid=z["valid"]))
        bno += 1


def block_body_digest(wire: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """Content digest of a block body: per-tx digests + validity flags,
    folded order-dependently. (N, WB) / (N,) -> (2,) u32; leading dims
    batch blocks, (D, N, WB) / (D, N) -> (D, 2)."""
    words = unmarshal.wire_words(wire)
    d1 = hashing.hash_words(words, seed=hashing.SEED_A)  # (..., N)
    d2 = hashing.hash_words(words, seed=hashing.SEED_B)
    v = valid.to(u32.WORD)
    return torch.stack([hashing.hash_words(d1 ^ v, seed=hashing.SEED_A),
                        hashing.hash_words(d2 ^ (v << 1),
                                           seed=hashing.SEED_B)], dim=-1)


def _word(x, device) -> torch.Tensor:
    """A block number (int or 0-d tensor) as a (1,) u32 word."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(u32.WORD)
    return torch.tensor([u32.s32(x)], dtype=u32.WORD, device=device)


def append_hash(prev_hash: torch.Tensor, block_no, body_digest: torch.Tensor
                ) -> torch.Tensor:
    """Chain: H(prev || block_no || body). (2,) u32."""
    words = torch.cat([prev_hash, _word(block_no, prev_hash.device),
                       body_digest])[None, :]
    return torch.stack([hashing.hash_words(words, seed=hashing.SEED_A)[0],
                        hashing.hash_words(words, seed=hashing.SEED_B)[0]])


class StoredBlock(NamedTuple):
    block_no: int
    prev_hash: np.ndarray  # (2,) u32
    block_hash: np.ndarray  # (2,) u32
    wire: np.ndarray  # (B, 4P) u8
    valid: np.ndarray  # (B,) bool


def chained_hash(prev: np.ndarray, sb: "StoredBlock") -> np.ndarray:
    """The hash a stored block must carry after ``prev`` (host u32 arrays),
    re-derived from its body with the plain functions on the CPU."""
    digest = block_body_digest(_tensor(sb.wire), _tensor(sb.valid))
    return u32.to_numpy(append_hash(u32.from_numpy(prev), sb.block_no,
                                    digest))


class BlockStore:
    """The storage role: async, append-only, off the critical path.

    A writer thread drains a queue of device blocks and, for each, copies
    it to the host, spills it to its channel's ``channel_dir(spill_dir,
    c)`` as ``block_%08d.npz`` (the JAX package's format), hands it to the
    channel's state journal, and appends it to the channel's chain last: a
    block is in a chain only if every sink accepted it. The copy runs on
    the writer thread's current stream, the default stream, behind the
    commit that produced the block; a caller on another stream must record
    an event first. Submitted tensors must not be written afterwards: the
    committer hands over fresh head, hash and validity tensors, and the
    round's wire is never written. The journal decodes and hashes from the
    host copy, on the CPU, so the writer launches nothing on the card.

    One writer thread and one queue serve every channel: ``submit`` is
    channel-tagged, and chains, pruning bases and journals are kept per
    channel, so a corrupt record in channel i fails only channel i's
    checks. The channel-0 surface (``.chain``, ``.base_block_no``,
    ``.base_hash``, the methods without ``channel``) is the single-channel
    store's.

    Once an append fails, its spill file is removed and everything behind
    it is dropped (fail-stop); the next ``drain``/``close`` raises the
    error once, or ``resume`` clears it and says where to resubmit from.
    """

    def __init__(self, spill_dir: str | None = None, *, journal=None):
        self._q: queue.Queue = queue.Queue()
        self.chains: dict[int, list[StoredBlock]] = {0: []}
        self.base_block_nos: dict[int, int] = {0: -1}
        self.base_hashes: dict[int, np.ndarray] = {0: np.zeros(2, np.uint32)}
        self._spill_dir = spill_dir
        self._journals: dict[int, object] = {}
        if journal is not None:
            self._journals[0] = journal
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    # -- channels --------------------------------------------------------------

    def _chan(self, channel: int) -> list[StoredBlock]:
        if channel not in self.chains:
            self.chains[channel] = []
            self.base_block_nos[channel] = -1
            self.base_hashes[channel] = np.zeros(2, np.uint32)
        return self.chains[channel]

    def set_journal(self, channel: int, journal) -> None:
        """Attach channel ``channel``'s state journal to the writer (drain
        first)."""
        self._journals[channel] = journal

    @property
    def chain(self) -> list[StoredBlock]:
        """Channel 0's chain (the live list)."""
        return self._chan(0)

    @chain.setter
    def chain(self, value: list[StoredBlock]) -> None:
        self.chains[0] = value

    @property
    def base_block_no(self) -> int:
        return self.base_block_nos[0]

    @base_block_no.setter
    def base_block_no(self, value: int) -> None:
        self.base_block_nos[0] = value

    @property
    def base_hash(self) -> np.ndarray:
        return self.base_hashes[0]

    @base_hash.setter
    def base_hash(self, value: np.ndarray) -> None:
        self.base_hashes[0] = value

    def _spill_path(self, channel: int, bno: int) -> str:
        """A block's spill file; channel subdirectories are made on demand,
        the base directory must exist (the writer fail-stops otherwise)."""
        d = channel_dir(self._spill_dir, channel)
        if channel != 0:
            os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"block_{bno:08d}.npz")

    # -- the writer -------------------------------------------------------------

    def submit(self, block_no: int, prev_hash, block_hash, wire, valid,
               channel: int = 0) -> None:
        self._chan(channel)  # registered here, so the writer only appends
        self._q.put((block_no, prev_hash, block_hash, wire, valid, channel))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            spill_path = None
            try:
                if item is None:
                    return
                if self._err is not None:
                    continue  # fail-stop: no gap behind a failed append
                bno, prev, bh, wire, valid, channel = item
                sb = StoredBlock(int(bno), u32.host_copy(prev),
                                 u32.host_copy(bh), _host(wire), _host(valid))
                if self._spill_dir is not None:
                    spill_path = self._spill_path(channel, sb.block_no)
                    np.savez(spill_path, prev_hash=sb.prev_hash,
                             block_hash=sb.block_hash, wire=sb.wire,
                             valid=sb.valid)
                jrnl = self._journals.get(channel)
                if jrnl is not None:
                    jrnl.append_block(sb.block_no, sb.wire, sb.valid)
                self.chains[channel].append(sb)
            except Exception as e:  # raised by drain()/close()
                self._err = e
                # Un-spill: no reader of the spill directory may see a
                # block the chain and journal fail-stopped before.
                if spill_path is not None:
                    try:
                        os.remove(spill_path)
                    except OSError:
                        pass
            finally:
                self._q.task_done()

    def _surface_err(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        self._surface_err()

    def drain(self) -> None:
        """Block until everything submitted so far is stored."""
        self._q.join()
        self._surface_err()

    def resume(self, channel: int = 0) -> int:
        """Supervised restart after a writer failure: wait for the writer
        to discard the dropped suffix, clear the latched error (without
        raising it) and return the next block number ``channel``'s chain
        expects, from which the caller resubmits."""
        self._q.join()
        self._err = None
        ch = self._chan(channel)
        return (ch[-1].block_no if ch else self.base_block_nos[channel]) + 1

    def prune_upto(self, block_no: int, channel: int = 0) -> int:
        """Drop ``channel``'s blocks <= ``block_no`` (covered by a
        snapshot) from memory and from the spill directory; returns the
        number dropped. Call with the writer drained."""
        ch = self._chan(channel)
        dropped = [sb for sb in ch if sb.block_no <= block_no]
        if dropped:
            self.chains[channel] = [sb for sb in ch if sb.block_no > block_no]
            self.base_block_nos[channel] = dropped[-1].block_no
            self.base_hashes[channel] = dropped[-1].block_hash
            if self._spill_dir is not None:
                for sb in dropped:
                    path = self._spill_path(channel, sb.block_no)
                    if os.path.exists(path):
                        os.remove(path)
        return len(dropped)

    def verify_chain(self, channel: int = 0) -> bool:
        """Re-derive every block hash of ``channel``'s chain from its body
        on the host, from the pruning base."""
        prev = self.base_hashes.get(channel, np.zeros(2, np.uint32))
        for sb in self.chains.get(channel, ()):
            if not np.array_equal(sb.prev_hash, prev):
                return False
            if not np.array_equal(chained_hash(prev, sb), sb.block_hash):
                return False
            prev = sb.block_hash
        return True

    def replay_state(self, dims: types.FabricDims, n_buckets: int,
                     slots: int, start_state: world_state.HashState | None
                     = None, resize_at: dict | None = None, device=None,
                     channel: int = 0) -> world_state.HashState:
        """Rebuild ``channel``'s world state on ``device`` (default: the
        card) from its chain (crash recovery for P-I).

        ``start_state``: the covering snapshot's state when the prefix was
        pruned (updated in place). ``resize_at`` maps a boundary block to
        the bucket count(s), an int or a list applied in order, the table
        resized to right after that block.
        """
        device = resolve_device(device)
        st = (world_state.create(n_buckets, slots, dims.vw, device=device)
              if start_state is None else start_state)
        resize_at = {b: list(nb) if isinstance(nb, (list, tuple)) else [nb]
                     for b, nb in (resize_at or {}).items()}

        def cross(st, boundary):
            for nb in resize_at.pop(boundary, ()):
                st = world_state.resize(st, nb).state
            return st

        for sb in self.chains.get(channel, ()):
            st = cross(st, sb.block_no - 1)
            wk, wv = unmarshal.write_sets(_tensor(sb.wire, device), dims)
            st = world_state.commit_vectorized(
                st, wk, wv, _tensor(sb.valid, device)).state
            st = cross(st, sb.block_no)
        for boundary in sorted(resize_at):
            st = cross(st, boundary)
        return st


def _tensor(a, device=None) -> torch.Tensor:
    """A host array as a tensor of its own on ``device``."""
    return torch.from_numpy(np.array(a)).to(device)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
