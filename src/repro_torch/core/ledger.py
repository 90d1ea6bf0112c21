"""Hash-chained ledger + the decoupled block store, Opt P-II storage role
(port of repro.core.ledger, channel 0).

``append_hash`` is the on-path part: the committer computes each block's
chain hash. ``BlockStore`` is the off-path storage role: a writer thread
receives validated blocks, copies them to the host and keeps the chain, from
which ``verify_chain`` re-authenticates every block and ``replay_state``
rebuilds the world state.
"""

from __future__ import annotations

import queue
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hashing, types, u32, unmarshal, world_state


def block_body_digest(wire: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """Content digest of a block body: per-tx digests + validity flags,
    folded order-dependently. (2,) u32."""
    words = unmarshal.wire_words(wire)
    d1 = hashing.hash_words(words, seed=hashing.SEED_A)  # (N,)
    d2 = hashing.hash_words(words, seed=hashing.SEED_B)
    v = valid.to(u32.WORD)
    return torch.stack([
        hashing.hash_words((d1 ^ v)[None, :], seed=hashing.SEED_A)[0],
        hashing.hash_words((d2 ^ (v << 1))[None, :], seed=hashing.SEED_B)[0],
    ])


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


class BlockStore:
    """The storage role: async, append-only, off the critical path.

    A writer thread drains a queue of device blocks, copies them to the host
    and appends them to the chain. The copy runs on the writer thread's
    current stream, the default stream, behind the commit that produced the
    block; a caller on another stream must record an event first. Submitted
    tensors must not be written afterwards: the committer hands over fresh
    head, hash and validity tensors, and the round's wire is never written.
    Once an append fails, everything behind it is dropped and the error is
    raised by the next ``drain``/``close``.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self.chain: list[StoredBlock] = []
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def submit(self, block_no: int, prev_hash, block_hash, wire, valid
               ) -> None:
        self._q.put((block_no, prev_hash, block_hash, wire, valid))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._err is not None:
                    continue  # fail-stop: no gap behind a failed append
                bno, prev, bh, wire, valid = item
                self.chain.append(StoredBlock(
                    int(bno), u32.to_numpy(prev), u32.to_numpy(bh),
                    wire.cpu().numpy(), valid.cpu().numpy()))
            except Exception as e:  # raised by drain()/close()
                self._err = e
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

    def verify_chain(self) -> bool:
        """Re-derive every block hash from its body on the host."""
        prev = np.zeros(2, np.uint32)
        for sb in self.chain:
            if not np.array_equal(sb.prev_hash, prev):
                return False
            digest = block_body_digest(torch.from_numpy(sb.wire),
                                       torch.from_numpy(sb.valid))
            expect = append_hash(u32.from_numpy(prev), sb.block_no, digest)
            if not np.array_equal(u32.to_numpy(expect), sb.block_hash):
                return False
            prev = sb.block_hash
        return True

    def replay_state(self, dims: types.FabricDims, n_buckets: int,
                     slots: int, device=None) -> world_state.HashState:
        """Rebuild the world state on ``device`` (default: the card) from
        the chain (crash recovery for P-I)."""
        device = resolve_device(device)
        st = world_state.create(n_buckets, slots, dims.vw, device=device)
        for sb in self.chain:
            dec = unmarshal.unmarshal(torch.from_numpy(sb.wire).to(device),
                                      dims)
            st = world_state.commit_vectorized(
                st, dec.txb.write_keys, dec.txb.write_vals,
                torch.from_numpy(sb.valid).to(device)).state
        return st
