"""Carry engine state and model weights across packages as numpy arrays.

The JAX package's state, as numpy (u32 arrays, Python ints, stored blocks),
goes into a port :class:`~repro_torch.core.engine.FabricEngine` on its
device, and back out; the JAX ``LM.init`` weights go into a port
:class:`~repro_torch.models.lm.LM`. Nothing here imports JAX: the caller
turns JAX arrays into numpy (``np.asarray``) first. The tests use this to
start both packages from one state and one set of weights.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import committer, engine, ledger, u32
from repro_torch.core import world_state as ws
from repro_torch.models.lm import LM


class EngineState(NamedTuple):
    """One channel's engine state, all numpy / Python values."""

    peer: tuple  # (keys (NB,S,2), versions (NB,S), values (NB,S,VW)) u32
    endorser: tuple  # the endorser replica, same layout
    ledger_head: np.ndarray  # (2,) u32
    block_no: int  # the peer's next block number
    journal_head: np.ndarray  # (2,) u32
    log_head: np.ndarray  # (2,) u32 consensus log head
    next_block_no: int  # the engine's next block number
    overflow: bool  # sticky bucket overflow
    chain: tuple = ()  # stored blocks: (block_no, prev, hash, wire, valid)
    # The sorted store of a peer without P-I: (key_hi (N,), key_lo (N,),
    # versions (N,), values (N,VW), count int, wal_head (2,)); else None.
    sorted: tuple | None = None


def hash_state(keys, versions, values, device) -> ws.HashState:
    return ws.HashState(*(u32.from_numpy(np.asarray(a, np.uint32), device)
                          for a in (keys, versions, values)))


def sorted_state(key_hi, key_lo, versions, values, count, wal_head, device
                 ) -> ws.SortedState:
    word = lambda a: u32.from_numpy(np.asarray(a, np.uint32), device)
    return ws.SortedState(
        word(key_hi), word(key_lo), word(versions), word(values),
        torch.tensor(int(count), dtype=torch.int32, device=device),
        word(wal_head))


def load_engine(eng: engine.FabricEngine, st: EngineState) -> None:
    """Replace ``eng``'s state with ``st``, on ``eng.device``. An engine
    whose peer has no hash table (P-I off) needs ``st.sorted``; other
    engines ignore it."""
    dev = eng.device
    word = lambda a: u32.from_numpy(np.asarray(a, np.uint32), dev)
    sstate = None
    if not eng.cfg.peer.hash_state:
        if st.sorted is None:
            raise ValueError("the engine's peer keeps the sorted store; "
                             "EngineState.sorted is None")
        sstate = sorted_state(*st.sorted, dev)
    eng.peer_state = committer.PeerState(
        hash_state=hash_state(*st.peer, dev),
        sorted_state=sstate,
        ledger_head=word(st.ledger_head),
        block_no=word(np.uint32(st.block_no)).reshape(()),
        journal_head=word(st.journal_head),
    )
    eng.endorser_state = hash_state(*st.endorser, dev)
    eng.log_head = word(st.log_head)
    eng.next_block_no = int(st.next_block_no)
    eng.overflow = torch.tensor(bool(st.overflow), device=dev)
    if eng.store is not None:
        eng.store.drain()
        eng.store.chain[:] = [
            ledger.StoredBlock(int(bno), np.asarray(prev, np.uint32),
                               np.asarray(bh, np.uint32), np.asarray(wire),
                               np.asarray(valid))
            for bno, prev, bh, wire, valid in st.chain]


def export_engine(eng: engine.FabricEngine) -> EngineState:
    """``eng``'s state as numpy."""
    ps = eng.peer_state
    arrays = lambda h: tuple(u32.to_numpy(t) for t in h)
    srt = ps.sorted_state
    if srt is not None:
        srt = (*arrays(srt[:4]), int(srt.count), u32.to_numpy(srt.wal_head))
    chain = ()
    if eng.store is not None:
        eng.store.drain()
        chain = tuple(tuple(sb) for sb in eng.store.chain)
    return EngineState(
        peer=arrays(ps.hash_state),
        endorser=arrays(eng.endorser_state),
        ledger_head=u32.to_numpy(ps.ledger_head),
        block_no=int(u32.to_numpy(ps.block_no)),
        journal_head=u32.to_numpy(ps.journal_head),
        log_head=u32.to_numpy(eng.log_head),
        next_block_no=eng.next_block_no,
        overflow=eng.overflowed(),
        chain=chain,
        sorted=srt,
    )


def lm_params(np_params: dict, cfg: ModelConfig, device, **lm_kwargs) -> LM:
    """The JAX ``LM.init`` pytree as numpy (``layers`` stacked on a leading
    layer axis) -> a port :class:`LM` on ``device`` with those weights, in
    ``cfg.torch_dtype``. ``lm_kwargs`` go to :class:`LM`."""
    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            device=device, dtype=cfg.torch_dtype)

    def tree(d, index=None):
        return {k: tree(v, index) if isinstance(v, dict)
                else tensor(v if index is None else v[index])
                for k, v in d.items()}

    top = {k: v for k, v in np_params.items() if k != "layers"}
    per_layer = [tree(np_params["layers"], i) for i in range(cfg.n_layers)]
    return LM(cfg, device=device, **lm_kwargs).load_params(
        {**tree(top), "layers": per_layer})
