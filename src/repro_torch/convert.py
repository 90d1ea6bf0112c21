"""Carry engine state and model weights across packages as numpy arrays.

The JAX package's state, as numpy (u32 arrays, Python ints, stored blocks),
goes into a port :class:`~repro_torch.core.engine.FabricEngine` on its
device, and back out; the JAX ``LM.init`` weights go into a port
:class:`~repro_torch.models.lm.LM`, and a JAX ``TrainState`` into the
port's and back (leaves in the JAX flatten order of
``training.train_step.state_leaves``). Nothing here imports JAX: the caller
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
from repro_torch.launch import sharding
from repro_torch.models.lm import F32_LEAVES, LM, MeshLM


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
    layer axis, and encdec's ``enc_layers`` on an encoder-layer axis) -> a
    port :class:`LM` on ``device`` with those weights, each stack split
    into a list of per-layer dicts (hybrid's ``shared_attn`` is one
    unstacked dict and stays one). A
    leaf's dtype comes from its role, not from the array given: the leaves
    of ``lm.F32_LEAVES`` (the MoE router, the SSM's ``dt_bias``, ``A_log``
    and ``D``) are f32, every other leaf ``cfg.torch_dtype``. So an f32
    numpy tree (``export_train_state`` writes one) loads as the model the
    config describes. ``lm_kwargs`` go to :class:`LM`."""
    def tensor(name, a):
        dt = torch.float32 if name in F32_LEAVES else cfg.torch_dtype
        return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                            dtype=dt)

    def tree(d, index=None):
        return {k: tree(v, index) if isinstance(v, dict)
                else tensor(k, v if index is None else v[index])
                for k, v in d.items()}

    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers}
    top = {k: v for k, v in np_params.items() if k not in stacks}
    per_layer = {k: [tree(np_params[k], i) for i in range(n)]
                 for k, n in stacks.items() if k in np_params}
    return LM(cfg, device=device, **lm_kwargs).load_params(
        {**tree(top), **per_layer})


def mesh_lm_params(np_params: dict, cfg: ModelConfig, mesh,
                   **lm_kwargs) -> MeshLM:
    """:func:`lm_params` onto a mesh: the JAX ``LM.init`` pytree as numpy ->
    a port :class:`MeshLM` over ``mesh`` holding those weights in the
    layout of ``launch.sharding``. Each position's block is cut from the
    numpy leaf on the host, converted there (dtype from the leaf's role,
    as in :func:`lm_params`) and copied to its device: no card ever holds
    more of a leaf than its block. ``lm_kwargs`` go to the MeshLM."""
    model = MeshLM(cfg, mesh, **lm_kwargs)
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers}

    def layer(d, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in d.items()}

    tree = {k: [layer(v, i) for i in range(stacks[k])] if k in stacks
            else v for k, v in np_params.items()}

    def put(block, path, dev):
        dt = torch.float32 if path[-1] in F32_LEAVES else cfg.torch_dtype
        return torch.from_numpy(np.array(block, np.float32)).to(dev, dt)

    model.params = sharding.place(tree, model.specs, mesh, put=put)
    return model


def _np_leaves(tree: dict) -> list:
    """A JAX params tree's leaves (numpy, ``layers`` stacked) in the JAX
    flatten order: dict keys sorted at every level."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        out += _np_leaves(val) if isinstance(val, dict) else [val]
    return out


def _np_tree(groups: list, like: dict) -> dict:
    """Numpy leaves (in the JAX order of ``like``, a JAX-layout tree) as a
    tree of ``like``'s structure."""
    it = iter(groups)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}

    return build(like)


def _as_numpy(group: list) -> np.ndarray:
    """One JAX leaf from the port's tensors (stacked when several), f32 for
    floating leaves (numpy has no bf16)."""
    t = group[0] if len(group) == 1 else torch.stack(group)
    t = t.detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def train_state(np_state, cfg: ModelConfig, device, **lm_kwargs):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``: ``params`` and ``opt.m``/``opt.v`` with stacked layers,
    ``opt.step``, ``ledger_head`` u32) -> (port ``LM`` holding its params,
    port ``TrainState``) on ``device``; ``lm_kwargs`` go to the LM."""
    from repro_torch.training import train_step as ts_lib

    model = lm_params(np_state.params, cfg, device, **lm_kwargs)
    state = ts_lib.init_state(model)
    src = ([np.asarray(np_state.opt.step)] + _np_leaves(np_state.opt.m)
           + _np_leaves(np_state.opt.v))
    dst = ts_lib.state_leaves(state)
    n = len(_np_leaves(np_state.params))
    with torch.no_grad():
        for arr, group in zip(src, dst[n:-1]):
            arr = np.asarray(arr)
            parts = [arr] if len(group) == 1 else list(arr)
            for t, a in zip(group, parts):
                t.copy_(torch.from_numpy(np.array(
                    a, np.float32 if t.is_floating_point() else None))
                    .reshape(t.shape))
    head = u32.from_numpy(np.asarray(np_state.ledger_head, np.uint32),
                          device)
    return model, state._replace(ledger_head=head)


class TrainArrays(NamedTuple):
    """A port ``TrainState`` as numpy in the JAX layout (stacked layers),
    the fields of JAX ``TrainState(params, AdamWState(step, m, v),
    ledger_head)``."""

    params: dict
    step: np.ndarray  # () int32
    m: dict
    v: dict
    ledger_head: np.ndarray  # (2,) u32


def export_train_state(state, np_like: dict) -> TrainArrays:
    """The port ``TrainState`` as numpy, in the structure of ``np_like``
    (a JAX-layout params tree, e.g. the JAX state's ``params``)."""
    from repro_torch.training import train_step as ts_lib

    groups = [_as_numpy(g) for g in ts_lib.state_leaves(state)]
    n = len(_np_leaves(np_like))
    return TrainArrays(
        params=_np_tree(groups[:n], np_like),
        step=groups[n],
        m=_np_tree(groups[n + 1:2 * n + 1], np_like),
        v=_np_tree(groups[2 * n + 1:3 * n + 1], np_like),
        ledger_head=u32.to_numpy(state.ledger_head))
