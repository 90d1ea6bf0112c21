"""Shared inputs and runners of the block-pipeline tests of the port
(tests/test_torch_pipeline*.py): windows of endorsed blocks made by the JAX
endorser from seeds, the JAX fabric step on a (1, 1) mesh (compiled once
per configuration and shape), the port's step on the CPU, and the
field-by-field comparison through u32 views."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import endorser, engine, types, unmarshal
from repro.launch import fabric_step as jfs
from repro_torch.core import types as ttypes, u32
from repro_torch.launch import fabric_step as tfs

DIMS = types.TEST_DIMS
TDIMS = ttypes.TEST_DIMS
MESH = jax.make_mesh((1, 1), ("data", "model"))


def window(depth, n=16, seed=0, *, read_your_write=False,
           endorser_buckets=1 << 12, endorser_slots=8):
    """(D, B, WB) u8 wire and (D, B, 2) u32 ids of D endorsed blocks, as
    tests/test_pipeline.py makes them. ``read_your_write``: every block
    moves the same accounts, so block k reads the versions block k-1
    wrote. A tiny endorser table (with an equally tiny peer table) makes
    inserts drop mid-window."""
    eng = engine.FabricEngine(engine.EngineConfig(
        dims=DIMS, store_blocks=False, n_buckets=endorser_buckets,
        slots=endorser_slots))
    wires, idss = [], []
    for k in range(depth):
        props = eng.make_proposals(
            n, seed=seed if read_your_write else seed + 11 * k)
        if read_your_write:
            props = props._replace(nonce=props.nonce + jnp.uint32(k * 100003))
        txb = endorser.execute_and_endorse(eng.endorser_state, props, DIMS)
        wires.append(unmarshal.marshal(txb, DIMS))
        idss.append(txb.tx_id)
        if read_your_write:
            eng.endorser_state = endorser.apply_validated(
                eng.endorser_state, txb, jnp.ones(n, bool))
    return np.asarray(jnp.stack(wires)), np.asarray(jnp.stack(idss))


def port_cfg(cfg):
    """The port's FabricStepConfig with the fields of a JAX one."""
    return tfs.FabricStepConfig(**dataclasses.asdict(cfg))


@functools.cache
def _jax_step(cfg, depth, nb, slots, b, wb):
    """The JAX step compiled once for its shapes: the state a step returns
    is committed to the mesh, so a plain jit would compile again for it."""
    step = jax.jit(jfs.make_fabric_step(
        DIMS, dataclasses.replace(cfg, pipeline_depth=depth), MESH))
    shape = (1, b) if depth == 1 else (1, depth, b)
    return step.lower(
        jfs.create_mesh_state(1, DIMS, n_buckets=nb, slots=slots),
        jnp.zeros((*shape, wb), jnp.uint8),
        jnp.zeros((*shape, 2), jnp.uint32)).compile()


def jax_run(cfg, wire, ids, depth, nb=256, slots=8, *, state=None):
    """The JAX step over ``wire``: depth 1 one block at a time (returns the
    state after each block), else one window. -> (states, valid (D, B))."""
    step = _jax_step(cfg, depth, nb, slots, wire.shape[1], wire.shape[2])
    st = state or jfs.create_mesh_state(1, DIMS, n_buckets=nb, slots=slots)
    if depth > 1:
        st, v = step(st, jnp.asarray(wire[None]), jnp.asarray(ids[None]))
        return [numpy_state(st)], np.asarray(v)[0]
    states, valids = [], []
    for k in range(wire.shape[0]):
        st, v = step(st, jnp.asarray(wire[k][None]), jnp.asarray(ids[k][None]))
        states.append(numpy_state(st))
        valids.append(np.asarray(v)[0])
    return states, np.stack(valids)


def port_run(cfg, wire, ids, depth, nb=256, slots=8, *, state=None):
    """The port's step on the CPU, as :func:`jax_run`."""
    step = tfs.make_fabric_step(
        TDIMS, dataclasses.replace(port_cfg(cfg), pipeline_depth=depth))
    st = state or tfs.create_mesh_state(1, TDIMS, nb, slots, device="cpu")
    w, i = torch.from_numpy(wire.copy()), u32.from_numpy(ids)
    if depth > 1:
        st, v = step(st, w[None], i[None])
        return [numpy_state(st)], v[0].numpy()
    states, valids = [], []
    for k in range(wire.shape[0]):
        st, v = step(st, w[k][None], i[k][None])
        states.append(numpy_state(st))
        valids.append(v[0].numpy())
    return states, np.stack(valids)


def numpy_state(st) -> tuple:
    """A state of either package as u32 numpy arrays (a copy: the port's
    table is committed in place)."""
    return tuple(u32.host_copy(a) if isinstance(a, torch.Tensor)
                 else np.asarray(a) for a in st)


def assert_same(a, b, what=""):
    """Two (states, valid) results equal field by field."""
    (sa, va), (sb, vb) = a, b
    np.testing.assert_array_equal(va, vb, err_msg=f"{what} valid")
    assert len(sa) == len(sb)
    for xa, xb in zip(sa, sb):
        for name, x, y in zip(tfs.FabricMeshState._fields, xa, xb):
            assert x.dtype == y.dtype == np.uint32, (name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")
