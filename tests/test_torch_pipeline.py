"""The port's fabric step (launch/fabric_step, pipeline/schedule) against
the JAX step on a (1, 1) mesh, at depths 1, 2, 4 and 8: every state field
(table, heads, block number, overflow lanes) and the validity bits, bit for
bit, on disjoint, read-your-write and replayed windows under FASTFABRIC;
and the port at depth D against the port at depth 1 D times. Fabric 1.2,
the tree-hash folds and overflowing windows are in
tests/test_torch_pipeline_plan.py. The JAX results are computed once per
module (each configuration and shape compiles once)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.launch import fabric_step as jfs
from repro_torch.core import u32
from repro_torch.launch import fabric_step as tfs

from torch_pipeline_inputs import (TDIMS, assert_same, jax_run, port_cfg,
                                   port_run, window)

FF = jfs.FASTFABRIC_STEP
DEPTHS = (2, 4, 8)


@pytest.fixture(scope="module")
def ff():
    """An 8-block window of disjoint transfers (16 txs a block) through the
    JAX step at depth 1 (a state after each block) and at 2, 4 and 8."""
    wire, ids = window(8, n=16, seed=8)
    jax_res = {1: jax_run(FF, wire, ids, 1)}
    for d in DEPTHS:
        jax_res[d] = jax_run(FF, wire[:d], ids[:d], d)
    return wire, ids, jax_res


@pytest.mark.parametrize("depth", (1,) + DEPTHS)
def test_step_matches_jax(ff, depth):
    wire, ids, jax_res = ff
    n = wire.shape[0] if depth == 1 else depth
    res = port_run(FF, wire[:n], ids[:n], depth)
    assert_same(res, jax_res[depth], f"depth {depth}")
    assert res[1].all()  # disjoint accounts: every transaction valid
    assert not res[0][-1][-1].any()  # an ample table: no overflow


@pytest.mark.parametrize("depth", DEPTHS)
def test_depth_d_equals_depth_1_d_times(ff, depth):
    wire, ids, _ = ff
    states, valid = port_run(FF, wire[:depth], ids[:depth], 1)
    assert_same(port_run(FF, wire[:depth], ids[:depth], depth),
                ([states[-1]], valid), f"depth {depth}")


@pytest.mark.parametrize("depth", (2, 4))
def test_read_your_write_window(depth):
    """Block k reads what block k-1 wrote: every transaction is valid only
    if the fill versions are repaired with the window's earlier writes."""
    wire, ids = window(depth, n=16, seed=1, read_your_write=True)
    res = port_run(FF, wire, ids, depth)
    assert_same(res, jax_run(FF, wire, ids, depth), "read-your-write")
    assert res[1].all()
    states, valid = port_run(FF, wire, ids, 1)
    assert_same(res, ([states[-1]], valid), "against depth 1")


def test_replayed_window_is_invalid(ff):
    """The same window twice: every version is stale the second time."""
    wire, ids, _ = ff
    step = tfs.make_fabric_step(
        TDIMS, dataclasses.replace(tfs.FASTFABRIC_STEP, pipeline_depth=2))
    st = tfs.create_mesh_state(1, TDIMS, 256, 8, device="cpu")
    w, i = torch.from_numpy(wire[None, :2].copy()), u32.from_numpy(ids[None, :2])
    st, v1 = step(st, w, i)
    st, v2 = step(st, w, i)
    assert int(v1.sum()) == 32 and int(v2.sum()) == 0
    jst, jv = jax_run(FF, wire[:2], ids[:2], 2)
    _, jv2 = jax_run(FF, wire[:2], ids[:2], 2, state=jfs.FabricMeshState(
        *(np.asarray(a) for a in jst[0])))
    np.testing.assert_array_equal(v2[0].numpy(), jv2)


def test_wrong_window_shape_raises(ff):
    wire, ids, _ = ff
    step = tfs.make_fabric_step(
        TDIMS, dataclasses.replace(tfs.FASTFABRIC_STEP, pipeline_depth=4))
    st = tfs.create_mesh_state(1, TDIMS, 256, 8, device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth=4"):
        step(st, torch.from_numpy(wire[None, :2].copy()),
             u32.from_numpy(ids[None, :2]))


def test_sharded_state_and_channels_are_refused():
    """Sharded state runs (held against JAX in test_torch_sharded_step.py),
    but a shard count that is no partition of the table, or more shards
    than the overflow bitmask has bits, raises instead of running some
    other way. Several channels run (C = 2 is held against JAX in
    test_torch_multichannel_step.py), but a wire of another channel count
    than the state's is refused."""
    with pytest.raises(ValueError, match="<= 64 shards"):
        tfs.make_fabric_step(TDIMS, tfs.FASTFABRIC_PIPELINED_STEP,
                             n_shards=128)
    wire, ids = window(8, seed=1)
    for m, nb in ((3, 256), (16, 8)):
        sstep = tfs.make_fabric_step(TDIMS, tfs.FASTFABRIC_PIPELINED_STEP,
                                     n_shards=m)
        with pytest.raises(ValueError, match="n_shards"):
            sstep(tfs.create_mesh_state(1, TDIMS, nb, 8, device="cpu"),
                  torch.from_numpy(wire[None].copy()), u32.from_numpy(
                      ids[None]))
    assert tfs.create_mesh_state(2, TDIMS, 256, 8,
                                 device="cpu").keys.shape[0] == 2
    step = tfs.make_fabric_step(TDIMS, tfs.FASTFABRIC_STEP)
    st = tfs.create_mesh_state(1, TDIMS, 256, 8, device="cpu")
    wire = torch.zeros((2, 16, 4 * TDIMS.payload_words), dtype=torch.uint8)
    with pytest.raises(ValueError, match="channels"):
        step(st, wire, torch.zeros((2, 16, 2), dtype=torch.int32))
    assert port_cfg(jfs.FASTFABRIC_PIPELINED_STEP).name == \
        jfs.FASTFABRIC_PIPELINED_STEP.name == "fastfabric+shard+pipe8"
