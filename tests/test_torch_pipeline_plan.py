"""Overflowing windows in the port against JAX: 8 x 2 tables, where
inserts drop mid-window and later blocks read keys whose insert was
dropped, through the fabric step at depths 2 and 8 and through Fabric
1.2's step (sequential commit, serial log chain) at depth 4; each also
against the port at depth 1; and the store chain and journal head of an
overflowing window through the window committer. The planner's parts are in
tests/test_torch_pipeline_parts.py. The JAX results are computed once per
module."""

import numpy as np
import pytest
import torch

from repro.launch import fabric_step as jfs
from repro_torch.core import ledger, u32
from repro_torch.launch import fabric_step as tfs
from repro_torch.pipeline import engine_bridge as teb

from torch_pipeline_inputs import (TDIMS, assert_same, jax_run, port_run,
                                   window)

FF = jfs.FASTFABRIC_STEP


@pytest.fixture(scope="module")
def ovf():
    """An 8-block read-your-write window against an 8 x 2 endorser table:
    each block's 32 writes exceed the peer table's 16 slots."""
    wire, ids = window(8, n=16, seed=1, read_your_write=True,
                       endorser_buckets=8, endorser_slots=2)
    jax_res = {d: jax_run(FF, wire[:d], ids[:d], d, 8, 2) for d in (2, 8)}
    jax_res["v12"] = jax_run(jfs.FABRIC_V12_STEP, wire[:4], ids[:4], 4, 8, 2)
    return wire, ids, jax_res


@pytest.mark.parametrize("depth", (2, 8))
def test_overflow_window_matches_jax(ovf, depth):
    wire, ids, jax_res = ovf
    res = port_run(FF, wire[:depth], ids[:depth], depth, 8, 2)
    assert_same(res, jax_res[depth], f"overflow depth {depth}")
    assert res[0][-1][-1].any()  # the sticky bitmask latched
    assert 0 < res[1].sum() < res[1].size  # poisoned repairs: SOME invalid
    states, valid = port_run(FF, wire[:depth], ids[:depth], 1, 8, 2)
    assert_same(res, ([states[-1]], valid), "against depth 1")


def test_sequential_baseline_overflow_matches_jax(ovf):
    """Fabric 1.2's step bumps every duplicate occurrence and fills slots
    in write order; the planner mirrors it, on a window that overflows."""
    wire, ids, jax_res = ovf
    res = port_run(jfs.FABRIC_V12_STEP, wire[:4], ids[:4], 4, 8, 2)
    assert_same(res, jax_res["v12"], "fabric-1.2 overflow")
    assert res[0][-1][-1].any()
    states, valid = port_run(jfs.FABRIC_V12_STEP, wire[:4], ids[:4], 1, 8, 2)
    assert_same(res, ([states[-1]], valid), "fabric-1.2 against depth 1")


def test_overflow_window_store_chain_and_journal(ovf):
    """An overflowing window retires the same store chain, journal head and
    table through the window committer at depth 4 as one block a call."""
    wire, ids, _ = ovf
    w, i = torch.from_numpy(wire[:4].copy()), u32.from_numpy(ids[:4])
    out = {}
    for depth in (1, 4):
        wc = teb.WindowCommitter(TDIMS, tfs.FabricStepConfig(
            pipeline_depth=depth), n_buckets=8, slots=2, device="cpu")
        res = ([wc.commit_window(w[k:k + 1], i[k:k + 1]) for k in range(4)]
               if depth == 1 else [wc.commit_window(w, i)])
        store = ledger.BlockStore()
        bno = 0
        for r in res:
            for k in range(r.valid.shape[0]):
                store.submit(bno, r.prev_hash[k], r.block_hash[k], w[bno],
                             r.valid[k])
                bno += 1
        store.drain()
        assert store.verify_chain() and wc.overflow
        out[depth] = (store.chain, wc.journal_head, wc.state_digest())
        store.close()
    (c1, j1, d1), (c4, j4, d4) = out[1], out[4]
    np.testing.assert_array_equal(j1, j4)
    np.testing.assert_array_equal(d1, d4)
    assert [(a.block_no, a.block_hash.tolist(), a.valid.tolist())
            for a in c1] == [(b.block_no, b.block_hash.tolist(),
                              b.valid.tolist()) for b in c4]
