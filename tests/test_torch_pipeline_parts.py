"""The window planner's parts in the port against JAX, on random tables
with duplicate and empty keys and versions at and past 2^31:
``bucket_free_slots``, ``version_adjustment``, ``plan_block_writes``
block by block as the schedule runs it and ``commit_window`` on its log;
the overflow bitmask lanes, the O-I prefix decode, the log folds and the
unmarshal cache; and a tree-hash window through the fabric step."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unmarshal as jum
from repro.core import world_state as jws
from repro.launch import fabric_step as jfs, state_sharding as jss
from repro.pipeline import batched_mvcc as jbm, stages as jst
from repro_torch.core import u32, unmarshal as tum
from repro_torch.core import world_state as tws
from repro_torch.launch import state_sharding as tss
from repro_torch.pipeline import batched_mvcc as tbm, stages as tst

from torch_pipeline_inputs import (DIMS, TDIMS, assert_same, jax_run,
                                   port_cfg, port_run, window)

T = lambda a: u32.from_numpy(np.asarray(a), "cpu")
N = lambda t: u32.host_copy(t) if t.dtype == torch.int32 else t.numpy()


def test_tree_hash_window_matches_jax():
    cfg = dataclasses.replace(jfs.FASTFABRIC_STEP, tree_hash=True)
    wire, ids = window(2, n=16, seed=5)
    res = port_run(cfg, wire, ids, 2)
    assert_same(res, jax_run(cfg, wire, ids, 2), "tree")
    states, valid = port_run(cfg, wire, ids, 1)
    assert_same(res, ([states[-1]], valid), "tree against depth 1")
    assert port_cfg(cfg).name == cfg.name == "fastfabric+tree"


# -- the planner's parts on random inputs -------------------------------------

NB, S, VW, B, WK = 8, 4, 4, 6, 2
EDGE_VERSIONS = (1 << 31, (1 << 31) + 7, 0xFFFFFFFE, 0xFFFFFFFF)


def _pool(rng, n=20):
    """n distinct paired keys (word 0 never 0) and an empty key (0, x)."""
    hi = rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), n, replace=False)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return np.stack([hi, lo], 1)


def _table(rng, pool):
    """A table holding a random part of the pool, versions drawn over the
    whole u32 range and at the unsigned edges."""
    keys = np.zeros((NB, S, 2), np.uint32)
    vers = np.zeros((NB, S), np.uint32)
    vals = rng.integers(0, 1 << 32, (NB, S, VW), dtype=np.uint64).astype(
        np.uint32)
    fill = np.zeros(NB, int)
    for k in pool[rng.random(len(pool)) < 0.5]:
        bkt = k[0] & (NB - 1)
        if fill[bkt] < S:
            keys[bkt, fill[bkt]] = k
            vers[bkt, fill[bkt]] = rng.choice(
                [rng.integers(1, 1 << 32, dtype=np.uint64),
                 rng.choice(EDGE_VERSIONS)])
            fill[bkt] += 1
    vals[keys[..., 0] == 0] = 0
    return keys, vers, vals


def _writes(rng, pool, shape):
    """Write keys drawn from the pool (so duplicates within and across
    blocks), one in six empty."""
    k = pool[rng.integers(0, len(pool), shape)]
    empty = rng.random(shape) < 1 / 6
    k[empty, 0] = 0
    return k


@pytest.mark.parametrize("seed", range(3))
def test_bucket_free_slots_and_version_adjustment(seed):
    rng = np.random.default_rng(seed)
    pool = _pool(rng)
    keys, vers, vals = _table(rng, pool)
    q = _writes(rng, pool, (B, WK))
    jstate = jws.HashState(*(jnp.asarray(a) for a in (keys, vers, vals)))
    tstate = tws.HashState(*(T(a) for a in (keys, vers, vals)))
    np.testing.assert_array_equal(
        N(tws.bucket_free_slots(tstate, T(q))),
        np.asarray(jws.bucket_free_slots(jstate, jnp.asarray(q))))
    wl = _writes(rng, pool, (3, B * WK))
    bumps = rng.random((3, B * WK)) < 0.6
    np.testing.assert_array_equal(
        N(tbm.version_adjustment(T(q), T(wl), torch.from_numpy(bumps))),
        np.asarray(jbm.version_adjustment(jnp.asarray(q), jnp.asarray(wl),
                                          jnp.asarray(bumps))))


def _plan_window(seed, sequential, package):
    """Plan a 3-block window on a random table with one package's planner,
    block by block as the schedule does, then apply the log with its
    fused commit. Returns every plan and the table after."""
    rng = np.random.default_rng(seed)
    pool = _pool(rng)
    table = _table(rng, pool)
    wkeys = _writes(rng, pool, (3, B, WK))
    wvals = rng.integers(0, 1 << 32, (3, B * WK, VW), dtype=np.uint64
                         ).astype(np.uint32)
    valid = rng.random((3, B)) < 0.8
    if package == "jax":
        A, ws_, bm = jnp.asarray, jws, jbm
    else:
        A = lambda a: (T(a) if np.asarray(a).dtype == np.uint32
                       else torch.from_numpy(np.asarray(a)))
        ws_, bm = tws, tbm
    st = ws_.HashState(*(A(a) for a in table))
    fill = bm.gather_window_state(
        st, A(np.zeros((3 * B, 2, 2), np.uint32)), A(wkeys.reshape(-1, WK, 2))
    ) if package != "jax" else bm.gather_window_state(
        st, A(np.zeros((3 * B, 2, 2), np.uint32)), A(wkeys.reshape(-1, WK, 2)),
        False, n_buckets_global=NB, n_shards=1)
    wv = fill.write_vers.reshape(3, B, WK)
    free = fill.write_free.reshape(3, B, WK)
    log = [np.zeros((0, B * WK, 2), np.uint32), np.zeros((0, B * WK), bool),
           np.zeros((0, B * WK), bool)]
    plans = []
    for t in range(3):
        plan = bm.plan_block_writes(
            A(wkeys[t]), A(valid[t]), sequential, wv[t], free[t],
            A(log[0]), A(log[1]), A(log[2]), n_buckets_global=NB)
        plan = [np.asarray(x) if package == "jax" else N(x) for x in plan]
        plans.append(plan)
        log = [np.concatenate([log[0], plan[0][None]]),
               np.concatenate([log[1], plan[1][None]]),
               np.concatenate([log[2], plan[2][None]])]
    out = ws_.commit_window(st, A(log[0].reshape(-1, 2)),
                            A(wvals.reshape(-1, VW)), A(log[1].reshape(-1)),
                            A(log[2].reshape(-1)))
    table = [np.asarray(x) if package == "jax" else N(x) for x in out]
    return plans, table, rng


@pytest.mark.parametrize("sequential", (False, True))
@pytest.mark.parametrize("seed", range(3))
def test_plan_block_writes_and_commit_window(seed, sequential):
    jplans, jtable, _ = _plan_window(seed, sequential, "jax")
    tplans, ttable, _ = _plan_window(seed, sequential, "torch")
    for t, (jp, tp) in enumerate(zip(jplans, tplans)):
        for name, a, b in zip(tbm.BlockWritePlan._fields, jp, tp):
            np.testing.assert_array_equal(a, b, err_msg=f"block {t} {name}")
    for name, a, b in zip(tws.HashState._fields, jtable, ttable):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert any(p[1].any() for p in jplans)  # some write applied


def test_overflow_bitmask_and_lanes():
    rng = np.random.default_rng(3)
    for m in (1, 5, 33, 64):
        shard = rng.random(m) < 0.4
        np.testing.assert_array_equal(
            N(tss.overflow_bits(torch.from_numpy(shard))),
            np.asarray(jss.overflow_bits(jnp.asarray(shard))))
    keys = rng.integers(1, 1 << 32, (40, 2), dtype=np.uint64).astype(
        np.uint32)
    dropped = rng.random(40) < 0.3
    for shards in (1, 4):
        lanes = N(tss.dropped_write_bits(T(keys), torch.from_numpy(dropped),
                                         64, shards))
        np.testing.assert_array_equal(lanes, np.asarray(
            jss.dropped_write_bits(jnp.asarray(keys), jnp.asarray(dropped),
                                   64, shards)))
        assert tss.bits_to_int(T(lanes)) == jss.bits_to_int(lanes)
    for bits in (0, 1, (1 << 63) | 5, 0xFFFFFFFF):
        np.testing.assert_array_equal(tss.int_to_lanes(bits),
                                      jss.int_to_lanes(bits))
    with pytest.raises(ValueError, match="channel 3"):
        tss.overflow_bits(torch.zeros(65, dtype=torch.bool), channel=3)


def test_prefix_decode_folds_and_unmarshal_cache():
    wire, _ = window(1, n=16, seed=2)
    words = np.asarray(jum.unmarshal(jnp.asarray(wire[0]), DIMS).txb.tx_id)
    spw = tum.struct_prefix_words(TDIMS)
    assert spw == jum.struct_prefix_words(DIMS)
    w32 = wire[0].view(np.uint32)
    for rows in (w32[:, :spw], w32):  # O-I prefix rows, baseline whole rows
        jt = jst.decode_published(jnp.asarray(rows), DIMS, rows is not w32)
        tt = tst.decode_published(T(rows), TDIMS)
        for name, a, b in zip(jt._fields, jt, tt):
            np.testing.assert_array_equal(np.asarray(a), N(b), err_msg=name)
    np.testing.assert_array_equal(N(tt.tx_id), words)
    head = np.array([0x12345678, 0xFFFFFFFF], np.uint32)
    for n in (1, 5, 16):
        d = w32[:n, 7].copy()
        np.testing.assert_array_equal(
            N(tst.fold_log_chain(T(head), T(d))),
            np.asarray(jst.fold_log_chain(jnp.asarray(head), jnp.asarray(d))))
        np.testing.assert_array_equal(
            N(tst.fold_log_tree(T(head), T(d))),
            np.asarray(jst.fold_log_tree(jnp.asarray(head), jnp.asarray(d))))
    np.testing.assert_array_equal(
        N(tst.fold_log_head(T(head), T(w32[:3]), port_cfg(
            jfs.FABRIC_V12_STEP))),
        np.asarray(jst.fold_log_head(jnp.asarray(head), jnp.asarray(w32[:3]),
                                     jfs.FABRIC_V12_STEP)))
    # The cache's slot is block_no % depth: block 7 takes block 5's slot.
    cache = tum.UnmarshalCache(2)
    tw = torch.from_numpy(wire[0].copy())
    first = cache.get(5, tw, TDIMS)
    assert cache.get(5, tw, TDIMS) is first and cache.hits == 1
    cache.get(7, tw, TDIMS)
    assert cache.get(5, tw, TDIMS) is not first and cache.misses == 3
    cache.evict(5)
    cache.get(5, tw, TDIMS)
    assert cache.misses == 4 and bool(first.checksum_ok.all())
