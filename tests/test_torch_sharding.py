"""Bucket-sharded world state in the port (launch/state_sharding) against
the JAX package, in one process, at M = 1, 2 and 4 shards of 256-bucket
tables: the routed lookups and window fill against JAX ``lookup`` and
``bucket_free_slots`` of the merged table and the VMEM-budget sharded
dispatch ``ops._sharded_lookup``; the routed commit (vectorized and
sequential) and its per-shard overflow flags against JAX ``commit`` and
``ops._sharded_commit``; the routed window commit against
``ops._sharded_commit_window``; the butterfly resize (grow, shrink, a lossy
shrink) against JAX ``resize`` of the merged table, split; the digest tree;
the butterfly permutations and recovery's range schedule against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import world_state as jws
from repro.kernels.hash_table import ops as jops
from repro.launch import state_sharding as jss
from repro.pipeline import batched_mvcc as jbm
from repro.storage import recovery as jrec
from repro_torch.core import types as tt, u32
from repro_torch.core import world_state as tws
from repro_torch.launch import fabric_step as tfs
from repro_torch.launch import state_sharding as tss
from repro_torch.pipeline import batched_mvcc as tbm
from repro_torch.storage import recovery as trec

NB, S, VW = 256, 8, 4
SHARDS = (1, 2, 4)
T = lambda a: u32.from_numpy(np.asarray(a), "cpu")
N = lambda t: u32.host_copy(t) if t.dtype == torch.int32 else t.numpy()


def _pool(rng, n):
    """n distinct paired keys (word 0 never 0)."""
    hi = rng.choice(np.arange(1, 1 << 24, dtype=np.uint32), n, replace=False)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return np.stack([hi, lo], 1)


def _table(rng, pool, nb=NB, s=S, hot=()):
    """A table holding a random half of the pool (the keys of ``hot``
    buckets all of them, so those buckets fill), versions over the whole
    u32 range."""
    keys = np.zeros((nb, s, 2), np.uint32)
    vers = np.zeros((nb, s), np.uint32)
    vals = np.zeros((nb, s, VW), np.uint32)
    fill = np.zeros(nb, int)
    for k in pool:
        bkt = k[0] & (nb - 1)
        if fill[bkt] < s and (bkt in hot or rng.random() < 0.5):
            keys[bkt, fill[bkt]] = k
            vers[bkt, fill[bkt]] = rng.integers(1, 1 << 32, dtype=np.uint64)
            vals[bkt, fill[bkt]] = rng.integers(0, 1 << 32, VW,
                                                dtype=np.uint64)
            fill[bkt] += 1
    return keys, vers, vals


def _hot_pool(rng, n, buckets, nb=NB):
    """n keys a bucket of ``buckets``: more than the bucket holds."""
    out = []
    for b in buckets:
        hi = (rng.integers(1, 1 << 16, n, dtype=np.uint32) * nb + b)
        lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        out.append(np.stack([hi.astype(np.uint32), lo], 1))
    return np.concatenate(out)


def _jstate(table):
    return jws.HashState(*(jnp.asarray(a) for a in table))


def _tstate(table):
    return tws.HashState(*(T(a) for a in table))


def _np_state(st):
    return [N(a) if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in st]


def _merge_port(shards):
    return [np.concatenate([N(getattr(st, f)) for st in shards])
            for f in tws.HashState._fields]


def _assert_tables(a, b, what):
    for name, x, y in zip(tws.HashState._fields, a, b):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")


def _setup(seed, hot=(3, 200)):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([_pool(rng, 900), _hot_pool(rng, 12, hot)])
    return rng, pool, _table(rng, pool, hot=hot)


@pytest.mark.parametrize("m", SHARDS)
def test_routed_lookups_and_fill(m):
    rng, pool, table = _setup(m)
    q = pool[rng.integers(0, len(pool), 160)]
    q[rng.random(160) < 0.1, 0] = 0  # empty keys never match
    q = np.concatenate([q, _pool(rng, 40)])  # absent keys
    free_q = pool[rng.integers(0, len(pool), 64)]
    jst = _jstate(table)
    shards = tss.shard_views(_tstate(table), m)
    look = tss.sharded_lookup(shards, T(q), NB, m)
    want = jws.lookup(jst, jnp.asarray(q))
    for name in ("found", "versions", "values"):
        np.testing.assert_array_equal(N(getattr(look, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # Slots are the owner shard's local ones: the merged table's, as the
    # owner's local bucket is the global bucket's low bits.
    np.testing.assert_array_equal(N(look.slots)[N(look.found)],
                                  np.asarray(want.slots)[N(look.found)])
    f, v, va = jops._sharded_lookup(*(jnp.asarray(a) for a in table),
                                    jnp.asarray(q), m)
    np.testing.assert_array_equal(N(look.found), np.asarray(f))
    np.testing.assert_array_equal(N(look.versions), np.asarray(v))
    np.testing.assert_array_equal(N(look.values), np.asarray(va))
    np.testing.assert_array_equal(
        N(tss.sharded_lookup_versions(shards, T(q), NB, m)),
        np.asarray(want.versions))
    vers, free = tss.sharded_window_fill(shards, T(q), T(free_q), NB, m)
    np.testing.assert_array_equal(N(vers), np.asarray(want.versions))
    np.testing.assert_array_equal(
        N(free), np.asarray(jws.bucket_free_slots(jst, jnp.asarray(free_q))))
    assert N(look.found).any() and not N(look.found).all()


def _writes(rng, pool, b=12, wk=4):
    k = pool[rng.integers(0, len(pool), (b, wk))]
    k[rng.random((b, wk)) < 0.1, 0] = 0
    vals = rng.integers(0, 1 << 32, (b, wk, VW), dtype=np.uint64).astype(
        np.uint32)
    return k, vals, rng.random(b) < 0.8


def _jax_shard_flags(table, wk, wv, act, m, sequential):
    """The reference's per-rank commit body on one device: each shard
    commits the block with non-owned write keys blanked; its flag."""
    sk, sv, sva = jws.split_table(*(jnp.asarray(a) for a in table), m)
    owner = np.asarray(jws.shard_of(NB, m, jnp.asarray(wk)))
    flags = []
    for r in range(m):
        blank = np.where((owner == r)[..., None], wk, 0).astype(np.uint32)
        res = jws.commit(jws.HashState(sk[r], sv[r], sva[r]),
                         jnp.asarray(blank), jnp.asarray(wv),
                         jnp.asarray(act), sequential=sequential)
        flags.append(bool(res.overflow))
    return np.array(flags)


@pytest.mark.parametrize("sequential", (False, True))
@pytest.mark.parametrize("m", SHARDS)
def test_routed_commit_and_shard_overflow(m, sequential):
    rng, pool, table = _setup(10 + m)
    # New keys into the two full hot buckets: those shards overflow.
    extra = _hot_pool(rng, 3, (3, 200))
    wk, wv, act = _writes(rng, np.concatenate([pool, extra]))
    wk[0, :3], wk[1, :3] = extra[:3], extra[3:6]
    act[:2] = True
    shards = tss.shard_views(_tstate(table), m)
    res = tss.sharded_commit(shards, T(wk), T(wv), torch.from_numpy(act),
                             NB, m, sequential=sequential)
    want = jws.commit(_jstate(table), jnp.asarray(wk), jnp.asarray(wv),
                      jnp.asarray(act), sequential=sequential)
    _assert_tables(_merge_port(res.state), _np_state(want.state), "commit")
    flags = _jax_shard_flags(table, wk, wv, act, m, sequential)
    np.testing.assert_array_equal(res.shard_overflow.numpy(), flags)
    assert bool(res.overflow) == bool(want.overflow) == flags.any()
    owners = {int(b) * m // NB for b in (3, 200)}
    assert set(np.flatnonzero(flags)) == owners
    np.testing.assert_array_equal(
        N(tss.overflow_bits(res.shard_overflow)),
        np.asarray(jss.overflow_bits(jnp.asarray(flags))))
    if sequential:
        k, v, va, ovf = jops._sharded_commit(
            *(jnp.asarray(a) for a in table),
            jnp.asarray(wk.reshape(-1, 2)),
            jnp.asarray(wv.reshape(-1, VW)),
            jnp.asarray(np.repeat(act, wk.shape[1])), m)
        _assert_tables(_merge_port(res.state),
                       [np.asarray(x) for x in (k, v, va)], "ops commit")
        assert bool(ovf) == flags.any()


@pytest.mark.parametrize("m", SHARDS)
def test_routed_window_fill_and_commit(m):
    """A 3-block window planned by the JAX planner on the merged table's
    fill; the port's routed fill equals that fill, and its routed window
    commit equals ``ops._sharded_commit_window`` and the merged
    ``commit_window``."""
    rng, pool, table = _setup(20 + m)
    blocks = [_writes(rng, pool, b=8, wk=2) for _ in range(3)]
    wkeys = np.stack([b[0] for b in blocks])  # (3, B, WK, 2)
    wvals = np.stack([b[1] for b in blocks]).reshape(-1, VW)
    rkeys = pool[rng.integers(0, len(pool), (24, 2))]
    jst = _jstate(table)
    fill = jbm.gather_window_state(
        jst, jnp.asarray(rkeys), jnp.asarray(wkeys.reshape(-1, 2, 2)), False,
        n_buckets_global=NB, n_shards=1)
    tfill = tbm.gather_window_state(
        _tstate(table), T(rkeys), T(wkeys.reshape(-1, 2, 2)), True,
        n_buckets_global=NB, n_shards=m)
    for name, a, b in zip(jbm.WindowFill._fields, fill, tfill):
        np.testing.assert_array_equal(N(b), np.asarray(a), err_msg=name)
    wv = np.asarray(fill.write_vers).reshape(3, 8, 2)
    free = np.asarray(fill.write_free).reshape(3, 8, 2)
    log = [np.zeros((0, 16, 2), np.uint32), np.zeros((0, 16), bool),
           np.zeros((0, 16), bool)]
    for t in range(3):
        plan = jbm.plan_block_writes(
            jnp.asarray(wkeys[t]), jnp.asarray(blocks[t][2]), False,
            jnp.asarray(wv[t]), jnp.asarray(free[t]), jnp.asarray(log[0]),
            jnp.asarray(log[1]), jnp.asarray(log[2]), n_buckets_global=NB)
        log = [np.concatenate([log[i], np.asarray(plan[i])[None]])
               for i in range(3)]
    lk, lb, ln = (x.reshape(-1, *x.shape[2:]) for x in log)
    shards = tss.commit_window_routed(
        tss.shard_views(_tstate(table), m), T(lk), T(wvals),
        torch.from_numpy(lb), torch.from_numpy(ln), NB, m)
    want = jops._sharded_commit_window(
        *(jnp.asarray(a) for a in table), jnp.asarray(lk),
        jnp.asarray(wvals), jnp.asarray(lb), jnp.asarray(ln), m)
    _assert_tables(_merge_port(shards), [np.asarray(x) for x in want],
                   "routed window commit")
    merged = jws.commit_window(jst, jnp.asarray(lk), jnp.asarray(wvals),
                               jnp.asarray(lb), jnp.asarray(ln))
    _assert_tables(_merge_port(shards), _np_state(merged), "merged")
    assert lb.any() and ln.any()


def _resize_flags(table, new_nb, m):
    """Which new shards a merged-table resize drops entries in: a new
    bucket holding more entries than slots, counted on the host."""
    keys = table[0].reshape(-1, 2)
    live = keys[keys[:, 0] != 0]
    counts = np.bincount(live[:, 0] & (new_nb - 1), minlength=new_nb)
    over = counts > table[0].shape[1]
    return over.reshape(m, -1).any(axis=1)


@pytest.mark.parametrize("mode", ("grow", "shrink", "lossy_shrink"))
def test_resize_sharded_matches_merged_resize(mode):
    for m in SHARDS:
        rng = np.random.default_rng(30 + m)
        pool = _pool(rng, 1500 if mode == "lossy_shrink" else 500)
        table = _table(rng, pool)
        new_nb = 2 * NB if mode == "grow" else NB // 2
        res = tss.resize_sharded(tss.shard_views(_tstate(table), m),
                                 new_nb // m, NB, m)
        want = jws.resize(_jstate(table), new_nb)
        _assert_tables(_merge_port(res.state), _np_state(want.state),
                       f"{mode} M={m}")
        for st in res.state:
            assert st.n_buckets == new_nb // m
        flags = _resize_flags(table, new_nb, m)
        np.testing.assert_array_equal(res.shard_overflow.numpy(), flags)
        assert bool(res.overflow) == bool(want.overflow)
        assert flags.any() == (mode == "lossy_shrink")
        with pytest.raises(ValueError, match="2x"):
            tss.resize_sharded(tss.shard_views(_tstate(table), m),
                               4 * NB // m, NB, m)


def test_butterfly_sources_and_digest_tree():
    for m in (2, 4, 8):
        for grow in (True, False):
            assert tss._butterfly_perms(m, grow) == jss._butterfly_perms(
                m, grow)
            src = tss.butterfly_sources(m, grow)
            h = m // 2
            for r, (lo, hi) in enumerate(src):
                assert (lo, hi) == ((2 * (r % h), 2 * (r % h) + 1) if grow
                                    else (r // 2, r // 2 + h))
    rng, pool, table = _setup(40)
    for m in SHARDS + (8,):
        np.testing.assert_array_equal(
            N(tss.sharded_digest(tss.shard_views(_tstate(table), m))),
            np.asarray(jws.tree_head(_jstate(table), m)))


def test_range_schedule_matches_jax():
    for nbs in ([64], [64, 128], [64, 128, 256], [128, 64], [256, 128, 64],
                [64, 128, 64], [128, 64, 128, 256, 128], [16, 8, 4, 8]):
        for m in (1, 2, 4):
            if nbs[-1] < m or any(nb % m for nb in nbs):
                continue
            for shard in range(m):
                assert (trec._range_schedule(shard, m, nbs)
                        == jrec._range_schedule(shard, m, nbs)), (nbs, m)


def test_shard_views_write_through_and_refusals():
    rng, pool, table = _setup(50)
    st = _tstate(table)
    shards = tss.shard_views(st, 4)
    shards[3].versions[0, 0] = 7
    assert int(st.versions[3 * NB // 4, 0]) == 7
    assert tss.split_table is tws.split_table
    assert tss.merge_table is tws.merge_table
    with pytest.raises(ValueError, match="partition"):
        tss.sharded_lookup(shards[:2], T(pool[:4]), NB, 4)
    with pytest.raises(ValueError, match="<= 64 shards"):
        tss.overflow_bits(torch.zeros(65, dtype=torch.bool))
    with pytest.raises(ValueError, match="<= 64 shards"):
        tfs.make_fabric_step(tt.TEST_DIMS, tfs.FASTFABRIC_SHARDED_STEP,
                             n_shards=128)
    step = tfs.make_fabric_step(tt.TEST_DIMS, tfs.FASTFABRIC_SHARDED_STEP,
                                n_shards=3)
    state = tfs.create_mesh_state(1, tt.TEST_DIMS, 256, 8, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        step(state, torch.zeros((1, 4, 8), dtype=torch.uint8),
             torch.zeros((1, 4, 2), dtype=torch.int32))
