"""The schedules of the two redesigned hash-table kernels, on the CPU.

Sequential commit (K3): a plain mirror of the kernel's schedule
(``kernels/hash_table/ref.commit_grouped``: the buckets split into parts,
each part's applying writes staged in flat order, each bucket's run
applied to a copy of its row and written back once) against the plain
version, the JAX Pallas kernel (interpret mode, at small K) and
``repro.core.world_state.commit_sequential``, the JAX engine's function;
bit-equal, overflow flag included.

Probe (K2): a plain mirror of the group probe
(``kernels/hash_table/ref.lookup_grouped``: G lanes a query, a ballot a
segment of the row, its lowest set bit) against the plain version, the JAX
Pallas kernel (interpret mode) and ``repro.core.world_state.lookup``.

The kernels themselves are held against the plain versions on a card in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import world_state as jws
from repro.kernels.hash_table import kernel as jhtk
from repro_torch.core import types as tt
from repro_torch.kernels.hash_table import ref as ht_ref

from test_torch_kernels import N, T, _queries, _table


def _commit_every_way(keys, vers, vals, wk, wv, act, *, pallas):
    """The mirror, the plain version, JAX commit_sequential and (when
    ``pallas``) the Pallas kernel on the same inputs: (keys, versions,
    values, overflow) as numpy, by name."""
    out = {}
    for name, fn in (("grouped", ht_ref.commit_grouped),
                     ("plain", ht_ref.commit_ref)):
        st = [T(a) for a in (keys, vers, vals)]
        ovf = fn(*st, T(wk), T(wv), torch.from_numpy(act))
        out[name] = (*(N(t) for t in st), bool(ovf))
    j = [jnp.asarray(a) for a in (keys, vers, vals, wk, wv, act)]
    core = jws.commit_sequential(jws.HashState(*j[:3]), j[3][:, None],
                                 j[4][:, None], j[5])
    out["core"] = (*(np.asarray(a) for a in core.state), bool(core.overflow))
    if pallas:
        res = jhtk.commit(*j, interpret=True)
        out["pallas"] = (*(np.asarray(a) for a in res[:3]), bool(res[3]))
    return out


def _assert_same(out):
    want = out.pop("core")
    for name, got in out.items():
        for field, g, w in zip(("keys", "versions", "values", "overflow"),
                               got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {field}")
    return want


def _writes(rng, keys, k, vw, *, n_upd, p_inactive=0.1, p_empty=0.05):
    """K writes: ``n_upd`` updates of stored keys, the rest new keys; some
    inactive, some with the empty key."""
    occ = np.argwhere(keys[..., 0] != 0)
    wk = rng.integers(1, 1 << 32, (k, 2), dtype=np.uint32)
    wk[:n_upd] = keys[tuple(occ[rng.integers(0, len(occ), n_upd)].T)]
    wk = wk[rng.permutation(k)]
    wk[rng.random(k) < p_empty, 0] = 0
    wv = rng.integers(0, 1 << 32, (k, vw), dtype=np.uint32)
    return wk, wv, rng.random(k) >= p_inactive


def _in_bucket(wk, nb, bucket):
    wk[:, 0] = (wk[:, 0] & ~np.uint32(nb - 1)) | np.uint32(bucket)
    return wk


@pytest.mark.parametrize("case", ["hot_bucket", "full_buckets",
                                  "duplicate_keys", "inactive_and_empty",
                                  "one_write", "version_wrap"])
def test_commit_grouped_matches_pallas_and_core(case):
    """Small K, every way including the Pallas kernel: 64 writes of 6 keys
    into one bucket with 3 free slots (the run fills it, then overflows);
    writes into full buckets; keys written several times and a later write
    matching a slot an earlier write of its run filled; 30 % inactive and
    20 % empty-key writes inside runs; K = 1; a u32 version wrap."""
    nb, s, vw = 64, 8, 4
    rng = np.random.default_rng(len(case))
    keys, vers, vals = _table(3, nb, s, vw, nb * s // 2, n_full=4)
    if case == "hot_bucket":
        bkt = int(np.argwhere((keys[..., 0] == 0).sum(axis=1) == 3)[0, 0])
        pool = _in_bucket(rng.integers(1, 1 << 32, (6, 2), dtype=np.uint32),
                          nb, bkt)
        wk, wv, act = _writes(rng, keys, 64, vw, n_upd=0)
        wk[:] = pool[rng.integers(0, 6, 64)]
    elif case == "full_buckets":
        full = np.argwhere((keys[..., 0] != 0).all(axis=1))[:, 0]
        wk, wv, act = _writes(rng, keys, 64, vw, n_upd=16)
        wk[16:] = _in_bucket(wk[16:], nb, full[0])
    elif case == "duplicate_keys":
        wk, wv, act = _writes(rng, keys, 120, vw, n_upd=30)
        wk[60:] = wk[rng.integers(0, 60, 60)]
    elif case == "inactive_and_empty":
        wk, wv, act = _writes(rng, keys, 150, vw, n_upd=60, p_inactive=0.3,
                              p_empty=0.2)
        wk[100:] = _in_bucket(wk[100:], nb, 9)
    elif case == "one_write":
        wk, wv, act = _writes(rng, keys, 1, vw, n_upd=1, p_inactive=0.0,
                              p_empty=0.0)
    else:
        wk, wv, act = _writes(rng, keys, 40, vw, n_upd=40, p_inactive=0.0,
                              p_empty=0.0)
        occ = np.argwhere(keys[..., 0] != 0)
        hit = [tuple(o) for o in occ if (keys[tuple(o)] == wk[0]).all()][0]
        vers[hit] = 0xFFFFFFFF
    want = _assert_same(_commit_every_way(keys, vers, vals, wk, wv, act,
                                          pallas=True))
    if case in ("hot_bucket", "full_buckets"):
        assert want[3]
    if case == "version_wrap":  # 0xFFFFFFFF + n updates wraps to n - 1
        assert want[1][hit] == (wk == wk[0]).all(axis=1).sum() - 1


def test_commit_grouped_first_of_a_stored_twice_key():
    """A table holding one key twice (no commit makes one): the first slot
    takes the update, as JAX commit_sequential does. The Pallas kernel
    reads the larger of the two versions instead, so it is left out."""
    nb, s, vw = 32, 4, 2
    keys, vers, vals = _table(5, nb, s, vw, 40)
    bkt = np.argwhere((keys[..., 0] != 0).sum(axis=1) >= 2)[0, 0]
    keys[bkt, 1] = keys[bkt, 0]
    vers[bkt, :2] = (5, 12)
    wk = np.repeat(keys[bkt, :1], 3, axis=0)
    wv = np.arange(6, dtype=np.uint32).reshape(3, 2)
    want = _assert_same(_commit_every_way(
        keys, vers, vals, wk, wv, np.ones(3, bool), pallas=False))
    assert tuple(want[1][bkt, :2]) == (8, 12)


@pytest.mark.parametrize("s", [1, 3, 16, 32])
def test_commit_grouped_other_slot_counts(s):
    """Group widths other than the paths' 8 (1, 16 and 32 lanes; 3 slots
    in a group of 4), with overflow, against every way."""
    nb, vw, k = 16, 2, 96
    rng = np.random.default_rng(s)
    keys, vers, vals = _table(s, nb, s, vw, nb * s // 2)
    wk, wv, act = _writes(rng, keys, k, vw, n_upd=k // 3)
    wk[k // 2:] = _in_bucket(wk[k // 2:], nb, 3)
    _assert_same(_commit_every_way(keys, vers, vals, wk, wv, act,
                                   pallas=s <= 3))


def test_commit_grouped_k4096():
    """K = 4,096 at TEST_DIMS (a 2,048-tx block's writes; 128 parts):
    updates, inserts, duplicates, a hot bucket, inactive and empty keys;
    against the plain version and JAX commit_sequential."""
    nb, s, vw, k = 1 << 10, 8, tt.TEST_DIMS.vw, 4096
    rng = np.random.default_rng(4096)
    keys, vers, vals = _table(7, nb, s, vw, nb * 3)
    wk, wv, act = _writes(rng, keys, k, vw, n_upd=1500)
    wk[3000:3100] = _in_bucket(wk[3000:3100], nb, 11)
    wk[3100:3300] = wk[rng.integers(0, 3000, 200)]
    assert ht_ref.commit_part_bits(k) == 7
    want = _assert_same(_commit_every_way(keys, vers, vals, wk, wv, act,
                                          pallas=False))
    assert want[3]


def test_commit_grouped_one_part_many_passes():
    """2,000 writes to distinct buckets that all hash to one part, so that
    part stages them in three passes (more than 1,024 - 256 at a time),
    with updates and inactive writes; against the plain version and JAX
    commit_sequential."""
    nb, s, vw, k = 1 << 18, 2, 1, 2000
    bits = ht_ref.commit_part_bits(k)
    b = np.arange(nb, dtype=np.uint64)
    same = b[((b * ht_ref.GOLDEN) & 0xFFFFFFFF) >> (32 - bits) == 0]
    assert len(same) >= k
    rng = np.random.default_rng(1)
    keys = np.zeros((nb, s, 2), np.uint32)
    vers = np.zeros((nb, s), np.uint32)
    vals = np.zeros((nb, s, vw), np.uint32)
    wk = _in_bucket(rng.integers(1, 1 << 32, (k, 2), dtype=np.uint32), nb,
                    0)
    wk[:, 0] |= same[rng.permutation(len(same))[:k]].astype(np.uint32)
    wk[k // 2:] = wk[rng.integers(0, k // 2, k - k // 2)]
    wv = rng.integers(0, 1 << 32, (k, vw), dtype=np.uint32)
    act = rng.random(k) < 0.9
    _assert_same(_commit_every_way(keys, vers, vals, wk, wv, act,
                                   pallas=False))


# -- K2: the group probe ---------------------------------------------------------

@pytest.mark.parametrize("nb,s,vw,q", [(64, 8, 4, 200), (16, 3, 1, 33),
                                       (8, 40, 2, 100), (32, 32, 4, 64),
                                       (32, 1, 4, 40)])
def test_lookup_grouped_matches_pallas_and_core(nb, s, vw, q):
    """S = 8 (four queries a warp), a row of 3 in a group of 4, S = 40
    (two segments), a full-warp group and one lane a query; hits, misses,
    empty keys and the last slot of a full bucket."""
    keys, vers, vals = _table(nb + s, nb, s, vw, nb * s // 2)
    qs = _queries(q + s, keys, q)
    got = ht_ref.lookup_grouped(T(keys), T(vers), T(vals), T(qs))
    pallas = jhtk.lookup(*(jnp.asarray(a) for a in (keys, vers, vals, qs)),
                         q_tile=32, interpret=True)
    core = jws.lookup(jws.HashState(*(jnp.asarray(a)
                                      for a in (keys, vers, vals))),
                      jnp.asarray(qs))
    for g, p, c in zip(got[:3], pallas, core[:3]):
        np.testing.assert_array_equal(N(g), np.asarray(p))
        np.testing.assert_array_equal(N(g), np.asarray(c))
    np.testing.assert_array_equal(N(got[3]), np.asarray(core.slots))
    assert got[0][2] and not got[0][0]


def test_lookup_grouped_first_of_a_stored_twice_key():
    """A key stored twice in a row, the second time in the second segment
    of a 40-slot row: the first slot is read, as JAX lookup does."""
    nb, s, vw = 8, 40, 2
    keys, vers, vals = _table(9, nb, s, vw, 60)
    bkt = np.argwhere(keys[:, 0, 0] != 0)[0, 0]
    keys[bkt, 35] = keys[bkt, 0]
    got = ht_ref.lookup_grouped(T(keys), T(vers), T(vals),
                                T(keys[bkt, :1]))
    core = jws.lookup(jws.HashState(*(jnp.asarray(a)
                                      for a in (keys, vers, vals))),
                      jnp.asarray(keys[bkt, :1]))
    for g, c in zip(got, core):
        np.testing.assert_array_equal(N(g), np.asarray(c))
    assert int(got[3][0]) == 0
