"""The port's kernels (endorsement MAC, hash-table probe, MVCC scan; the
sequential commit is in test_torch_commit.py): their plain versions,
reached through the wrappers on CPU tensors, against both the JAX Pallas
kernel (interpret mode) and the JAX ``core/`` function the JAX engine runs;
bit-equal. The CUDA kernels themselves are held
against these plain versions in test_torch_cuda.py, on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import crypto as jc, mvcc as jm, types as jt
from repro.core import world_state as jws
from repro.kernels.hash_table import kernel as jhtk
from repro.kernels.mvcc_validate import kernel as jmvk
from repro.kernels.sig_mac import kernel as jsmk
from repro_torch.core import crypto as tc, mvcc as tm, types as tt, u32
from repro_torch.core import world_state as tws
from repro_torch.kernels.hash_table import ops as ht_ops
from repro_torch.kernels.mvcc_validate import ops as mv_ops
from repro_torch.kernels.mvcc_validate import ref as mv_ref
from repro_torch.kernels.sig_mac import ops as mac_ops

P31 = (1 << 31) - 1


def T(a):
    return u32.from_numpy(np.asarray(a), "cpu")


def N(t):
    return u32.to_numpy(t)


def _eq(got, want):
    np.testing.assert_array_equal(N(got), np.asarray(want))


def _messages(seed, b, w):
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 1 << 32, (b, w), dtype=np.uint32)
    msg[0] = 0
    msg[min(1, b - 1)] = 0xFFFFFFFF
    return msg


def _keys(seed, ne):
    rng = np.random.default_rng(seed)
    rs = rng.integers(0, P31, ne, dtype=np.uint32)
    ss = rng.integers(0, P31, ne, dtype=np.uint32)
    rs[0], ss[-1] = P31 - 1, 0
    return rs, ss


# -- K1: endorsement MAC --------------------------------------------------------

@pytest.mark.parametrize("b,w,ne", [(100, 22, 3), (37, 3, 1), (5, 1, 4)])
def test_mac_many_matches_pallas_and_core(b, w, ne):
    msg = _messages(b * w, b, w)
    rs, ss = _keys(ne, ne)
    got = mac_ops.mac_many(T(msg), T(rs), T(ss))
    _eq(got, jsmk.mac_many(jnp.asarray(msg), jnp.asarray(rs), jnp.asarray(ss),
                           tx_tile=32, interpret=True))
    core = np.stack([np.asarray(jc.poly_mac(jnp.asarray(msg), rs[e], ss[e]))
                     for e in range(ne)], axis=1)
    _eq(got, core)


def test_field_arithmetic_and_keys():
    x = _messages(1, 64, 1)[:, 0]
    a = np.asarray(jc.mod31(jnp.asarray(x)))
    b = np.asarray(jc.mod31(jnp.asarray(_messages(2, 64, 1)[:, 0])))
    _eq(tc.mod31(T(x)), a)
    _eq(tc.addmod31(T(a), T(b)), jc.addmod31(jnp.asarray(a), jnp.asarray(b)))
    _eq(tc.mulmod31(T(a), T(b)), jc.mulmod31(jnp.asarray(a), jnp.asarray(b)))
    for got, want in zip(tc.endorser_keys(5, "cpu"), jc.endorser_keys(5)):
        _eq(got, want)


def test_endorse_and_verify_tags():
    jb = jt.make_transfer_batch(jt.TEST_DIMS, 40, seed=2)
    tb = tt.make_transfer_batch(tt.TEST_DIMS, 40, seed=2, device="cpu")
    tags = tc.endorse_batch(tb)
    _eq(tags, jc.endorse_batch(jb))
    bad = N(tags).copy()
    bad[3, 1] ^= 1
    bad[9, 0] = 0
    tb = tb._replace(endorse_tags=T(bad))
    jb = jb._replace(endorse_tags=jnp.asarray(bad))
    _eq(tc.verify_tags(tb), jc.verify_tags(jb))
    assert int((~tc.verify_tags(tb)).sum()) == 2


# -- K2: hash-table probe -------------------------------------------------------

def _table(seed, nb, s, vw, n_keys, *, n_full=2):
    """A consistent table built in numpy: keys in their buckets' first
    slots, and ``n_full`` buckets filled to the last slot."""
    rng = np.random.default_rng(seed)
    keys = np.zeros((nb, s, 2), np.uint32)
    vers = np.zeros((nb, s), np.uint32)
    vals = np.zeros((nb, s, vw), np.uint32)
    fill = np.zeros(nb, int)
    cand = rng.integers(1, 1 << 32, (n_keys, 2), dtype=np.uint32)
    hot = rng.integers(0, nb, n_full)
    extra = rng.integers(1, 1 << 32, (n_full * s, 2), dtype=np.uint32)
    extra[:, 0] = (extra[:, 0] & ~np.uint32(nb - 1)) | np.repeat(hot, s)
    for k in np.concatenate([cand, extra]):
        bkt = int(k[0]) & (nb - 1)
        if k[0] == 0 or fill[bkt] == s:
            continue
        keys[bkt, fill[bkt]] = k
        fill[bkt] += 1
    occ = keys[..., 0] != 0
    vers[occ] = rng.integers(1, 1 << 32, occ.sum(), dtype=np.uint32)
    vals[occ] = rng.integers(0, 1 << 32, (occ.sum(), vw), dtype=np.uint32)
    assert (fill == s).sum() >= 1
    return keys, vers, vals


def _queries(seed, keys, q):
    rng = np.random.default_rng(seed)
    occ = np.argwhere(keys[..., 0] != 0)
    hits = keys[tuple(occ[rng.integers(0, len(occ), q // 2)].T)]
    miss = rng.integers(1, 1 << 32, (q - q // 2, 2), dtype=np.uint32)
    qs = np.concatenate([hits, miss])
    qs[0, 0] = 0  # empty key: never matches
    qs[1] = (0, hits[2, 1])
    full = np.argwhere((keys[..., 0] != 0).all(axis=1))[0, 0]
    qs[2] = keys[full, -1]  # last slot of a full bucket
    qs[3] = (keys[full, 0, 0], keys[full, 0, 1] ^ 1)  # miss in a full bucket
    return qs


@pytest.mark.parametrize("nb,s,vw,q", [(64, 8, 4, 200), (16, 4, 1, 33),
                                       (128, 8, 2, 257)])
def test_lookup_matches_pallas_and_core(nb, s, vw, q):
    keys, vers, vals = _table(nb, nb, s, vw, nb * s // 2)
    qs = _queries(q, keys, q)
    found, v, x, slot = ht_ops.lookup(T(keys), T(vers), T(vals), T(qs))
    pallas = jhtk.lookup(*(jnp.asarray(a) for a in (keys, vers, vals, qs)),
                         q_tile=32, interpret=True)
    core = jws.lookup(jws.HashState(*(jnp.asarray(a)
                                      for a in (keys, vers, vals))),
                      jnp.asarray(qs))
    for got, p, c in zip((found, v, x), pallas, core[:3]):
        _eq(got, p)
        _eq(got, c)
    _eq(slot, core.slots)
    assert found[2] and not found[0] and not found[1] and not found[3]


def test_lookup_duplicate_keys_take_first_slot():
    """A table holding one key twice (never produced by a commit): the
    engine's function, and the port, read the first matching slot."""
    keys, vers, vals = _table(5, 32, 4, 2, 40)
    bkt = np.argwhere((keys[..., 0] != 0).sum(axis=1) >= 2)[0, 0]
    keys[bkt, 1] = keys[bkt, 0]
    qs = keys[bkt, :1]
    got = ht_ops.lookup(T(keys), T(vers), T(vals), T(qs))
    core = jws.lookup(jws.HashState(*(jnp.asarray(a)
                                      for a in (keys, vers, vals))),
                      jnp.asarray(qs))
    for g, c in zip(got, core):
        _eq(g, c)
    assert int(got[3][0]) == 0


def _jax_state(st):
    return jws.HashState(*(jnp.asarray(N(t)) for t in st))


@pytest.mark.parametrize("nb,s,b", [(16, 2, 30), (256, 8, 50), (8, 4, 40)])
def test_commit_vectorized_matches_core(nb, s, b):
    """Updates, inserts, full buckets (overflow), duplicate and empty keys,
    and inactive writes, against the JAX engine's commit."""
    rng = np.random.default_rng(nb + b)
    keys, vers, vals = _table(b, nb, s, 4, nb * s // 3)
    wk = rng.integers(1, 1 << 32, (b, 2, 2), dtype=np.uint32)
    occ = np.argwhere(keys[..., 0] != 0)
    upd = occ[rng.integers(0, len(occ), b // 3)]
    wk[: b // 3, 0] = keys[tuple(upd.T)]
    wk[b // 3, 1] = wk[b // 3 + 1, 0]  # duplicate key across writes
    wk[b // 3 + 2, 1, 0] = 0  # empty key
    wv = rng.integers(0, 1 << 32, (b, 2, 4), dtype=np.uint32)
    active = rng.random(b) < 0.8
    st = tws.HashState(T(keys), T(vers), T(vals))
    res = tws.commit_vectorized(st, T(wk), T(wv), torch.from_numpy(active))
    want = jws.commit_vectorized(
        jws.HashState(*(jnp.asarray(a) for a in (keys, vers, vals))),
        jnp.asarray(wk), jnp.asarray(wv), jnp.asarray(active))
    for got, w in zip(res.state, want.state):
        _eq(got, w)
    assert bool(res.overflow) == bool(want.overflow)
    assert int(tws.occupancy(res.state)) == int(jws.occupancy(want.state))
    _eq(tws.state_digest(res.state), jws.state_digest(want.state))
    if nb == 8:
        assert bool(res.overflow)


# -- K4: MVCC validation --------------------------------------------------------

def _mvcc_inputs(seed, b, conflict_rate):
    rng = np.random.default_rng(seed)
    jb = jt.make_transfer_batch(jt.TEST_DIMS, b, seed=seed, n_accounts=64,
                                conflict_rate=conflict_rate)
    rk = np.array(jb.read_keys)
    wk = np.array(jb.write_keys)
    rk[rng.random(b) < 0.1, 1] = 0  # empty read slots
    wk[rng.random(b) < 0.1, 0] = 0  # empty write slots
    rv = rng.integers(0, 3, (b, 2)).astype(np.uint32)
    cur = np.where(rng.random((b, 2)) < 0.85, rv, rv + 1).astype(np.uint32)
    ok0 = rng.random(b) < 0.9
    return rk, rv, wk, cur, ok0


@pytest.mark.parametrize("b,conflict_rate", [(100, 0.5), (64, 0.0),
                                             (33, 0.9), (1, 0.0)])
def test_validate_matches_pallas_and_core(b, conflict_rate):
    rk, rv, wk, cur, ok0 = _mvcc_inputs(b, b, conflict_rate)
    got = mv_ops.validate(T(rk), T(rv), T(wk), T(cur), torch.from_numpy(ok0))
    pallas = jmvk.validate_blocks(
        *(jnp.asarray(a)[None] for a in (rk, rv, wk, cur, ok0)),
        interpret=True)[0]
    _eq(got, pallas)
    jb = jt.make_transfer_batch(jt.TEST_DIMS, b)._replace(
        read_keys=jnp.asarray(rk), read_vers=jnp.asarray(rv),
        write_keys=jnp.asarray(wk))
    core = jm.validate(jb, jnp.asarray(cur), checksum_ok=jnp.asarray(ok0))
    _eq(got, core.valid)
    tb = tt.make_transfer_batch(tt.TEST_DIMS, b, device="cpu")._replace(
        read_keys=T(rk), read_vers=T(rv), write_keys=T(wk))
    res = tm.validate(tb, T(cur), checksum_ok=torch.from_numpy(ok0))
    _eq(res.valid, core.valid)
    _eq(mv_ref.read_fresh(T(rk), T(rv), T(cur)), core.vers_ok)
    _eq(tm.conflict_matrix(tb), jm.conflict_matrix(jb))
    if b == 100:
        assert 0 < int(got.sum()) < b


def test_validate_sequential_reference_matches():
    """Fabric's literal per-tx walk, in both packages, against the scan."""
    jb = jt.make_transfer_batch(jt.TEST_DIMS, 60, seed=4, n_accounts=32,
                                conflict_rate=0.3)
    tb = tt.make_transfer_batch(tt.TEST_DIMS, 60, seed=4, n_accounts=32,
                                conflict_rate=0.3, device="cpu")
    keys, vers, vals = _table(9, 64, 8, 4, 100)
    st = tws.HashState(T(keys), T(vers), T(vals))
    ok = np.random.default_rng(3).random(60) < 0.9
    got = tm.validate_sequential_reference(tb, st,
                                           endorse_ok=torch.from_numpy(ok))
    want = jm.validate_sequential_reference(
        jb, _jax_state(st), endorse_ok=jnp.asarray(ok))
    _eq(got, want)
    cur = tws.lookup(st, tb.read_keys.reshape(-1, 2)).versions.reshape(60, -1)
    _eq(tm.validate(tb, cur, endorse_ok=torch.from_numpy(ok)).valid, want)


# -- wrappers -------------------------------------------------------------------

def test_wrappers_reject_bad_inputs():
    msg = T(_messages(0, 4, 3))
    rs, ss = (T(a) for a in _keys(0, 2))
    with pytest.raises(TypeError):
        mac_ops.mac_many(msg.long(), rs, ss)
    with pytest.raises(ValueError):
        mac_ops.mac_many(msg.t(), rs, ss)
    keys, vers, vals = (T(a) for a in _table(1, 16, 4, 2, 20))
    with pytest.raises(ValueError):
        ht_ops.lookup(keys, vers, vals, keys[:, 0].t())
    with pytest.raises(ValueError):
        ht_ops.lookup(keys[:12], vers[:12], vals[:12], keys[0])
    rk, rv, wk, cur, ok0 = (T(a) for a in _mvcc_inputs(0, 8, 0.0))
    with pytest.raises(TypeError):
        mv_ops.validate(rk, rv, wk, cur, ok0.to(u32.WORD))
    wkeys, wvals = keys[0], vals[0]
    with pytest.raises(TypeError):
        ht_ops.commit(keys, vers, vals, wkeys, wvals,
                      torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        ht_ops.commit(keys, vers, vals, wkeys, wvals[:, :1],
                      torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        ht_ops.commit(keys[:12], vers[:12], vals[:12], wkeys, wvals,
                      torch.ones(4, dtype=torch.bool))
    assert mac_ops.launches == ht_ops.launches == mv_ops.launches == 0
    assert ht_ops.commit_launches == 0
