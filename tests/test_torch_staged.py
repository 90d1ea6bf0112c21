"""The Fabric 1.2 baseline's pieces on the port, on the CPU, against the JAX
package on the same numpy inputs, bit-equal: the sorted store
(``sorted_lookup``, ``sorted_commit``, the WAL head, truncation at capacity,
and the reference's lost updates, which the port reproduces) and the staged
committer (``stage_*`` with serial, tiled and whole-block endorsement
checks, over the sorted store and the hash table)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import committer as jcm, types as jt
from repro.core import world_state as jws
from repro_torch.core import committer as tcm, crypto as tc, types as tt
from repro_torch.core import u32, unmarshal as tu
from repro_torch.core import world_state as tws

DEAD = 0xFFFFFFFF
# The JAX engine runs the sorted store inside its jitted commit stage.
_jax_sorted_commit = jax.jit(jws.sorted_commit)
_jax_sorted_lookup = jax.jit(jws.sorted_lookup)


def T(a):
    return u32.from_numpy(np.asarray(a), "cpu")


def _same_sorted(got: tws.SortedState, want: jws.SortedState):
    for name, g, w in zip(tws.SortedState._fields, got, want):
        np.testing.assert_array_equal(
            u32.to_numpy(g) if g.dtype == u32.WORD else g.numpy(),
            np.asarray(w), err_msg=name)


class _Pair:
    """One sorted store in each package, fed the same blocks."""

    def __init__(self, capacity, vw=2):
        self.t = tws.sorted_create(capacity, vw, "cpu")
        self.j = jws.sorted_create(capacity, vw)

    def commit(self, wk, wv, active):
        self.t = tws.sorted_commit(self.t, T(wk), T(wv),
                                   torch.from_numpy(np.asarray(active)))
        self.j = _jax_sorted_commit(self.j, jnp.asarray(wk), jnp.asarray(wv),
                                    jnp.asarray(active))
        _same_sorted(self.t, self.j)

    def lookup(self, keys):
        got = tws.sorted_lookup(self.t, T(keys))
        want = _jax_sorted_lookup(self.j, jnp.asarray(keys))
        for name, g, w in zip(tws.Lookup._fields, got, want):
            np.testing.assert_array_equal(
                u32.to_numpy(g) if g.dtype == u32.WORD else g.numpy(),
                np.asarray(w), err_msg=name)
        return got


def _block(rng, b, pool=None):
    """(B, 2, 2) write keys (from ``pool`` when given), (B, 2, 2) values."""
    if pool is None:
        wk = rng.integers(1, 1 << 32, (b, 2, 2), dtype=np.uint32)
    else:
        wk = pool[rng.integers(0, len(pool), (b, 2))]
    return wk, rng.integers(0, 1 << 32, (b, 2, 2), dtype=np.uint32)


def test_sorted_store_matches_jax_over_blocks():
    """Inserts, updates, duplicate and dead keys, a key with hi = DEAD,
    inactive writes, lookups, then truncation at capacity (count runs on
    past it, unclamped)."""
    rng = np.random.default_rng(0)
    p = _Pair(48)
    wk, wv = _block(rng, 10)
    wk[0, 0, 0] = DEAD  # never found: inserted again on every write
    wk[1, 1] = wk[1, 0]  # one key twice in a transaction
    wk[2, 1, 0] = 0  # empty key
    p.commit(wk, wv, np.ones(10, bool))
    pool = np.concatenate([wk.reshape(-1, 2), rng.integers(
        1, 1 << 32, (8, 2), dtype=np.uint32)])
    for _ in range(2):
        wk2, wv2 = _block(rng, 8, pool)
        wk2[0, 0] = (DEAD, pool[0, 1])
        p.commit(wk2, wv2, rng.random(8) < 0.7)
    qs = np.concatenate([pool, np.array(
        [(0, 5), (DEAD, DEAD), (DEAD, pool[0, 1])], np.uint32)])
    found = p.lookup(qs)
    assert 0 < int(found.found.sum()) < len(qs)
    # Overfill: 40 new keys into a store that holds 48.
    wk3, wv3 = _block(rng, 20)
    p.commit(wk3, wv3, np.ones(20, bool))
    assert int(p.t.count) > p.t.capacity
    p.lookup(np.concatenate([qs, wk3.reshape(-1, 2)]))


HI = 0xF0000000  # the transactions' second keys: new, sorting after the rest


def _stored_pair(keys):
    """A store holding ``keys`` at version 1 (one write each)."""
    p = _Pair(16)
    k = len(keys)
    p.commit(np.asarray(keys, np.uint32).reshape(k, 1, 2)
             .repeat(2, axis=1) * np.array([1, 0], np.uint32)[None, :, None],
             np.zeros((k, 2, 2), np.uint32), np.ones(k, bool))
    return p


@pytest.mark.parametrize("valid,version", [((True, False), 1),
                                           ((False, True), 2)])
def test_sorted_commit_last_write_at_a_slot_decides(valid, version):
    """Two transactions write key (5, 7), stored at version 1, one valid
    and one not: the reference's scatter lets the later write decide, so
    valid-then-invalid loses the update (version stays 1)."""
    p = _stored_pair([(5, 7)])
    wk = np.array([[(5, 7), (HI, 1)], [(5, 7), (HI, 2)]], np.uint32)
    wv = np.full((2, 2, 2), 9, np.uint32)
    p.commit(wk, wv, np.array(valid))
    look = p.lookup(np.array([(5, 7)], np.uint32))
    assert int(look.versions[0]) == version


def test_sorted_commit_insert_clobbers_update_at_its_slot():
    """A new key B between stored keys A < C has C's slot as insertion
    point; a later write of B carries C's pre-block contents there, so C's
    update in the same block is lost."""
    p = _stored_pair([(3, 1), (9, 1)])
    wk = np.array([[(9, 1), (HI, 1)], [(6, 1), (HI, 2)]], np.uint32)
    wv = np.full((2, 2, 2), 4, np.uint32)
    p.commit(wk, wv, np.array([True, True]))
    look = p.lookup(np.array([(3, 1), (6, 1), (9, 1)], np.uint32))
    assert [int(v) for v in look.versions] == [1, 1, 1]
    assert int(p.t.count) == 5


# -- the staged committer ----------------------------------------------------------

B = 50


def _wires(dims):
    """Three endorsed blocks of B txs, as the port's wire: disjoint inserts,
    then transfers among 40 accounts (conflicts, stale reads, src == dst),
    with a few bad tags and a corrupted checksum."""
    out = []
    for i, rate in enumerate((0.0, 0.3, 0.6)):
        tb = tt.make_transfer_batch(dims, B, seed=i, n_accounts=40,
                                    conflict_rate=rate, device="cpu")
        tags = tc.endorse_batch(tb)
        tags[3 * i + 1, 0] ^= 1
        wire = tu.marshal(tb._replace(endorse_tags=tags), dims)
        wire[5 + i, -1] ^= 0xFF
        out.append(wire)
    return out


@pytest.mark.parametrize("peer", [
    "FABRIC_V12_PEER",
    "OPT_P1",
    dataclasses.replace(jcm.OPT_P2, tx_par=16),
])
def test_commit_block_staged_matches_jax(peer):
    """commit_block with cache=False: the three stages, each decoding the
    wire, over three blocks; valid bits, block hashes, heads, overflow and
    the world state (hash table, or sorted store with its WAL head)."""
    jpeer = getattr(jcm, peer) if isinstance(peer, str) else peer
    tpeer = tcm.PeerConfig(**{f.name: getattr(jpeer, f.name)
                              for f in dataclasses.fields(tcm.PeerConfig)})
    assert not tpeer.cache
    dims = tt.TEST_DIMS
    ts = tcm.create_peer_state(dims, n_buckets=32, slots=4,
                               hash_state=tpeer.hash_state, device="cpu")
    js = jcm.create_peer_state(jt.TEST_DIMS, n_buckets=32, slots=4)
    n_valid = []
    for wire in _wires(dims):
        got = tcm.commit_block(ts, wire, dims, tpeer)
        want = jcm.commit_block(js, jnp.asarray(wire.numpy()), jt.TEST_DIMS,
                                jpeer)
        ts, js = got.state, want.state
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(u32.to_numpy(got.block_hash),
                                      np.asarray(want.block_hash))
        assert bool(got.overflow) == bool(want.overflow)
        for name in ("ledger_head", "block_no", "journal_head"):
            np.testing.assert_array_equal(
                u32.to_numpy(getattr(ts, name)), np.asarray(getattr(js, name)),
                err_msg=name)
        if tpeer.hash_state:
            for g, w in zip(ts.hash_state, js.hash_state):
                np.testing.assert_array_equal(u32.to_numpy(g), np.asarray(w))
            assert ts.sorted_state is None
        else:
            _same_sorted(ts.sorted_state, js.sorted_state)
            assert not tws.occupancy(ts.hash_state)
        n_valid.append(int(got.valid.sum()))
    assert 0 < n_valid[2] < n_valid[0] < B


def test_endorsement_checks_serial_tiled_whole_agree():
    """The three endorsement paths (the whole block at once, tiles of
    ``tx_par`` in order, one transaction a step in order) give the same
    bits, with three corrupted tags found by each."""
    dims = tt.TEST_DIMS
    tb = tt.make_transfer_batch(dims, 37, seed=4, device="cpu")
    tags = tc.endorse_batch(tb)
    tags[[2, 17, 36], 1] ^= 1
    tb = tb._replace(endorse_tags=tags)
    whole = tcm._verify_endorsements(tb, True, 0)
    assert int((~whole).sum()) == 3
    for parallel, tx_par in ((False, 0), (False, 16), (True, 16), (True, 5)):
        np.testing.assert_array_equal(
            tcm._verify_endorsements(tb, parallel, tx_par).numpy(),
            whole.numpy())
