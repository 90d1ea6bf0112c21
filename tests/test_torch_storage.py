"""The port's storage layer (journal, snapshots, recovery, the block store's
durability half, the world state's shard and resize helpers) on the CPU,
against the JAX package on the same numpy inputs, bit for bit through
``np.uint32`` views; the files each package writes load in the other."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ledger as jl, types as jt, unmarshal as ju
from repro.core import world_state as jws
from repro.storage import journal as jj, recovery as jr, snapshot as js
from repro_torch import convert
from repro_torch.core import ledger as tl, types as tt, u32
from repro_torch.core import world_state as tws
from repro_torch.storage import journal as tj, recovery as tr, snapshot as ts

DIMS = jt.TEST_DIMS
TDIMS = tt.TEST_DIMS
NB, SLOTS = 64, 4


def _blocks(n_blocks, batch=8, seed=0):
    """Random write sets: (write_keys, write_vals, valid) u32/bool arrays."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 1 << 30, (batch, DIMS.wk, 2), dtype=np.uint32),
             rng.integers(0, 1 << 30, (batch, DIMS.wk, DIMS.vw),
                          dtype=np.uint32),
             rng.integers(0, 2, batch).astype(bool))
            for _ in range(n_blocks)]


def _journals(blocks, jdir=None, tdir=None):
    jj_ = jj.StateJournal(DIMS, spill_dir=jdir)
    tj_ = tj.StateJournal(TDIMS, spill_dir=tdir)
    for b, (wk, wv, ok) in enumerate(blocks):
        jj_.append_writes(b, jnp.asarray(wk), jnp.asarray(wv),
                          jnp.asarray(ok))
        tj_.append_writes(b, u32.from_numpy(wk), u32.from_numpy(wv),
                          torch.from_numpy(ok))
    return jj_, tj_


def _same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.block_no == y.block_no
        for f in ("write_keys", "write_vals", "valid", "prev_head", "head"):
            u, v = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
            assert u.dtype == v.dtype and np.array_equal(u, v), f


def _same_npz_dirs(da, db):
    """Same file names; in each file the same keys, dtypes and arrays."""
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db))
    for name in names:
        with np.load(os.path.join(da, name)) as za, \
                np.load(os.path.join(db, name)) as zb:
            assert sorted(za.files) == sorted(zb.files), name
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (name, k)
                assert np.array_equal(za[k], zb[k]), (name, k)
    return names


def _populated(n_buckets=NB, slots=SLOTS, n=40, seed=7):
    """A table filled by the JAX commit, as numpy (keys, versions, values)."""
    st = jws.create(n_buckets, slots, DIMS.vw)
    rng = np.random.default_rng(seed)
    wk = rng.integers(1, 1 << 31, (n, 1, 2), dtype=np.uint32)
    wv = rng.integers(0, 1 << 31, (n, 1, DIMS.vw), dtype=np.uint32)
    st = jws.commit_vectorized(st, jnp.asarray(wk), jnp.asarray(wv),
                               jnp.ones(n, bool)).state
    return tuple(np.asarray(a) for a in st)


def _jstate(arrays):
    return jws.HashState(*(jnp.asarray(a) for a in arrays))


def _tstate(arrays):
    return convert.hash_state(*arrays, "cpu")


def _same_state(jst, tst):
    for a, t in zip(jst, tst):
        assert np.array_equal(np.asarray(a), u32.to_numpy(t))


# -- journal -------------------------------------------------------------------


def test_journal_records_heads_and_spill_match(tmp_path):
    """Appends give identical records and heads, the commit-path head
    update agrees, and the spilled files match name for name."""
    blocks = _blocks(4)
    jd, td = tmp_path / "jax", tmp_path / "torch"
    jjr, tjr = _journals(blocks, str(jd), str(td))
    _same_records(jjr.records, tjr.records)
    assert np.array_equal(jjr.head, tjr.head)
    wk, wv, ok = blocks[2]
    want = jj.journal_head_update(
        jnp.asarray(jjr.records[1].head), jnp.uint32(2), jnp.asarray(wk),
        jnp.asarray(wv), jnp.asarray(ok))
    got = tj.journal_head_update(
        u32.from_numpy(tjr.records[1].head), 2, u32.from_numpy(wk),
        u32.from_numpy(wv), torch.from_numpy(ok))
    assert np.array_equal(np.asarray(want), u32.to_numpy(got))
    assert _same_npz_dirs(jd, td) == [f"journal_{b:08d}.npz"
                                      for b in range(4)]
    assert tjr.verify_chain() and jjr.verify_chain()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_cold_load_across_packages(tmp_path, writer):
    jjr, tjr = _journals(_blocks(3, seed=3), str(tmp_path / "jax"),
                         str(tmp_path / "torch"))
    # Each package loads the other's spill.
    src = str(tmp_path / writer)
    loaded_j = jj.StateJournal.load(DIMS, src)
    loaded_t = tj.StateJournal.load(TDIMS, src)
    _same_records(loaded_j.records, loaded_t.records)
    _same_records(loaded_t.records, tjr.records)
    assert loaded_j.verify_chain() and loaded_t.verify_chain()
    assert np.array_equal(loaded_t.head, jjr.head)
    assert (loaded_t.base_block_no, loaded_j.base_block_no) == (-1, -1)


@pytest.mark.parametrize("field", ["write_keys", "write_vals", "valid",
                                   "prev_head", "missing"])
def test_journal_verify_reason_matches(field):
    jjr, tjr = _journals(_blocks(4))
    for j in (jjr, tjr):
        if field == "missing":
            del j.records[1]
            continue
        rec = j.records[2]
        arr = np.array(getattr(rec, field))
        arr.flat[0] = (not arr.flat[0]) if field == "valid" else \
            arr.flat[0] ^ 1
        j.records[2] = rec._replace(**{field: arr})
    want = jjr.verify_chain_reason()
    assert want[0] is False and tjr.verify_chain_reason() == want
    assert tjr.verify_chain() is False


def test_journal_prune_upto_matches(tmp_path):
    jjr, tjr = _journals(_blocks(5), str(tmp_path / "jax"),
                         str(tmp_path / "torch"))
    assert jjr.prune_upto(2) == tjr.prune_upto(2) == 3
    assert tjr.base_block_no == jjr.base_block_no == 2
    assert np.array_equal(tjr.base_head, jjr.base_head)
    _same_records(jjr.records, tjr.records)
    assert tjr.verify_chain()
    assert _same_npz_dirs(tmp_path / "jax", tmp_path / "torch") == [
        "journal_00000003.npz", "journal_00000004.npz"]
    reloaded = tj.StateJournal.load(TDIMS, str(tmp_path / "jax"))
    assert reloaded.base_block_no == 2 and reloaded.verify_chain()


def test_journal_replay_matches_direct_commits():
    blocks = _blocks(3, batch=12, seed=5)
    jjr, tjr = _journals(blocks)
    direct = _tstate((np.zeros((256, 8, 2), np.uint32),
                      np.zeros((256, 8), np.uint32),
                      np.zeros((256, 8, DIMS.vw), np.uint32)))
    for wk, wv, ok in blocks:
        tws.commit_vectorized(direct, u32.from_numpy(wk), u32.from_numpy(wv),
                              torch.from_numpy(ok))
    rep = tjr.replay(tws.create(256, 8, DIMS.vw, device="cpu"))
    want = jjr.replay(jws.create(256, 8, DIMS.vw))
    _same_state(want.state, rep.state)
    _same_state(want.state, direct)
    assert rep.overflow is want.overflow is False


def test_journal_replay_crosses_jax_reanchor(tmp_path):
    """A journal the JAX package wrote across a resize epoch (a grow after
    block 1, a shrink at the tip) loads and replays in the port onto the
    final layout, each rebuilt table held against its record's tree
    head."""
    blocks = _blocks(3, batch=6, seed=11)
    jjr = jj.StateJournal(DIMS, spill_dir=str(tmp_path))
    st = jws.create(16, SLOTS, DIMS.vw)
    for b, (wk, wv, ok) in enumerate(blocks):
        jjr.append_writes(b, jnp.asarray(wk), jnp.asarray(wv),
                          jnp.asarray(ok))
        st = jws.commit_vectorized(st, jnp.asarray(wk), jnp.asarray(wv),
                                   jnp.asarray(ok)).state
        if b in (1, 2):
            old_nb, new_nb = st.n_buckets, (32 if b == 1 else 16)
            st = jws.resize(st, new_nb).state
            jjr.append_reanchor(
                b, old_n_buckets=old_nb, new_n_buckets=new_nb, n_shards=2,
                tree_head=jws.tree_head(st, 2), overflow_bits=b - 1)
    loaded = tj.StateJournal.load(TDIMS, str(tmp_path))
    assert len(loaded.reanchors) == 2 and loaded.verify_chain()
    for rec in loaded.reanchors:
        assert np.array_equal(rec.head, tj.reanchor_head_update(
            rec.prev_reanchor, rec.prev_head, rec.block_no,
            rec.old_n_buckets, rec.new_n_buckets, rec.n_shards,
            rec.tree_head, rec.overflow_bits))
    rep = loaded.replay(tws.create(16, SLOTS, DIMS.vw, device="cpu"),
                        check_reanchors=True)
    want = jjr.replay(jws.create(16, SLOTS, DIMS.vw), check_reanchors=True)
    _same_state(want.state, rep.state)
    _same_state(st, rep.state)
    assert rep.overflow == want.overflow
    # A re-anchor record tampered on disk fails both chains the same way.
    bad = loaded.reanchors[0]._replace(overflow_bits=7)
    for j in (loaded, jjr):
        j.reanchors[0] = bad
    assert loaded.verify_chain_reason() == jjr.verify_chain_reason()
    assert loaded.verify_chain() is False


# -- world state: shards, digest tree, resize --------------------------------


@pytest.mark.parametrize("n_shards", [1, 4])
def test_split_merge_and_digest_tree(n_shards):
    arrays = _populated()
    jst, tst = _jstate(arrays), _tstate(arrays)
    jparts = jws.split_table(*jst, n_shards)
    tparts = tws.split_table(*tst, n_shards)
    for a, t in zip(jparts, tparts):
        assert np.array_equal(np.asarray(a), u32.to_numpy(t))
    for a, t in zip(arrays, tws.merge_table(*tparts)):
        assert np.array_equal(a, u32.to_numpy(t))
    assert np.array_equal(np.asarray(jws.tree_head(jst, n_shards)),
                          u32.to_numpy(tws.tree_head(tst, n_shards)))
    keys = jst.keys.reshape(-1, 2)
    assert np.array_equal(
        np.asarray(jws.shard_of(NB, n_shards, keys)),
        tws.shard_of(NB, n_shards, tst.keys.reshape(-1, 2)).numpy())
    # The tree over an odd count repeats the last digest.
    digests = np.random.default_rng(n_shards).integers(
        0, 1 << 32, (3 * n_shards, 2), dtype=np.uint32)
    assert np.array_equal(
        np.asarray(jws.shard_digest_tree(jnp.asarray(digests))),
        u32.to_numpy(tws.shard_digest_tree(u32.from_numpy(digests))))
    assert tws.shard_buckets(NB, n_shards) == jws.shard_buckets(NB, n_shards)


@pytest.mark.parametrize("new_nb, n, lossy", [(128, 150, False),
                                              (32, 20, False),
                                              (16, 150, True)])
def test_resize_matches(new_nb, n, lossy):
    """A grow, a shrink that fits, and a lossy shrink: the same arrays and
    the same overflow flag."""
    arrays = _populated(n=n, seed=new_nb)
    want = jws.resize(_jstate(arrays), new_nb)
    got = tws.resize(_tstate(arrays), new_nb)
    _same_state(want.state, got.state)
    assert bool(want.overflow) is bool(got.overflow) is lossy


# -- snapshots -----------------------------------------------------------------


def _same_manifest(a, b):
    for f in a._fields:
        u, v = getattr(a, f), getattr(b, f)
        if isinstance(u, np.ndarray):
            assert u.dtype == np.asarray(v).dtype and np.array_equal(u, v), f
        else:
            assert u == v, f


@pytest.mark.parametrize("n_shards", [1, 4])
def test_snapshot_take_save_load_across_packages(tmp_path, n_shards):
    arrays = _populated(n=50)
    heads = dict(block_no=5, journal_head=np.array([3, 4], np.uint32),
                 ledger_head=np.array([1 << 31, 9], np.uint32),
                 n_shards=n_shards, overflow_bits=0b10)
    jsn = js.take(_jstate(arrays), **heads,
                  reanchor_head=np.array([7, 8], np.uint32))
    tsn = ts.take(_tstate(arrays), **heads,
                  reanchor_head=np.array([7, 8], np.uint32))
    _same_manifest(jsn.manifest, tsn.manifest)
    for a, b in zip(jsn.shards, tsn.shards):
        assert a.shard == b.shard
        for f in ("keys", "versions", "values"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    js.save(str(tmp_path / "jax"), jsn)
    ts.save(str(tmp_path / "torch"), tsn)
    _same_npz_dirs(tmp_path / "jax", tmp_path / "torch")
    for writer in ("jax", "torch"):
        d = str(tmp_path / writer)
        lt, lj = ts.load(d), js.load(d)
        _same_manifest(lj.manifest, lt.manifest)
        assert ts.verify(lt, "cpu") and js.verify(lj)
        _same_state(js.to_state(lj), ts.to_state(lt, "cpu"))
        _same_state(_jstate(arrays), ts.to_state(lt, "cpu"))


def test_snapshot_tamper_foreign_files_and_gc(tmp_path):
    arrays = _populated()
    for b in (2, 5, 9):
        snap = ts.take(_tstate(arrays), block_no=b,
                       journal_head=np.zeros(2, np.uint32),
                       ledger_head=np.zeros(2, np.uint32), n_shards=2)
        ts.save(str(tmp_path), snap)
    # Foreign and torn files are ignored by both packages' listings.
    (tmp_path / "notes.txt").write_text("x")
    (tmp_path / "manifest_12.npz").write_bytes(b"junk")
    (tmp_path / "manifest_00000011.npz").write_bytes(b"torn")
    os.remove(ts.shard_path_for(str(tmp_path), 9, 1))
    assert ts.list_blocks(str(tmp_path)) == js.list_blocks(str(tmp_path)) \
        == [2, 5]
    assert ts.latest_manifest(str(tmp_path)).block_no == 5
    # A tampered shard: both verifications fail, both recoveries raise.
    loaded = ts.load(str(tmp_path), 5)
    part = loaded.shards[1]
    bad = loaded._replace(shards=(loaded.shards[0], part._replace(
        versions=part.versions + np.uint32(1))))
    assert not ts.verify_shard(bad.manifest, bad.shards[1], "cpu")
    assert not ts.verify(bad, "cpu") and not js.verify(bad)
    with pytest.raises(tr.RecoveryError, match="mismatch"):
        tr.recover(tj.StateJournal(TDIMS), snapshot=bad, n_buckets=NB,
                   slots=SLOTS, value_width=DIMS.vw, device="cpu")
    with pytest.raises(jr.RecoveryError, match="mismatch"):
        jr.recover(jj.StateJournal(DIMS), snapshot=bad, n_buckets=NB,
                   slots=SLOTS, value_width=DIMS.vw)
    # gc drops a manifest with its shards (and the orphaned shard of the
    # torn block 9), keeps foreign files: the same listing as JAX's gc.
    twin = tmp_path / "twin"
    twin.mkdir()
    for name in os.listdir(tmp_path):
        if name != "twin":
            (twin / name).write_bytes((tmp_path / name).read_bytes())
    ts.gc(str(tmp_path), keep=1)
    js.gc(str(twin), keep=1)
    left = sorted(n for n in os.listdir(tmp_path) if n != "twin")
    assert left == sorted(os.listdir(twin))
    assert "manifest_00000002.npz" not in left
    assert not any(n.startswith("shard_00000002") for n in left)
    assert "notes.txt" in left and ts.list_blocks(str(tmp_path)) == [5]


# -- recovery ------------------------------------------------------------------


@pytest.mark.parametrize("from_snapshot", [False, True])
def test_recover_matches(from_snapshot):
    """Recovery from genesis and from a snapshot + journal suffix gives the
    JAX package's result, field for field."""
    blocks = _blocks(5, batch=10, seed=21)
    jjr, tjr = _journals(blocks)
    jsn = tsn = None
    if from_snapshot:
        st = jws.create(NB, SLOTS, DIMS.vw)
        for wk, wv, ok in blocks[:3]:
            st = jws.commit_vectorized(st, jnp.asarray(wk), jnp.asarray(wv),
                                       jnp.asarray(ok)).state
        kw = dict(block_no=2, journal_head=jjr.records[2].head,
                  ledger_head=np.array([5, 6], np.uint32), n_shards=2,
                  overflow_bits=0b100)
        jsn = js.take(st, **kw)
        tsn = ts.take(_tstate(tuple(np.asarray(a) for a in st)), **kw)
    layout = dict(n_buckets=NB, slots=SLOTS, value_width=DIMS.vw)
    want = jr.recover(jjr, snapshot=jsn, **layout)
    got = tr.recover(tjr, snapshot=tsn, device="cpu", **layout)
    _same_state(want.state, got.state)
    for f in want._fields[1:]:
        u, v = getattr(want, f), getattr(got, f)
        assert np.array_equal(np.asarray(u), np.asarray(v)), f
    assert got.replayed_records == (2 if from_snapshot else 5)


def test_recover_refuses_overpruned_journal():
    jjr, tjr = _journals(_blocks(3))
    for j in (jjr, tjr):
        j.prune_upto(2)
    layout = dict(n_buckets=NB, slots=SLOTS, value_width=DIMS.vw)
    with pytest.raises(jr.RecoveryError, match="pruned"):
        jr.recover(jjr, **layout)
    with pytest.raises(tr.RecoveryError, match="pruned"):
        tr.recover(tjr, device="cpu", **layout)


# -- block store -----------------------------------------------------------------


def _chain_blocks(n_blocks=4, batch=8):
    """Consistently hash-chained (block_no, prev, hash, wire, valid), numpy,
    made by the JAX package."""
    prev = jnp.zeros((2,), jnp.uint32)
    out = []
    for b in range(n_blocks):
        wire = ju.marshal(jt.make_transfer_batch(DIMS, batch, seed=60 + b),
                          DIMS)
        valid = jnp.asarray(np.arange(batch) % 3 != 1)
        bh = jl.append_hash(prev, jnp.uint32(b),
                            jl.block_body_digest(wire, valid))
        out.append((b, np.asarray(prev), np.asarray(bh), np.asarray(wire),
                    np.asarray(valid)))
        prev = bh
    return out


class _FlakyJournal:
    def __init__(self):
        self.blocks = []
        self.fail_once = True

    def append_block(self, bno, wire, valid):
        if bno == 1 and self.fail_once:
            self.fail_once = False
            raise RuntimeError("disk full")
        self.blocks.append(bno)


def test_blockstore_spill_failstop_resume_and_load(tmp_path):
    """Spill files as the JAX store writes them; a failed journal append
    fail-stops the writer and un-spills its block in both packages;
    ``resume`` resubmits gap-free; ``load_spilled_blocks`` and pruning
    agree."""
    blocks = _chain_blocks()
    logs = {}
    for name, mod in (("jax", jl), ("torch", tl)):
        d = tmp_path / name
        d.mkdir()
        j = _FlakyJournal()
        store = mod.BlockStore(str(d), journal=j)
        for b in blocks:
            store.submit(*b)
        with pytest.raises(RuntimeError, match="disk full"):
            store.drain()
        assert os.listdir(d) == ["block_00000000.npz"]
        assert store.resume() == 1
        for b in blocks[1:]:
            store.submit(*b)
        store.drain()
        assert [sb.block_no for sb in store.chain] == [0, 1, 2, 3]
        assert store.verify_chain()
        assert store.prune_upto(1) == 2 and store.verify_chain()
        assert store.resume() == 4
        logs[name] = (j.blocks, store.base_block_no,
                      np.asarray(store.base_hash))
        store.close()
    assert logs["jax"][:2] == logs["torch"][:2] == ([0, 1, 2, 3], 1)
    assert np.array_equal(logs["jax"][2], logs["torch"][2])
    _same_npz_dirs(tmp_path / "jax", tmp_path / "torch")
    want = jl.load_spilled_blocks(str(tmp_path / "jax"), 2)
    got = tl.load_spilled_blocks(str(tmp_path / "torch"), 2)
    assert [sb.block_no for sb in got] == [sb.block_no for sb in want] \
        == [2, 3]
    for a, b in zip(want, got):
        for u, v in zip(a[1:], b[1:]):
            assert np.array_equal(u, v)
        assert np.array_equal(tl.chained_hash(b.prev_hash, b), b.block_hash)
    # A chain replay from the pruned base needs the covering state: the
    # port's from a start state equals the JAX package's.
    start = _populated(n_buckets=256, slots=8, n=30)
    want_st = jl.BlockStore()
    got_st = tl.BlockStore()
    for b in blocks:
        want_st.submit(*b)
        got_st.submit(*b)
    want_st.drain()
    got_st.drain()
    _same_state(
        want_st.replay_state(DIMS, 256, 8, start_state=_jstate(start),
                             resize_at={1: 512}),
        got_st.replay_state(TDIMS, 256, 8, start_state=_tstate(start),
                            resize_at={1: 512}, device="cpu"))
    want_st.close()
    got_st.close()
