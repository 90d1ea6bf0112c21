"""The port's durable engine (block spill, state journal, snapshots, pruning,
recover, restore, verify's recovery proof) on the CPU, against the JAX
engine on the same proposals: the files both write, the heads, the stores
and the ``verify()`` verdicts are equal, and each restores from the other's
directories. The JAX engines run once for the module."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro.core import committer as jcm, engine as jeng
from repro.core import world_state as jws
from repro.storage import recovery as jr, snapshot as js
from repro_torch.core import committer as tcm, engine as teng, u32
from repro_torch.core import world_state as tws
from repro_torch.storage import journal as tj, recovery as tr, snapshot as ts

ROUNDS = (150,) * 5  # blocks of 50: 15 blocks, snapshots at 5 and 11
ALL_TRUE = {"chain_ok": True, "replica_ok": True, "replay_ok": True,
            "recovery_ok": True, "overflow_ok": True}
DIRS = ("snap", "jrnl", "blocks")


def _cfg(mod, root, peer="fastfabric", every=4):
    base = mod.FASTFABRIC
    if peer == "p1":  # P-I behind the Fabric 1.2 orderer
        base = dataclasses.replace(
            mod.FABRIC_V12,
            peer=(jcm if mod is jeng else tcm).OPT_P1)
    return dataclasses.replace(
        base, n_buckets=1 << 10,
        orderer=dataclasses.replace(base.orderer, block_size=50),
        snapshot_every_blocks=every, snapshot_dir=os.path.join(root, "snap"),
        journal_dir=os.path.join(root, "jrnl"),
        block_dir=os.path.join(root, "blocks"))


def _run(eng, rounds=ROUNDS, seed0=0):
    for i, n in enumerate(rounds):
        eng.run_round(eng.make_proposals(n, seed=seed0 + i))
    eng.store.drain()
    return eng


def _view(eng):
    """Heads, digests, store and journal of an engine, as numpy."""
    jax_side = isinstance(eng, jeng.FabricEngine)
    word = (lambda a: np.asarray(a)) if jax_side else u32.to_numpy
    digest = jws.state_digest if jax_side else tws.state_digest
    ps = eng.peer_state
    return dict(
        digest=word(digest(ps.hash_state)),
        replica=word(digest(eng.endorser_state)),
        journal_head=word(ps.journal_head),
        ledger_head=word(ps.ledger_head),
        block_no=int(word(ps.block_no)),
        next_block_no=(eng._next_block_no if jax_side
                       else eng.next_block_no),
        overflow_bits=eng.overflow_bits(),
        base=(eng.store.base_block_no, np.asarray(eng.store.base_hash)),
        chain=[(sb.block_no, np.asarray(sb.prev_hash),
                np.asarray(sb.block_hash), np.asarray(sb.valid))
               for sb in eng.store.chain],
        journal=(eng.journal.base_block_no, np.asarray(eng.journal.head),
                 [r.block_no for r in eng.journal.records]),
    )


def _same(a, b, skip=()):
    for k in a:
        if k in skip:
            continue
        u, v = a[k], b[k]
        if k == "chain":
            assert [x[0] for x in u] == [y[0] for y in v]
            for x, y in zip(u, v):
                assert all(np.array_equal(p, q) for p, q in zip(x, y)), x[0]
        elif k in ("base", "journal"):
            assert u[0] == v[0] and np.array_equal(u[1], v[1]), k
            assert u[2:] == v[2:], k
        else:
            assert np.array_equal(u, v), k


def _same_npz_dirs(da, db):
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


def _copy(root, dst):
    shutil.copytree(root, dst)
    return str(dst)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The durable FASTFABRIC and P-I engines of both packages, each over
    the same rounds into its own directories."""
    out = {}
    for peer, rounds, every in (("fastfabric", ROUNDS, 4),
                                ("p1", (100,) * 5, 3)):
        root = tmp_path_factory.mktemp(peer)
        for name, mod, kw in (("jax", jeng, {}),
                              ("torch", teng, {"device": "cpu"})):
            d = str(root / name)
            eng = mod.FabricEngine(_cfg(mod, d, peer, every), **kw)
            out[peer, name] = (_run(eng, rounds), d)
    yield out
    for eng, _ in out.values():
        eng.store.close()


@pytest.mark.parametrize("peer", ["fastfabric", "p1"])
def test_durable_rounds_match_jax(runs, peer):
    """Manifests, journal records and spilled blocks on disk, the live
    heads, the pruned store and journal, and verify() all equal."""
    (je, jd), (te, td) = runs[peer, "jax"], runs[peer, "torch"]
    _same(_view(je), _view(te))
    names = {d: _same_npz_dirs(os.path.join(jd, d), os.path.join(td, d))
             for d in DIRS}
    assert te.store.base_block_no >= 0  # the chain was pruned
    assert te.store.base_block_no == te.snapshots[-2].block_no
    assert len(names["snap"]) == 4  # two snapshots kept, one shard each
    assert te.snapshots[-1].block_no < te.next_block_no - 1  # trails the tip
    assert je.verify() == te.verify() == ALL_TRUE
    want, got = je.recover(), te.recover()
    assert (got.snapshot_block_no, got.replayed_records, got.block_no) == (
        want.snapshot_block_no, want.replayed_records, want.block_no)
    assert np.array_equal(got.state_digest, want.state_digest)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restore_across_packages(runs, tmp_path, writer):
    """Each package restores from the other's directories (a snapshot that
    trails the tip, its ledger head rebuilt from the block spill) to the
    live engine's heads, then both go on identically for a round."""
    live, d = runs["fastfabric", writer]
    a, b = _copy(d, tmp_path / "a"), _copy(d, tmp_path / "b")
    rj = jeng.FabricEngine.restore(_cfg(jeng, a))
    rt = teng.FabricEngine.restore(_cfg(teng, b), device="cpu")
    want = _view(live)
    # The reference's restore leaves the orderer's log head at genesis and
    # seeds the store with the suffix past the snapshot only.
    _same(want, _view(rt), skip=("chain", "base", "journal"))
    _same(_view(rj), _view(rt))
    assert rt.store.base_block_no == rt.snapshots[-1].block_no == 11
    assert [sb.block_no for sb in rt.store.chain] == [12, 13, 14]
    assert not u32.to_numpy(rt.log_head).any()
    assert rj.verify() == rt.verify() == ALL_TRUE
    for e in (rj, rt):
        e.run_round(e.make_proposals(100, seed=9))
        e.store.drain()
    _same(_view(rj), _view(rt))
    for sub in DIRS:
        _same_npz_dirs(os.path.join(a, sub), os.path.join(b, sub))
    assert rj.verify() == rt.verify() == ALL_TRUE
    rj.store.close()
    rt.store.close()


def _tamper_npz(path, key, index=None):
    """Flip one bit of ``key`` at ``index``, or of the first occupied
    slot's first value word (an empty slot's words are not digested)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    if index is None:
        index = (*np.argwhere(arrays["keys"][..., 0] != 0)[0], 0)
    arr = arrays[key].copy()
    arr[index] ^= 1
    arrays[key] = arr
    np.savez(path, **arrays)


@pytest.mark.parametrize("what", ["journal", "snapshot", "spilled_block",
                                  "no_block_dir"])
def test_restore_refuses_tampered_or_missing_files(runs, tmp_path, what):
    """A flipped word in the newest journal record or in the snapshot
    shard, a flipped hash in a spilled block of the trailing suffix, or no
    block spill: both packages' restore raise RecoveryError."""
    _, d = runs["fastfabric", "torch"]
    roots = {}
    for name in ("jax", "torch"):
        root = _copy(d, tmp_path / name)
        if what == "journal":
            _tamper_npz(os.path.join(root, "jrnl", "journal_00000014.npz"),
                        "write_vals", (0, 0, 0))
        elif what == "snapshot":
            _tamper_npz(ts.shard_path_for(os.path.join(root, "snap"), 11, 0),
                        "values")
        elif what == "spilled_block":
            _tamper_npz(os.path.join(root, "blocks", "block_00000013.npz"),
                        "block_hash", (0,))
        roots[name] = root
    match = {"journal": "authenticate", "snapshot": "mismatch",
             "spilled_block": "spilled block", "no_block_dir": "block spill"}
    cfgs = {name: _cfg(mod, roots[name]) for name, mod in
            (("jax", jeng), ("torch", teng))}
    if what == "no_block_dir":
        cfgs = {k: dataclasses.replace(c, block_dir=None)
                for k, c in cfgs.items()}
    with pytest.raises(jr.RecoveryError, match=match[what]):
        jeng.FabricEngine.restore(cfgs["jax"])
    with pytest.raises(tr.RecoveryError, match=match[what]):
        teng.FabricEngine.restore(cfgs["torch"], device="cpu")


def test_tampered_journal_flips_recovery_ok(runs):
    """A record of the live journal's suffix, tampered in memory, makes
    recover() raise and verify() report recovery_ok False in both; a
    tampered in-memory snapshot does too."""
    verdicts = {}
    for name in ("jax", "torch"):
        eng, _ = runs["fastfabric", name]
        err = jr.RecoveryError if name == "jax" else tr.RecoveryError
        rec = eng.journal.records[-1]
        vals = np.array(rec.write_vals)
        vals[0, 0, 0] ^= 1
        eng.journal.records[-1] = rec._replace(write_vals=vals)
        try:
            with pytest.raises(err, match="authenticate"):
                eng.recover()
            verdicts[name, "journal"] = eng.verify()
        finally:
            eng.journal.records[-1] = rec
        snap = eng.snapshots[-1]
        part = snap.shards[0]
        keys = np.array(part.keys)
        keys[0, 0, 0] ^= 1
        eng.snapshots[-1] = snap._replace(
            shards=(part._replace(keys=keys),) + snap.shards[1:])
        try:
            with pytest.raises(err, match="mismatch"):
                eng.recover()
            verdicts[name, "snapshot"] = eng.verify()
        finally:
            eng.snapshots[-1] = snap
        assert eng.verify() == ALL_TRUE
    for kind in ("journal", "snapshot"):
        want = dict(ALL_TRUE, recovery_ok=False)
        assert verdicts["jax", kind] == verdicts["torch", kind] == want


def test_lost_snapshot_list_reports_false(runs):
    """A pruned chain whose covering snapshot is gone fails chain_ok,
    replay_ok and recovery_ok in both, without raising."""
    verdicts = []
    for name in ("jax", "torch"):
        eng, _ = runs["fastfabric", name]
        kept = list(eng.snapshots)
        eng.snapshots.clear()
        try:
            verdicts.append(eng.verify())
        finally:
            eng.snapshots[:] = kept
    assert verdicts[0] == verdicts[1] == dict(
        ALL_TRUE, chain_ok=False, replay_ok=False, recovery_ok=False)


def test_journal_without_snapshots_proves_recovery(tmp_path):
    """With only a journal directory (no snapshot cadence) a journal is
    attached and recovery_ok is computed from genesis: True, and False
    once a record is tampered, in both."""
    verdicts = []
    for name, mod, kw in (("jax", jeng, {}),
                          ("torch", teng, {"device": "cpu"})):
        cfg = dataclasses.replace(
            _cfg(mod, str(tmp_path / name)), snapshot_every_blocks=0,
            snapshot_dir=None, block_dir=None)
        eng = _run(mod.FabricEngine(cfg, **kw), rounds=(150,))
        assert eng.journal is not None and not eng.snapshots
        assert eng.verify() == ALL_TRUE
        rec = eng.journal.records[0]
        eng.journal.records[0] = rec._replace(valid=~np.asarray(rec.valid))
        verdicts.append(eng.verify())
        eng.store.close()
    assert verdicts[0] == verdicts[1] == dict(ALL_TRUE, recovery_ok=False)
    loaded = tj.StateJournal.load(teng.FASTFABRIC.dims,
                                  str(tmp_path / "jax" / "jrnl"))
    assert [r.block_no for r in loaded.records] == [0, 1, 2]


def test_snapshots_need_a_journaled_hash_table_peer():
    for mod, kw in ((jeng, {}), (teng, {"device": "cpu"})):
        for cfg in (
                dataclasses.replace(mod.FABRIC_V12, snapshot_every_blocks=4),
                dataclasses.replace(
                    mod.FASTFABRIC, snapshot_every_blocks=4,
                    peer=dataclasses.replace(mod.FASTFABRIC.peer,
                                             journal=False))):
            with pytest.raises(ValueError, match="snapshot_every_blocks"):
                mod.FabricEngine(cfg, **kw)
    with pytest.raises(tr.RecoveryError, match="journal_dir"):
        teng.FabricEngine.restore(teng.FASTFABRIC, device="cpu")


def test_durable_entry_points_need_a_card(runs, monkeypatch):
    """Without ``device`` restore, recover, to_state and verify run on the
    card, and raise without one."""
    eng, d = runs["fastfabric", "torch"]
    snap = eng.snapshots[-1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: teng.FabricEngine.restore(_cfg(teng, d)),
                 lambda: tr.recover(eng.journal, snapshot=snap,
                                    n_buckets=1 << 10, slots=8,
                                    value_width=4),
                 lambda: ts.to_state(snap),
                 lambda: ts.verify(snap)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # A JAX-written snapshot verifies on the CPU in the port.
    jsnap = js.latest(os.path.join(runs["fastfabric", "jax"][1], "snap"))
    assert ts.verify(jsnap, "cpu")


def test_restore_crosses_a_jax_resize(runs, tmp_path):
    """A JAX engine that doubled its table after the last snapshot wrote a
    re-anchor record at the tip: the port restores onto the doubled table
    (recovery crosses the epoch, held against the record's tree head) and
    its verify() replays the chain across it."""
    je = _run(jeng.FabricEngine(_cfg(jeng, str(tmp_path))))
    je.resize(1 << 11)
    je.store.drain()
    rt = teng.FabricEngine.restore(_cfg(teng, str(tmp_path)), device="cpu")
    assert rt.peer_state.hash_state.n_buckets == 1 << 11
    assert rt.reanchor_log == [(14, 1 << 11)]
    _same(_view(je), _view(rt), skip=("chain", "base", "journal"))
    assert je.verify() == rt.verify() == ALL_TRUE
    je.store.close()
    rt.store.close()
