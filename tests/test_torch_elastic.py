"""Elastic world state in the port's engine (``ResizePolicy``, the policy
pass between rounds, ``resize`` and its re-anchor records) beside the JAX
engine under the same policy and proposals: the same resize epochs at the
same blocks into the same layouts, the same state digests, journal and
re-anchor heads, and ``verify()`` all True on both, across a restart."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import endorser as je, engine as jeng, world_state as jws
from repro_torch.core import endorser as te, engine as teng, u32
from repro_torch.core import world_state as tws

BLOCK = 50
ALL_TRUE = {"chain_ok": True, "replica_ok": True, "replay_ok": True,
            "recovery_ok": True, "overflow_ok": True}


def _cfg(mod, root=None, **kw):
    base = mod.FASTFABRIC
    durable = {} if root is None else dict(
        snapshot_every_blocks=3, snapshot_dir=os.path.join(root, "snap"),
        journal_dir=os.path.join(root, "jrnl"),
        block_dir=os.path.join(root, "blocks"))
    return dataclasses.replace(
        base, obs=True,
        orderer=dataclasses.replace(base.orderer, block_size=BLOCK),
        **durable, **kw)


def _policy(mod, **kw):
    return dataclasses.replace(
        _cfg(mod), resize_policy=mod.ResizePolicy(**kw)).resize_policy


def _engine(mod, cfg):
    return (mod.FabricEngine(cfg) if mod is jeng
            else mod.FabricEngine(cfg, device="cpu"))


def _restore(mod, cfg):
    return (mod.FabricEngine.restore(cfg) if mod is jeng
            else mod.FabricEngine.restore(cfg, device="cpu"))


def _hot_bucket_round(mod, n_buckets=1 << 10):
    """A round of 150 whose first 8 transfers pair 16 accounts that all
    hash to one bucket of a ``n_buckets`` table (their 16 fresh keys
    overflow its 8 slots); the rest move fresh accounts. The overflow
    tests keep the fixture's table layouts, so the JAX engine compiles
    nothing new for them."""
    acct = np.arange(1 << 16, dtype=np.uint32)
    keys = u32.to_numpy(te._account_key(u32.from_numpy(acct)))
    bucket = keys[:, 0] & (n_buckets - 1)
    hot = acct[bucket == np.bincount(bucket).argmax()][:16]
    n = 3 * BLOCK
    rest = np.arange(2 * (n - 8), dtype=np.uint32) + np.uint32(1 << 20)
    cols = dict(src=np.concatenate([hot[0::2], rest[:n - 8]]),
                dst=np.concatenate([hot[1::2], rest[n - 8:]]),
                amount=np.full(n, 7, np.uint32),
                client=np.zeros(n, np.uint32),
                nonce=np.arange(n, dtype=np.uint32) + np.uint32(99 << 16))
    if mod is jeng:
        return je.Proposal(**{k: jnp.asarray(v) for k, v in cols.items()})
    return te.Proposal(**{k: u32.from_numpy(v, "cpu")
                          for k, v in cols.items()})


def _view(eng):
    """Layout, digests, heads and resize epochs of an engine, as numpy."""
    jax_side = isinstance(eng, jeng.FabricEngine)
    word = np.asarray if jax_side else u32.to_numpy
    digest = jws.state_digest if jax_side else tws.state_digest
    ps = eng.peer_state
    epochs = [r["args"] for r in eng.tracer.records()
              if r["name"] == "resize.epoch"]
    log = ([(r["block_no"], r["new_n_buckets"]) for r in eng.reanchor_log]
           if jax_side else list(eng.reanchor_log))
    out = dict(
        n_buckets=eng.n_buckets, table=ps.hash_state.keys.shape[0],
        digest=word(digest(ps.hash_state)),
        replica=word(digest(eng.endorser_state)),
        journal_head=word(ps.journal_head), ledger_head=word(ps.ledger_head),
        overflow_bits=eng.overflow_bits(), epochs=epochs, reanchor_log=log,
        trips=[(t["reason"], t["ctx"]) for t in eng.recorder.trips],
        metrics={k: v for k, v in eng.metrics().items()
                 if k.startswith(("resize.", "state.", "overflow."))})
    if eng.journal is not None:
        out["reanchor_head"] = np.asarray(eng.journal.reanchor_head)
        out["reanchors"] = [
            (r.block_no, r.old_n_buckets, r.new_n_buckets, r.n_shards,
             np.asarray(r.tree_head).tolist(), r.overflow_bits,
             r.head.tolist())
            for r in eng.journal.reanchors]
    return out


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) \
            else a[k] == b[k], k


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """Both packages' durable engines with ResizePolicy(grow_free_slots=3)
    on a 1,024 x 8 table, three rounds of 150 fresh transfers: it grows to
    2,048 after the second round. (Every table layout costs the JAX engine
    its compiles, so the file keeps to 1,024 and 2,048, 8 and 16.)"""
    out = {}
    for name, mod in (("jax", jeng), ("torch", teng)):
        root = str(tmp_path_factory.mktemp(name))
        cfg = _cfg(mod, root, n_buckets=1 << 10,
                   resize_policy=_policy(mod, grow_free_slots=3))
        eng = _engine(mod, cfg)
        for seed in range(3):
            eng.run_round(eng.make_proposals(3 * BLOCK, seed=seed))
        eng.store.drain()
        out[name] = (eng, cfg)
    yield out
    for eng, _ in out.values():
        eng.store.close()


@pytest.mark.parametrize("n_shards", [1, 4])
def test_shard_signals_match_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    keys = rng.integers(1, 1 << 32, (64, 4, 2), dtype=np.uint64).astype(
        np.uint32)
    keys[rng.random((64, 4)) < 0.6] = 0
    keys[5] = 0  # an empty bucket
    keys[40, :, 0] = np.uint32(0xFFFFFFF0)  # a full one, high bits
    vers = np.zeros((64, 4), np.uint32)
    vals = np.zeros((64, 4, 3), np.uint32)
    j = jws.HashState(keys, vers, vals)
    t = tws.HashState(*(u32.from_numpy(a) for a in (keys, vers, vals)))
    jo = np.asarray(jws.shard_occupancy(j, n_shards))
    to = tws.shard_occupancy(t, n_shards)
    assert to.tolist() == jo.tolist()
    assert tws.shard_min_free(t, n_shards).tolist() == np.asarray(
        jws.shard_min_free(j, n_shards)).tolist()
    for bits in (0, 0b100, 0b1010):
        assert tws.hot_shard(bits, to) == jws.hot_shard(bits, jo)
    assert tws.hot_shard(0, torch.tensor([3, 7, 7])) == 1


def test_policy_grows_under_pressure_like_jax(grown):
    j, t = (_view(grown[k][0]) for k in ("jax", "torch"))
    _same(t, j)
    assert t["n_buckets"] == t["table"] == 2048
    assert t["epochs"] == [{"block_no": 5, "old_n_buckets": 1024,
                            "new_n_buckets": 2048, "overflow_bits": 0,
                            "hot_shard": 0, "channel": 0}]
    # the snapshot at block 8 pruned the record; its head stays
    assert t["reanchor_log"] == [(5, 2048)] and t["reanchors"] == []
    assert t["reanchor_head"].any()
    assert t["metrics"]["resize.grow"] == 1
    assert t["metrics"]["resize.policy_checks"] == 3
    assert t["metrics"]["state.health{channel=0}"] == 0
    for name in ("jax", "torch"):
        assert grown[name][0].verify() == ALL_TRUE, name


def test_restart_resumes_post_resize_layout(grown):
    """Each package restores its own directories, and the port the JAX
    engine's, onto the grown layout; one more round keeps them equal. (A
    loaded journal whose re-anchor records were pruned restarts its
    re-anchor head at genesis in both packages.)"""
    (je, jcfg), (te, tcfg) = grown["jax"], grown["torch"]
    jr, tr = _restore(jeng, jcfg), _restore(teng, tcfg)
    cross = _restore(teng, dataclasses.replace(
        tcfg, snapshot_dir=jcfg.snapshot_dir, journal_dir=jcfg.journal_dir,
        block_dir=jcfg.block_dir))
    keys = ("n_buckets", "table", "digest", "journal_head", "ledger_head",
            "overflow_bits")
    live = _view(te)
    for eng in (jr, tr, cross):
        v = _view(eng)
        assert all(np.array_equal(v[k], live[k]) for k in keys)
        assert np.array_equal(v["reanchor_head"], _view(jr)["reanchor_head"])
        assert eng.verify() == ALL_TRUE
    keys += ("reanchor_head",)
    for eng in (jr, tr):
        eng.run_round(eng.make_proposals(3 * BLOCK, seed=10))
        eng.store.drain()
    _same(*({k: _view(e)[k] for k in keys + ("reanchors",)}
            for e in (jr, tr)))
    assert jr.verify() == tr.verify() == ALL_TRUE
    for eng in (jr, tr, cross):
        eng.store.close()


def test_grow_on_overflow_once_and_restart_keeps_bits(tmp_path):
    """A table that overflows grows once (the sticky bit is repaired, not
    re-fired every round); a restart keeps the bits and the layout and
    does not grow again."""
    views = []
    for name, mod in (("jax", jeng), ("torch", teng)):
        cfg = _cfg(mod, str(tmp_path / name), n_buckets=1 << 10,
                   resize_policy=_policy(mod, grow_free_slots=0))
        eng = _engine(mod, cfg)
        sizes = []
        for props in (_hot_bucket_round(mod),
                      eng.make_proposals(3 * BLOCK, seed=5),
                      eng.make_proposals(3 * BLOCK, seed=6)):
            eng.run_round(props)
            sizes.append(eng.n_buckets)
        verdict = eng.verify()
        eng.store.drain()
        eng.store.close()
        r = _restore(mod, cfg)
        r.run_round(r.make_proposals(3 * BLOCK, seed=1))
        views.append((sizes, verdict, _view(eng), r.n_buckets,
                      r.overflow_bits(), r.verify()))
        r.store.close()
    assert views[1][:2] == views[0][:2]
    _same(views[1][2], views[0][2])
    assert views[1][3:] == views[0][3:]
    sizes, verdict, view, nb, bits, rverdict = views[1]
    assert sizes == [2048] * 3 and nb == 2048 and bits == 1
    assert not verdict["overflow_ok"] and not rverdict["overflow_ok"]
    assert verdict["recovery_ok"] and rverdict["replica_ok"]
    assert [e["overflow_bits"] for e in view["epochs"]] == [1]
    assert view["trips"][0][0] == "overflow_latch"


def test_manual_resize_shrink_matches_jax():
    """Grow, shrink and grow again, two epochs at one boundary: the same
    info dicts, and verify() replays across them."""
    views = []
    for mod in (jeng, teng):
        eng = _engine(mod, _cfg(mod, n_buckets=1 << 10))
        infos = []
        eng.run_round(eng.make_proposals(3 * BLOCK, seed=0))
        infos.append(eng.resize(1 << 11))
        eng.run_round(eng.make_proposals(3 * BLOCK, seed=1))
        infos += [eng.resize(1 << 10), eng.resize(1 << 11)]
        eng.run_round(eng.make_proposals(3 * BLOCK, seed=2))
        views.append((infos, eng.verify(), _view(eng)))
        eng.store.close()
    assert views[1][:2] == views[0][:2]
    _same(views[1][2], views[0][2])
    infos, verdict, view = views[1]
    assert [i["new_n_buckets"] for i in infos] == [2048, 1024, 2048]
    assert [i["block_no"] for i in infos] == [2, 5, 5]
    assert verdict == ALL_TRUE and view["table"] == 2048
    assert view["metrics"]["resize.shrink"] == 1
    assert view["reanchor_log"] == [(2, 2048), (5, 1024), (5, 2048)]


def test_resize_refused_at_the_ceiling_trips_once():
    """Overflow with the table at max_buckets: the repair cannot run, so
    one resize_refused trip, not one a round; the table stays."""
    views = []
    for mod in (jeng, teng):
        eng = _engine(mod, _cfg(
            mod, n_buckets=1 << 10,
            resize_policy=_policy(mod, grow_free_slots=0, max_buckets=1024)))
        eng.run_round(_hot_bucket_round(mod))
        eng.run_round(eng.make_proposals(3 * BLOCK, seed=1))
        views.append(_view(eng))
        eng.store.close()
    _same(views[1], views[0])
    trips = [t for t in views[1]["trips"] if t[0] == "resize_refused"]
    assert trips == [("resize_refused", {
        "channel": 0, "n_buckets": 1024, "max_buckets": 1024,
        "overflow_bits": 1})]
    assert views[1]["table"] == 1024 and views[1]["epochs"] == []
