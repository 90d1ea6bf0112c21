"""The port's engine with a window committer (pipeline/engine_bridge)
against the port's per-block engine and the JAX per-block engine, on the
same proposals: two rounds of 600 in blocks of 100 at depth 4 (a full
window and a tail of 2 a round) under ResizePolicy(grow_free_slots=2) from
2,048 x 8, which grows the table after the second round; a third round
then commits through the resized committer on the port's two engines
(the JAX engine stops at two rounds: each table layout costs it ~20 s of
compiles). The store chain, validity bits, journal heads, state digests,
resize epochs and verify() agree; the store-chain hashes of a window equal
the JAX ``_chain_hashes``; snapshots recover; an 8 x 2 table reports
overflow_ok False; the window spans and counters count windows and
blocks."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.pipeline import engine_bridge as jeb
from repro_torch.core import engine as teng, u32
from repro_torch.launch import fabric_step as tfs
from repro_torch.pipeline import engine_bridge as teb

from torch_pipeline_inputs import TDIMS, window

ROUND, DEPTH, START = 600, 4, 1 << 11
ALL_TRUE = {"chain_ok": True, "replica_ok": True, "replay_ok": True,
            "recovery_ok": True, "overflow_ok": True}


def _cfg(mod, root, **kw):
    return dataclasses.replace(
        mod.FASTFABRIC, dims=mod.types.TEST_DIMS, n_buckets=START,
        journal_dir=os.path.join(root, "jrnl"),
        resize_policy=mod.ResizePolicy(grow_free_slots=2), **kw)


def _committer(depth=DEPTH, n_buckets=START, slots=8):
    return teb.WindowCommitter(TDIMS, tfs.FabricStepConfig(
        pipeline_depth=depth), n_buckets=n_buckets, slots=slots,
        device="cpu")


def _chain(eng):
    eng.store.drain()
    chain = eng.store.chains[0] if hasattr(eng.store, "chains") \
        else eng.store.chain
    return [(sb.block_no, sb.prev_hash, sb.block_hash, sb.valid)
            for sb in chain]


def _view(eng):
    """Chain, journal head, digest and verify() of an engine, as numpy."""
    jax_side = isinstance(eng, jeng.FabricEngine)
    return {
        "chain": _chain(eng),
        "journal_head": (np.asarray(eng.peer_state.journal_head) if jax_side
                         else eng._peer_journal_head()),
        "digest": (np.asarray(jeng.ws.state_digest(eng.peer_state.hash_state))
                   if jax_side else eng._peer_digest()),
        "verify": eng.verify()}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Each engine after two rounds (``views``), and the port's two after a
    third (``views3``)."""
    out, views, views3 = {}, {}, {}
    for name, mod, kw in (("jax", jeng, {}), ("block", teng, {}),
                          ("window", teng, {"obs": True})):
        root = str(tmp_path_factory.mktemp(name))
        cfg = _cfg(mod, root, **kw)
        if mod is jeng:
            eng = jeng.FabricEngine(cfg)
        else:
            eng = teng.FabricEngine(cfg, device="cpu", window_committer=(
                _committer() if name == "window" else None))
        stats = [eng.run_round(eng.make_proposals(ROUND, seed=s))
                 for s in range(2)]
        views[name] = _view(eng)
        if mod is teng:
            stats.append(eng.run_round(eng.make_proposals(ROUND, seed=2)))
            views3[name] = _view(eng)
        out[name] = (eng, stats)
    yield out, views, views3
    for eng, _ in out.values():
        eng.store.close()


def _same(a, b):
    assert len(a["chain"]) == len(b["chain"])
    for x, y in zip(a["chain"], b["chain"]):
        assert x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            np.testing.assert_array_equal(u, v)
    for k in ("journal_head", "digest"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["verify"] == b["verify"] == ALL_TRUE


def test_window_engine_matches_per_block_engines(engines):
    out, views, _ = engines
    (_, jst), (_, wst) = out["jax"], out["window"]
    assert [s.n_valid for s in wst[:2]] == [s.n_valid for s in jst] \
        == [600] * 2
    assert [s.n_blocks for s in wst] == [6, 6, 6]
    assert len(views["window"]["chain"]) == 12
    _same(views["window"], views["block"])
    _same(views["window"], views["jax"])


def test_window_engine_commits_after_resize(engines):
    """The third round commits through the committer grown to 4,096
    buckets: the same chain, heads, digest and verify() as the per-block
    engine, and the off-path journal's head is the committer's."""
    out, _, views3 = engines
    _same(views3["window"], views3["block"])
    we = out["window"][0]
    np.testing.assert_array_equal(we.journal.head,
                                  we.window_committer.journal_head)
    assert we.reanchor_log == out["block"][0].reanchor_log
    assert we.window_committer.n_buckets == we.n_buckets >= 4096


def test_resize_epochs_match_jax(engines):
    out, _, _ = engines
    (je, _), (we, _) = out["jax"], out["window"]
    jlog = [(r["block_no"], r["new_n_buckets"]) for r in je.reanchor_log]
    assert we.reanchor_log[:1] == jlog == [(11, 4096)]
    epochs = [r["args"] for r in we.tracer.records()
              if r["name"] == "resize.epoch"]
    assert epochs[0] == {"block_no": 11, "old_n_buckets": 2048,
                         "new_n_buckets": 4096, "overflow_bits": 0,
                         "hot_shard": 0, "channel": 0}
    assert [(r.block_no, r.old_n_buckets, r.new_n_buckets,
             np.asarray(r.tree_head).tolist(), r.overflow_bits,
             r.head.tolist()) for r in we.journal.reanchors[:1]] == [
        (r.block_no, r.old_n_buckets, r.new_n_buckets,
         np.asarray(r.tree_head).tolist(), r.overflow_bits, r.head.tolist())
        for r in je.chans[0].journal.reanchors]


def test_window_spans_and_counters(engines):
    we, stats = engines[0]["window"]
    m = we.metrics()
    assert m["window.commits"] == 6  # a window of 4 and a tail of 2, thrice
    assert m["blocks.committed"] == 18
    assert m["commit.latency"]["count"] == 18
    assert m["txs.valid"] == sum(s.n_valid for s in stats) == 1800
    names = [r["name"] for r in we.tracer.records()]
    for span in ("window.fill", "window.steady", "window.drain"):
        assert names.count(span) == 6
    depths = [r["args"]["depth"] for r in we.tracer.records()
              if r["name"] == "window.fill"]
    assert depths == [4, 2] * 3
    assert names.count("block.ship") == 18
    assert names.count("reanchor.epoch") == len(we.reanchor_log) >= 1


def test_chain_hashes_match_jax():
    """The store-chain links of a window: each block's wire and validity
    bits in ingest order, block numbers wrapping past 2^32 - 1."""
    rng = np.random.default_rng(4)
    wire, _ = window(3, n=16, seed=4)
    valid = rng.random((3, 16)) < 0.7
    prev = np.array([0xDEADBEEF, 7], np.uint32)
    bno0 = np.uint32(0xFFFFFFFE)
    jp, jh = jax.device_get(jeb._chain_hashes(
        jnp.asarray(prev), jnp.asarray(bno0), jnp.asarray(wire),
        jnp.asarray(valid)))
    tp, th = teb._chain_hashes(
        u32.from_numpy(prev), u32.from_numpy(np.array(bno0)).reshape(()),
        torch.from_numpy(wire.copy()), torch.from_numpy(valid))
    np.testing.assert_array_equal(u32.to_numpy(tp), jp)
    np.testing.assert_array_equal(u32.to_numpy(th), jh)


def test_window_engine_snapshots_recover(tmp_path):
    """Snapshots cover the committer's table and heads (at blocks 5 and
    11, the chain pruned to the first); verify() replays from the snapshot
    and recover() from the newest reproduces the live peer; the per-block
    engine takes the same snapshots of the same table."""
    views = {}
    for name in ("block", "window"):
        cfg = dataclasses.replace(
            teng.FASTFABRIC, dims=TDIMS, snapshot_every_blocks=4,
            snapshot_dir=str(tmp_path / name / "snap"))
        eng = teng.FabricEngine(cfg, device="cpu", window_committer=(
            _committer(depth=2, n_buckets=cfg.n_buckets)
            if name == "window" else None))
        for seed in range(2):
            eng.run_round(eng.make_proposals(ROUND, seed=seed))
        assert eng.verify() == ALL_TRUE
        snaps = eng.snapshots
        views[name] = [(s.block_no, s.manifest.state_digest.tolist(),
                        s.manifest.journal_head.tolist()) for s in snaps]
        rec = eng.recover()
        np.testing.assert_array_equal(rec.state_digest, eng._peer_digest())
        eng.store.close()
    assert views["window"] == views["block"]
    assert [v[0] for v in views["block"]] == [5, 11]


def test_overflowing_window_engine_is_unhealthy():
    """An 8 x 2 table at depth 4: overflow latches, verify() says so while
    the chain still verifies, and the chain, bits and digest are the
    per-block engine's."""
    cfg = dataclasses.replace(teng.FASTFABRIC, dims=TDIMS, n_buckets=8,
                              slots=2)
    out = {}
    for name in ("block", "window"):
        eng = teng.FabricEngine(cfg, device="cpu", window_committer=(
            _committer(n_buckets=8, slots=2) if name == "window" else None))
        eng.run_round(eng.make_proposals(200, seed=0))
        verdict = eng.verify()
        assert verdict["overflow_ok"] is False and verdict["chain_ok"], name
        assert eng.overflow_bits() == 1
        out[name] = (_chain(eng), eng._peer_digest())
        eng.store.close()
    for x, y in zip(out["block"][0], out["window"][0]):
        assert x[0] == y[0] and all(np.array_equal(a, b)
                                    for a, b in zip(x[1:], y[1:]))
    np.testing.assert_array_equal(out["block"][1], out["window"][1])


def test_committer_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="power of two"):
        teb.WindowCommitter(TDIMS, tfs.FASTFABRIC_PIPELINED_STEP,
                            n_shards=3, device="cpu")
    sharded = teb.WindowCommitter(TDIMS, tfs.FASTFABRIC_PIPELINED_STEP,
                                  n_buckets=START, n_shards=4, device="cpu")
    with pytest.raises(ValueError, match="2x only"):
        sharded.resize(4 * START)
    assert sharded.n_buckets == START and sharded.n_shards == 4
    wc = _committer()
    with pytest.raises(ValueError, match="channel 1"):
        wc.journal_head_for(1)
    with pytest.raises(ValueError, match="1 to 4 blocks"):
        wc.commit_window(torch.zeros((5, 16, 128), dtype=torch.uint8),
                         torch.zeros((5, 16, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="resize to current size"):
        wc.resize(START)
