"""Several channels on the host path: the port's engine at C = 2 against
the JAX engine (``FabricEngine(n_channels=2).run_rounds``) on the same
proposals, both durable into their own directories (blocks of 32, three
rounds of 64, 128 x 8 tables, a snapshot every 2 blocks, so each
channel's chain and journal are pruned to its second snapshot; channel 1
resized to 256 buckets after the first round, so its epochs diverge): per-channel store chains, journal heads,
state digests, validity counts, per-channel counters and ``verify_all``;
then each package restores the other's directories. The rest ports the
JAX package's multi-channel tests that run on the host path: per-channel
resize, a tampered journal or chain flipping only its channel, the
store's channel multiplexing, restore from a trailing snapshot and its
refusal without the block spill, the mismatched-committer raise, and the
overflow bitmask naming its channels (the restore tests run two channels
through ``run_rounds``, the newest snapshot trailing the journal tip)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro_torch.core import engine as teng, ledger as tl, types as ttypes
from repro_torch.core import u32, unmarshal as tun
from repro_torch.launch import fabric_step as tfs, state_sharding as tss
from repro_torch.pipeline import engine_bridge as teb
from repro_torch.storage import recovery as trec

BLOCK, ROUND, NB = 32, 64, 128
ALL_TRUE = {"chain_ok": True, "replica_ok": True, "replay_ok": True,
            "recovery_ok": True, "overflow_ok": True}


def _cfg(mod, **kw):
    return mod.EngineConfig(
        dims=mod.types.TEST_DIMS,
        orderer=dataclasses.replace(mod.FASTFABRIC.orderer,
                                    block_size=BLOCK), **kw)


def _dirs(root) -> dict:
    return {k: str(root / k) for k in ("snapshot_dir", "journal_dir",
                                       "block_dir")}


def _durable_cfg(mod, root):
    return _cfg(mod, n_channels=2, n_buckets=NB, snapshot_every_blocks=2,
                obs=True, **_dirs(root))


def _run(eng):
    """Round 0, channel 1 doubled, rounds 1 and 2; the stats of each."""
    stats = [eng.run_rounds([eng.make_proposals(ROUND, seed=c)
                             for c in range(2)])]
    info = eng.resize(2 * NB, channel=1)
    assert info["channel"] == 1
    for r in range(2):
        stats.append(eng.run_rounds([eng.make_proposals(
            ROUND, seed=10 + 2 * r + c) for c in range(2)]))
    return stats


def _chain(eng, c):
    eng.store.drain()
    return [(sb.block_no, np.asarray(sb.prev_hash), np.asarray(sb.block_hash),
             np.asarray(sb.valid)) for sb in eng.store.chains[c]]


def _view(eng, c):
    """Channel c of either package's engine, as numpy."""
    jax_side = isinstance(eng, jeng.FabricEngine)
    ch = eng.chans[c]
    return {
        "chain": _chain(eng, c),
        "base": (eng.store.base_block_nos[c],
                 np.asarray(eng.store.base_hashes[c])),
        "journal_head": np.asarray(eng._peer_journal_head(c)),
        "ledger_head": np.asarray(eng._ledger_head(c)),
        "digest": np.asarray(eng._peer_digest(c)),
        "journal": (np.asarray(ch.journal.head),
                    np.asarray(ch.journal.reanchor_head)),
        "next_block_no": ch.next_block_no, "n_buckets": ch.n_buckets,
        "reanchors": [(r["block_no"], r["new_n_buckets"]) if jax_side else r
                      for r in ch.reanchor_log],
    }


def _same(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        if k == "chain":
            assert len(a[k]) == len(b[k]), what
            for x, y in zip(a[k], b[k]):
                assert x[0] == y[0], what
                for u, v in zip(x[1:], y[1:]):
                    np.testing.assert_array_equal(u, v, err_msg=what)
        elif k in ("base", "journal"):
            for u, v in zip(a[k], b[k]):
                np.testing.assert_array_equal(u, v, err_msg=f"{what} {k}")
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
        else:
            assert a[k] == b[k], (what, k, a[k], b[k])


@pytest.fixture(scope="module")
def durable(tmp_path_factory):
    """Both packages' engines after the three durable rounds."""
    out = {}
    for name, mod, kw in (("jax", jeng, {}), ("port", teng,
                                              {"device": "cpu"})):
        root = tmp_path_factory.mktemp(name)
        eng = mod.FabricEngine(_durable_cfg(mod, root), **kw)
        stats = _run(eng)
        out[name] = (eng, stats, root, {c: _view(eng, c) for c in range(2)},
                     eng.verify_all())
    yield out
    for eng, *_ in out.values():
        eng.store.close()


def test_host_rounds_match_jax(durable):
    (je, jst, _, jviews, jverdict), (te, tst, _, tviews, tverdict) = (
        durable["jax"], durable["port"])
    assert tverdict == jverdict == {0: ALL_TRUE, 1: ALL_TRUE}
    for c in range(2):
        _same(tviews[c], jviews[c], f"channel {c}")
        # Snapshots at blocks 1, 3 and 5: pruned to the one at 3.
        assert [x[0] for x in tviews[c]["chain"]] == [4, 5]
        assert tviews[c]["base"][0] == 3
    assert [[s.n_valid for s in r] for r in tst] == \
        [[s.n_valid for s in r] for r in jst] == [[ROUND, ROUND]] * 3
    # One wall clock a lockstep round.
    assert all(r[0].wall_s == r[1].wall_s for r in tst)
    tm, jm = te.metrics(), je.metrics()
    for key in ("txs.valid{channel=0}", "txs.valid{channel=1}",
                "txs.invalid{channel=1}", "txs.valid"):
        assert tm[key] == jm[key], key
    assert tm["txs.valid{channel=1}"] == 3 * ROUND
    assert te.total_valid == sum(ch.total_valid for ch in te.chans)


def test_per_channel_resize_reanchors_one_channel(durable):
    te = durable["port"][0]
    assert [ch.n_buckets for ch in te.chans] == [NB, 2 * NB]
    assert te.n_buckets == NB  # channel 0's, the single-channel surface
    # The epoch after block 1 is in channel 1's journal chain only (its
    # record was pruned with blocks <= 3; its head remains).
    assert not te.chans[0].journal.reanchor_head.any()
    assert te.chans[1].journal.reanchor_head.any()
    assert te.chans[0].reanchor_log == []
    assert te.chans[1].reanchor_log == [(1, 2 * NB)]
    verdict = te.health()
    assert set(verdict.channels) == {0, 1} and verdict.status == "healthy"


def test_channel_directories(durable):
    root = durable["port"][2]
    for c, sub in ((0, ""), (1, "channel_0001")):
        assert (root / "block_dir" / sub / "block_00000005.npz").exists()
        assert not (root / "block_dir" / sub / "block_00000003.npz").exists()
        assert any((root / "snapshot_dir" / sub).iterdir())
        assert any((root / "journal_dir" / sub).iterdir())


@pytest.mark.parametrize("direction", ["port_restores_jax",
                                       "jax_restores_port"])
def test_restore_across_packages(durable, direction):
    """A restore of the other package's directories: every channel comes
    back (channel 1 on its grown layout, both from a snapshot trailing the
    journal tip), with the live engine's heads and digests, and verify_all
    holds."""
    src = "jax" if direction == "port_restores_jax" else "port"
    live, _, root, views, _ = durable[src]
    if direction == "port_restores_jax":
        back = teng.FabricEngine.restore(_durable_cfg(teng, root),
                                         device="cpu")
    else:
        back = jeng.FabricEngine.restore(_durable_cfg(jeng, root))
    try:
        for c in range(2):
            ch = back.chans[c]
            assert (ch.next_block_no, ch.n_buckets) == (
                views[c]["next_block_no"], views[c]["n_buckets"])
            for k, got in (("digest", back._peer_digest(c)),
                           ("ledger_head", back._ledger_head(c)),
                           ("journal_head", back._peer_journal_head(c))):
                np.testing.assert_array_equal(np.asarray(got), views[c][k],
                                              err_msg=f"channel {c} {k}")
        assert back.verify_all() == {0: ALL_TRUE, 1: ALL_TRUE}
    finally:
        back.store.close()


def test_tamper_flips_only_that_channel(tmp_path):
    """Corrupt channel 1's journal: only channel 1's verify fails; put it
    back and corrupt channel 0's chain: only channel 0's fails."""
    eng = teng.FabricEngine(_cfg(teng, n_channels=2,
                                 journal_dir=str(tmp_path / "j")),
                            device="cpu")
    for r in range(2):
        eng.run_rounds([eng.make_proposals(ROUND, seed=200 + 3 * r + c)
                        for c in range(2)])
    assert eng.verify_all() == {0: ALL_TRUE, 1: ALL_TRUE}
    rec = eng.chans[1].journal.records[2]
    eng.chans[1].journal.records[2] = rec._replace(
        write_vals=rec.write_vals + np.uint32(1))
    v0, v1 = eng.verify(0), eng.verify(1)
    assert v0 == ALL_TRUE and not all(v1.values()), v1
    assert eng.recorder.trips[-1]["ctx"]["channel"] == 1
    eng.chans[1].journal.records[2] = rec
    assert eng.verify(1) == ALL_TRUE
    sb = eng.store.chains[0][1]
    eng.store.chains[0][1] = sb._replace(
        block_hash=sb.block_hash ^ np.uint32(1))
    v0, v1 = eng.verify(0), eng.verify(1)
    assert not v0["chain_ok"] and v1 == ALL_TRUE
    eng.store.close()


def _chain_blocks(n_blocks, batch=8, seed=0):
    prev = torch.zeros((2,), dtype=u32.WORD)
    out = []
    for b in range(n_blocks):
        txb = ttypes.make_transfer_batch(ttypes.TEST_DIMS, batch,
                                         seed=seed + b, device="cpu")
        wire = tun.marshal(txb, ttypes.TEST_DIMS)
        valid = torch.ones(batch, dtype=torch.bool)
        bh = tl.append_hash(prev, b, tl.block_body_digest(wire, valid))
        out.append((b, prev, bh, wire, valid))
        prev = bh
    return out


def test_blockstore_multiplexes_channels(tmp_path):
    """One writer, three channels' chains: per-channel spill directories,
    verify_chain, prune_upto and resume."""
    store = tl.BlockStore(spill_dir=str(tmp_path))
    chans = {c: _chain_blocks(3, seed=40 * (c + 1)) for c in range(3)}
    for b in range(3):
        for c, blocks in chans.items():
            store.submit(*blocks[b], channel=c)
    store.drain()
    for c, blocks in chans.items():
        assert store.verify_chain(c)
        assert [sb.block_no for sb in store.chains[c]] == [0, 1, 2]
        loaded = tl.load_spilled_blocks(str(tmp_path), 0, channel=c)
        assert [sb.block_no for sb in loaded] == [0, 1, 2]
        for sb, (_, _, bh, _, _) in zip(loaded, blocks):
            np.testing.assert_array_equal(sb.block_hash, u32.to_numpy(bh))
        assert store.resume(c) == 3
    assert (tmp_path / "channel_0002" / "block_00000001.npz").exists()
    assert store.prune_upto(1, channel=1) == 2
    assert store.base_block_nos == {0: -1, 1: 1, 2: -1}
    assert not (tmp_path / "channel_0001" / "block_00000001.npz").exists()
    assert store.resume(1) == 3 and store.chain is store.chains[0]
    assert all(store.verify_chain(c) for c in range(3))
    store.chains[2][1] = store.chains[0][1]  # a cross-channel splice
    assert store.verify_chain(0) and store.verify_chain(1)
    assert not store.verify_chain(2)
    store.close()


def _trailing_cfg(root, **kw):
    return _cfg(teng, n_channels=2, n_buckets=256, snapshot_every_blocks=4,
                snapshot_dir=str(root / "s"), journal_dir=str(root / "j"),
                **kw)


def test_restore_from_snapshot_trailing_journal_tip(tmp_path):
    cfg = _trailing_cfg(tmp_path, block_dir=str(tmp_path / "b"))
    eng = teng.FabricEngine(cfg, device="cpu")
    for i in range(5):
        eng.run_rounds([eng.make_proposals(ROUND, seed=2 * i + c)
                        for c in range(2)])
    want = [(eng._peer_digest(c), eng.chans[c].next_block_no,
             eng._ledger_head(c)) for c in range(2)]
    assert eng.chans[1].snapshots[-1].block_no == 7  # the tip is 9
    eng.store.close()
    back = teng.FabricEngine.restore(cfg, device="cpu")
    for c, (digest, bno, head) in enumerate(want):
        assert back.chans[c].next_block_no == bno == 10
        np.testing.assert_array_equal(back._peer_digest(c), digest)
        np.testing.assert_array_equal(back._ledger_head(c), head)
        assert [sb.block_no for sb in back.store.chains[c]] == [8, 9]
    assert back.verify_all() == {0: ALL_TRUE, 1: ALL_TRUE}
    back.store.close()


def test_restore_trailing_snapshot_requires_block_spill(tmp_path):
    cfg = _trailing_cfg(tmp_path)
    eng = teng.FabricEngine(cfg, device="cpu")
    for i in range(5):
        eng.run_rounds([eng.make_proposals(ROUND, seed=2 * i + c)
                        for c in range(2)])
    eng.store.close()
    with pytest.raises(trec.RecoveryError, match="block_dir"):
        teng.FabricEngine.restore(cfg, device="cpu")


def test_mismatched_committer_and_round_raise():
    wc = teb.WindowCommitter(ttypes.TEST_DIMS, tfs.FabricStepConfig(),
                             n_buckets=NB, device="cpu")
    with pytest.raises(ValueError, match="channels"):
        teng.FabricEngine(_cfg(teng, n_channels=2, n_buckets=NB),
                          device="cpu", window_committer=wc)
    wc2 = teb.WindowCommitter(ttypes.TEST_DIMS, tfs.FabricStepConfig(),
                              n_buckets=NB, n_channels=2, device="cpu")
    eng = teng.FabricEngine(_cfg(teng, n_channels=2, n_buckets=NB,
                                 store_blocks=False),
                            device="cpu", window_committer=wc2)
    with pytest.raises(ValueError, match="run_rounds"):
        eng.run_round(eng.make_proposals(ROUND))
    with pytest.raises(ValueError, match="2 proposal batches"):
        eng.run_rounds([eng.make_proposals(ROUND)])
    with pytest.raises(ValueError, match="shape-uniform"):
        eng.run_rounds([eng.make_proposals(ROUND),
                        eng.make_proposals(2 * ROUND)])
    with pytest.raises(ValueError, match="n_channels"):
        teng.FabricEngine(_cfg(teng, n_channels=0), device="cpu")


def test_overflow_cap_raise_names_channels():
    flags = torch.zeros(tss.MAX_OVERFLOW_SHARDS + 1, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"channel \(1, 3\)"):
        tss.overflow_bits(flags, channel=(1, 3))
