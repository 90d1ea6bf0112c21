"""The port's engine with a bucket-sharded window committer,
``WindowCommitter(FASTFABRIC_PIPELINED_STEP, n_shards=4)``, against the JAX
host-path engine with ``snapshot_shards=4``, over the same rounds (1,024 x
8 tables, blocks of 50, a snapshot every 9 blocks, journal and block
spills): four rounds of 150 (a snapshot after block 8), a doubling to
2,048 buckets, and one more round, so the journal suffix after the
snapshot crosses the re-anchor. The store chain, validity bits, journal
head, ``state_digest``, ``tree_head``, the re-anchor record,
the snapshot's four parts and verify() agree; ``recover_shard`` rebuilds
every shard from the other package's directories, in both directions;
the committer's shard stats and hot shard follow the shards; and an
overflowing 8 x 2 sharded engine names its shards in its bits and
gauges."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import world_state as jws
from repro.storage import journal as jjrnl
from repro.storage import recovery as jrec
from repro.storage import snapshot as jsnap
from repro_torch.core import engine as teng, u32
from repro_torch.core import world_state as tws
from repro_torch.launch import fabric_step as tfs
from repro_torch.launch import state_sharding as tss
from repro_torch.pipeline import engine_bridge as teb
from repro_torch.storage import journal as tjrnl
from repro_torch.storage import recovery as trec

from torch_pipeline_inputs import DIMS, TDIMS

M, NB, BLOCK = 4, 1 << 10, 50
ALL_TRUE = {"chain_ok": True, "replica_ok": True, "replay_ok": True,
            "recovery_ok": True, "overflow_ok": True}
DIRS = ("journal_dir", "snapshot_dir", "block_dir")


def _cfg(mod, root, **kw):
    base = mod.FASTFABRIC
    return dataclasses.replace(
        base, dims=mod.types.TEST_DIMS, n_buckets=NB, slots=8,
        orderer=dataclasses.replace(base.orderer, block_size=BLOCK),
        snapshot_every_blocks=9, snapshot_shards=M,
        **{k: os.path.join(root, k) for k in DIRS}, **kw)


def _committer(n_buckets=NB, slots=8):
    return teb.WindowCommitter(TDIMS, tfs.FASTFABRIC_PIPELINED_STEP,
                               n_buckets=n_buckets, slots=slots, n_shards=M,
                               device="cpu")


def _table(eng):
    """An engine's committed table as u32 numpy arrays."""
    if isinstance(eng, jeng.FabricEngine):
        return [np.asarray(a) for a in eng.peer_state.hash_state]
    return [u32.host_copy(a) for a in eng.window_committer.hash_state()]


def _view(eng):
    jax_side = isinstance(eng, jeng.FabricEngine)
    eng.store.drain()
    chain = eng.store.chains[0] if hasattr(eng.store, "chains") \
        else eng.store.chain
    table = _table(eng)
    return {
        "chain": [(sb.block_no, sb.prev_hash, sb.block_hash, sb.valid)
                  for sb in chain],
        "journal_head": (np.asarray(eng.peer_state.journal_head) if jax_side
                         else eng._peer_journal_head()),
        "digest": np.asarray(jws.state_digest(jws.HashState(
            *(jnp.asarray(a) for a in table)))),
        "port_digest": u32.to_numpy(tws.state_digest(tws.HashState(
            *(u32.from_numpy(a, "cpu") for a in table)))),
        "tree_head": np.asarray(jws.tree_head(jws.HashState(
            *(jnp.asarray(a) for a in table)), M)),
        "table": table,
        "verify": eng.verify()}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both engines over the same rounds, with their directories."""
    out = {}
    for name, mod in (("jax", jeng), ("port", teng)):
        root = str(tmp_path_factory.mktemp(name))
        cfg = _cfg(mod, root)
        eng = (jeng.FabricEngine(cfg) if mod is jeng else teng.FabricEngine(
            cfg, device="cpu", window_committer=_committer()))
        for seed in range(4):
            eng.run_round(eng.make_proposals(150, seed=seed))
        info = eng.resize(2 * NB)
        eng.run_round(eng.make_proposals(150, seed=4))
        out[name] = {"eng": eng, "info": info, "root": root,
                     "view": _view(eng)}
    yield out
    for v in out.values():
        v["eng"].store.close()


def test_sharded_engine_matches_jax_host_path(engines):
    a, b = engines["jax"]["view"], engines["port"]["view"]
    assert [x[0] for x in a["chain"]] == [x[0] for x in b["chain"]] == list(
        range(15))
    for x, y in zip(a["chain"], b["chain"]):
        assert x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            np.testing.assert_array_equal(u, v)
    # A window engine's ledger head is its step's ledger fold, the host
    # path's the store chain's head (ROADMAP section 3): not compared.
    for k in ("journal_head", "digest", "tree_head"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name, x, y in zip(tws.HashState._fields, a["table"], b["table"]):
        np.testing.assert_array_equal(x, y, err_msg=name)
    np.testing.assert_array_equal(b["port_digest"], b["digest"])
    port = engines["port"]["eng"]
    np.testing.assert_array_equal(port.window_committer.tree_head(),
                                  b["tree_head"])
    np.testing.assert_array_equal(
        u32.to_numpy(tss.sharded_digest(tss.shard_views(
            port.window_committer.hash_state(), M))), b["tree_head"])
    assert a["verify"] == b["verify"] == ALL_TRUE
    assert port.n_shards == port.window_committer.n_shards == M
    assert port.n_buckets == 2 * NB


def test_reanchor_record_and_snapshot_parts_match_jax(engines):
    jeng_, peng = engines["jax"]["eng"], engines["port"]["eng"]
    (jr,), (tr,) = jeng_.journal.reanchors, peng.chans[0].journal.reanchors
    assert tr.block_no == jr.block_no == 11
    assert (tr.old_n_buckets, tr.new_n_buckets, tr.n_shards) == (
        jr.old_n_buckets, jr.new_n_buckets, jr.n_shards) == (NB, 2 * NB, M)
    for k in ("tree_head", "prev_head", "prev_reanchor", "head"):
        np.testing.assert_array_equal(getattr(tr, k), getattr(jr, k),
                                      err_msg=k)
    assert tr.overflow_bits == jr.overflow_bits == 0
    info = engines["port"]["info"]
    assert info["hot_shard"] == engines["jax"]["info"]["hot_shard"]
    names = {n: sorted(os.listdir(os.path.join(engines[n]["root"],
                                               "snapshot_dir")))
             for n in ("jax", "port")}
    assert names["jax"] == names["port"]
    assert sum(f.startswith("shard_") for f in names["port"]) == M
    jm, tm = (jsnap.latest_manifest(os.path.join(engines[n]["root"],
                                                 "snapshot_dir"))
              for n in ("jax", "port"))
    assert (tm.n_shards, tm.n_buckets) == (jm.n_shards, jm.n_buckets) == (
        M, NB)
    for k in ("shard_digests", "tree_head", "journal_head", "state_digest"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k),
                                      err_msg=k)


@pytest.mark.parametrize("direction", ("port_on_jax_dirs",
                                       "jax_on_port_dirs"))
def test_recover_shard_across_packages(engines, direction):
    """The snapshot is block 8's at 1,024 buckets and the journal suffix
    (blocks 9-14) crosses the doubling after block 11: each shard loads two
    of the four parts."""
    src = "jax" if direction == "port_on_jax_dirs" else "port"
    live = engines["port" if src == "jax" else "jax"]["view"]["table"]
    jdir = os.path.join(engines[src]["root"], "journal_dir")
    sdir = os.path.join(engines[src]["root"], "snapshot_dir")
    nb_loc = 2 * NB // M
    for shard in range(M):
        if direction == "port_on_jax_dirs":
            res = trec.recover_shard(tjrnl.StateJournal.load(TDIMS, jdir),
                                     snapshot_dir=sdir, shard=shard,
                                     device="cpu")
            got = [u32.host_copy(a) for a in res.state]
            digest = res.shard_digest
        else:
            res = jrec.recover_shard(jjrnl.StateJournal.load(DIMS, jdir),
                                     snapshot_dir=sdir, shard=shard)
            got = [np.asarray(a) for a in res.state]
            digest = np.asarray(res.shard_digest)
        want = [a[shard * nb_loc:(shard + 1) * nb_loc] for a in live]
        for name, x, y in zip(tws.HashState._fields, got, want):
            np.testing.assert_array_equal(x, y, err_msg=f"shard {shard} "
                                          f"{name}")
        np.testing.assert_array_equal(digest, np.asarray(jws.state_digest(
            jws.HashState(*(jnp.asarray(a) for a in want)))))
        sched = trec._range_schedule(shard, M, [NB, 2 * NB])
        assert res.loaded_parts == sum(max(s // (NB // M), 1)
                                       for _, s in sched[0]) == 2
        assert (res.block_no, res.replayed_records, res.crossed_reanchors,
                res.n_shards) == (14, 6, 1, M)


def test_sharded_committer_stats_and_hot_shard(engines):
    peng = engines["port"]["eng"]
    wc = peng.window_committer
    table = engines["jax"]["view"]["table"]
    occ, min_free, cap, bits = wc.shard_stats([0])[0]
    jst = jws.HashState(*(jnp.asarray(a) for a in table))
    np.testing.assert_array_equal(occ, np.asarray(jws.shard_occupancy(jst,
                                                                      M)))
    assert min_free == int(np.asarray(jws.shard_min_free(jst, M)).min())
    assert cap == 2 * NB // M * 8 and bits == 0
    assert wc.hot_shard() == int(np.argmax(occ))
    assert peng._shard_stats([0])[0][0].shape == (M,)


def test_overflowing_sharded_engine_names_its_shards():
    """An 8 x 2 table in 4 shards (2 buckets each), obs on: the round
    overflows, the bits name the shards that dropped writes (equal to a
    sharded step's over the same blocks), the per-shard gauges follow them,
    the hot shard is the first set bit, and verify() says overflow."""
    cfg = dataclasses.replace(
        teng.FASTFABRIC, dims=TDIMS, n_buckets=8, slots=2, obs=True,
        orderer=dataclasses.replace(teng.FASTFABRIC.orderer,
                                    block_size=BLOCK))
    eng = teng.FabricEngine(cfg, device="cpu",
                            window_committer=_committer(8, 2))
    eng.run_round(eng.make_proposals(200, seed=0))
    bits = eng.overflow_bits()
    assert bits and bits >> M == 0 and bits != 1
    metrics = eng.metrics()
    for m in range(M):
        assert metrics[f"state.shard_overflow{{channel=0,shard={m}}}"] == (
            bits >> m) & 1
    assert eng.window_committer.hot_shard() == (bits & -bits).bit_length() - 1
    verdict = eng.verify()
    assert not verdict["overflow_ok"] and verdict["chain_ok"]
    eng.store.close()
