"""The port's engine with a window committer over a (2, 2) mesh of CPU
positions, ``WindowCommitter(mesh=...)``, against its one-device window
engine on the same proposals (that engine is held against JAX's host
engine in test_torch_multichannel_step.py). Two channels over ``data``,
bucket-sharded or replicated over ``model``, depth 2 (a window of two
blocks and a one-block tail a round), durable, a snapshot every 4 blocks:
a round, a doubling of channel 0 (its butterfly across its row's shard
positions; it then lives alone, replicated over ``data``), two more rounds
(a snapshot after the resize: a resize at a snapshot's block is lost to
recovery, ROADMAP section 3).
The store chain, validity bits, heads, ``state_digest``, ``tree_head``,
overflow bits, shard stats, verify(), the per-shard snapshot files and
``recover_shard`` onto a named device agree; every rank's tensors are its
own; a committer whose mesh does not start on the engine's device is
refused."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng, types, u32
from repro_torch.launch import fabric_step as tfs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import state_sharding as tss
from repro_torch.pipeline import engine_bridge as teb
from repro_torch.storage import recovery as trec
from repro_torch.storage import snapshot as tsnap

DIMS = types.TEST_DIMS
NB, BLOCK, ROUND, DEPTH, C = 1 << 10, 50, 150, 2, 2
DIRS = ("journal_dir", "snapshot_dir", "block_dir")
MODES = ("sharded", "replicated")


def _mesh(devices=(("cpu", "cpu"), ("cpu", "cpu"))):
    return tmesh.Mesh(devices)


def _cfg(root):
    base = teng.FASTFABRIC
    return dataclasses.replace(
        base, dims=DIMS, n_buckets=NB, slots=8, n_channels=C,
        orderer=dataclasses.replace(base.orderer, block_size=BLOCK),
        snapshot_every_blocks=4,
        **{k: os.path.join(root, k) for k in DIRS})


def _committer(mode, mesh=None):
    step = tfs.FabricStepConfig(shard_state=mode == "sharded",
                                pipeline_depth=DEPTH)
    return teb.WindowCommitter(
        DIMS, step, n_buckets=NB, slots=8, n_channels=C,
        n_shards=2, **({"mesh": mesh} if mesh else {"device": "cpu"}))


def _view(eng, c):
    wc = eng.window_committer
    eng.store.drain()
    return {
        "chain": [(sb.block_no, sb.prev_hash, sb.block_hash, sb.valid)
                  for sb in eng.store.chains[c]],
        "log_head": u32.to_numpy(eng.chans[c].log_head),
        "journal_head": wc.journal_head_for(c),
        "ledger_head": wc.ledger_head_for(c),
        "digest": wc.state_digest(c),
        "tree_head": wc.tree_head(c),
        "bits": wc.overflow_bits_for(c),
        "n_buckets": wc.n_buckets_for(c),
        "table": [u32.host_copy(a) for a in wc.hash_state(c)],
    }


def _assert_views(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "chain":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert x[0] == y[0]
                for u, v in zip(x[1:], y[1:]):
                    np.testing.assert_array_equal(np.asarray(u),
                                                  np.asarray(v), err_msg=k)
        elif k == "table":
            for u, v in zip(a[k], b[k]):
                np.testing.assert_array_equal(u, v, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _rounds(eng, seeds):
    return [eng.run_rounds([eng.make_proposals(ROUND, seed=s + 7 * c)
                            for c in range(C)]) for s in seeds]


@pytest.fixture(scope="module", params=MODES)
def runs(request, tmp_path_factory):
    """The one-device and the mesh engine over the same rounds."""
    mode = request.param
    out = {"mode": mode}
    for kind in ("one", "mesh"):
        root = str(tmp_path_factory.mktemp(f"{mode}_{kind}"))
        mesh = _mesh() if kind == "mesh" else None
        eng = teng.FabricEngine(_cfg(root), device="cpu",
                                window_committer=_committer(mode, mesh))
        _rounds(eng, (0,))
        before = [_view(eng, c) for c in range(C)]
        eng.resize(2 * NB, channel=0)
        _rounds(eng, (1, 2))
        out[kind] = {"eng": eng, "root": root, "mesh": mesh,
                     "before": before,
                     "after": [_view(eng, c) for c in range(C)]}
    yield out
    for kind in ("one", "mesh"):
        out[kind]["eng"].store.close()


def test_mesh_engine_equals_one_device(runs):
    for c in range(C):
        _assert_views(runs["mesh"]["before"][c], runs["one"]["before"][c])
        _assert_views(runs["mesh"]["after"][c], runs["one"]["after"][c])
    assert runs["mesh"]["after"][0]["n_buckets"] == 2 * NB
    assert not any(runs["mesh"]["after"][c]["bits"] for c in range(C))


def test_mesh_engine_verifies(runs):
    want = {c: {"chain_ok": True, "replica_ok": True, "replay_ok": True,
                "recovery_ok": True, "overflow_ok": True} for c in range(C)}
    assert runs["mesh"]["eng"].verify_all() == want
    assert runs["one"]["eng"].verify_all() == want


def test_mesh_groups_are_placed(runs):
    """After the resize each channel is a group of one, which does not
    split over two data ranks: both rows hold it, each rank a table of its
    own; the shards or replicas are distinct storage."""
    wc = runs["mesh"]["eng"].window_committer
    assert len(wc.groups) == 2
    sharded = runs["mode"] == "sharded"
    for g in wc.groups:
        ms = g.state
        assert isinstance(ms, tfs.MeshState) and not ms.over_data
        assert ms.channels == ((0,), (0,))
        ptrs = set()
        for d, row in enumerate(ms.ranks):
            for m, r in enumerate(row):
                assert r.keys.device == wc.mesh.devices[d][m]
                assert r.keys.shape[1] == g.n_buckets // (2 if sharded
                                                          else 1)
                ptrs.add(r.keys.untyped_storage().data_ptr())
        assert len(ptrs) == 4
    assert len(wc.sync_target()) == 8


def test_mesh_shard_stats_and_hot_shard(runs):
    one = runs["one"]["eng"].window_committer
    wc = runs["mesh"]["eng"].window_committer
    got, want = wc.shard_stats((0, 1)), one.shard_stats((0, 1))
    for c in range(C):
        np.testing.assert_array_equal(got[c][0], want[c][0])
        assert got[c][1:] == want[c][1:]
        assert wc.hot_shard(c) == one.hot_shard(c)


def test_mesh_resize_moves_butterfly_bytes(runs):
    moved = runs["mesh"]["mesh"].moved
    assert moved["consensus"] > 0
    if runs["mode"] == "sharded":
        # Growing two shards: each new shard takes the other old shard's
        # table, on both data rows.
        table = NB // 2 * 8 * (2 + 1 + DIMS.vw) * 4
        assert moved["resize"] == 2 * 2 * table
        assert moved["routed_read"] > 0
    else:
        assert not moved["resize"] and not moved["routed_read"]


def test_mesh_snapshots_per_shard(runs):
    m = 2 if runs["mode"] == "sharded" else 1
    for c in range(C):
        dirs = [os.path.join(runs[k]["root"], "snapshot_dir")
                for k in ("one", "mesh")]
        mans = [tsnap.latest_manifest(teng.ledger.channel_dir(d, c))
                for d in dirs]
        assert mans[0].block_no == mans[1].block_no
        assert mans[1].n_shards == m
        np.testing.assert_array_equal(mans[0].shard_digests,
                                      mans[1].shard_digests)
        np.testing.assert_array_equal(mans[0].tree_head, mans[1].tree_head)
        for k in range(m):
            parts = [tsnap.load_shard(teng.ledger.channel_dir(d, c),
                                      mans[0].block_no, k) for d in dirs]
            for name in ("keys", "versions", "values"):
                np.testing.assert_array_equal(getattr(parts[0], name),
                                              getattr(parts[1], name))


def test_recover_shard_onto_named_device(runs):
    eng = runs["mesh"]["eng"]
    eng.store.drain()
    wc = eng.window_committer
    for c in range(C):
        live = wc.shard_tables(c)
        for k, shard in enumerate(live):
            rec = trec.recover_shard(
                eng.chans[c].journal, shard=k, device=shard.keys.device,
                snapshot_dir=teng.ledger.channel_dir(
                    os.path.join(runs["mesh"]["root"], "snapshot_dir"), c))
            assert rec.state.keys.device == shard.keys.device
            for x, y in zip(rec.state, shard):
                assert torch.equal(x, y)


@pytest.mark.parametrize("where", ("engine_elsewhere", "mesh_elsewhere"))
def test_committer_off_the_engines_device_is_refused(where, tmp_path):
    mesh = (_mesh() if where == "engine_elsewhere"
            else _mesh((("meta", "cpu"),)))
    wc = _committer("sharded", mesh)
    with pytest.raises(ValueError, match="window committer on"):
        teng.FabricEngine(_cfg(str(tmp_path)),
                          device="meta" if where == "engine_elsewhere"
                          else "cpu", window_committer=wc)


def test_mesh_refuses_a_ragged_grid_and_missing_cards():
    with pytest.raises(ValueError):
        tmesh.Mesh([["cpu", "cpu"], ["cpu"]])
    if torch.cuda.device_count() < 4:
        with pytest.raises(RuntimeError, match="needs 4 cards"):
            tmesh.from_cards(2, 2)
    mesh = _mesh()
    assert (tmesh.dp_size(mesh), tmesh.model_size(mesh)) == (2, 2)
    assert mesh.distinct() == [torch.device("cpu")]
    assert tss.MAX_OVERFLOW_SHARDS >= mesh.model_size
