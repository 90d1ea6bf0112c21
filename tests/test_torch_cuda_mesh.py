"""The fabric step and the window engine over a mesh of the devices
present, against the one-device step and engine on the first card, bit for
bit, with the K1, K2, K3 and K4 launches counted by device. With four
cards or more the mesh is (2, 2) over four cards, with two or three it is
(1, 2) over two cards, and with one it is (1, 2) over ``cuda:0`` and the
CPU, so that every copy between devices and every reduction onto a stated
device runs (the CPU position takes the plain versions and counts no
launch). Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_mesh.py

Without a card every test here skips."""

import collections
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.core import endorser, engine, types, u32, unmarshal
from repro_torch.kernels.hash_table import ops as ht_ops
from repro_torch.kernels.mvcc_validate import ops as mv_ops
from repro_torch.kernels.sig_mac import ops as mac_ops
from repro_torch.launch import fabric_step as fs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.pipeline import engine_bridge as eb
from repro_torch.storage import recovery

pytestmark = pytest.mark.gpu
DIMS = types.TEST_DIMS
FIELDS = fs.FabricMeshState._fields
B, NB = 32, 1 << 10
STEPS = {
    "sharded_d1": fs.FabricStepConfig(shard_state=True),
    "sharded_d4": fs.FabricStepConfig(shard_state=True, pipeline_depth=4),
    "replicated_d1": fs.FabricStepConfig(),
    "replicated_d4": fs.FabricStepConfig(pipeline_depth=4),
    "fabric12": fs.FABRIC_V12_STEP,
}


@pytest.fixture(scope="module")
def mesh():
    """The mesh of the cards present (see the module docstring)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count()
    if n >= 4:
        return mesh_mod.from_cards(2, 2)
    if n >= 2:
        return mesh_mod.from_cards(1, 2)
    return mesh_mod.Mesh([["cuda:0", "cpu"]])


def _zero():
    for counter in (mac_ops.launches_by_device, ht_ops.launches_by_device,
                    ht_ops.commit_launches_by_device,
                    mv_ops.launches_by_device):
        counter.clear()


def _counts() -> dict:
    return {"mac_many": dict(mac_ops.launches_by_device),
            "lookup": dict(ht_ops.launches_by_device),
            "commit": dict(ht_ops.commit_launches_by_device),
            "validate": dict(mv_ops.launches_by_device)}


def _want(mesh, cfg, depth: int, c_loc: int, steps: int) -> dict:
    """K1-K4 launches of ``steps`` mesh steps by card: a rank's K1 once a
    step on its rows; its K2 once a channel for the read and once for a
    vectorized commit (depth 1), or the fill's and the fused commit's
    (a window); K3 once a channel under a sequential commit; K4 once a
    block position (one-CTA route)."""
    k2 = 2 if depth > 1 or not cfg.sequential_commit else 1
    per = {"mac_many": 1, "lookup": k2 * c_loc,
           "commit": c_loc if cfg.sequential_commit else 0,
           "validate": depth}
    out = {k: collections.Counter() for k in per}
    for row in mesh.devices:
        for dev in row:
            if dev.type == "cuda":
                for k, n in per.items():
                    out[k][str(dev)] += n * steps
    return {k: {d: n for d, n in v.items() if n} for k, v in out.items()}


def _blocks(n_blocks, seed):
    """(n_blocks, B, WB) wire and (n_blocks, B, 2) ids of endorsed blocks,
    on the CPU."""
    eng = engine.FabricEngine(engine.EngineConfig(
        dims=DIMS, store_blocks=False, n_buckets=1 << 12), device="cpu")
    out = []
    for k in range(n_blocks):
        txb = endorser.execute_and_endorse(
            eng.endorser_state, eng.make_proposals(B, seed=seed + 11 * k),
            DIMS)
        out.append((unmarshal.marshal(txb, DIMS), txb.tx_id))
    return (torch.stack([w for w, _ in out]),
            torch.stack([i for _, i in out]))


@pytest.mark.parametrize("name", STEPS)
def test_mesh_step_equals_one_card(name, mesh):
    cfg = STEPS[name]
    depth = cfg.pipeline_depth
    nch = 2
    over = nch % mesh.dp_size == 0
    blocks = [_blocks(2 * depth, 100 * c) for c in range(nch)]
    wire = torch.stack([w for w, _ in blocks]).to(mesh.first)
    ids = torch.stack([i for _, i in blocks]).to(mesh.first)
    one = fs.make_fabric_step(DIMS, cfg, n_shards=mesh.model_size)
    st = fs.create_mesh_state(nch, DIMS, NB, 8, device=mesh.first)
    step = fs.make_fabric_step(DIMS, cfg, mesh=mesh,
                               channels_over_data=over)
    ms = fs.create_mesh_state(nch, DIMS, NB, 8, mesh=mesh,
                              shard_state=cfg.shard_state,
                              channels_over_data=over)
    n_steps = 2 if depth > 1 else 2 * depth
    sl = (lambda k: (wire[:, 4 * k:4 * k + 4], ids[:, 4 * k:4 * k + 4])
          ) if depth > 1 else (lambda k: (wire[:, k], ids[:, k]))
    for k in range(n_steps):
        st, v1 = one(st, *sl(k))
        _zero()
        ms, v2 = step(ms, *sl(k))
        mesh.synchronize()
        assert _counts() == _want(mesh, cfg, depth, nch // (
            mesh.dp_size if over else 1), 1), k
        assert v2.device == mesh.first
        assert torch.equal(v1, v2), k
    got = fs.gather_state(ms)
    for f, a, b in zip(FIELDS, st, got):
        assert torch.equal(a, b), f
    for d, row in enumerate(ms.ranks):
        for m, r in enumerate(row):
            assert all(t.device == mesh.devices[d][m] for t in r)


def test_mesh_window_engine_equals_one_card(mesh, tmp_path):
    """Two channels, sharded, depth 2, durable; a round, a doubling of
    channel 0, two rounds: chain, heads, digests, overflow, verify, the
    snapshot parts, and recover_shard of each shard onto its device."""
    base = engine.FASTFABRIC
    nch = 2
    views, engs = [], []
    for kind in ("one", "mesh"):
        root = str(tmp_path / kind)
        cfg = dataclasses.replace(
            base, dims=DIMS, n_buckets=NB, slots=8, n_channels=nch,
            orderer=dataclasses.replace(base.orderer, block_size=50),
            snapshot_every_blocks=4,
            **{k: os.path.join(root, k)
               for k in ("journal_dir", "snapshot_dir", "block_dir")})
        step = fs.FabricStepConfig(shard_state=True, pipeline_depth=2)
        wc = (eb.WindowCommitter(DIMS, step, n_buckets=NB, n_channels=nch,
                                 mesh=mesh) if kind == "mesh" else
              eb.WindowCommitter(DIMS, step, n_buckets=NB, n_channels=nch,
                                 n_shards=mesh.model_size,
                                 device=mesh.first))
        eng = engine.FabricEngine(cfg, device=wc.device,
                                  window_committer=wc)
        run = lambda seeds: [eng.run_rounds(
            [eng.make_proposals(150, seed=s + 7 * c) for c in range(nch)])
            for s in seeds]
        run((0,))
        eng.resize(2 * NB, channel=0)
        run((1, 2))
        eng.store.drain()
        views.append([{
            "chain": [(sb.block_no, sb.prev_hash, sb.block_hash,
                       sb.valid) for sb in eng.store.chains[c]],
            "journal": wc.journal_head_for(c),
            "ledger": wc.ledger_head_for(c),
            "digest": wc.state_digest(c), "tree": wc.tree_head(c),
            "bits": wc.overflow_bits_for(c),
            "verify": eng.verify(c)} for c in range(nch)])
        engs.append((eng, root))
    for a, b in zip(*views):
        assert len(a["chain"]) == len(b["chain"])
        for x, y in zip(a["chain"], b["chain"]):
            assert x[0] == y[0]
            for u, v in zip(x[1:], y[1:]):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
        for k in ("journal", "ledger", "digest", "tree"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["bits"] == b["bits"] == 0
        assert a["verify"] == b["verify"] and all(a["verify"].values())
    eng, root = engs[1]
    wc = eng.window_committer
    for c in range(nch):
        for k, shard in enumerate(wc.shard_tables(c)):
            rec = recovery.recover_shard(
                eng.chans[c].journal, shard=k, device=shard.keys.device,
                snapshot_dir=engine.ledger.channel_dir(
                    os.path.join(root, "snapshot_dir"), c))
            assert all(torch.equal(x, y) for x, y in zip(rec.state, shard))
    for e, _ in engs:
        e.store.close()


def test_engine_refuses_a_mesh_elsewhere(mesh):
    """An engine on the CPU with a committer whose mesh starts on the
    card is refused, as a one-device committer elsewhere is."""
    wc = eb.WindowCommitter(DIMS, fs.FabricStepConfig(pipeline_depth=2),
                            n_buckets=NB, mesh=mesh)
    with pytest.raises(ValueError, match="window committer on"):
        engine.FabricEngine(dataclasses.replace(
            engine.FASTFABRIC, dims=DIMS, n_buckets=NB), device="cpu",
            window_committer=wc)
    assert u32.to_numpy(wc.state.keys).shape[1] == NB
