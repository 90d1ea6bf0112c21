"""Several channels on a card against the same calls on the CPU, at
TEST_DIMS: K4 over NB independent blocks (``ops.validate_blocks``) against
its plain version at NB = 1-8 on both routes, past the one-CTA limit too,
with one launch (one CTA a block) or two (tiled) for any NB; a four-channel
window committer and a two-channel host-path engine, bit for bit. Imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_multichannel.py

Without a card every test here skips."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import endorser, engine, types, u32, unmarshal
from repro_torch.kernels.mvcc_validate import ops as mv_ops
from repro_torch.kernels.mvcc_validate import ref as mv_ref
from repro_torch.launch import fabric_step as fs
from repro_torch.pipeline import engine_bridge as eb

pytestmark = pytest.mark.gpu
DIMS = types.TEST_DIMS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _blocks(nblk, b, nr=2, nw=2, seed=0):
    """NB blocks of transfers among few accounts (in-block conflicts),
    with empty keys, stale reads and failed checks, on the CPU."""
    rng = np.random.default_rng(seed)
    n_acc = max(4, b // 2)
    key = lambda shape: np.stack([rng.integers(1, n_acc, shape),
                                  rng.integers(0, 3, shape)], -1)
    rk = key((nblk, b, nr)).astype(np.uint32)
    wk = key((nblk, b, nw)).astype(np.uint32)
    rk[rng.random((nblk, b, nr)) < 0.1] = 0
    wk[rng.random((nblk, b, nw)) < 0.1] = 0
    rv = rng.integers(0, 3, (nblk, b, nr)).astype(np.uint32)
    cur = np.where(rng.random((nblk, b, nr)) < 0.9, rv, rv + 1).astype(
        np.uint32)
    ok0 = rng.random((nblk, b)) < 0.95
    return (*(u32.from_numpy(a) for a in (rk, rv, wk, cur)),
            torch.from_numpy(ok0))


@pytest.mark.parametrize("nblk", [1, 2, 5, 8])
def test_validate_blocks_matches_plain(cuda, nblk):
    for b, route, nr, nw in ((100, "cta", 2, 2), (100, "tiled", 2, 2),
                             (160, "cta", 2, 2), (300, "tiled", 2, 2),
                             (1024, "tiled", 2, 2), (70, "tiled", 3, 1)):
        ins = _blocks(nblk, b, nr, nw, seed=nblk * 1000 + b)
        want = mv_ref.validate_blocks_ref(*ins)
        before = mv_ops.launches
        got = mv_ops.validate_blocks(*(t.to(cuda) for t in ins),
                                     route=route)
        torch.cuda.synchronize()
        assert mv_ops.launches - before == (1 if route == "cta" else 2)
        assert torch.equal(got.cpu(), want), (b, route)
        # Each block alone gives its own bits.
        one = mv_ops.validate(*(t[nblk - 1].to(cuda) for t in ins),
                              route=route)
        assert torch.equal(one.cpu(), want[nblk - 1]), (b, route)
    assert mv_ops.route_for(300, 2, 2, cuda) == "tiled"


def _window(depth, n, seed):
    eng = engine.FabricEngine(engine.EngineConfig(
        dims=DIMS, store_blocks=False), device="cpu")
    wires, ids = [], []
    for k in range(depth):
        txb = endorser.execute_and_endorse(
            eng.endorser_state, eng.make_proposals(n, seed=seed + 11 * k),
            DIMS)
        wires.append(unmarshal.marshal(txb, DIMS))
        ids.append(txb.tx_id)
    return torch.stack(wires), torch.stack(ids)


def test_four_channel_committer_card_equals_cpu(cuda):
    """Four channels at depth 4, two windows, channel 2 doubled between
    them: one K4 launch a block position per shape group on the card,
    the same states, bits and chain hashes as on the CPU."""
    wins = [[_window(4, 32, seed=100 * c + w) for c in range(4)]
            for w in range(2)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        wc = eb.WindowCommitter(DIMS, fs.FabricStepConfig(pipeline_depth=4),
                                n_buckets=256, n_channels=4, device=dev)
        res = []
        before = mv_ops.launches
        for w in range(2):
            if w == 1:
                wc.resize(512, channel=2)
            res.append(wc.commit_windows(
                torch.stack([x[0] for x in wins[w]]).to(dev),
                torch.stack([x[1] for x in wins[w]]).to(dev)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert mv_ops.launches - before == 4 + 2 * 4
        out[dev.type] = (
            [(r.valid.cpu(), r.prev_hash, r.block_hash) for r in res],
            [tuple(u32.host_copy(a) for a in wc.channel_state(c))
             for c in range(4)])
    for x, y in zip(out["cuda"][0], out["cpu"][0]):
        assert torch.equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_array_equal(x[2], y[2])
    for c, (x, y) in enumerate(zip(out["cuda"][1], out["cpu"][1])):
        for name, a, b in zip(fs.FabricMeshState._fields, x, y):
            np.testing.assert_array_equal(a, b, err_msg=f"ch{c} {name}")


def test_two_channel_host_engine_card_equals_cpu(cuda):
    cfg = engine.EngineConfig(
        dims=DIMS, n_channels=2, n_buckets=512,
        orderer=dataclasses.replace(engine.FASTFABRIC.orderer,
                                    block_size=50))
    views = []
    for dev in (cuda, "cpu"):
        eng = engine.FabricEngine(cfg, device=dev)
        for r in range(2):
            eng.run_rounds([eng.make_proposals(100 * (c + 1), seed=r + c)
                            for c in range(2)])
        verdict = eng.verify_all()
        eng.store.drain()
        views.append((verdict, [
            ([(sb.block_no, sb.block_hash.tolist(), sb.valid.tolist())
              for sb in eng.store.chains[c]], eng._peer_digest(c).tolist(),
             eng._peer_journal_head(c).tolist()) for c in range(2)]))
        eng.store.close()
    assert views[0] == views[1]
    assert all(all(v.values()) for v in views[0][0].values())
