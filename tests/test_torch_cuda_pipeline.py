"""The block pipeline on a card against the same calls on the CPU, at
TEST_DIMS: the fabric step at depths 1, 4 and 8 (FASTFABRIC, an
overflowing 8 x 2 table, Fabric 1.2's sequential commit) and the window
engine, bit for bit, with K4 launched once a block and K1 once a window.
Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_pipeline.py

Without a card every test here skips."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import endorser, engine, types, u32, unmarshal
from repro_torch.kernels.hash_table import ops as ht_ops
from repro_torch.kernels.mvcc_validate import ops as mv_ops
from repro_torch.kernels.sig_mac import ops as mac_ops
from repro_torch.launch import fabric_step as fs
from repro_torch.pipeline import engine_bridge as eb

pytestmark = pytest.mark.gpu
DIMS = types.TEST_DIMS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _window(depth, n=32, seed=0, *, read_your_write=False, n_buckets=1 << 12,
            slots=8):
    """(D, B, WB) wire and (D, B, 2) ids of D blocks endorsed by the port's
    endorser on the CPU (read-your-write: every block moves the same
    accounts, the replica updated between blocks)."""
    eng = engine.FabricEngine(engine.EngineConfig(
        dims=DIMS, store_blocks=False, n_buckets=n_buckets, slots=slots),
        device="cpu")
    wires, ids = [], []
    for k in range(depth):
        props = eng.make_proposals(
            n, seed=seed if read_your_write else seed + 11 * k)
        if read_your_write:
            props = props._replace(nonce=u32.add(props.nonce, k * 100003))
        txb = endorser.execute_and_endorse(eng.endorser_state, props, DIMS)
        wires.append(unmarshal.marshal(txb, DIMS))
        ids.append(txb.tx_id)
        if read_your_write:
            eng.endorser_state = endorser.apply_validated(
                eng.endorser_state, txb, torch.ones(n, dtype=torch.bool))
    return torch.stack(wires), torch.stack(ids)


def _counts():
    return (mac_ops.launches, ht_ops.launches, ht_ops.commit_launches,
            mv_ops.launches)


def _run(cfg, wire, ids, depth, device, nb, slots):
    """The step over the window on ``device``: depth 1 a block at a time.
    Returns (state as u32 arrays, valid (D, B), launches on the way)."""
    step = fs.make_fabric_step(DIMS, dataclasses.replace(
        cfg, pipeline_depth=depth))
    st = fs.create_mesh_state(1, DIMS, nb, slots, device=device)
    w, i = wire.to(device), ids.to(device)
    before = _counts()
    if depth == 1:
        valid = []
        for k in range(w.shape[0]):
            st, v = step(st, w[k][None], i[k][None])
            valid.append(v[0])
        valid = torch.stack(valid)
    else:
        st, valid = step(st, w[None], i[None])
        valid = valid[0]
    launched = [a - b for a, b in zip(_counts(), before)]
    return [u32.to_numpy(a) for a in st], valid.cpu().numpy(), launched


def _card_equals_cpu(cuda, cfg, wire, ids, depth, nb=256, slots=8):
    st_c, v_c, n = _run(cfg, wire, ids, depth, cuda, nb, slots)
    st_h, v_h, _ = _run(cfg, wire, ids, depth, "cpu", nb, slots)
    np.testing.assert_array_equal(v_c, v_h)
    for name, a, b in zip(fs.FabricMeshState._fields, st_c, st_h):
        np.testing.assert_array_equal(a, b, err_msg=name)
    d = wire.shape[0]
    windows = d if depth == 1 else 1
    mac, look, commit, validate = n
    assert validate == d  # K4 once a block
    assert mac == windows  # K1 once a window
    seq = cfg.sequential_commit
    assert look == windows * (1 if seq and depth == 1 else 2)
    assert commit == (d if seq and depth == 1 else 0)
    return v_c, st_c


@pytest.mark.parametrize("depth", (1, 4, 8))
def test_fastfabric_window_card_equals_cpu(cuda, depth):
    wire, ids = _window(8, seed=depth)
    v, _ = _card_equals_cpu(cuda, fs.FASTFABRIC_STEP, wire[:max(depth, 4)],
                            ids[:max(depth, 4)], depth)
    assert v.sum() > v.size // 2


def test_read_your_write_window_card_equals_cpu(cuda):
    wire, ids = _window(4, seed=1, read_your_write=True)
    v, _ = _card_equals_cpu(cuda, fs.FASTFABRIC_STEP, wire, ids, 4)
    assert v.all()


@pytest.mark.parametrize("cfg", (fs.FASTFABRIC_STEP, fs.FABRIC_V12_STEP),
                         ids=("fastfabric", "fabric-1.2"))
@pytest.mark.parametrize("depth", (1, 8))
def test_overflow_window_card_equals_cpu(cuda, cfg, depth):
    wire, ids = _window(8, n=16, seed=1, read_your_write=True, n_buckets=8,
                        slots=2)
    v, st = _card_equals_cpu(cuda, cfg, wire, ids, depth, nb=8, slots=2)
    assert st[-1].any() and 0 < v.sum() < v.size


def test_window_engine_card_equals_cpu(cuda):
    """Two rounds of 600 at depth 4 (a window and a tail of 2 a round):
    chain, heads, digests and verify() equal on both."""
    views = []
    for device in (cuda, "cpu"):
        wc = eb.WindowCommitter(DIMS, fs.FabricStepConfig(pipeline_depth=4),
                                device=device)
        e = engine.FabricEngine(engine.EngineConfig(dims=DIMS),
                                device=device, window_committer=wc)
        before = _counts()
        for seed in range(2):
            e.run_round(e.make_proposals(600, seed=seed))
        launched = [a - b for a, b in zip(_counts(), before)]
        verdict = e.verify()
        e.store.drain()
        views.append(([(sb.block_no, sb.block_hash.tolist(),
                        sb.valid.tolist()) for sb in e.store.chain],
                      e._peer_digest().tolist(),
                      e._peer_journal_head().tolist(), verdict))
        e.store.close()
        if device == cuda:
            # K1: 2 a round and 1 a window; K4: 1 a block.
            assert launched[0] == 2 * 2 + 4 and launched[3] == 12
    assert views[0] == views[1]
    assert all(views[0][3].values())
