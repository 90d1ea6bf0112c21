"""The storage layer on a card against the same calls on the CPU, at a small
size: a durable engine's files, ``take``, ``verify``, ``recover``,
``restore`` and ``verify()``. Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_storage.py

Without a card every test here skips."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.core import engine, u32
from repro_torch.core import world_state as ws
from repro_torch.storage import recovery, snapshot

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg(root):
    return dataclasses.replace(
        engine.FASTFABRIC, n_buckets=1 << 10,
        orderer=dataclasses.replace(engine.FASTFABRIC.orderer,
                                    block_size=50),
        snapshot_every_blocks=4, snapshot_dir=os.path.join(root, "snap"),
        journal_dir=os.path.join(root, "jrnl"),
        block_dir=os.path.join(root, "blocks"))


def _durable(root, device):
    eng = engine.FabricEngine(_cfg(root), device=device)
    for seed in range(5):
        eng.run_round(eng.make_proposals(150, seed=seed))
    eng.store.drain()
    return eng


def _same_dirs(da, db):
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db))
    for name in names:
        with np.load(os.path.join(da, name)) as za, \
                np.load(os.path.join(db, name)) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype
                assert np.array_equal(za[k], zb[k]), (name, k)


def _words(state):
    return [u32.to_numpy(t) for t in state]


def test_durable_engine_card_equals_cpu(cuda, tmp_path):
    card = _durable(str(tmp_path / "card"), cuda)
    cpu = _durable(str(tmp_path / "cpu"), "cpu")
    for sub in ("snap", "jrnl", "blocks"):
        _same_dirs(tmp_path / "card" / sub, tmp_path / "cpu" / sub)
    assert card.verify() == cpu.verify()
    assert all(card.verify().values())
    got, want = card.recover(), cpu.recover()
    assert got.state.keys.is_cuda
    assert (got.block_no, got.snapshot_block_no, got.replayed_records) == (
        want.block_no, want.snapshot_block_no, want.replayed_records)
    assert np.array_equal(got.state_digest, want.state_digest)
    assert all(np.array_equal(a, b)
               for a, b in zip(_words(got.state), _words(want.state)))
    for n_shards in (1, 4):
        kw = dict(block_no=3, journal_head=np.arange(2, dtype=np.uint32),
                  ledger_head=np.zeros(2, np.uint32), n_shards=n_shards)
        a = snapshot.take(card.peer_state.hash_state, **kw)
        b = snapshot.take(cpu.peer_state.hash_state, **kw)
        for f in a.manifest._fields:
            assert np.array_equal(getattr(a.manifest, f),
                                  getattr(b.manifest, f)), f
        assert snapshot.verify(b) and snapshot.verify(a, cuda)
        assert snapshot.to_state(b).keys.is_cuda
    card.store.close()
    cpu.store.close()


def test_restore_on_card_equals_cpu(cuda, tmp_path):
    live = _durable(str(tmp_path / "live"), "cpu")
    live.store.close()
    on_card = engine.FabricEngine.restore(_cfg(str(tmp_path / "live")))
    on_cpu = engine.FabricEngine.restore(_cfg(str(tmp_path / "live")),
                                         device="cpu")
    assert on_card.device.type == "cuda"
    for a, b in ((on_card.peer_state.hash_state, on_cpu.peer_state.hash_state),
                 (on_card.endorser_state, on_cpu.endorser_state)):
        assert all(np.array_equal(x, y) for x, y in zip(_words(a), _words(b)))
    for f in ("ledger_head", "journal_head", "block_no"):
        assert np.array_equal(u32.to_numpy(getattr(on_card.peer_state, f)),
                              u32.to_numpy(getattr(on_cpu.peer_state, f)))
    assert on_card.next_block_no == on_cpu.next_block_no == 15
    assert on_card.verify() == on_cpu.verify()
    assert all(on_card.verify().values())
    digest = ws.state_digest(live.peer_state.hash_state)
    assert np.array_equal(
        u32.to_numpy(ws.state_digest(on_card.peer_state.hash_state)),
        u32.to_numpy(digest))
    # A tampered snapshot shard is refused on the card too.
    shard = snapshot.shard_path_for(str(tmp_path / "live" / "snap"), 11, 0)
    with np.load(shard) as z:
        arrays = {k: z[k] for k in z.files}
    slot = (*np.argwhere(arrays["keys"][..., 0] != 0)[0], 0)
    arrays["values"][slot] ^= 1
    np.savez(shard, **arrays)
    with pytest.raises(recovery.RecoveryError, match="mismatch"):
        engine.FabricEngine.restore(_cfg(str(tmp_path / "live")))
    on_card.store.close()
    on_cpu.store.close()
