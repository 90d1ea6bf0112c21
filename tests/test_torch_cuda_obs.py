"""Observability and elastic state on a card against the same calls on the
CPU, at a small size: span syncs on CUDA tensors, the overflow and shard
reads of an overflowing engine, and an elastic durable run whose resize
epochs, digests and heads are identical card to CPU. Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_obs.py

Without a card every test here skips."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import engine, u32
from repro_torch.core import world_state as ws

pytestmark = pytest.mark.gpu
BLOCK = 50


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg(**kw):
    return dataclasses.replace(
        engine.FASTFABRIC, obs=True,
        orderer=dataclasses.replace(engine.FASTFABRIC.orderer,
                                    block_size=BLOCK), **kw)


def test_span_syncs_the_card_once_at_exit(cuda, monkeypatch):
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: (calls.append(d), real(d)))
    x = torch.ones(1 << 20, device=cuda)
    tr = obs.Tracer()
    with tr.span("card", sync=lambda: (x, [x * 2])):
        x = x * 3
        assert calls == []
    assert len(calls) == 1 and torch.device(calls[0]).type == "cuda"
    with tr.span("host", sync=torch.zeros(2)):
        pass
    with obs.NULL_TRACER.span("off", sync=x):
        pass
    assert len(calls) == 1
    assert [r["name"] for r in tr.records()] == ["card", "host"]


def test_overflow_reads_and_health_card_equal_cpu(cuda, tmp_path):
    """A static 8 x 2 table overflows: the stacked shard read, the overflow
    bits, the trips and the health verdict are the CPU engine's."""
    views = []
    for dev in (cuda, "cpu"):
        eng = engine.FabricEngine(_cfg(
            n_buckets=8, slots=2,
            recorder_dir=str(tmp_path / str(dev))), device=dev)
        eng.run_round(eng.make_proposals(2 * BLOCK))
        occ, min_free, cap, bits = eng._shard_stats((0,))[0]
        views.append((occ.tolist(), min_free, cap, bits,
                      eng.overflow_bits(), eng.health().to_dict(),
                      [t["reason"] for t in eng.recorder.trips],
                      eng.metrics()["health.status"]))
        eng.store.close()
    assert views[0] == views[1]
    assert views[0][3] == 1 and views[0][5]["status"] == "critical"
    assert views[0][6] == ["overflow_latch"] and views[0][7] == 2
    assert len(os.listdir(tmp_path / str(cuda))) == 5


def test_elastic_durable_run_card_equals_cpu(cuda, tmp_path):
    """ResizePolicy(grow_free_slots=3) on 1,024 x 8, three rounds of 150
    with snapshots every 3 blocks: the same epochs, layout, digest,
    journal and re-anchor heads on both, and a restore on the card resumes
    the grown layout."""
    views = []
    for dev in (cuda, "cpu"):
        root = str(tmp_path / str(dev))
        cfg = _cfg(n_buckets=1 << 10,
                   resize_policy=engine.ResizePolicy(grow_free_slots=3),
                   snapshot_every_blocks=3,
                   snapshot_dir=os.path.join(root, "snap"),
                   journal_dir=os.path.join(root, "jrnl"),
                   block_dir=os.path.join(root, "blocks"))
        eng = engine.FabricEngine(cfg, device=dev)
        for seed in range(3):
            eng.run_round(eng.make_proposals(3 * BLOCK, seed=seed))
        verdict = eng.verify()
        eng.store.close()
        ps = eng.peer_state
        views.append(dict(
            epochs=[r["args"] for r in eng.tracer.records()
                    if r["name"] == "resize.epoch"],
            log=eng.reanchor_log, n_buckets=eng.n_buckets,
            digest=u32.to_numpy(ws.state_digest(ps.hash_state)).tolist(),
            journal=u32.to_numpy(ps.journal_head).tolist(),
            reanchor=np.asarray(eng.journal.reanchor_head).tolist(),
            verdict=verdict))
        if dev is cuda:
            r = engine.FabricEngine.restore(cfg, device=dev)
            assert r.n_buckets == r.peer_state.hash_state.n_buckets == 2048
            assert r.peer_state.hash_state.keys.is_cuda
            assert u32.to_numpy(ws.state_digest(
                r.peer_state.hash_state)).tolist() == views[0]["digest"]
            assert all(r.verify().values())
            r.store.close()
    assert views[0] == views[1]
    assert views[0]["log"] == [(5, 2048)] and all(
        views[0]["verdict"].values())
