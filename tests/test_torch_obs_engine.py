"""The port's engine with observability on, beside the JAX engine on the same
proposals: the same metric keys and counters, histogram counts, trace
records (times taken out), exemplar and lifecycle tx-ids, fault trips and
health verdicts; with obs off, no sync target is called, no host copy or
overflow read is made, and the registry stays empty. The JAX engines of
the shared rounds run once for the module."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro import obs as jobs
from repro.core import endorser as je, engine as jeng
from repro_torch import obs as tobs
from repro_torch.core import endorser as te, engine as teng, u32
from repro_torch.obs import trace as ttrace

BLOCK = 50
DUMP_FILES = {"trace.jsonl", "trace_chrome.json", "metrics.json",
              "lifecycles.json", "meta.json"}


def _cfg(mod, root, **kw):
    base = mod.FASTFABRIC
    return dataclasses.replace(
        base, n_buckets=1024, obs=True,
        orderer=dataclasses.replace(base.orderer, block_size=BLOCK),
        snapshot_every_blocks=4, snapshot_dir=os.path.join(root, "snap"),
        journal_dir=os.path.join(root, "jrnl"),
        block_dir=os.path.join(root, "blocks"),
        recorder_dir=os.path.join(root, "dump"), **kw)


def _conflicting(mod, n, seed=5):
    """Transfers among 64 accounts with src != dst: conflicts and stale
    reads, so both outcomes appear."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 64, n, dtype=np.uint32)
    dst = ((src + rng.integers(1, 64, n, dtype=np.uint32)) % 64).astype(
        np.uint32)
    cols = dict(src=src, dst=dst,
                amount=rng.integers(1, 1000, n, dtype=np.uint32),
                client=rng.integers(0, 64, n, dtype=np.uint32),
                nonce=np.arange(n, dtype=np.uint32) + np.uint32(seed << 16))
    if mod is jeng:
        return je.Proposal(**{k: jnp.asarray(v) for k, v in cols.items()})
    return te.Proposal(**{k: u32.from_numpy(v, "cpu")
                          for k, v in cols.items()})


def _engine(mod, cfg):
    return (mod.FabricEngine(cfg) if mod is jeng
            else mod.FabricEngine(cfg, device="cpu"))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both engines over two disjoint rounds and a conflicting one (9
    blocks, a snapshot at block 5, blocks 6-8 in the journal's suffix),
    then health()."""
    out = {}
    for name, mod in (("jax", jeng), ("torch", teng)):
        eng = _engine(mod, _cfg(mod, str(tmp_path_factory.mktemp(name))))
        for seed in (0, 1):
            eng.run_round(eng.make_proposals(3 * BLOCK, seed=seed))
        eng.run_round(_conflicting(mod, 3 * BLOCK))
        eng.store.drain()
        eng.health()
        out[name] = eng
    yield out
    for eng in out.values():
        eng.store.close()


def _split(m):
    """metrics() -> (plain values, histogram counts)."""
    plain = {k: v for k, v in m.items() if not isinstance(v, dict)}
    return plain, {k: v["count"] for k, v in m.items() if isinstance(v, dict)}


def test_metrics_match_jax(pair):
    j, t = pair["jax"].metrics(), pair["torch"].metrics()
    assert sorted(t) == sorted(j)
    assert _split(t) == _split(j)
    assert t["txs.valid"] == pair["torch"].total_valid < 9 * BLOCK
    assert t["journal.appends"] == 9 and t["snapshot.saves"] == 1
    assert t["commit.latency"]["count"] == 9
    # the conflicting round's validity rate is under the 0.99 objective
    assert t["health.status"] == 1
    families = lambda text: sorted(ln for ln in text.splitlines()
                                   if ln.startswith("# TYPE"))
    assert families(pair["torch"].stats_text()) == families(
        pair["jax"].stats_text())


def test_trace_records_match_jax(pair):
    """The same spans and nesting (round.order, round.commit with a
    block.ship per block, round.endorser_replay, snapshot.take), args
    included; the times (and dump paths) differ."""
    untimed = lambda eng: [
        (r["name"], r["depth"], r["parent"],
         {k: v for k, v in r["args"].items() if k != "dump"})
        for r in eng.tracer.records()]
    t = untimed(pair["torch"])
    assert t == untimed(pair["jax"])
    names = [r[0] for r in t]
    assert names.count("round.order") == 3 and names.count("block.ship") == 9
    assert names.count("snapshot.take") == 1
    assert all(r[2] == "round.commit" for r in t if r[0] == "block.ship")


def test_exemplars_lifecycles_and_phases_match_jax(pair):
    """Exemplar and lifecycle tx-ids are the JAX engine's; the phases sum
    to e2e and count every transaction; outcomes add up to the totals."""
    eng = pair["torch"]
    m = eng.metrics()
    lc = lambda e: [(x["tx_id"], x["block_no"], x["outcome"])
                    for x in e.txtrace.lifecycles.items()]
    assert lc(eng) == lc(pair["jax"])
    first = {b: tx for tx, b, _ in lc(pair["jax"])}
    assert len(first) == 9
    for name, h in m.items():
        for key, exs in (h.items() if isinstance(h, dict) else ()):
            if key.endswith("_exemplars"):
                assert all(first[e["block_no"]] == e["tx_id"]
                           or e["tx_id"] in {x[0] for x in lc(eng)}
                           for e in exs), name
    for p in ("queue", "order", "validate", "commit"):
        assert m[f"tx.phase.{p}"]["count"] == eng.total_txs
    s = sum(m[f"tx.phase.{p}"]["sum"]
            for p in ("queue", "order", "validate", "commit"))
    assert s == pytest.approx(m["tx.e2e"]["sum"], rel=1e-9)
    valid = m["tx.outcome{outcome=valid}"]
    assert valid == eng.total_valid
    assert valid + m["tx.outcome{outcome=mvcc_conflict}"] == eng.total_txs
    assert m["tx.phase.commit"]["p99_exemplars"]


def _trip_view(eng):
    return [(t["reason"], sorted(t["ctx"])) for t in eng.recorder.trips]


def test_verify_contract_trip_matches_jax(pair):
    """A word flipped in the newest journal record: verify() fails, trips
    verify_contract with the journal's reason, and auto-dumps."""
    ctxs = []
    for name in ("jax", "torch"):
        eng = pair[name]
        rec = eng.journal.records[-1]
        vals = np.array(rec.write_vals, copy=True)
        vals[0, 0, 0] ^= 1
        eng.journal.records[-1] = rec._replace(write_vals=vals)
        try:
            out = eng.verify()
        finally:
            eng.journal.records[-1] = rec
        assert not out["recovery_ok"]
        assert eng.recorder.trips[-1]["reason"] == "verify_contract"
        ctxs.append(eng.recorder.trips[-1]["ctx"])
    assert ctxs[1] == ctxs[0]
    assert "recomputed head mismatch" in ctxs[1]["journal_reason"]
    dump = pair["torch"].cfg.recorder_dir
    assert set(os.listdir(dump)) == DUMP_FILES
    meta = json.load(open(os.path.join(dump, "meta.json")))
    assert meta["trips"][-1]["reason"] == "verify_contract"
    assert json.load(open(os.path.join(dump, "lifecycles.json")))
    assert all(pair["torch"].verify().values())


def test_overflow_latch_trip_and_health_match_jax(tmp_path):
    """A static undersized table (8 buckets x 2 slots) latches overflow:
    an overflow_latch trip, an auto-dump, health() critical with a shard
    reason and health.status 2, as in the JAX engine."""
    views = []
    for name, mod in (("jax", jeng), ("torch", teng)):
        cfg = dataclasses.replace(
            _cfg(mod, str(tmp_path / name)), n_buckets=8, slots=2,
            snapshot_every_blocks=0,
            slo=(jobs if mod is jeng else tobs).SLOConfig(commit_p95_s=60.0))
        eng = _engine(mod, cfg)
        st = eng.run_round(eng.make_proposals(3 * BLOCK, seed=0))
        v = eng.health()
        m = eng.metrics()
        views.append((st.n_valid, eng.overflow_bits(), v.to_dict(),
                      _trip_view(eng), eng.recorder.trips[0]["ctx"],
                      _split(m)))
        eng.store.close()
    assert views[1] == views[0]
    _, bits, verdict, trips, ctx, (plain, _) = views[1]
    assert bits == 1 and verdict["status"] == "critical"
    assert any("shard 0" in r and "overflow" in r for r in verdict["reasons"])
    assert trips == [("overflow_latch", ["bits", "channel"])]
    assert ctx == {"channel": 0, "bits": 1}
    assert plain["health.status"] == 2 and plain["overflow.latches"] == 1
    assert plain["tx.outcome{outcome=overflow_dropped}"] == 3 * BLOCK
    assert set(os.listdir(tmp_path / "torch" / "dump")) == DUMP_FILES


def test_exception_trip_matches_jax():
    trips = []
    for mod in (jeng, teng):
        eng = _engine(mod, dataclasses.replace(mod.EngineConfig(), obs=True))
        with pytest.raises(ValueError, match="multiple"):
            eng.run_round(eng.make_proposals(77))
        trips.append((_trip_view(eng), eng.recorder.trips[0]["ctx"]))
        eng.store.close()
    assert trips[1] == trips[0]
    assert trips[1][0] == [("exception", ["channel", "error", "where"])]
    assert "ValueError" in trips[1][1]["error"]


def test_obs_off_round_adds_no_sync_or_copy(monkeypatch):
    """Obs off: the null tracer never resolves a sync target, the engine
    syncs at the round's four edges as before, reads no overflow flag and
    makes no tx-id copy; metrics() stays empty through health()."""
    eng = teng.FabricEngine(dataclasses.replace(
        teng.FASTFABRIC, n_buckets=1024), device="cpu")
    assert isinstance(eng.txtrace, tobs.NullTxTracer)
    assert eng.obs.tracer is tobs.NULL_TRACER

    def forbidden(*a, **k):
        raise AssertionError("obs off touched an obs-only read")

    def begin_round(channel, tx_ids, block_size, block_no0):
        assert tx_ids is None  # no sidecar copy
        return tobs.NULL_ROUND

    syncs = []
    monkeypatch.setattr(ttrace, "_block", forbidden)
    monkeypatch.setattr(eng, "overflow_bits", forbidden)
    monkeypatch.setattr(eng, "_shard_stats", forbidden)
    monkeypatch.setattr(eng, "_sync", lambda: syncs.append(1))
    monkeypatch.setattr(eng.txtrace, "begin_round", begin_round)
    st = eng.run_round(eng.make_proposals(200))
    monkeypatch.undo()
    assert st.n_valid == 200 and len(syncs) == 4
    assert eng.metrics() == {} and eng.tracer.records() == []
    assert eng.health().status == "healthy"
    assert eng.metrics() == {}
    eng.store.close()


def test_shared_registry_handle_and_no_metrics_keyword(tmp_path):
    """cfg.obs takes an Obs handle: Obs(registry=reg) gives the durability
    layer's metrics to ``reg`` with tracing off; the keyword is gone."""
    reg = tobs.Registry()
    cfg = dataclasses.replace(_cfg(teng, str(tmp_path)),
                              obs=tobs.Obs(registry=reg))
    eng = teng.FabricEngine(cfg, device="cpu")
    assert not eng.obs.on and eng.metrics() is not None
    eng.run_round(eng.make_proposals(6 * BLOCK))
    eng.store.drain()
    assert reg.counter("journal.appends").value == 6
    assert reg.counter("snapshot.saves").value == 1
    assert eng.tracer.records() == []
    eng.store.close()
    with pytest.raises(TypeError):
        teng.FabricEngine(cfg, device="cpu", metrics=reg)
    with pytest.raises(TypeError):
        teng.FabricEngine.restore(cfg, device="cpu", metrics=reg)


def test_metrics_stable_across_restore_match_jax(tmp_path):
    """A restored engine starts a fresh registry: reloading is not an
    append, and post-restore rounds count from zero, as in JAX."""
    views = []
    for name, mod in (("jax", jeng), ("torch", teng)):
        cfg = dataclasses.replace(_cfg(mod, str(tmp_path / name)),
                                  snapshot_every_blocks=2, block_dir=None)
        eng = _engine(mod, cfg)
        eng.run_round(eng.make_proposals(3 * BLOCK, seed=1))
        m1 = eng.metrics()
        eng.store.drain()
        eng.store.close()
        eng2 = (mod.FabricEngine.restore(cfg) if mod is jeng
                else mod.FabricEngine.restore(cfg, device="cpu"))
        m2 = eng2.metrics()
        eng2.run_round(eng2.make_proposals(3 * BLOCK, seed=2))
        m3 = eng2.metrics()
        views.append((_split(m1), _split(m2), _split(m3),
                      all(eng2.verify().values())))
        eng2.store.close()
    assert views[1] == views[0]
    (p1, h1), (p2, h2), (p3, h3), ok = views[1]
    assert p1["journal.appends"] == 3 and h1["commit.latency"] == 3
    assert p2.get("journal.appends", 0) == 0 and "commit.latency" not in h2
    assert p3["journal.appends"] == 3 and h3["commit.latency"] == 3
    assert ok
