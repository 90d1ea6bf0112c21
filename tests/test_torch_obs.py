"""The port's obs modules (tracer, ring, health rollup, tx tracing, flight
recorder, ``Obs`` handle) against the JAX package's ``repro.obs`` on the
same inputs: records and verdicts equal with the times taken out."""

import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import recorder as jrec, txtrace as jtx
from repro_torch import obs as tobs
from repro_torch.core import u32
from repro_torch.obs import recorder as trec, trace as ttrace
from repro_torch.obs import txtrace as ttx

TIMES = ("ts", "dur", "tid")
DUMP_FILES = {"trace.jsonl", "trace_chrome.json", "metrics.json",
              "lifecycles.json", "meta.json"}


def _untimed(recs):
    return [{k: v for k, v in r.items() if k not in TIMES} for r in recs]


def _drive(tracer):
    """The same spans and events, nested two deep, on either tracer."""
    with tracer.span("round.order", channel=0):
        tracer.event("resize.decision", action="grow", n_buckets=8)
    with tracer.span("round.commit", n_blocks=2, channel=0):
        for b in range(2):
            with tracer.span("block.ship", block_no=b, channel=0):
                pass
    tracer.event("resize.epoch", block_no=1, new_n_buckets=16)
    return tracer


def test_tracer_records_and_chrome_match_jax(tmp_path):
    j, t = _drive(jobs.Tracer()), _drive(tobs.Tracer())
    assert _untimed(t.records()) == _untimed(j.records())
    assert [(r["name"], r["depth"], r["parent"]) for r in t.records()] == [
        ("round.order", 0, None), ("resize.decision", 1, "round.order"),
        ("round.commit", 0, None), ("block.ship", 1, "round.commit"),
        ("block.ship", 1, "round.commit"), ("resize.epoch", 0, None)]
    assert (_untimed(t.chrome_events()) == _untimed(j.chrome_events()))
    assert {e["ph"] for e in t.chrome_events()} == {"X", "i"}
    t.dump_jsonl(tmp_path / "t.jsonl")
    t.dump_chrome(tmp_path / "t.json")
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert _untimed(json.loads(x) for x in lines) == _untimed(j.records())
    chrome = json.loads((tmp_path / "t.json").read_text())
    assert len(chrome["traceEvents"]) == 6


@pytest.mark.parametrize("capacity", [1, 3, None])
def test_ring_and_bounded_tracer_drop_counter(capacity):
    rings = (jobs.Ring(capacity), tobs.Ring(capacity))
    for r in rings:
        for i in range(7):
            r.push(i)
    assert rings[0].items() == rings[1].items()
    assert rings[0].dropped == rings[1].dropped
    if capacity is None:
        return
    handles = (jobs.Obs.enabled(max_events=capacity),
               tobs.Obs.enabled(max_events=capacity))
    for o in handles:
        _drive(o.tracer)
    j, t = handles
    assert t.tracer.dropped_events == j.tracer.dropped_events == 6 - capacity
    assert t.registry.collect() == j.registry.collect()
    assert _untimed(t.tracer.records()) == _untimed(j.tracer.records())


def test_obs_handle_on_off():
    for mod in (jobs, tobs):
        assert mod.Obs.enabled().on and not mod.Obs.disabled().on
        assert not mod.Obs(registry=mod.Registry()).on
        assert mod.Obs.disabled().registry is mod.NULL_REGISTRY
    assert isinstance(tobs.Obs.disabled().tracer, tobs.NullTracer)


def test_span_sync_targets_and_null_tracer_never_syncs():
    """A live span resolves its target once at exit (callable, tensor, or
    a tuple of tensors; CPU tensors need no sync); the null tracer never
    calls it, and neither does a span that raised."""
    calls = []

    def target():
        calls.append(1)
        return (torch.zeros(2), [torch.ones(1)])

    with tobs.NULL_TRACER.span("x", sync=target) as sp:
        sp.set_sync(target)
    assert calls == []
    tr = tobs.Tracer()
    with tr.span("a", sync=target):
        assert calls == []
    assert calls == [1]
    with tr.span("b", sync=torch.zeros(3)):
        pass
    with pytest.raises(RuntimeError):
        with tr.span("c", sync=target):
            raise RuntimeError("boom")
    assert calls == [1]
    assert [r["name"] for r in tr.records()] == ["a", "b", "c"]
    assert len(list(ttrace._tensors((torch.zeros(1), [torch.ones(2)],
                                     3)))) == 2


def test_health_rollup_verdicts_match_jax():
    """The same pushes give the same verdicts (the JAX package's
    transition test as the model)."""
    def run(mod):
        slo = mod.SLOConfig(commit_p95_s=0.1, min_validity_rate=0.9,
                            critical_validity_rate=0.5, max_occupancy=0.8,
                            window_rounds=4)
        hr = mod.HealthRollup(slo, n_channels=2)
        out = []
        for c in range(2):
            hr.push_round(c, n_txs=100, n_valid=100, wall_s=0.01,
                          n_blocks=2)
        out.append(hr.evaluate().to_dict())
        hr.push_round(1, n_txs=100, n_valid=70, wall_s=0.01, n_blocks=2)
        out.append(hr.evaluate().to_dict())
        hr.push_round(1, n_txs=300, n_valid=0, wall_s=0.01, n_blocks=2)
        out.append(hr.evaluate().to_dict())
        hr.set_overflow(1, 0b100)
        out.append(hr.evaluate().to_dict())
        hr.set_overflow(1, 0)
        for _ in range(4):
            hr.push_round(0, n_txs=10, n_valid=10, wall_s=1.0, n_blocks=2)
        hr.set_occupancy(0, [0.2, 0.95])
        out.append(hr.evaluate().to_dict())
        return out

    j, t = run(jobs), run(tobs)
    assert t == j
    assert [v["status"] for v in t] == [
        "healthy", "degraded", "critical", "critical", "critical"]
    assert any("shard 2" in r for r in t[3]["channels"][1]["reasons"])
    assert any("commit p95" in r for r in t[4]["channels"][0]["reasons"])
    assert any("shard 1" in r and "occupancy" in r
               for r in t[4]["channels"][0]["reasons"])


def _tx_round(obs, ids, valid, latched=False):
    """One traced round of 3 blocks of 4 on the package's TxTracer."""
    tr = obs.TxTracer(obs.Registry())
    rt = tr.begin_round(0, ids, 4, 10)
    rt.order_start()
    rt.ordered()
    rt.validated(0, 2)
    rt.committed()
    rt.finish(valid, overflow_latched=latched)
    return tr


@pytest.mark.parametrize("latched", [False, True])
def test_txtrace_outcomes_and_lifecycles_match_jax(latched):
    """Same tx-ids (words at and above 2^31) and validity: the same outcome
    counters, histogram counts, exemplar and lifecycle tx-ids."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 1 << 32, (12, 2), dtype=np.uint64).astype(
        np.uint32)
    ids[0] = (0x80000000, 0xFFFFFFFF)
    valid = [np.array([1, 1, 1, 1], bool), np.array([1, 0, 1, 0], bool),
             np.array([0, 0, 0, 0], bool)]
    j = _tx_round(jobs, ids, valid, latched=latched)
    t = _tx_round(tobs, ids, valid, latched=latched)
    jm, tm = j.registry.collect(), t.registry.collect()
    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        if isinstance(v, dict):
            assert tm[k]["count"] == v["count"] == 12, k
            ex = lambda m: sorted(e["tx_id"] for key, es in m.items()
                                  if key.endswith("_exemplars")
                                  for e in es)
            assert ex(tm[k]) == ex(v), k
        else:
            assert tm[k] == v, k
    ok = "overflow_dropped" if latched else "valid"
    assert tm[f"tx.outcome{{outcome={ok}}}"] == 6
    assert tm["tx.outcome{outcome=mvcc_conflict}"] == 6
    lc = lambda tr: [(x["tx_id"], x["block_no"], x["outcome"])
                     for x in tr.lifecycles.items()]
    assert lc(t) == lc(j)
    assert lc(t)[0] == ("80000000ffffffff", 10, ok)
    s = tm["tx.phase.queue"]["sum"] + tm["tx.phase.order"]["sum"] + \
        tm["tx.phase.validate"]["sum"] + tm["tx.phase.commit"]["sum"]
    assert s == pytest.approx(tm["tx.e2e"]["sum"], rel=1e-9)


def test_null_txtracer_is_inert():
    rt = tobs.NULL_TXTRACER.begin_round(0, None, 4, 0)
    for step in (rt.order_start, rt.ordered, rt.committed, rt.finish):
        step()
    rt.validated(0, 1)
    assert tobs.NULL_TXTRACER.lifecycles is None


def test_recorder_dump_matches_jax(tmp_path):
    """Both recorders fed the same records, lifecycles and trips write the
    same five files; meta.json equal with the times taken out."""
    ids = np.array([[0x90000000, 1], [2, 3]] * 2, np.uint32)
    valid = [np.array([1, 0], bool), np.array([1, 1], bool)]
    metas, lifecycles = [], []
    for mod, xm, name in ((jobs, jtx, "jax"), (tobs, ttx, "torch")):
        o = mod.Obs.enabled(max_events=64)
        rec = mod.FlightRecorder(capacity=4, registry=o.registry,
                                 dump_dir=str(tmp_path / name))
        rec.attach(o.tracer)
        _drive(o.tracer)
        tt = xm.TxTracer(o.registry, recorder=rec)
        rt = tt.begin_round(0, ids, 2, 0)
        rt.finish(valid)
        rec.snapshot_registry()
        path = rec.trip("overflow_latch", channel=0, bits=1,
                        verdict={"chain_ok": True})
        assert path == str(tmp_path / name) and rec.tripped
        assert {p.name for p in (tmp_path / name).iterdir()} == DUMP_FILES
        meta = json.loads((tmp_path / name / "meta.json").read_text())
        for trip in meta["trips"]:
            trip.pop("ts")
        metas.append(meta)
        lifecycles.append([
            {k: v for k, v in x.items() if k in ("tx_id", "outcome",
                                                 "block_no")}
            for x in json.loads(
                (tmp_path / name / "lifecycles.json").read_text())])
    assert metas[1] == metas[0]
    assert metas[1]["dropped"]["spans"] == 3  # 7 records into 4 slots
    assert lifecycles[1] == lifecycles[0]
    assert lifecycles[1][0]["tx_id"] == "9000000000000001"


def test_recorder_without_dump_dir_logs_the_trip():
    rec = tobs.FlightRecorder()
    rec.attach(tobs.NULL_TRACER)
    assert rec.trip("exception", where="run_round", error="x") is None
    assert rec.tripped and rec.trips[0]["reason"] == "exception"
    assert [r["name"] for r in rec.spans.items()] == [
        "flightrec.trip.exception"]


def test_jsonable_takes_tensors_as_unsigned_words():
    """Tensors become numbers and lists; an int32 word holding bits at or
    above 2^31 becomes its unsigned value, as the JAX package's u32 scalar
    does."""
    hi = 0x80000005
    word = torch.tensor(u32.s32(hi), dtype=torch.int32)
    assert trec._jsonable(word) == jrec._jsonable(np.uint32(hi)) == hi
    words = u32.from_numpy(np.array([[hi, 0xFFFFFFFF], [1, 2]], np.uint32))
    assert trec._jsonable({"head": words, "n": torch.tensor(3),
                           "ok": torch.tensor(True),
                           "f": torch.tensor(0.5)}) == {
        "head": [[hi, 0xFFFFFFFF], [1, 2]], "n": 3, "ok": True, "f": 0.5}
    ctx = {"bits": 3, "v": (1, "a"), "none": None}
    assert trec._jsonable(ctx) == jrec._jsonable(ctx)
    assert trec._jsonable(object()).startswith("<object")
    json.dumps(trec._jsonable({"t": words}))
