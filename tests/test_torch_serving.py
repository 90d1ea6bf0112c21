"""The port's serving engine against the JAX ``ServeEngine`` on the CPU, on
the qwen2-7b smoke config with the same weights (``convert.lm_params``)
and the requests of the JAX serving tests: every request's tokens, the
admission order, the request ledger's hash-table arrays (bit for bit, as
``np.uint32``), ``request_version``, the counters and gauges of
``metrics()`` and the ``health()`` status must be identical. (The decode
latency histograms hold wall times, which differ.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jcfg
from repro.models.lm import LM as JLM
from repro.serving import engine as jse
from repro_torch import convert
from repro_torch.configs import base as tcfg
from repro_torch.core import u32
from repro_torch.launch import serve as tserve
from repro_torch.serving import engine as tse


@pytest.fixture(scope="module")
def models():
    jmodel = JLM(jcfg.get_smoke("qwen2-7b"), vocab_chunk=8)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = convert.lm_params(jax.tree.map(np.asarray, params),
                               tcfg.get_smoke("qwen2-7b"), "cpu")
    return jmodel, params, tmodel


def _requests(seed, n, plen, max_new, rid0=0):
    rng = np.random.default_rng(seed)
    return [(rid0 + i, rng.integers(0, 256, plen).astype(np.int32), max_new)
            for i in range(n)]


def _engines(models, slots, max_len):
    jmodel, params, tmodel = models
    return (jse.ServeEngine(jmodel, params, slots=slots, max_len=max_len),
            tse.ServeEngine(tmodel, slots=slots, max_len=max_len))


def _same_state(je, te, specs):
    """Ledger arrays, versions, counters and gauges identical."""
    for jarr, tarr in zip(je.state, te.state):
        np.testing.assert_array_equal(u32.to_numpy(tarr),
                                      np.asarray(jarr, np.uint32))
    for rid, _, _ in specs:
        assert te.request_version(rid) == je.request_version(rid)
    jm, tm = je.metrics(), te.metrics()
    assert jm.keys() == tm.keys()
    for key, val in jm.items():
        if not isinstance(val, dict):  # histograms hold wall times
            assert tm[key] == val, key
    assert (te.steps, te.tokens_out) == (je.steps, je.tokens_out)


def _run_both(models, specs, slots, max_len):
    je, te = _engines(models, slots, max_len)
    jreqs = [jse.Request(rid=r, prompt=p, max_new=m) for r, p, m in specs]
    treqs = [tse.Request(rid=r, prompt=p, max_new=m) for r, p, m in specs]
    je.run(jreqs)
    te.run(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.out == jr.out, f"req {jr.rid}"
        assert tr.done == jr.done
    _same_state(je, te, specs)
    return je, te, treqs


def test_continuous_batching_matches_jax(models):
    """5 prompts of 8 through 2 slots, 6 tokens each (interleaved)."""
    _run_both(models, _requests(3, 5, 8, 6), slots=2, max_len=32)


def test_slot_reuse_and_ledger_match_jax(models):
    """6 requests through 2 slots: every ledger version is 2 (assign +
    retire), in both packages."""
    specs = _requests(4, 6, 4, 3)
    _, te, treqs = _run_both(models, specs, slots=2, max_len=16)
    assert all(r.done for r in treqs)
    assert all(te.request_version(r) == 2 for r, _, _ in specs)
    assert te.tokens_out == sum(len(r.out) - 1 for r in treqs)


def test_admission_order_matches_jax(models):
    specs = _requests(5, 8, 4, 2)
    je, te = _engines(models, 3, 16)
    je.submit([jse.Request(rid=r, prompt=p, max_new=m) for r, p, m in specs])
    te.submit([tse.Request(rid=r, prompt=p, max_new=m) for r, p, m in specs])
    assert [r.rid for r in te.queue] == [r.rid for r in je.queue]
    assert te.metrics() == je.metrics()


def test_metrics_and_health_match_jax(models):
    """Queue-depth gauge, counters and Prometheus text after submit and
    drain; then the health verdicts of the JAX serving test (healthy,
    degraded by a tight p95 objective, critical past twice the queue
    limit)."""
    je, te = _engines(models, 2, 16)
    specs = _requests(6, 5, 4, 3)
    je.submit([jse.Request(rid=r, prompt=p, max_new=m) for r, p, m in specs])
    te.submit([tse.Request(rid=r, prompt=p, max_new=m) for r, p, m in specs])
    assert te.metrics() == je.metrics()
    je.run([])
    te.run([])
    _same_state(je, te, specs)
    text = te.stats_text()
    assert "# TYPE serving_queue_depth gauge" in text
    assert "serving_requests_completed 5" in text
    assert "serving_decode_latency_bucket" in text
    for kw in (dict(decode_p95_s=60.0), dict(decode_p95_s=1e-6)):
        assert te.health(**kw).status == je.health(**kw).status
    flood = _requests(7, 5, 4, 1, rid0=100)
    je.submit([jse.Request(rid=r, prompt=p, max_new=m) for r, p, m in flood])
    te.submit([tse.Request(rid=r, prompt=p, max_new=m) for r, p, m in flood])
    kw = dict(decode_p95_s=60.0, max_queue_depth=2)
    tv, jv = te.health(**kw), je.health(**kw)
    assert tv.status == jv.status == "critical"
    assert tv.reasons == jv.reasons
    assert te.metrics()["serving.health"] == je.metrics()["serving.health"]


def test_serve_launcher_runs_on_the_cpu(capsys):
    stats = tserve.run(["--device", "cpu", "--requests", "3",
                        "--max-new", "3", "--prompt-len", "5"])
    assert stats["completed"] == stats["total"] == 3
    assert "ledger_version=2" in capsys.readouterr().out
