"""The port's ``LM`` for the moe and ssm families against the JAX ``LM`` on
the CPU, at the qwen2-moe (6 experts, top-2, 2 shared), moonshot (8
experts, top-2, 1 shared) and mamba2 smoke configs, with the JAX ``init``
weights carried over by ``convert.lm_params`` (norm scales and the conv
bias perturbed so they matter) and the same numpy tokens: logits, the loss
with its CE and MoE aux, ``prefill`` and greedy ``decode_step``s (logits,
tokens and caches), and the MoE serving engine against the JAX
``ServeEngine``.

Logits and losses within atol = rtol = 1e-4 and caches within 1e-5, as in
``test_torch_lm.py``: two f32 layers summed in other orders stay ~1e-6
apart, and a different MoE drop moves a logit by ~1e-2. The MoE models
run at capacity factor 1.0 (drops in the 32-token forward and in decode),
the serving engine at 2.0, as the serving launchers build them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.launch import serve as jserve
from repro.models.lm import LM as JLM, Batch as JBatch
from repro.serving import engine as jse
from repro_torch import convert
from repro_torch.configs import base as tcfg
from repro_torch.core import u32
from repro_torch.launch import serve as tserve, train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.lm import LM, Batch
from repro_torch.serving import engine as tse

ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "mamba2-2.7b")
TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
N_DECODE = 4


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].key in ("scale", "conv_b"):
            a = a + rng.normal(size=a.shape).astype(a.dtype) * 0.1
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(arch, seed=0, **kw):
    jmodel = JLM(jcfg.get_smoke(arch), **kw)
    np_params = _perturbed(jmodel.init(jax.random.PRNGKey(seed)), seed)
    tmodel = convert.lm_params(np_params, tcfg.get_smoke(arch), "cpu", **kw)
    return jmodel, jax.tree.map(jnp.asarray, np_params), tmodel


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param, moe_capacity_factor=1.0, ssd_chunk=8)


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)
                                                ).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_logits_and_loss_match_jax(pair):
    jmodel, jparams, tmodel = pair
    toks, labels = _tokens(1, 2, 16), _tokens(2, 2, 16)
    labels[0, :3] = -1
    _close(tmodel.logits(Batch(tokens=torch.from_numpy(toks))),
           jmodel.logits(jparams, JBatch(tokens=jnp.asarray(toks))))
    jl, jm = jmodel.loss(jparams, JBatch(tokens=jnp.asarray(toks),
                                         labels=jnp.asarray(labels)))
    tl_, tm = tmodel.loss(Batch(tokens=torch.from_numpy(toks),
                                labels=torch.from_numpy(labels)))
    assert tm.keys() == jm.keys()
    for got, want in [(tl_, jl)] + [(tm[k], jm[k]) for k in jm]:
        assert float(got) == pytest.approx(float(want), abs=1e-4, rel=1e-4)
    if tmodel.cfg.family == "moe":
        assert float(tl_) == pytest.approx(float(tm["ce"])
                                           + 0.01 * float(tm["aux"]))


def _caches(tc, jc):
    if tc.k is not None:
        return [(tc.k, jc.k), (tc.v, jc.v)]
    return [(tc.conv, jc.conv), (tc.ssm_state, jc.ssm_state)]


def test_prefill_and_decode_match_jax(pair):
    """Prefill a batch of 2 x 16 into a cache of 24, then 4 greedy decode
    steps: logits, greedy tokens and the caches after each call."""
    jmodel, jparams, tmodel = pair
    jdecode = jax.jit(jmodel.decode_step)  # one compile for the 4 steps
    toks = _tokens(3, 2, 16)
    jlog, jcache = jmodel.prefill(jparams, JBatch(tokens=jnp.asarray(toks)),
                                  jmodel.init_cache(2, 24))
    tlog, tcache = tmodel.prefill(Batch(tokens=torch.from_numpy(toks)),
                                  tmodel.init_cache(2, 24))
    pos = toks.shape[1]
    for step in range(N_DECODE + 1):
        _close(tlog, jlog)
        for got, want in _caches(tcache, jcache):
            assert got.dtype == torch.float32
            _close(got, want, **CACHE_TOL)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, dim=-1).numpy(), tok)
        if step == N_DECODE:
            break
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                               jnp.int32(pos))
        tlog, tcache = tmodel.decode_step(tcache, torch.from_numpy(tok), pos)
        pos += 1


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b"])
def test_prefill_decode_consistency(arch):
    """The JAX test's check (``tests/test_models.py``) on the port: a
    prefill of 11 tokens and one decode step give the full forward's
    logits at positions 10 and 11 (atol 2e-4, rtol 1e-4). The MoE model
    runs at capacity factor n_experts, where nothing drops: routing the 24
    tokens at once and 2 at a time then keeps the same assignments."""
    cfg = tcfg.get_smoke(arch)
    model = LM(cfg, vocab_chunk=8, moe_capacity_factor=float(
        max(cfg.n_experts, 1)), device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(4, 2, 12))
    full = model.logits(Batch(tokens=toks))
    lg_pre, cache = model.prefill(Batch(tokens=toks[:, :11]),
                                  model.init_cache(2, 16))
    lg_dec, _ = model.decode_step(cache, toks[:, 11], 11)
    tol = dict(atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(lg_pre.numpy(), full[:, -2].numpy(), **tol)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, -1].numpy(), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_count_and_leaf_dtypes(arch):
    """At a bf16 config: the port's ``init`` holds cfg.n_params() weights
    (the smoke vocab needs no padding) with the JAX init's leaf shapes and
    dtypes (f32 router, dt_bias, A_log and D; bf16 else), in the JAX
    flatten order; ``convert.lm_params`` gives the same dtypes from the
    JAX tree and from that tree cast to f32 (as ``export_train_state``
    writes it): a leaf's dtype follows its role, not its array."""
    jc = dataclasses.replace(jcfg.get_smoke(arch), dtype="bfloat16")
    tc = dataclasses.replace(tcfg.get_smoke(arch), dtype="bfloat16")
    jparams = JLM(jc).init(jax.random.PRNGKey(0))
    want = [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jparams)]
    model = LM(tc, device="cpu").init(torch.Generator().manual_seed(0))
    conv = convert.lm_params(jax.tree.map(np.asarray, jparams), tc, "cpu")
    conv32 = convert.lm_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tc, "cpu")
    assert sum(p.numel() for p in model.parameters()) == tc.n_params()
    for m in (model, conv, conv32):
        # a leaf under ``layers`` is one tensor a layer (2 here), stacked
        # in JAX
        got = [(((len(g),) if len(g) > 1 else ()) + tuple(g[0].shape),
                str(g[0].dtype).split(".")[-1])
               for g in tlm.jax_leaves(m.params.tree())]
        assert [(tuple(s), d) for s, d in want] == got
    f32 = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
    names = {n.rsplit(".", 1)[-1] for n in f32}
    assert names == ({"router"} if tc.family == "moe"
                     else {"dt_bias", "A_log", "D"})


def _engine_pair(slots, max_len):
    arch = "qwen2-moe-a2.7b"
    jmodel = JLM(jcfg.get_smoke(arch), moe_capacity_factor=2.0)
    params = jmodel.init(jax.random.PRNGKey(5))
    tmodel = convert.lm_params(jax.tree.map(np.asarray, params),
                               tcfg.get_smoke(arch), "cpu",
                               moe_capacity_factor=2.0)
    return (jse.ServeEngine(jmodel, params, slots=slots, max_len=max_len),
            tse.ServeEngine(tmodel, slots=slots, max_len=max_len))


def test_moe_serving_matches_jax():
    """Three requests through two slots (6, 3 and 9 new tokens): the short
    one retires, the third takes its slot, and the last steps decode with
    one slot inactive (which still takes expert capacity in both
    packages). Admission order, every request's tokens, the request
    ledger's arrays and versions identical."""
    je, te = _engine_pair(2, 32)
    rng = np.random.default_rng(6)
    specs = [(10 + i, rng.integers(0, 256, 8).astype(np.int32), m)
             for i, m in enumerate((6, 3, 9))]
    jreqs = [jse.Request(rid=r, prompt=p, max_new=m) for r, p, m in specs]
    treqs = [tse.Request(rid=r, prompt=p, max_new=m) for r, p, m in specs]
    je.submit(jreqs)
    te.submit(treqs)
    assert [r.rid for r in te.queue] == [r.rid for r in je.queue]
    masks = []
    decode_fn = te.decode_fn

    def recording(cache, token, pos, active):
        masks.append(active.tolist())
        return decode_fn(cache, token, pos, active)

    te.decode_fn = recording
    while True:
        n = te.step()
        assert je.step() == n
        if not n and not te.queue:
            break
    assert [True, False] in masks or [False, True] in masks
    for jr, tr in zip(jreqs, treqs):
        assert tr.out == jr.out and tr.done and jr.done, tr.rid
    for jarr, tarr in zip(je.state, te.state):
        np.testing.assert_array_equal(u32.to_numpy(tarr),
                                      np.asarray(jarr, np.uint32))
    assert [te.request_version(r) for r, _, _ in specs] == \
        [je.request_version(r) for r, _, _ in specs] == [2, 2, 2]
    assert (te.steps, te.tokens_out) == (je.steps, je.tokens_out)


def test_serve_launcher_moe_runs_and_ssm_exits(capsys):
    """``python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --device
    cpu`` serves its requests; ``--arch mamba2-2.7b`` exits with the JAX
    launcher's message."""
    stats = tserve.run(["--arch", "qwen2-moe-a2.7b", "--device", "cpu"])
    assert stats["completed"] == stats["total"] == 8
    assert "ledger_version=2" in capsys.readouterr().out
    msgs = []
    for run in (jserve.run, tserve.run):
        with pytest.raises(SystemExit) as exc:
            run(["--arch", "mamba2-2.7b", "--device", "cpu"]
                if run is tserve.run else ["--arch", "mamba2-2.7b"])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "ssm" in msgs[0]


def test_train_launcher_refuses_moe_and_ssm():
    """The training launcher refuses no family any more: moe, ssm, hybrid
    (zamba2) and encdec (seamless) build as the JAX launcher builds them,
    MoE at capacity factor 2.0, encdec with encoder frames a quarter of
    the text (their training: test_torch_train_families*.py)."""
    from repro.launch import train as jtrain
    kw = dict(smoke=True, seq=16, batch=2, microbatches=1, lr=1e-3,
              total_steps=10)
    for arch in ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "mamba2-2.7b",
                 "zamba2-1.2b", "seamless-m4t-medium"):
        cfg, model, tcfg_, dcfg = ttrain.build(arch, device="cpu", **kw)
        jcfg_, jmodel, jtcfg, jdcfg = jtrain.build(arch, **kw)
        assert cfg.name == jcfg_.name and model.cfg.family == cfg.family
        assert model.moe_cf == jmodel.moe_cf == 2.0
        assert dataclasses.asdict(dcfg) == dataclasses.asdict(jdcfg)
        assert tcfg_.microbatches == jtcfg.microbatches
        assert tuple(tcfg_.opt) == tuple(jtcfg.opt)
