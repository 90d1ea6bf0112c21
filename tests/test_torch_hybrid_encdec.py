"""The port's ``LM`` for the hybrid (zamba2) and encoder-decoder (seamless)
families against the JAX ``LM`` on the CPU, with the JAX ``init`` weights
carried over by ``convert.lm_params`` (norm scales and the conv bias
perturbed so they matter) and the same numpy tokens and encoder frames:
logits, the loss, ``prefill`` and greedy ``decode_step``s (logits, tokens
and caches), cross-attention alone, and the reference's two encdec paths
at a config with biases and qk_norm, where they differ.

Configs: zamba2-smoke (4 layers, ``attn_every`` 2: two sites), the same at
5 layers (three sites, the last group of one layer) and seamless-smoke
(2 + 2 layers). Logits and losses within atol = rtol = 1e-4, caches within
1e-5, as in ``test_torch_families.py``: a few f32 layers summed in other
orders stay ~1e-6 apart."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import layers as jl
from repro.models.lm import LM as JLM, Batch as JBatch
from repro_torch import convert
from repro_torch.configs import base as tcfg
from repro_torch.models import layers as tl, lm as tlm
from repro_torch.models.lm import LM, Batch

TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
N_DECODE = 4
ZAMBA, SEAMLESS = "zamba2-1.2b", "seamless-m4t-medium"
# name -> (arch, config changes)
CONFIGS = {"zamba2-smoke": (ZAMBA, {}),
           "zamba2-smoke-5": (ZAMBA, {"n_layers": 5}),
           "seamless-smoke": (SEAMLESS, {})}


def _cfgs(arch, **changes):
    return (dataclasses.replace(jcfg.get_smoke(arch), **changes),
            dataclasses.replace(tcfg.get_smoke(arch), **changes))


def _perturbed(params, seed):
    """Norm scales, the conv bias and the attention biases moved off their
    initial ones and zeros, so that a dropped one shows."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].key in ("scale", "conv_b", "bq", "bk", "bv"):
            a = a + rng.normal(size=a.shape).astype(a.dtype) * 0.1
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(jc, tc, seed=0):
    jmodel = JLM(jc, ssd_chunk=8)
    np_params = _perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(seed)),
                           seed)
    tmodel = convert.lm_params(np_params, tc, "cpu", ssd_chunk=8)
    return jmodel, jax.tree.map(jnp.asarray, np_params), tmodel


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    arch, changes = CONFIGS[request.param]
    return _pair(*_cfgs(arch, **changes))


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)
                                                ).astype(np.int32)


def _frames(seed, b, s, d):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _batches(cfg, toks, labels=None, enc_len=8, seed=7):
    """The same inputs as a JAX and a port Batch; encoder frames for
    encdec."""
    enc = (_frames(seed, toks.shape[0], enc_len, cfg.d_model)
           if cfg.family == "encdec" else None)
    j = JBatch(tokens=jnp.asarray(toks),
               labels=None if labels is None else jnp.asarray(labels),
               enc_embeds=None if enc is None else jnp.asarray(enc))
    t = Batch(tokens=torch.from_numpy(toks),
              labels=None if labels is None else torch.from_numpy(labels),
              enc_embeds=None if enc is None else torch.from_numpy(enc))
    return j, t


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_logits_and_loss_match_jax(pair):
    jmodel, jparams, tmodel = pair
    toks, labels = _tokens(1, 2, 16), _tokens(2, 2, 16)
    labels[0, :3] = -1
    jb, tb = _batches(tmodel.cfg, toks, labels)
    _close(tmodel.logits(tb), jax.jit(jmodel.logits)(jparams, jb))
    jloss, jm = jax.jit(jmodel.loss)(jparams, jb)
    tloss, tm = tmodel.loss(tb)
    assert tm.keys() == jm.keys()
    for got, want in [(tloss, jloss)] + [(tm[k], jm[k]) for k in jm]:
        assert float(got) == pytest.approx(float(want), abs=1e-4, rel=1e-4)


def _caches(tc, jc):
    if tc.hyb_k is not None:
        return [(tc.hyb_k, jc.hyb_k), (tc.hyb_v, jc.hyb_v),
                (tc.conv, jc.conv), (tc.ssm_state, jc.ssm_state)]
    return [(tc.k, jc.k), (tc.v, jc.v), (tc.cross_k, jc.cross_k),
            (tc.cross_v, jc.cross_v)]


def test_prefill_and_decode_match_jax(pair):
    """Prefill a batch of 2 x 16 (with 8 encoder frames for encdec, into a
    cross cache the prefill replaces) into a cache of 24, then 4 greedy
    decode steps: logits, greedy tokens and every cache after each call."""
    jmodel, jparams, tmodel = pair
    jdecode = jax.jit(jmodel.decode_step)  # one compile for the 4 steps
    toks = _tokens(3, 2, 16)
    jb, tb = _batches(tmodel.cfg, toks)
    jlog, jcache = jax.jit(jmodel.prefill)(jparams, jb,
                                           jmodel.init_cache(2, 24))
    tlog, tcache = tmodel.prefill(tb, tmodel.init_cache(2, 24))
    caches = _caches(tcache, jcache)
    assert all(got.shape == want.shape for got, want in caches)
    pos = toks.shape[1]
    for step in range(N_DECODE + 1):
        _close(tlog, jlog)
        for got, want in _caches(tcache, jcache):
            _close(got, want, **CACHE_TOL)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, dim=-1).numpy(), tok)
        if step == N_DECODE:
            break
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                               jnp.int32(pos))
        tlog, tcache = tmodel.decode_step(tcache, torch.from_numpy(tok), pos)
        pos += 1


@pytest.mark.parametrize("arch", [ZAMBA, SEAMLESS])
def test_prefill_decode_consistency(arch):
    """The JAX test's check (``tests/test_models.py``) on the port: a
    prefill of 11 tokens and one decode step give the full forward's
    logits at positions 10 and 11 (atol 2e-4, rtol 1e-4), with 8 encoder
    frames for encdec. At seamless-smoke (no bias, no qk_norm) the
    reference's two cross-attention paths agree."""
    cfg = tcfg.get_smoke(arch)
    model = LM(cfg, vocab_chunk=8, device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = _tokens(4, 2, 12)
    _, full_b = _batches(cfg, toks)
    full = model.logits(full_b)
    _, pre_b = _batches(cfg, toks[:, :11])
    lg_pre, cache = model.prefill(pre_b, model.init_cache(2, 16, enc_len=8))
    lg_dec, cache = model.decode_step(cache, torch.from_numpy(toks[:, 11]),
                                      11)
    for got, want in ((lg_pre, full[:, -2]), (lg_dec, full[:, -1])):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("enc_len,impl", [(8, "naive"), (13, "naive"),
                                          (8, "chunked")])
def test_cross_attention_matches_jax(enc_len, impl):
    """``layers.attention(memory=)`` against JAX's at a 12-token query and
    8 or 13 memory frames, with biases and qk_norm (perturbed) so every
    projection term counts: no rope, no causal mask; under ``chunked`` with
    4-row chunks, JAX's ``attn_chunked`` path and the port's."""
    jc, tc = _cfgs(SEAMLESS, qkv_bias=True, qk_norm=True)
    p = _perturbed(jl.init_attention(jax.random.PRNGKey(5), jc), 5)
    rng = np.random.default_rng(enc_len)
    x = rng.normal(size=(2, 12, jc.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, enc_len, jc.d_model)).astype(np.float32)
    kw = dict(impl=impl, q_chunk=4, kv_chunk=4 if enc_len == 8 else enc_len)
    jout, (jk, jv) = jl.attention(
        jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x),
        positions=jnp.arange(12), memory=jnp.asarray(mem), **kw)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    tout, (tk, tv) = tl.attention(
        tp, tc, torch.from_numpy(x), positions=torch.arange(12),
        memory=torch.from_numpy(mem), **kw)
    assert tk.shape == (2, enc_len, tc.n_kv, tc.head_dim)
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        _close(got, want)


def test_encdec_quirk_each_path_matches_its_jax_path():
    """With biases and qk_norm the reference's encdec paths part: forward
    (``logits``) runs cross-attention through ``attention(memory=)``,
    prefill through a bare ``@ wq/wk/wv``. The port's ``logits`` equal JAX
    ``logits`` and its prefill JAX ``prefill``, while the two JAX paths
    differ at the last position."""
    jmodel, jparams, tmodel = _pair(*_cfgs(SEAMLESS, qkv_bias=True,
                                           qk_norm=True), seed=3)
    toks = _tokens(5, 2, 10)
    jb, tb = _batches(tmodel.cfg, toks)
    jfull = jax.jit(jmodel.logits)(jparams, jb)
    _close(tmodel.logits(tb), jfull)
    jlog, jcache = jax.jit(jmodel.prefill)(jparams, jb,
                                           jmodel.init_cache(2, 12, 8))
    tlog, tcache = tmodel.prefill(tb, tmodel.init_cache(2, 12, 8))
    _close(tlog, jlog)
    for got, want in _caches(tcache, jcache):
        _close(got, want, **CACHE_TOL)
    assert float(jnp.abs(jlog - jfull[:, -1]).max()) > 1e-2


@pytest.mark.parametrize("arch", [ZAMBA, SEAMLESS])
def test_weights_and_leaf_dtypes(arch):
    """The weight count is ``n_params()`` plus the vocab padding rows; at
    bf16 every leaf is bf16 but the SSM's dt_bias, A_log and D, through
    ``init`` and through ``convert.lm_params``; ``jax_leaves`` follows the
    JAX flatten order (``shared_attn`` one subtree, ``enc_layers``
    stacked)."""
    cfg = dataclasses.replace(tcfg.get_smoke(arch), dtype="bfloat16")
    jc = dataclasses.replace(jcfg.get_smoke(arch), dtype="bfloat16")
    np_params = jax.tree.map(np.asarray,
                             jax.jit(JLM(jc).init)(jax.random.PRNGKey(0)))
    pad = (cfg.vocab_padded - cfg.vocab) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    want_f32 = {"dt_bias", "A_log", "D"} if cfg.family == "hybrid" else set()
    for model in (LM(cfg, device="cpu").init(torch.Generator().manual_seed(0)),
                  convert.lm_params(np_params, cfg, "cpu")):
        assert sum(p.numel() for p in model.parameters()) == (
            cfg.n_params() + pad)
        f32 = {n.rsplit(".", 1)[-1] for n, p in model.named_parameters()
               if p.dtype == torch.float32}
        assert f32 == want_f32
        assert all(p.dtype in (torch.float32, torch.bfloat16)
                   for p in model.parameters())
        groups = tlm.jax_leaves(model.params.tree())
        jleaves = jax.tree.leaves(np_params)
        assert len(groups) == len(jleaves)
        for group, a in zip(groups, jleaves):
            got = (group[0] if len(group) == 1 else torch.stack(group))
            assert tuple(got.shape) == a.shape
