"""The port's dense LM against the JAX ``LM`` on the CPU, with the same
weights (the JAX ``init`` pytree carried over by ``convert.lm_params``,
biases and norm scales perturbed so they matter) and the same numpy
tokens: full logits, ``prefill`` (last-token logits and the padded cache)
and greedy ``decode_step``s, for the qwen2-7b (QKV bias) and qwen3-4b
(qk-norm) smoke configs. Logits ``atol=rtol=1e-4``: two f32 layers of
64-128-wide products summed in another order stay ~1e-6 apart; greedy
tokens identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models.lm import LM as JLM, Batch as JBatch
from repro_torch import convert
from repro_torch.configs import base as tcfg
from repro_torch.models import layers as tl, lm as tlm
from repro_torch.models.lm import LM, Batch

TOL = dict(atol=1e-4, rtol=1e-4)
N_DECODE = 4


def _perturbed(params, seed):
    """The JAX init as numpy, with noise on the biases and norm scales
    (which init as 0 and 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name in ("bq", "bk", "bv", "scale"):
            a = a + rng.normal(size=a.shape).astype(a.dtype) * 0.1
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(arch, seed=0, **lm_kwargs):
    jmodel = JLM(jcfg.get_smoke(arch), **lm_kwargs)
    np_params = _perturbed(jmodel.init(jax.random.PRNGKey(seed)), seed)
    tmodel = convert.lm_params(np_params, tcfg.get_smoke(arch), "cpu",
                               **lm_kwargs)
    return jmodel, jax.tree.map(jnp.asarray, np_params), tmodel


@pytest.fixture(scope="module", params=["qwen2-7b", "qwen3-4b"])
def pair(request):
    return _pair(request.param)


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)
                                                ).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_logits_match_jax(pair):
    jmodel, jparams, tmodel = pair
    toks = _tokens(1, 2, 12)
    _close(tmodel.logits(Batch(tokens=torch.from_numpy(toks))),
           jmodel.logits(jparams, JBatch(tokens=jnp.asarray(toks))))


def test_prefill_and_decode_match_jax(pair):
    """Prefill a batch of 2 into a cache of 20, then 4 greedy decode steps:
    logits, the cache after each call (zero past the filled length) and
    the greedy tokens."""
    jmodel, jparams, tmodel = pair
    toks = _tokens(2, 2, 9)
    smax = 20
    jlog, jcache = jmodel.prefill(jparams, JBatch(tokens=jnp.asarray(toks)),
                                  jmodel.init_cache(2, smax))
    tlog, tcache = tmodel.prefill(Batch(tokens=torch.from_numpy(toks)),
                                  tmodel.init_cache(2, smax))
    pos = toks.shape[1]
    for step in range(N_DECODE + 1):
        _close(tlog, jlog)
        _close(tcache.k, jcache.k)
        _close(tcache.v, jcache.v)
        assert not tcache.k[:, :, pos:].any()
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, dim=-1).numpy(), tok)
        if step == N_DECODE:
            break
        jlog, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          jnp.int32(pos))
        tlog, tcache = tmodel.decode_step(tcache, torch.from_numpy(tok), pos)
        pos += 1


def test_chunked_prefill_matches_jax():
    """A prompt longer than 2 x q_chunk takes attn_chunked on the CPU, in
    both packages."""
    jmodel, jparams, tmodel = _pair("qwen2-7b", seed=3, q_chunk=4,
                                    kv_chunk=4)
    toks = _tokens(3, 1, 16)
    jlog, jcache = jmodel.prefill(jparams, JBatch(tokens=jnp.asarray(toks)),
                                  jmodel.init_cache(1, 16))
    tlog, tcache = tmodel.prefill(Batch(tokens=torch.from_numpy(toks)),
                                  tmodel.init_cache(1, 16))
    _close(tlog, jlog)
    _close(tcache.k, jcache.k)


def test_prefix_embeds_match_jax():
    """The vision-frontend stub (llava smoke): precomputed patch embeddings
    before the tokens."""
    jmodel, jparams, tmodel = _pair("llava-next-34b", seed=4)
    toks = _tokens(4, 2, 6)
    pre = np.random.default_rng(5).normal(size=(2, 16, 64)).astype(
        np.float32)
    _close(tmodel.logits(Batch(tokens=torch.from_numpy(toks),
                               prefix_embeds=torch.from_numpy(pre))),
           jmodel.logits(jparams, JBatch(tokens=jnp.asarray(toks),
                                         prefix_embeds=jnp.asarray(pre))))


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-4b", "phi3-mini-3.8b",
                                  "llava-next-34b"])
def test_init_counts_and_distributions(arch):
    """The module holds cfg.n_params() parameters (the smoke vocab needs no
    padding), drawn as the JAX package draws them: dense weights a standard
    normal truncated to [-2, 2] over sqrt(d_in), embeddings N(0, 0.02),
    norm scales 1, biases 0."""
    cfg = tcfg.get_smoke(arch)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == cfg.n_params()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            assert torch.equal(p, torch.ones_like(p)), name
        elif leaf in ("bq", "bk", "bv"):
            assert not p.any(), name
        elif leaf in ("embed", "lm_head"):
            assert abs(p.std().item() - 0.02) < 2e-3, name
        else:
            bound = 2.0 / np.sqrt(p.shape[0])
            assert p.abs().max().item() <= bound * (1 + 1e-6), name
            assert p.std().item() > 0.5 / np.sqrt(p.shape[0]), name


def test_other_families_cross_attention_and_no_card_raise(monkeypatch):
    """An unknown family raises; all five families construct (the
    ``test_torch_families.py`` and ``test_torch_hybrid_encdec.py`` files
    hold them against JAX); cached decode with ``memory=`` (which the
    reference never runs) raises; ``LM(cfg)`` without a card raises."""
    with pytest.raises(ValueError, match="unknown family"):
        LM(dataclasses.replace(tcfg.get_smoke("qwen2-7b"), family="rnn"),
           device="cpu")
    families = {LM(tcfg.get_smoke(arch), device="cpu").cfg.family
                for arch in ("qwen2-7b", "qwen2-moe-a2.7b", "mamba2-2.7b",
                             "zamba2-1.2b", "seamless-m4t-medium")}
    assert families == set(tlm.FAMILIES) == {"dense", "moe", "ssm",
                                             "hybrid", "encdec"}
    cfg = tcfg.get_smoke("qwen2-7b")
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    x = torch.zeros((1, 2, cfg.d_model))
    cache = torch.zeros((1, 4, cfg.n_kv, cfg.head_dim))
    with pytest.raises(NotImplementedError, match="memory"):
        tl.attention(model.params["layers"][0]["attn"], cfg, x[:, :1],
                     positions=torch.arange(1), memory=x,
                     kv_cache=(cache, cache.clone()), cache_len=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)  # the card by default
