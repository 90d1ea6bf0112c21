"""The mesh LM (``repro_torch.models.lm.MeshLM``) against the unsharded
JAX ``LM`` on the CPU: the JAX init (biases and norm scales perturbed)
placed on meshes of CPU positions by ``convert.mesh_lm_params``, a prefill
of 4 prompts into a cache of 48 and 8 greedy ``decode_step``s.

Checked: the last-token logits within 1e-4 of the largest |logit| (f32:
the mesh sums the same products in other orders, ~1e-7 apart); the greedy
tokens identical; the gathered caches within 1e-5 of each field's largest
magnitude after the prefill and after the steps; and ``Mesh.calls``
against the counts derived here from the layer count and the layout each
case states by hand.

Cases: llava-smoke (vision prefix), qwen2.5-14b-smoke (QKV bias),
qwen3-4b-smoke (qk_norm), qwen2-moe-smoke and moonshot-smoke on (1, 2),
(1, 4) and (2, 2). At model width 4 the dense smokes' wk/wv columns are
half a KV head a rank, so the K/V projections are all-gathered; qwen2-moe's
6 experts take TP inside each expert at width 4 and EP at width 2,
moonshot's 8 take EP. Three more meshes reach the other fallbacks: llava
at (1, 8) splits its Q heads in halves (Q gathered too); llava with 3
heads and 1 KV head at (1, 3) keeps wk/wv, the vocab and the MLP
replicated while wq is split; moonshot at (1, 3) replicates its experts.
The JAX side runs once a case under ``jax.jit``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models.lm import LM as JLM, Batch as JBatch
from repro_torch import convert
from repro_torch.configs import base as tcfg
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.lm import Batch

B, S_TEXT, SMAX, N_DECODE = 4, 9, 48, 8
LOGITS_TOL, CACHE_TOL = 1e-4, 1e-5

SMOKES = {"llava": "llava-next-34b", "qwen2.5": "qwen2.5-14b",
          "qwen3": "qwen3-4b", "qwen2-moe": "qwen2-moe-a2.7b",
          "moonshot": "moonshot-v1-16b-a3b"}
# A variant whose wk/wv (16 columns) do not divide over 3 ranks while wq
# (48) does: one Q head a rank, every rank reading the one KV head.
VARIANTS = {"llava-h3kv1": ("llava-next-34b",
                            dict(n_heads=3, n_kv=1))}

# The layout each case must take, stated by hand: vocab rows split; Q
# heads split / gathered (not whole heads a rank); K/V gathered or moved by
# an all-to-all (whole KV heads a rank) or replicated; the MLP (dense or
# shared experts) split; the experts' mode.
LAYOUT = {
    ("llava", 2): dict(vocab=1, q=1, gq=0, kv="a2a", mlp=1),
    ("llava", 4): dict(vocab=1, q=1, gq=0, kv="gather", mlp=1),
    ("llava", 8): dict(vocab=1, q=1, gq=1, kv="gather", mlp=1),
    ("llava-h3kv1", 3): dict(vocab=0, q=1, gq=0, kv="repl", mlp=0),
    ("qwen2.5", 2): dict(vocab=1, q=1, gq=0, kv="a2a", mlp=1),
    ("qwen2.5", 4): dict(vocab=1, q=1, gq=0, kv="gather", mlp=1),
    ("qwen3", 2): dict(vocab=1, q=1, gq=0, kv="a2a", mlp=1),
    ("qwen3", 4): dict(vocab=1, q=1, gq=0, kv="gather", mlp=1),
    ("qwen2-moe", 2): dict(vocab=1, q=1, gq=0, kv="a2a", mlp=1, moe="ep"),
    ("qwen2-moe", 4): dict(vocab=1, q=1, gq=0, kv="a2a", mlp=1, moe="tp"),
    ("moonshot", 2): dict(vocab=1, q=1, gq=0, kv="a2a", mlp=1, moe="ep"),
    ("moonshot", 4): dict(vocab=1, q=1, gq=0, kv="a2a", mlp=1, moe="ep"),
    ("moonshot", 3): dict(vocab=0, q=0, gq=0, kv="repl", mlp=0,
                          moe="replicated"),
}

CASES = ([(name, shape) for name in SMOKES
          for shape in ((1, 2), (1, 4), (2, 2))]
         + [("llava", (1, 8)), ("llava-h3kv1", (1, 3)),
            ("moonshot", (1, 3))])


def _configs(name):
    arch, over = VARIANTS.get(name, (SMOKES.get(name), {}))
    return (dataclasses.replace(jcfg.get_smoke(arch), **over),
            dataclasses.replace(tcfg.get_smoke(arch), **over))


def _perturbed(params, seed):
    """The JAX init as numpy, noise on the biases and norm scales."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].key in ("bq", "bk", "bv", "scale"):
            a = a + rng.normal(size=a.shape).astype(a.dtype) * 0.1
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(numpy params, inputs, JAX results): the prefill's logits and cache,
    then each greedy step's logits and the final cache."""
    jc, _ = _configs(name)
    model = JLM(jc)
    params = _perturbed(model.init(jax.random.PRNGKey(0)), 1)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jc.vocab, (B, S_TEXT)).astype(np.int32)
    prefix = (rng.normal(size=(B, jc.n_prefix, jc.d_model)).astype(
        np.float32) if jc.frontend == "vision" else None)
    jp = jax.tree.map(jnp.asarray, params)
    batch = JBatch(tokens=jnp.asarray(toks), prefix_embeds=None
                   if prefix is None else jnp.asarray(prefix))
    logits, cache = jax.jit(model.prefill)(jp, batch,
                                           model.init_cache(B, SMAX))
    out = {"prefill": np.asarray(logits),
           "cache0": (np.asarray(cache.k), np.asarray(cache.v)), "steps": []}
    step = jax.jit(model.decode_step)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    s = S_TEXT + (jc.n_prefix if prefix is not None else 0)
    for i in range(N_DECODE):
        logits, cache = step(jp, cache, tok, jnp.int32(s + i))
        out["steps"].append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out["cache"] = (np.asarray(cache.k), np.asarray(cache.v))
    return params, toks, prefix, s, out


def _want_calls(lay, n_layers, data, model):
    """Mesh.calls of one prefill and N_DECODE steps, from the layout and
    the layer count (a collective a data row, but the MoE's counts
    gather: one a model rank over the rows)."""
    moe = lay.get("moe")
    psum_mlp = (1 if (moe not in (None, "replicated") or lay["mlp"])
                else 0)
    kv_gather = lay["kv"] == "gather"
    prefill = {
        "all-reduce": lay["vocab"] + n_layers * (lay["q"] + psum_mlp),
        "all-gather": n_layers * (lay["gq"] + kv_gather) + lay["vocab"],
        "all-to-all": n_layers * (lay["kv"] == "a2a"),
    }
    decode = {
        "all-reduce": lay["vocab"] + n_layers * (lay["q"] + psum_mlp),
        # Q/K/V rows in one gather where split, the partials always
        "all-gather": n_layers * (lay["q"] + 1) + lay["vocab"],
    }
    want = {k: data * (prefill.get(k, 0) + N_DECODE * decode.get(k, 0))
            for k in ("all-reduce", "all-gather", "all-to-all")}
    if moe is not None and data > 1:
        want["all-gather"] += model * n_layers * (1 + N_DECODE)
    return {k: n for k, n in want.items() if n}


def _near(got, want, tol, what):
    want = np.asarray(want)
    err = np.abs(got.float().cpu().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("name,shape", CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in CASES])
def test_mesh_prefill_and_decode_match_jax(name, shape):
    params, toks, prefix, s, want = _reference(name)
    _, tc = _configs(name)
    mesh = mesh_mod.Mesh([["cpu"] * shape[1]] * shape[0])
    model = convert.mesh_lm_params(params, tc, mesh)
    lay = LAYOUT[(name, shape[1])]
    plan = model.heads
    assert (model.vocab_split, plan.q_split, plan.gather_q) == (
        bool(lay["vocab"]), bool(lay["q"]), bool(lay["gq"]))
    assert {"a2a": (True, False), "gather": (True, True),
            "repl": (False, False)}[lay["kv"]] == (plan.kv_split,
                                                   plan.gather_kv)
    if "moe" in lay:
        assert model.moe_mode == lay["moe"]
    cache = model.init_cache(B, SMAX)
    batch = Batch(tokens=torch.from_numpy(toks), prefix_embeds=None
                  if prefix is None else torch.from_numpy(prefix))
    with torch.no_grad():
        logits, cache = model.prefill(batch, cache)
        _near(logits, want["prefill"], LOGITS_TOL, "prefill logits")
        got = cache.gather("cpu")
        _near(got.k, want["cache0"][0], CACHE_TOL, "prefill k")
        _near(got.v, want["cache0"][1], CACHE_TOL, "prefill v")
        tok = logits.argmax(-1)
        for i, ref in enumerate(want["steps"]):
            assert np.array_equal(tok.numpy(), np.argmax(
                want["steps"][i - 1] if i else want["prefill"], -1))
            logits, cache = model.decode_step(cache, tok, s + i)
            _near(logits, ref, LOGITS_TOL, f"step {i} logits")
            tok = logits.argmax(-1)
        assert np.array_equal(tok.numpy(), np.argmax(want["steps"][-1], -1))
        got = cache.gather("cpu")
        _near(got.k, want["cache"][0], CACHE_TOL, "cache k")
        _near(got.v, want["cache"][1], CACHE_TOL, "cache v")
    assert dict(mesh.calls) == _want_calls(lay, tc.n_layers, *shape)
