"""The port's attention and layer functions against the JAX package, on the
CPU: the flash-attention wrapper's plain path (``ops.flash_attention`` on
CPU tensors) against the JAX Pallas kernel in interpret mode, its
``ref.py`` and ``layers.attn_chunked``; and the serving path's layers
(``rmsnorm``, ``apply_rope``, ``attn_grouped``, ``mlp``, ``embed``,
``unembed``) against ``repro.models.layers``. Inputs from numpy seeds.
Tolerances: f32 ``atol=2e-5, rtol=1e-5`` (the JAX kernel tests' own: sums
of a few hundred f32 products taken in another order); bf16 ``3e-2`` (one
bf16 rounding of the output, 2^-8 relative). The CUDA kernel is held
against the same plain path on the card in test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.kernels.flash_attention import kernel as jfk, ref as jfr
from repro.models import layers as jl
from repro_torch.configs import base as tcfg
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as tl

F32 = dict(atol=2e-5, rtol=1e-5)


def _qkv(seed, b, s, h, kv, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, kv, d)).astype(np.float32),
            rng.normal(size=(b, skv, kv, d)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               **(tol or F32))


# -- K5's plain path --------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kv,d,qb,kb", [
    (2, 64, 4, 2, 16, 16, 16),   # GQA, square blocks
    (2, 64, 4, 4, 32, 32, 16),   # MHA, rectangular blocks
    (1, 128, 8, 2, 16, 32, 32),  # longer sequence
    (2, 64, 4, 1, 16, 16, 32),   # MQA, kv block > q block
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_and_ref(b, s, h, kv, d, qb, kb, causal):
    arrays = _qkv(s * h + d, b, s, h, kv, d)
    got = fa_ops.flash_attention(*_t(*arrays), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    _close(got, jfk.flash_attention(*_j(*arrays), causal=causal, q_block=qb,
                                    kv_block=kb, interpret=True))
    _close(got, jfr.flash_attention_ref(*_j(*arrays), causal=causal))


@pytest.mark.parametrize("qc,kc", [(16, 16), (32, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_and_chunked_match_jax_chunked(qc, kc, causal):
    arrays = _qkv(qc + kc, 2, 64, 4, 2, 16)
    want = jl.attn_chunked(*_j(*arrays), causal=causal, q_chunk=qc,
                           kv_chunk=kc)
    _close(fa_ops.flash_attention(*_t(*arrays), causal=causal), want)
    _close(tl.attn_chunked(*_t(*arrays), causal=causal, q_chunk=qc,
                           kv_chunk=kc), want)


@pytest.mark.parametrize("s,skv,causal", [(60, 60, True), (60, 60, False),
                                           (45, 70, True)])
def test_flash_ragged_length(s, skv, causal):
    """S = 60 (or 45 queries over 70 keys) is no multiple of any block: the
    JAX kernel refuses it (the port's kernel masks the tail), so the
    reference is attn_naive."""
    arrays = _qkv(s + skv, 1, s, 4, 2, 16, skv=skv)
    _close(fa_ops.flash_attention(*_t(*arrays), causal=causal),
           jl.attn_naive(*_j(*arrays), causal=causal))


def test_flash_bf16():
    arrays = _qkv(5, 1, 64, 2, 1, 16)
    got = fa_ops.flash_attention(*_t(*arrays, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jfk.flash_attention(*_j(*arrays, dtype=jnp.bfloat16), causal=True,
                               q_block=16, kv_block=16, interpret=True)
    _close(got, want, atol=3e-2, rtol=3e-2)


def test_flash_rejects_bad_inputs():
    q, k, v = _t(*_qkv(1, 1, 16, 4, 2, 16))
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa_ops.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q[..., :8].contiguous(),
                               k[..., :8].contiguous(),
                               v[..., :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k.bfloat16(), v)


# -- the serving path's layers ----------------------------------------------

@pytest.mark.parametrize("q_offset", [0, 5])
def test_attn_naive_matches_jax(q_offset):
    q, k, v = _qkv(7, 2, 3, 4, 2, 16, skv=8)
    _close(tl.attn_naive(*_t(q, k, v), causal=True, q_offset=q_offset),
           jl.attn_naive(*_j(q, k, v), causal=True, q_offset=q_offset))


@pytest.mark.parametrize("q_offset", [0, 6])
def test_attn_grouped_decode_matches_jax(q_offset):
    """One new query against a cache of 12 (entries past it masked)."""
    q, k, v = _qkv(8 + q_offset, 2, 1, 6, 3, 16, skv=12)
    _close(tl.attn_grouped(*_t(q, k, v), causal=True, q_offset=q_offset),
           jl.attn_grouped(*_j(q, k, v), causal=True, q_offset=q_offset))


def test_rmsnorm_rope_mlp_embed_unembed_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    _close(tl.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                      1e-6),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))
    for pos in (np.arange(5), np.array([[3, 4, 5, 6, 7], [0, 9, 2, 40, 1]])):
        _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6),
               jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    h = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = {n: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
         for n, shape in (("w_gate", (32, 64)), ("w_up", (32, 64)),
                          ("w_down", (64, 32)))}
    _close(tl.mlp({n: torch.from_numpy(a) for n, a in w.items()},
                  torch.from_numpy(h)),
           jl.mlp({n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(h)))
    table = rng.normal(size=(40, 32)).astype(np.float32)
    tokens = rng.integers(0, 40, (2, 5)).astype(np.int32)
    _close(tl.embed(torch.from_numpy(table), torch.from_numpy(tokens)),
           jl.embed(jnp.asarray(table), jnp.asarray(tokens)))
    for tr, tab in ((True, table), (False, table.T.copy())):
        _close(tl.unembed(torch.from_numpy(tab), torch.from_numpy(h),
                          transpose=tr),
               jl.unembed(jnp.asarray(tab), jnp.asarray(h), transpose=tr))


def test_attention_layer_prefill_and_decode_match_jax():
    """The whole sub-layer (QKV bias, qk-norm, rope) in both modes, with
    random biases and norm scales; the port writes the decode K/V into the
    cache in place."""
    jcfg_qk = dataclasses.replace(jcfg.get_smoke("qwen2-7b"), qk_norm=True)
    cfg = dataclasses.replace(tcfg.get_smoke("qwen2-7b"), qk_norm=True)
    rng = np.random.default_rng(10)
    jp = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32)
        * 0.1, jl.init_attention(jax.random.PRNGKey(1), jcfg_qk))
    tp = jax.tree.map(torch.from_numpy, jp)
    jp = jax.tree.map(jnp.asarray, jp)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    want, (wk, wv) = jl.attention(jp, jcfg_qk, jnp.asarray(x),
                                  positions=jnp.arange(6))
    got, (gk, gv) = tl.attention(tp, cfg, torch.from_numpy(x),
                                 positions=torch.arange(6))
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w)
    cache = np.zeros((2, 10, cfg.n_kv, cfg.head_dim), np.float32)
    cache[:, :6] = np.asarray(wk)
    vcache = np.zeros_like(cache)
    vcache[:, :6] = np.asarray(wv)
    x1 = x[:, :1]
    want, (wk, wv) = jl.attention(
        jp, jcfg_qk, jnp.asarray(x1), positions=jnp.asarray([6]),
        kv_cache=(jnp.asarray(cache), jnp.asarray(vcache)), cache_len=6)
    ck, cv = torch.from_numpy(cache.copy()), torch.from_numpy(vcache.copy())
    got, (gk, gv) = tl.attention(tp, cfg, torch.from_numpy(x1),
                                 positions=torch.tensor([6]),
                                 kv_cache=(ck, cv), cache_len=6)
    assert gk is ck and gv is cv
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w)
