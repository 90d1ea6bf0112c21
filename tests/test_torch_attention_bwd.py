"""The training slice's gradients of attention and rmsnorm against the JAX
package, on the CPU, from the same numpy inputs:

* ``layers.rmsnorm`` (an autograd Function with the reference's
  hand-written VJP) against ``jax.vjp`` of ``repro.models.layers.rmsnorm``;
* K5's plain backward (``ref.flash_attention_bwd_ref``, from the plain
  forward's O and log-sum-exp) against ``jax.vjp`` of ``attn_naive`` and of
  ``attn_chunked`` (the functions JAX training differentiates) at GQA, MHA,
  causal, non-causal and ragged S; its LSE against JAX's logsumexp of the
  scaled, masked scores;
* the autograd Function (``ops.flash_attention`` under grad, CPU tensors)
  equal to the plain backward; and a whole attention sub-layer's gradients
  (``layers.attention``: projections, rope, K5's Function, or the plain
  ``attn_chunked`` past 2 ``q_chunk``) against ``jax.vjp`` of JAX's.

Tolerances: f32 ``atol=rtol=2e-5`` (the same f32 products summed in
another order; measured ~1e-6); bf16 ``atol=rtol=2e-2`` (inputs, O, dO and
the gradients each rounded to bf16 once, 2^-8 relative, and delta taken
from the bf16 O here but from the f32 softmax in JAX's VJP); the whole
sub-layer's ``atol=rtol=1e-4`` (gradients of ~10 summed over 2 x 48
positions through 64- and 128-wide products, test_torch_lm.py's limit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import layers as jl
from repro_torch.configs import base as tcfg
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers as tl

F32 = dict(atol=2e-5, rtol=2e-5)
SUBLAYER = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
DT = {"float32": (torch.float32, jnp.float32, F32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_forward_and_backward(dtype):
    """y, dx and dscale on a (2, 5, 3, 32) input (a q_norm's shape) with a
    perturbed scale, against jax.vjp of the reference's custom VJP."""
    tdt, jdt, tol = DT[dtype]
    x, scale, dy = _normal(1, (2, 5, 3, 32), (32,), (2, 5, 3, 32))
    scale = 1 + 0.1 * scale
    y_j, vjp = jax.vjp(lambda a, s: jl.rmsnorm({"scale": s}, a, 1e-6),
                       jnp.asarray(x, jdt), jnp.asarray(scale, jdt))
    dx_j, ds_j = vjp(jnp.asarray(dy, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = torch.from_numpy(scale).to(tdt).requires_grad_()
    y_t = tl.rmsnorm({"scale": st}, xt, 1e-6)
    dx_t, ds_t = torch.autograd.grad(y_t, (xt, st),
                                     torch.from_numpy(dy).to(tdt))
    assert y_t.dtype == dx_t.dtype == ds_t.dtype == tdt
    for got, want in ((y_t, y_j), (dx_t, dx_j), (ds_t, ds_j)):
        _close(got, want, tol)


# (B, S, Skv, H, Hkv, D, causal)
CASES = [
    (2, 24, 24, 4, 2, 16, True),    # GQA, causal
    (1, 20, 20, 4, 4, 32, False),   # MHA, no mask
    (2, 19, 33, 6, 2, 16, False),   # ragged, Skv > S
    (1, 37, 37, 4, 1, 16, True),    # MQA, ragged S
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_backward_matches_jax_vjp_of_attn_naive(case, dtype):
    b, s, skv, h, kv, d, causal = case
    tdt, jdt, tol = DT[dtype]
    q, k, v, do = _normal(sum(case), (b, s, h, d), (b, skv, kv, d),
                          (b, skv, kv, d), (b, s, h, d))
    out_j, vjp = jax.vjp(lambda a, bb, c: jl.attn_naive(a, bb, c,
                                                        causal=causal),
                         *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    qt, kt, vt, dot = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    out_t, lse = fa_ref.flash_attention_lse_ref(qt, kt, vt, causal=causal)
    got = fa_ref.flash_attention_bwd_ref(qt, kt, vt, out_t, dot, lse, causal)
    _close(out_t, out_j, tol)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _close(g, w, tol)


def test_lse_matches_jax():
    """The plain LSE: JAX's logsumexp of the scaled, masked f32 scores."""
    q, k, _ = _normal(3, (2, 30, 4, 16), (2, 30, 2, 16), (1,))
    kj = jl._expand_kv(jnp.asarray(k), 4)
    sc = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kj) / 4.0
    mask = jnp.arange(30)[:, None] >= jnp.arange(30)[None, :]
    want = jax.scipy.special.logsumexp(jnp.where(mask, sc, -jnp.inf), -1)
    _, lse = fa_ref.flash_attention_lse_ref(torch.from_numpy(q),
                                            torch.from_numpy(k),
                                            torch.from_numpy(k), causal=True)
    assert lse.shape == (2, 4, 30) and lse.is_contiguous()
    _close(lse, want, F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp_of_attn_chunked(dtype):
    """Past 2 q_chunk JAX trains through the online-softmax attn_chunked
    (S = 48 in chunks of 16 here); same gradient."""
    tdt, jdt, tol = DT[dtype]
    q, k, v, do = _normal(4, (1, 48, 4, 16), (1, 48, 2, 16), (1, 48, 2, 16),
                          (1, 48, 4, 16))
    _, vjp = jax.vjp(lambda a, bb, c: jl.attn_chunked(
        a, bb, c, causal=True, q_chunk=16, kv_chunk=16),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    qt, kt, vt, dot = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    out_t, lse = fa_ref.flash_attention_lse_ref(qt, kt, vt, causal=True)
    for g, w in zip(fa_ref.flash_attention_bwd_ref(qt, kt, vt, out_t, dot,
                                                   lse, True), want):
        _close(g, w, tol)


@pytest.mark.parametrize("causal", [True, False])
def test_function_backward_equals_plain_version_on_cpu(causal):
    """Under grad, ``ops.flash_attention`` on CPU tensors runs the autograd
    Function: its forward the plain one, its backward the plain backward,
    bit for bit; no kernel launch is counted."""
    q, k, v, do = (torch.from_numpy(x) for x in _normal(
        5, (2, 21, 4, 16), (2, 21, 2, 16), (2, 21, 2, 16), (2, 21, 4, 16)))
    before = (fa_ops.launches, fa_ops.launches_bwd)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa_ops.flash_attention(qg, kg, vg, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    o, lse = fa_ref.flash_attention_lse_ref(q, k, v, causal=causal)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    assert torch.equal(out, o)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert fa_ops.flash_attention(qg, kg, vg, causal=causal).grad_fn \
            is None
    assert (fa_ops.launches, fa_ops.launches_bwd) == before


@pytest.mark.parametrize("impl,s", [("naive", 12), ("chunked", 48)])
def test_attention_sublayer_gradients_match_jax(impl, s):
    """``layers.attention`` of the qwen2-7b smoke config (QKV bias, rope)
    with gradients on the input and every weight, against jax.vjp of the
    JAX sub-layer: through K5's Function (naive), or through the plain
    ``attn_chunked`` on the CPU (chunked, S = 48 > 2 x q_chunk 16)."""
    jc, tc = jcfg.get_smoke("qwen2-7b"), tcfg.get_smoke("qwen2-7b")
    d, h, kv, hd = jc.d_model, jc.n_heads, jc.n_kv, jc.head_dim
    names = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
             "wo": (h * hd, d), "bq": (h * hd,), "bk": (kv * hd,),
             "bv": (kv * hd,)}
    arrays = _normal(6, (2, s, d), (2, s, d), *names.values())
    x, dy = arrays[:2]
    p_np = {n: a * 0.2 for n, a in zip(names, arrays[2:])}
    kw = dict(impl=impl, q_chunk=16, kv_chunk=16)

    def jfun(xx, p):
        return jl.attention(p, jc, xx, positions=jnp.arange(s), **kw)[0]

    _, vjp = jax.vjp(jfun, jnp.asarray(x),
                     {n: jnp.asarray(a) for n, a in p_np.items()})
    dx_j, dp_j = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    pt = {n: torch.from_numpy(a).requires_grad_() for n, a in p_np.items()}
    out, _ = tl.attention(pt, tc, xt, positions=torch.arange(s), **kw)
    grads = torch.autograd.grad(out, [xt, *pt.values()],
                                torch.from_numpy(dy))
    _close(grads[0], dx_j, SUBLAYER)
    for n, g in zip(pt, grads[1:]):
        _close(g, dp_j[n], SUBLAYER)
