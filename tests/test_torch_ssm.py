"""The port's Mamba2/SSD block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the CPU, on the same numpy inputs and
the JAX ``init_mamba`` weights of the mamba2 smoke config (d 64, d_inner
128, 8 heads of 16, state 16).

Outputs, conv tails and states within atol = rtol = 1e-5 (f32 products of
16-64 terms and a 64-step recurrence summed in other orders stay ~1e-6
apart); the chunked scan against the sequential reference within 1e-4,
the JAX test's own limit (``tests/test_models.py``), where the two
orders of a 64-step decay product meet."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import ssm as jssm
from repro_torch.configs import base as tcfg
from repro_torch.models import ssm as tssm

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "mamba2-2.7b"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def block():
    cfg = jcfg.get_smoke(ARCH)
    jp = jssm.init_mamba(jax.random.PRNGKey(3), cfg)
    # conv_b and the norm scale init as 0 and 1: perturbed so they matter.
    rng = np.random.default_rng(3)
    jp = dict(jp, conv_b=jp["conv_b"] + rng.normal(
        size=jp["conv_b"].shape).astype(np.float32) * 0.1,
        norm={"scale": jp["norm"]["scale"] + rng.normal(
            size=jp["norm"]["scale"].shape).astype(np.float32) * 0.1})
    return cfg, tcfg.get_smoke(ARCH), jp, jax.tree.map(_t, jp)


def _ssd_inputs(seed, b=2, s=64, h=3, p=8, n=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(1e-3, 0.1, size=(b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_jax(with_prev):
    rng = np.random.default_rng(4)
    xbc = rng.normal(size=(2, 9, 40)).astype(np.float32)
    w = rng.normal(size=(4, 40)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    prev = rng.normal(size=(2, 3, 40)).astype(np.float32) if with_prev \
        else None
    jy, jtail = jssm.causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if prev is None else jnp.asarray(prev))
    ty, ttail = tssm.causal_conv(_t(xbc), _t(w), _t(b),
                                 None if prev is None else _t(prev))
    _close(ty, jy)
    # The tail is the last K-1 rows of (prev, xbc): copied, bit for bit.
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
    np.testing.assert_array_equal(ttail.numpy(), xbc[:, -3:])


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_jax_and_sequential(chunk):
    args = _ssd_inputs(5)
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, ts = tssm.ssd_chunked(*map(_t, args), chunk=chunk)
    _close(ty, jy)
    _close(ts, js)
    sy, ss = tssm.ssd_sequential_reference(*map(_t, args))
    _close(ty, sy.numpy(), atol=1e-4, rtol=1e-4)
    _close(ts, ss.numpy(), atol=1e-4, rtol=1e-4)


def test_sequential_reference_matches_jax():
    args = _ssd_inputs(6, s=24)
    jy, js = jssm.ssd_sequential_reference(*map(jnp.asarray, args))
    ty, ts = tssm.ssd_sequential_reference(*map(_t, args))
    _close(ty, jy)
    _close(ts, js)


def test_ssd_chunk_must_divide_seq():
    """A chunk that does not divide the sequence raises, as in JAX; a chunk
    longer than the sequence is cut to it."""
    args = _ssd_inputs(7, s=24)
    for mod in (jssm, tssm):
        conv = jnp.asarray if mod is jssm else _t
        with pytest.raises(ValueError, match="not divisible"):
            mod.ssd_chunked(*map(conv, args), chunk=16)
    ty, _ = tssm.ssd_chunked(*map(_t, args), chunk=256)
    jy, _ = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=256)
    _close(ty, jy)


def test_mamba_forward_with_state_matches_jax(block):
    """Prefill (chunked, 32 tokens at chunk 8) with return_state: output,
    conv tail and final state; then a 5-token continuation from them (the
    sequential path)."""
    jc, tc, jp, tp = block
    x = np.random.default_rng(8).normal(size=(2, 32, jc.d_model)).astype(
        np.float32)
    jy, jconv, jst = jssm.mamba_forward(jp, jc, jnp.asarray(x), chunk=8,
                                        return_state=True)
    ty, tconv, tst = tssm.mamba_forward(tp, tc, _t(x), chunk=8,
                                        return_state=True)
    _close(ty, jy)
    _close(tconv, jconv)
    _close(tst, jst)
    x2 = np.random.default_rng(9).normal(size=(2, 5, jc.d_model)).astype(
        np.float32)
    jy2, jconv2, jst2 = jssm.mamba_forward(
        jp, jc, jnp.asarray(x2), conv_state=jconv, ssm_state=jst,
        return_state=True)
    ty2, tconv2, tst2 = tssm.mamba_forward(
        tp, tc, _t(x2), conv_state=tconv, ssm_state=tst, return_state=True)
    _close(ty2, jy2)
    _close(tconv2, jconv2)
    _close(tst2, jst2)
    # The plain output equals the stateful one.
    _close(tssm.mamba_forward(tp, tc, _t(x), chunk=8), ty.numpy())


def test_mamba_decode_step_matches_jax(block):
    """Four decode steps from a random carried state."""
    jc, tc, jp, tp = block
    rng = np.random.default_rng(10)
    conv = rng.normal(size=(2, jc.d_conv - 1, jc.d_inner + 2 * jc.ssm_state)
                      ).astype(np.float32)
    st = rng.normal(size=(2, jc.ssm_heads, jc.ssm_head_dim, jc.ssm_state)
                    ).astype(np.float32)
    jconv, jst, tconv, tst = jnp.asarray(conv), jnp.asarray(st), _t(conv), \
        _t(st)
    for i in range(4):
        x = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        jy, jconv, jst = jssm.mamba_decode_step(jp, jc, jnp.asarray(x),
                                                jconv, jst)
        ty, tconv, tst = tssm.mamba_decode_step(tp, tc, _t(x), tconv, tst)
        _close(ty, jy)
        _close(tconv, jconv)
        _close(tst, jst)


def test_init_mamba_f32_leaves_and_ranges():
    """At a bf16 config: dt_bias, A_log and D f32, the rest bf16;
    softplus(dt_bias) in [1e-3, 1e-1]; A_log = log(1..H); D = 1; the
    projections within [-2, 2] / sqrt(d_in); shapes as JAX's."""
    cfg = dataclasses.replace(tcfg.get_smoke(ARCH), dtype="bfloat16")
    p = tssm.init_mamba(cfg, "cpu", torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(
        lambda k: jssm.init_mamba(k, dataclasses.replace(
            jcfg.get_smoke(ARCH), dtype="bfloat16")),
        jax.random.PRNGKey(0))
    for name, want in jshapes.items():
        got = p[name]["scale"] if name == "norm" else p[name]
        want = want["scale"] if name == "norm" else want
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    for name in ("dt_bias", "A_log", "D"):
        assert p[name].dtype == torch.float32
    sp = torch.nn.functional.softplus(p["dt_bias"])
    assert sp.min() >= 1e-3 * (1 - 1e-5) and sp.max() <= 1e-1 * (1 + 1e-5)
    assert torch.allclose(p["A_log"].exp(),
                          torch.arange(1, cfg.ssm_heads + 1).float())
    assert torch.equal(p["D"], torch.ones(cfg.ssm_heads))
    for name, din in (("in_proj", cfg.d_model), ("out_proj", cfg.d_inner)):
        assert p[name].float().abs().max() <= 2 / np.sqrt(din) * (1 + 2 ** -8)
