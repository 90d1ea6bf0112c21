"""The port's MoE MLP (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU, at the qwen2-moe smoke config
(6 experts, top-2, 2 shared) and the moonshot one (8 experts, top-2, 1
shared), with the JAX ``init_moe`` weights and the same numpy inputs.

Routes: expert ids identical, weights and the aux loss within 1e-6 (one
f32 softmax over a handful of experts). ``moe_mlp``: within atol = rtol =
1e-5 at capacity factors from 1e-9 (one slot an expert, most assignments
dropped) to ``n_experts`` (none dropped), for both dispatches and for two
groups: f32 sums of a few 32-64-term products stay ~1e-7 apart, while a
different dropped assignment moves an output by the size of an expert's
contribution (~1e-1). bf16 experts with the f32 router: see
``test_bf16_matches_jax``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import moe as jmoe
from repro_torch.configs import base as tcfg
from repro_torch.models import layers as tl, moe as tmoe

ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
TOL = dict(atol=1e-5, rtol=1e-5)


def _tree(jp):
    """JAX params -> torch tensors, each in its own dtype (f32 or bf16)."""
    def leaf(a):
        dt = torch.float32 if a.dtype == jnp.float32 else torch.bfloat16
        return torch.from_numpy(np.array(a, np.float32)).to(dt)
    return jax.tree.map(leaf, jp)


@pytest.fixture(scope="module", params=ARCHS)
def moe_pair(request):
    arch = request.param
    cfg = jcfg.get_smoke(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), cfg)
    return arch, cfg, tcfg.get_smoke(arch), jp, _tree(jp)


def _x(seed, b, s, d):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def test_route_matches_jax(moe_pair):
    _, cfg, tc, jp, tp = moe_pair
    x2d = _x(2, 1, 40, cfg.d_model)[0]
    jw, je, jaux = jmoe.route(jp["router"], jnp.asarray(x2d), cfg.top_k)
    tw, te, taux = tmoe.route(tp["router"], torch.from_numpy(x2d), tc.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-6, rel=1e-6)


def test_route_ties_take_the_lower_expert_first():
    """A zero router gives every expert the same probability: the top k
    are experts 0..k-1 in order, as jax.lax.top_k gives them."""
    cfg = jcfg.get_smoke("qwen2-moe-a2.7b")
    x2d = _x(3, 1, 5, cfg.d_model)[0]
    w = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    _, je, _ = jmoe.route(jnp.asarray(w), jnp.asarray(x2d), cfg.top_k)
    _, te, _ = tmoe.route(torch.from_numpy(w), torch.from_numpy(x2d),
                          cfg.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te.tolist() == [list(range(cfg.top_k))] * 5


def _dropped(experts: np.ndarray, cap: int, groups: int = 1) -> int:
    """Assignments past their expert's capacity, counted in slot order
    (per group of tokens): the reference's drop rule, in numpy."""
    n = 0
    for part in np.split(experts.reshape(-1, experts.shape[-1]), groups):
        seen = {}
        for e in part.reshape(-1):
            seen[e] = seen.get(e, 0) + 1
            n += seen[e] > cap
    return n


@pytest.mark.parametrize("cf", [1e-9, 0.5, 1.0, 2.0, "n_experts"])
def test_moe_mlp_matches_jax(moe_pair, cf):
    """Sort and cumsum dispatch and two groups, each against JAX's; the
    port's drop count against the reference's rule."""
    _, cfg, tc, jp, tp = moe_pair
    cf = float(cfg.n_experts) if cf == "n_experts" else cf
    x = _x(4, 2, 16, cfg.d_model)
    tx = torch.from_numpy(x)
    _, experts, _ = tmoe.route(tp["router"], tx.reshape(32, -1), tc.top_k)
    for kw in (dict(dispatch="sort"), dict(dispatch="cumsum"),
               dict(groups=2)):
        jy, jaux = jmoe.moe_mlp(jp, cfg, jnp.asarray(x), capacity_factor=cf,
                                **kw)
        stats = {}
        ty, taux = tmoe.moe_mlp(tp, tc, tx, capacity_factor=cf, stats=stats,
                                **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL,
                                   err_msg=str(kw))
        assert float(taux) == pytest.approx(float(jaux), abs=1e-6)
        g = kw.get("groups", 1)
        cap = tmoe.capacity(cf, 32 // g, tc.top_k, tc.n_experts)
        assert stats["assignments"] == 32 * tc.top_k
        assert int(stats["dropped"]) == _dropped(experts.numpy(), cap, g)


def test_dense_oracle_matches_jax(moe_pair):
    _, cfg, tc, jp, tp = moe_pair
    x = _x(5, 2, 8, cfg.d_model)
    jy, jaux = jmoe.moe_mlp_dense_oracle(jp, cfg, jnp.asarray(x))
    ty, taux = tmoe.moe_mlp_dense_oracle(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-6)
    # No drop at cf = n_experts: the dispatch equals the oracle.
    ty2, _ = tmoe.moe_mlp(tp, tc, torch.from_numpy(x),
                          capacity_factor=float(tc.n_experts))
    np.testing.assert_allclose(ty2.numpy(), ty.numpy(), **TOL)


def test_drop_does_not_clobber_slot_zero():
    """At one slot an expert, each expert keeps its first assignment in
    slot order, and that token's output is its kept experts' weighted
    outputs (from the dense per-expert products) plus the shared experts:
    a dropped assignment must not overwrite the kept row 0."""
    cfg = tcfg.get_smoke("qwen2-moe-a2.7b")
    tp = _tree(jmoe.init_moe(jax.random.PRNGKey(1),
                             jcfg.get_smoke("qwen2-moe-a2.7b")))
    x = torch.from_numpy(_x(6, 1, 8, cfg.d_model))
    x2d = x[0]
    y, _ = tmoe.moe_mlp(tp, cfg, x, capacity_factor=1e-9)
    w, experts, _ = tmoe.route(tp["router"], x2d, cfg.top_k)
    want = tl.mlp(tp["shared"], x2d).double()
    seen = set()
    for t in range(8):
        for j in range(cfg.top_k):
            e = int(experts[t, j])
            if e in seen:
                continue
            seen.add(e)
            ex = {n: tp[n][e] for n in ("w_gate", "w_up", "w_down")}
            want[t] += w[t, j].double() * tl.mlp(ex, x2d[t:t + 1])[0]
    assert 1 < len(seen) < 8 * cfg.top_k
    np.testing.assert_allclose(y[0].numpy(), want.numpy(), **TOL)


def test_bf16_matches_jax():
    """bf16 experts, shared experts and input, the f32 router (kept f32 by
    both inits): routes identical, outputs within 2^-6 (atol and rtol).
    Each side rounds to bf16 (8 significant bits, 2^-9 relative) after the
    gate and up products, the activation, the down product and the final
    cast: a few such roundings, summed over 2 + shared experts, stay well
    inside 2^-6 of outputs of size ~1, while a wrong drop or a lost expert
    moves them by ~1e-1."""
    for arch in ARCHS:
        jc = dataclasses.replace(jcfg.get_smoke(arch), dtype="bfloat16")
        tc = dataclasses.replace(tcfg.get_smoke(arch), dtype="bfloat16")
        jp = jmoe.init_moe(jax.random.PRNGKey(2), jc)
        assert jp["router"].dtype == jnp.float32
        assert jp["w_gate"].dtype == jnp.bfloat16
        tp = _tree(jp)
        x = _x(7, 2, 16, jc.d_model)
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        _, je, _ = jmoe.route(jp["router"], jx.reshape(32, -1), jc.top_k)
        _, te, _ = tmoe.route(tp["router"], tx.reshape(32, -1), tc.top_k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        jy, _ = jmoe.moe_mlp(jp, jc, jx, capacity_factor=1.0)
        ty, _ = tmoe.moe_mlp(tp, tc, tx, capacity_factor=1.0)
        assert ty.dtype == torch.bfloat16
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(jy, np.float32),
                                   atol=2 ** -6, rtol=2 ** -6)


def test_repeat_calls_bit_identical(moe_pair):
    _, _, tc, _, tp = moe_pair
    x = torch.from_numpy(_x(8, 2, 16, tc.d_model))
    a, _ = tmoe.moe_mlp(tp, tc, x, capacity_factor=0.5)
    b, _ = tmoe.moe_mlp(tp, tc, x, capacity_factor=0.5)
    assert torch.equal(a, b)


def test_capacity_rule_and_init():
    """The reference's capacity in Python floats: one slot an expert at the
    full config's decode (4 slots, top-4 of 60 at cf 2.0), 273 at a
    2,048-token prefill. ``init_moe`` at a bf16 config: the router f32,
    the experts and shared experts bf16, each expert's weights in
    [-2, 2] / sqrt(d_in)."""
    full = tcfg.get("qwen2-moe-a2.7b")
    assert tmoe.capacity(2.0, 4, full.top_k, full.n_experts) == 1
    assert tmoe.capacity(2.0, 2048, full.top_k, full.n_experts) == 273
    assert tmoe.capacity(1e-9, 16, 2, 6) == 1
    cfg = dataclasses.replace(tcfg.get_smoke("qwen2-moe-a2.7b"),
                              dtype="bfloat16")
    p = tmoe.init_moe(cfg, "cpu", torch.Generator().manual_seed(0))
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (cfg.d_model, cfg.n_experts)
    for name, din in (("w_gate", cfg.d_model), ("w_up", cfg.d_model),
                      ("w_down", cfg.d_ff)):
        w = p[name].float()
        assert p[name].dtype == torch.bfloat16
        assert w.shape[0] == cfg.n_experts and w.shape[1] == din
        assert w.abs().max() <= 2.0 / np.sqrt(din) * (1 + 2 ** -8)
        assert w.std() > 0.5 / np.sqrt(din)
    assert p["shared"]["w_gate"].shape == (cfg.d_model,
                                           cfg.n_shared * cfg.d_ff)
    assert p["shared"]["w_down"].dtype == torch.bfloat16
