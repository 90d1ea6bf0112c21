"""Training the moe, ssm, hybrid and encdec families, the port against the
JAX package on the CPU: ``LM.loss`` and every gradient leaf against
``jax.value_and_grad(LM.loss)`` on converted weights (f32 smoke configs,
B = 2, S = 64, labels -1 on part of each row; MoE's aux term, encdec's
``enc_embeds``), the aux term's own gradient at the routers, MoE at a
capacity factor that drops assignments under each dispatch, the scratch row of dropped assignments, the data
pipeline's ``enc_embeds``, and the reference's SSD gradient overflow at S
= 256 shown in both packages. Train steps and the launcher:
``test_torch_train_families_p2.py``.

Tolerances. Loss and gradients: ``atol=rtol=2e-5``, as
``test_torch_train.py`` (two f32 layers of 16-128-wide products summed in
other orders; measured <= 8e-6 of a leaf's largest magnitude at these
sizes). The SSD overflow compares which leaves are non-finite, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.data import pipeline as jpipe
from repro.models import ssm as jssm
from repro.models.lm import LM as JLM, Batch as JBatch
from repro.training import train_step as jts
from repro_torch import convert
from repro_torch.configs import base as tcfg
from repro_torch.data import pipeline as tpipe
from repro_torch.models import moe as tmoe, ssm as tssm
from repro_torch.models.lm import (Batch, jax_leaves, tree_leaves,
                                   tree_unflatten)
from repro_torch.training import train_step as tts

GRAD = dict(atol=2e-5, rtol=2e-5)
FAMILIES = ["qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-1.2b",
            "seamless-m4t-medium"]
B, S = 2, 64


def _np_state(arch, seed=0, **lm_kw):
    kw = {"vocab_chunk": 16, "moe_capacity_factor": 2.0, **lm_kw}
    jm = JLM(jcfg.get_smoke(arch), **kw)
    return jm, kw, jax.tree.map(np.asarray, jts.init_state(
        jm, jax.random.PRNGKey(seed)))


def data_config(cfg, seq=S, batch=B) -> tpipe.DataConfig:
    return tpipe.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                            d_model=cfg.d_model,
                            enc_frac=4 if cfg.family == "encdec" else 0)


def batches(cfg, step=0, seq=S, batch=B, mask=True):
    """(JAX Batch, port Batch) of the port pipeline's batch at ``step``,
    labels -1 on the first 5 positions of row 0 and the second half of
    row 1 when ``mask``."""
    b = tpipe.global_batch_for_step(data_config(cfg, seq, batch), step)
    lab = b.labels.copy()
    if mask:
        lab[0, :5] = -1
        lab[1, seq // 2:] = -1
    enc = b.enc_embeds
    return (JBatch(tokens=jnp.asarray(b.tokens), labels=jnp.asarray(lab),
                   enc_embeds=None if enc is None else jnp.asarray(enc)),
            Batch(tokens=torch.from_numpy(b.tokens),
                  labels=torch.from_numpy(lab),
                  enc_embeds=None if enc is None else torch.from_numpy(enc)))


def grads_np(state, grads) -> list:
    """The port's gradients as numpy leaves in the JAX order, stacked."""
    return [np.stack([t.detach().numpy() for t in g]) if len(g) > 1
            else g[0].detach().numpy()
            for g in jax_leaves(tree_unflatten(state.params, grads))]


def both_grads(arch, seq=S, **lm_kw):
    """(JAX loss, metrics, grads; port loss, metrics, grads), the JAX side
    compiled with ``jax.jit``."""
    jm, kw, st = _np_state(arch, **lm_kw)
    cfg = tcfg.get_smoke(arch)
    jb, tb = batches(cfg, seq=seq)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, st.params), jb)
    model, state = convert.train_state(st, cfg, "cpu", **kw)
    loss, met, grads = tts.value_and_grad(model, tree_leaves(state.params),
                                          tb)
    return ((float(jl), jmet, jax.tree.leaves(jax.tree.map(np.asarray, jg))),
            (float(loss), met, grads_np(state, grads)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """Every family's loss, metrics (MoE's aux term) and each gradient leaf
    (hybrid's one ``shared_attn`` summed over its 2 sites, encdec's encoder
    and cross-attention) against ``jax.value_and_grad``."""
    (jl, jmet, jg), (tl, tmet, tg) = both_grads(arch)
    np.testing.assert_allclose(tl, jl, **GRAD)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **GRAD)
    if arch.startswith("qwen2-moe"):
        assert float(tmet["aux"]) > 0
    assert len(tg) == len(jg)
    for a, w in zip(tg, jg):
        assert a.shape == w.shape and np.isfinite(w).all()
        np.testing.assert_allclose(a, w, **GRAD)


def test_moe_aux_term_reaches_the_router():
    """The load-balancing term's own gradient, 0.01 x aux through
    ``LM.loss``'s metrics, reaches every layer's router (through the
    router's probabilities; the one-hot hits carry none) and matches
    JAX's."""
    arch = "qwen2-moe-a2.7b"
    jm, kw, st = _np_state(arch)
    cfg = tcfg.get_smoke(arch)
    jb, tb = batches(cfg)
    jg = jax.jit(jax.grad(lambda p: 0.01 * jm.loss(p, jb)[1]["aux"]))(
        jax.tree.map(jnp.asarray, st.params))
    model, state = convert.train_state(st, cfg, "cpu", **kw)
    _, met = model.loss(tb)
    routers = [lp["moe"]["router"] for lp in state.params["layers"]]
    got = torch.autograd.grad(0.01 * met["aux"], routers)
    want = np.asarray(jg["layers"]["moe"]["router"])
    assert len(got) == want.shape[0] == cfg.n_layers
    for a, w in zip(got, want):
        assert float(a.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), w, **GRAD)


MOE_CASES = [dict(moe_dispatch="sort"), dict(moe_dispatch="cumsum"),
             dict(moe_groups=2)]


@pytest.mark.parametrize("kw", MOE_CASES, ids=["sort", "cumsum", "groups2"])
def test_moe_drops_grads_match_jax(kw):
    """MoE at capacity factor 0.5 (a third to a half of the assignments
    dropped at 128 tokens, 6 experts, top 2): loss, aux and every gradient
    against JAX's ``mode="drop"`` dispatch, under each dispatch."""
    arch = "qwen2-moe-a2.7b"
    stats = {}
    real = tmoe.moe_mlp

    def counted(*a, **k):
        return real(*a, **k, stats=stats)

    tmoe.moe_mlp = counted
    try:
        (jl, jmet, jg), (tl, tmet, tg) = both_grads(
            arch, moe_capacity_factor=0.5, **kw)
    finally:
        tmoe.moe_mlp = real
    assert int(stats["dropped"]) > stats["assignments"] // 4
    np.testing.assert_allclose(tl, jl, **GRAD)
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]),
                               **GRAD)
    for a, w in zip(tg, jg):
        np.testing.assert_allclose(a, w, **GRAD)


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_scratch_row_takes_no_gradient(groups):
    """The scratch row C of the (E, C + 1, D) buffer, where dropped
    assignments land, gets exactly 0 gradient, and the expert weights'
    gradients are bit for bit those of a run whose row C holds zeros: a
    dropped token's gradient comes only from the shared experts and the
    residual."""
    cfg = tcfg.get_smoke("qwen2-moe-a2.7b")
    _, kw, st = _np_state("qwen2-moe-a2.7b")
    kw.update(moe_capacity_factor=0.5, moe_groups=groups)
    _, tb = batches(cfg)
    real = tmoe._experts
    bufs = []

    def run(zero_scratch: bool):
        def experts(p, buf):
            if zero_scratch:
                rows = buf.reshape(buf.shape[0], groups, -1, buf.shape[-1])
                buf = rows.index_fill(2, torch.tensor([rows.shape[2] - 1]),
                                      0.0).reshape(buf.shape)
            buf.retain_grad()
            bufs.append(buf)
            return real(p, buf)

        model, state = convert.train_state(st, cfg, "cpu", **kw)
        tmoe._experts = experts
        try:
            _, _, grads = tts.value_and_grad(
                model, tree_leaves(state.params), tb)
        finally:
            tmoe._experts = real
        return tree_unflatten(state.params, grads)

    got = run(False)
    for buf in bufs:
        rows = buf.reshape(buf.shape[0], groups, -1, buf.shape[-1])
        assert rows[:, :, -1].abs().sum() > 0  # dropped tokens landed there
        g = buf.grad.reshape(rows.shape)
        assert torch.equal(g[:, :, -1], torch.zeros_like(g[:, :, -1]))
    zeroed = run(True)
    for lg, lz in zip(got["layers"], zeroed["layers"]):
        for name in ("w_gate", "w_up", "w_down"):
            assert torch.equal(lg["moe"][name], lz["moe"][name])


@pytest.mark.parametrize("step,dp_shards,rank", [(0, 1, 0), (7, 2, 1)])
def test_enc_embeds_bit_equal(step, dp_shards, rank):
    """The pipeline's encoder frames (seed off the first document ID,
    shifted by one; S // enc_frac frames) bit-equal to the JAX pipeline's,
    with the tokens and labels."""
    kw = dict(vocab=256, seq_len=64, global_batch=8, dp_shards=dp_shards,
              d_model=48, enc_frac=4)
    t = tpipe.global_batch_for_step(tpipe.DataConfig(**kw), step, rank)
    j = jpipe.global_batch_for_step(jpipe.DataConfig(**kw), step, rank)
    assert t.enc_embeds.shape == (8 // dp_shards, 16, 48)
    assert t.enc_embeds.dtype == np.float32 and t.prefix_embeds is None
    for a, b in ((t.enc_embeds, j.enc_embeds), (t.tokens, j.tokens),
                 (t.labels, j.labels)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssd_gradient_overflow_shown_in_both(arch):
    """The reference's defect, kept: at S = 256 (one 256-step chunk) the
    masked decay ``where(ltri, exp(diff), 0)`` overflows above the
    diagonal, where ``diff`` >= 0, and 0 x inf = NaN reaches the gradient.
    Both packages give a finite loss and non-finite gradients in the same
    leaves; both train steps flag the microbatch, skip the commit, leave
    params and moments as they were and chain the same ledger head."""
    (jl, _, jg), (tl, _, tg) = both_grads(arch, seq=256)
    assert np.isfinite(jl) and np.isfinite(tl)
    bad_j = [i for i, w in enumerate(jg) if not np.isfinite(w).all()]
    bad_t = [i for i, a in enumerate(tg) if not np.isfinite(a).all()]
    assert bad_t == bad_j and len(bad_j) >= len(jg) // 2
    for i, (a, w) in enumerate(zip(tg, jg)):
        if i not in bad_j:
            np.testing.assert_allclose(a, w, **GRAD)

    jm, kw, st = _np_state(arch)
    cfg = tcfg.get_smoke(arch)
    jb, tb = batches(cfg, seq=256)
    js, jmet = jax.jit(jts.make_train_step(jm, jts.TrainConfig()))(
        jax.tree.map(jnp.asarray, st), jb)
    model, state = convert.train_state(st, cfg, "cpu", **kw)
    before = [t.clone() for g in tts.state_leaves(state)[:-1] for t in g]
    state, tmet = tts.make_train_step(model, tts.TrainConfig())(state, tb)
    assert int(tmet["skipped"]) == int(jmet["skipped"]) == 1
    assert float(tmet["endorsed_mb"]) == float(jmet["endorsed_mb"]) == 0.0
    after = [t for g in tts.state_leaves(state)[:-1] for t in g]
    changed = [i for i, (a, b) in enumerate(zip(after, before))
               if not torch.equal(a, b)]
    n_params = len(tree_leaves(state.params))
    assert changed == [n_params]  # only the step counter moves on
    assert int(state.opt.step) == int(js.opt.step) == 1
    jn = jax.tree.map(np.asarray, js)
    for w, a in zip(jax.tree.leaves(jn.params),
                    jax.tree.leaves(st.params)):
        np.testing.assert_array_equal(w, a)
    np.testing.assert_array_equal(
        convert.u32.to_numpy(state.ledger_head), jn.ledger_head)


def test_ssd_chunked_gradient_overflows_in_both():
    """The cause alone: ``ssd_chunked``'s gradient in both packages, one
    chunk of 256 steps at log-decays dt x A of -0.5 a step. Above the
    diagonal diff reaches 127.5 and exp overflows; the outputs are finite,
    the gradients of dt and A NaN in both (x's reaches the output through
    the masked weights only and stays finite); at 128 steps (diff <= 63.5)
    all are finite and agree."""
    rng = np.random.default_rng(0)
    for s, finite in ((256, False), (128, True)):
        x = rng.standard_normal((1, s, 2, 4)).astype(np.float32)
        dt = np.full((1, s, 2), 0.25, np.float32)
        a_neg = np.array([-2.0, -1.0], np.float32)
        bm = rng.standard_normal((1, s, 8)).astype(np.float32)
        cm = rng.standard_normal((1, s, 8)).astype(np.float32)

        def jloss(x, dt, a):
            y, st = jssm.ssd_chunked(x, dt, a, bm, cm, chunk=256)
            return y.sum() + st.sum()

        jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(x, dt, a_neg)
        tx, tdt, ta = (torch.from_numpy(v).requires_grad_()
                       for v in (x, dt, a_neg))
        y, st = tssm.ssd_chunked(tx, tdt, ta, torch.from_numpy(bm),
                                 torch.from_numpy(cm), chunk=256)
        tl = y.sum() + st.sum()
        tg = torch.autograd.grad(tl, (tx, tdt, ta))
        assert np.isfinite(float(jl)) and torch.isfinite(tl)
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        for i, (a, w) in enumerate(zip(tg, jg)):
            w = np.asarray(w)
            ok = finite or i == 0
            assert bool(torch.isfinite(a).all()) == ok
            assert bool(np.isfinite(w).all()) == ok
            if ok:
                np.testing.assert_allclose(a.numpy(), w, rtol=1e-4,
                                           atol=1e-4 * np.abs(w).max())
