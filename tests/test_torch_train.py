"""LM training, the port against the JAX package on the CPU: ``LM.loss``
and its gradients against ``jax.value_and_grad(LM.loss)`` on converted
weights (labels of -1 masked), three ``train_step``s from a converted JAX
``TrainState`` at ``microbatches`` 1 and 2, the reference's
NaN-microbatch and all-bad-skip cases, and the port alone: microbatch
accumulation, a falling loss, ``convert``'s round trip and
``launch.train --device cpu`` killed and resumed against a straight run.

Tolerances. Loss and gradients: ``atol=rtol=2e-5`` (two f32 layers of
64-128-wide products summed in another order; measured ~1e-7 relative).
After train steps: metrics ``rtol=1e-5``; moments within 1e-5 of each
leaf's largest magnitude (measured ~1.5e-6); params within 1e-5 of it
plus 0.05 of the learning rates summed over the steps: AdamW moves a
parameter by ~lr whatever the size of its gradient, so where a gradient
sits near the rounding level the two sides' updates differ by a share of
lr (measured 9.2e-6 after three steps whose rates sum to 1.2e-3, 0.015 of
it), while a wrong update (bias correction, decay, clipping) moves whole
leaves by ~lr. Ledger heads are equal only where the gradient sums are
exact (test_torch_train_parts.py); here they are not compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models.lm import LM as JLM, Batch as JBatch
from repro.training import optimizer as jopt, train_step as jts
from repro_torch import convert
from repro_torch.configs import base as tcfg
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models.lm import (Batch, jax_leaves, tree_leaves,
                                   tree_unflatten)
from repro_torch.training import optimizer as topt, train_step as tts

GRAD = dict(atol=2e-5, rtol=2e-5)
METRIC = dict(rtol=1e-5, atol=1e-6)
ARCH = "qwen2-7b"
DATA = dict(vocab=256, seq_len=32, global_batch=8)


def _np_state(arch=ARCH, seed=0):
    jm = JLM(jcfg.get_smoke(arch), vocab_chunk=16, moe_capacity_factor=2.0)
    return jm, jax.tree.map(np.asarray, jts.init_state(
        jm, jax.random.PRNGKey(seed)))


def _batches(step):
    b = tpipe.global_batch_for_step(tpipe.DataConfig(**DATA), step)
    return (JBatch(tokens=jnp.asarray(b.tokens),
                   labels=jnp.asarray(b.labels)),
            Batch(tokens=torch.from_numpy(b.tokens),
                  labels=torch.from_numpy(b.labels)))


def _leaves_np(tree) -> list:
    return [np.stack([t.detach().numpy() for t in g]) if len(g) > 1
            else g[0].detach().numpy() for g in jax_leaves(tree)]


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-4b"])
def test_loss_and_grads_match_jax(arch):
    """qwen2-7b (QKV bias) and qwen3-4b (qk-norm: rmsnorm's backward on
    q and k), labels -1 on part of two rows."""
    jm, st = _np_state(arch)
    b = tpipe.global_batch_for_step(tpipe.DataConfig(**DATA), 0)
    lab = b.labels.copy()
    lab[0, :5] = -1
    lab[3, 10:] = -1
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, st.params),
        JBatch(tokens=jnp.asarray(b.tokens), labels=jnp.asarray(lab)))
    model, state = convert.train_state(st, tcfg.get_smoke(arch), "cpu",
                                       vocab_chunk=16)
    params = tree_leaves(state.params)
    loss, met, grads = tts.value_and_grad(
        model, params, Batch(tokens=torch.from_numpy(b.tokens),
                             labels=torch.from_numpy(lab)))
    np.testing.assert_allclose(float(loss), float(jl), **GRAD)
    assert int(met["tokens"]) == int(jmet["tokens"]) == int((lab >= 0).sum())
    got = _leaves_np(tree_unflatten(state.params, grads))
    for a, w in zip(got, jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(a, w, **GRAD)


def _compare_states(tstate, jstate, lr_sum):
    exp = convert.export_train_state(tstate, jax.tree.map(np.asarray,
                                                          jstate.params))
    jn = jax.tree.map(np.asarray, jstate)
    assert int(exp.step) == int(jn.opt.step)
    for got, want, extra in ((exp.params, jn.params, 0.05 * lr_sum),
                             (exp.m, jn.opt.m, 0.0), (exp.v, jn.opt.v, 0.0)):
        for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            scale = float(np.abs(w).max()) or 1.0
            assert float(np.abs(a - w).max()) <= 1e-5 * scale + extra


@pytest.fixture(scope="module")
def jax_steps():
    """JAX train steps, each configuration compiled once."""
    out = {}
    for mb in (1, 2):
        jm, _ = _np_state()
        out[mb] = (jm, jax.jit(jts.make_train_step(jm, jts.TrainConfig(
            opt=jopt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60),
            microbatches=mb))))
    return out


@pytest.mark.parametrize("mb", [1, 2])
def test_three_train_steps_match_jax(jax_steps, mb):
    _, jstep = jax_steps[mb]
    _, st = _np_state()
    model, state = convert.train_state(st, tcfg.get_smoke(ARCH), "cpu",
                                       vocab_chunk=16)
    step = tts.make_train_step(model, tts.TrainConfig(
        opt=topt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60),
        microbatches=mb))
    js = jax.tree.map(jnp.asarray, st)
    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batches(i)
        js, jm = jstep(js, jb)
        state, tm = step(state, tb)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **METRIC)
        lr_sum += float(jm["lr"])
    _compare_states(state, js, lr_sum)


def _poisoned(mb, tokens):
    """The reference's poison: embedding row 0 = inf, ``tokens`` rows."""
    jm, st = _np_state()
    embed = st.params["embed"].copy()
    embed[0] = np.inf
    st = st._replace(params={**st.params, "embed": embed})
    jstep = jax.jit(jts.make_train_step(jm, jts.TrainConfig(
        microbatches=mb, endorse_grads=True)))
    model, state = convert.train_state(st, tcfg.get_smoke(ARCH), "cpu",
                                       vocab_chunk=16)
    step = tts.make_train_step(model, tts.TrainConfig(microbatches=mb,
                                                      endorse_grads=True))
    jb, _ = _batches(0)
    lab = np.array(jb.labels)
    js, jmet = jstep(jax.tree.map(jnp.asarray, st),
                     JBatch(tokens=jnp.asarray(tokens),
                            labels=jnp.asarray(lab)))
    m0 = [t.clone() for t in tree_leaves(state.opt.m)]
    state, tmet = step(state, Batch(tokens=torch.from_numpy(tokens),
                                    labels=torch.from_numpy(lab)))
    for k in ("endorsed_mb", "skipped", "loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **METRIC)
    exp = convert.export_train_state(state, st.params)
    for a, w in zip(jax.tree.leaves(exp.m),
                    jax.tree.leaves(jax.tree.map(np.asarray, js.opt.m))):
        scale = float(np.abs(w).max()) or 1.0
        assert float(np.abs(a - w).max()) <= 1e-5 * scale
    return state, tmet, m0


def test_nan_microbatch_is_flagged_without_stall():
    """mb = 4; the first microbatch reads the inf row: 3 endorsed, the
    block still committed, the loss finite; as JAX."""
    b = tpipe.global_batch_for_step(tpipe.DataConfig(**DATA), 0)
    toks = b.tokens % 254 + 1
    toks[0:2] = 0
    _, m, _ = _poisoned(4, toks)
    assert float(m["endorsed_mb"]) == 3.0 and int(m["skipped"]) == 0
    assert np.isfinite(float(m["loss"]))


def test_all_bad_microbatches_skip_the_commit():
    """mb = 2, every row reads the inf row: the commit is skipped, the
    moments stay, the step counter advances; as JAX."""
    toks = np.zeros((8, 32), np.int32)
    state, m, m0 = _poisoned(2, toks)
    assert int(m["skipped"]) == 1 and int(state.opt.step) == 1
    for a, b in zip(tree_leaves(state.opt.m), m0):
        assert torch.equal(a, b)


def test_grad_accumulation_equivalence():
    """The port alone: mb = 2 accumulation equals mb = 1 on the same
    global batch (the reference's test and tolerances)."""
    out = []
    for mb in (1, 2):
        _, st = _np_state()
        model, state = convert.train_state(st, tcfg.get_smoke(ARCH), "cpu",
                                           vocab_chunk=16)
        state, m = tts.make_train_step(model, tts.TrainConfig(
            microbatches=mb))(state, _batches(0)[1])
        out.append((float(m["loss"]), _leaves_np(state.params)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-4)


def test_loss_decreases_on_affine_task():
    """The reference's learning check on the port: 120 steps on the
    affine task over a 64-token vocabulary."""
    cfg, model, tcfg_, _ = tlaunch.build(ARCH, smoke=True, seq=32, batch=8,
                                         microbatches=1, lr=3e-3,
                                         total_steps=120, device="cpu")
    dcfg = tpipe.DataConfig(vocab=64, seq_len=32, global_batch=8)
    state = tts.init_state(model, torch.Generator().manual_seed(0))
    step = tts.make_train_step(model, tcfg_)
    losses = []
    for i in range(120):
        state, m = step(state, tlaunch.device_batch(
            tpipe.global_batch_for_step(dcfg, i), "cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_train_state_round_trip():
    """convert: a JAX TrainState into the port and back, bit for bit."""
    _, st = _np_state(seed=5)
    _, state = convert.train_state(st, tcfg.get_smoke(ARCH), "cpu")
    back = convert.export_train_state(state, st.params)
    for a, b in zip(jax.tree.leaves((back.params, back.step, back.m, back.v,
                                     back.ledger_head)),
                    jax.tree.leaves(st)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_launch_kill_and_resume_equals_straight_run(tmp_path):
    """``launch.train --device cpu``: 8 steps straight, against a run
    killed after step 5 (checkpoints every 2 steps) and resumed from the
    checkpoint at step 4 with its chain verified: the same losses after the
    restore and the same final state, bit for bit."""
    base = ["--device", "cpu", "--steps", "8", "--batch", "4", "--seq", "32",
            "--log-every", "100"]
    straight = tlaunch.run(base)
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    killed = tlaunch.run(base + ck + ["--kill-at", "5"])
    assert killed["killed_at"] == 5
    resumed = tlaunch.run(base + ck + ["--resume"])
    assert resumed["losses"] == straight["losses"][4:]
    assert killed["losses"] == straight["losses"][:5]
    for a, b in zip(*(tts.state_leaves(r["state"])
                      for r in (straight, resumed))):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
