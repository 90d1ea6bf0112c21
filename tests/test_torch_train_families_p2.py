"""Training the moe, ssm, hybrid and encdec families, part 2, the port
against the JAX package on the CPU: three ``train_step``s from a converted
JAX ``TrainState`` at ``microbatches`` 1 and 2 for each family (encdec's
``enc_embeds`` split across microbatches, MoE's aux metric), the launcher
for each family (MoE at the reference launcher's capacity factor), kill
and resume against a straight run, and bf16 states whose f32 leaves (the
router, ``dt_bias``, ``A_log``, ``D``) and moments cross packages through
``convert`` and the checkpointers bit for bit.

Tolerances after three train steps: metrics ``rtol=1e-5`` (measured <=
1.1e-6); params within 1e-5 of each leaf's largest magnitude plus 0.1 of
the learning rates summed over the steps, moments within 2e-4 of each
leaf's largest magnitude. AdamW moves a parameter by ~lr whatever the size
of its gradient, so where a gradient sits near the rounding level (or
near AdamW's eps) the two sides' updates differ by a share of lr, and the
next steps' gradients differ with the params: measured 0.035 of the summed
rates and 8.3e-5 of a moment leaf's largest magnitude for zamba2 at one
microbatch (its Mamba2 ``in_proj``, ``conv_w``, ``D``; 0.21 of the one
rate after its first step), <= 0.0067 and <= 5.8e-6 for every other case.
A wrong update (bias correction, decay, clipping) moves whole leaves by
~lr, and a wrong gradient fails ``test_torch_train_families.py`` at
2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import base as jcfg
from repro.launch import train as jlaunch
from repro.models.lm import LM as JLM
from repro.training import optimizer as jopt, train_step as jts
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import base as tcfg
from repro_torch.launch import train as tlaunch
from repro_torch.models.lm import F32_LEAVES, _jax_paths, jax_leaves
from repro_torch.training import optimizer as topt, train_step as tts

from test_torch_train_families import FAMILIES, batches

METRIC = dict(rtol=1e-5, atol=1e-6)
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=60)


def _np_state(arch, seed=0, dtype=None):
    cfg = jcfg.get_smoke(arch)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jm = JLM(cfg, vocab_chunk=16, moe_capacity_factor=2.0)
    return jm, jax.tree.map(np.asarray, jts.init_state(
        jm, jax.random.PRNGKey(seed)))


def _compare_states(tstate, jstate, lr_sum):
    exp = convert.export_train_state(tstate, jax.tree.map(np.asarray,
                                                          jstate.params))
    jn = jax.tree.map(np.asarray, jstate)
    assert int(exp.step) == int(jn.opt.step)
    for got, want, tol, extra in (
            (exp.params, jn.params, 1e-5, 0.1 * lr_sum),
            (exp.m, jn.opt.m, 2e-4, 0.0), (exp.v, jn.opt.v, 2e-4, 0.0)):
        for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            scale = float(np.abs(w).max()) or 1.0
            assert float(np.abs(a - w).max()) <= tol * scale + extra


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_three_train_steps_match_jax(arch, mb):
    """Three steps of a batch of 2 x 64 (labels -1 on part of each row):
    every metric (MoE's aux at one microbatch, as JAX reports it), the step
    counter, params and moments against JAX's ``make_train_step``."""
    jm, st = _np_state(arch)
    cfg = tcfg.get_smoke(arch)
    jstep = jax.jit(jts.make_train_step(jm, jts.TrainConfig(
        opt=jopt.AdamWConfig(**OPT), microbatches=mb)))
    model, state = convert.train_state(st, cfg, "cpu", vocab_chunk=16,
                                       moe_capacity_factor=2.0)
    step = tts.make_train_step(model, tts.TrainConfig(
        opt=topt.AdamWConfig(**OPT), microbatches=mb))
    js = jax.tree.map(jnp.asarray, st)
    lr_sum = 0.0
    for i in range(3):
        jb, tb = batches(cfg, step=i)
        js, jmet = jstep(js, jb)
        state, tmet = step(state, tb)
        assert set(tmet) == set(jmet)
        assert ("aux" in tmet) == (mb == 1 and cfg.family == "moe")
        assert int(tmet["skipped"]) == 0 and float(tmet["endorsed_mb"]) == mb
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       **METRIC)
        lr_sum += float(jmet["lr"])
    _compare_states(state, js, lr_sum)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_trains_each_family(arch):
    """``launch.train --device cpu`` trains every family (no refusal), MoE
    at the JAX launcher's capacity factor; every loss finite and every
    step endorsed."""
    kw = dict(smoke=True, seq=32, batch=4, microbatches=1, lr=1e-3,
              total_steps=4)
    _, tmodel, _, tdcfg = tlaunch.build(arch, device="cpu", **kw)
    _, jmodel, _, jdcfg = jlaunch.build(arch, **kw)
    assert tmodel.moe_cf == jmodel.moe_cf == 2.0
    assert dataclasses.asdict(tdcfg) == dataclasses.asdict(jdcfg)
    out = tlaunch.run(["--arch", arch, "--device", "cpu", "--steps", "4",
                       "--batch", "4", "--seq", "32", "--microbatches", "2",
                       "--log-every", "100"])
    assert out["final_step"] == 4 and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))
    assert int(out["state"].opt.step) == 4


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "seamless-m4t-medium"])
def test_launch_kill_and_resume_equals_straight_run(tmp_path, arch):
    """MoE and encdec: 6 steps straight against a run killed after step 4
    (checkpoints every 2) and resumed from step 4: the same losses and the
    same final state, bit for bit."""
    base = ["--arch", arch, "--device", "cpu", "--steps", "6", "--batch",
            "4", "--seq", "32", "--log-every", "100"]
    straight = tlaunch.run(base)
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    killed = tlaunch.run(base + ck + ["--kill-at", "4"])
    assert killed["killed_at"] == 4
    resumed = tlaunch.run(base + ck + ["--resume"])
    assert killed["losses"] == straight["losses"][:4]
    assert resumed["losses"] == straight["losses"][4:]
    for a, b in zip(*(tts.state_leaves(r["state"])
                      for r in (straight, resumed))):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _bf16_state(arch, seed):
    """A JAX bf16 ``TrainState`` (numpy) with moments drawn at random, a
    step and a ledger head set."""
    jm, st = _np_state(arch, seed, dtype="bfloat16")
    rng = np.random.default_rng(seed)
    bump = lambda t: jax.tree.map(
        lambda a: rng.random(a.shape).astype(np.float32), t)
    st = st._replace(opt=st.opt._replace(m=bump(st.opt.m), v=bump(st.opt.v),
                                         step=np.int32(3)),
                     ledger_head=np.array([5, 0xFFFFFFF1], np.uint32))
    return jm, st


def _assert_same(exported, jstate):
    """A port state's export equals a JAX state bit for bit (each leaf at
    the JAX leaf's dtype)."""
    jn = jax.tree.map(np.asarray, jstate)
    for a, w in zip(jax.tree.leaves((exported.params, exported.step,
                                     exported.m, exported.v,
                                     exported.ledger_head)),
                    jax.tree.leaves(jn)):
        np.testing.assert_array_equal(np.asarray(a).astype(w.dtype), w)


def _assert_dtypes(state):
    """bf16 leaves but for the f32 ones named in ``F32_LEAVES``; f32
    moments."""
    names = [p[-1] for p in _jax_paths(state.params)]
    for name, group in zip(names, jax_leaves(state.params)):
        want = torch.float32 if name in F32_LEAVES else torch.bfloat16
        assert all(t.dtype == want for t in group), name
    for tree in (state.opt.m, state.opt.v):
        assert all(t.dtype == torch.float32
                   for g in jax_leaves(tree) for t in g)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b"])
def test_bf16_train_state_round_trip(arch):
    """A bf16 moe and ssm ``TrainState`` JAX -> port -> JAX through
    ``convert``, bit for bit, the f32 leaves f32 in the port's model."""
    _, st = _bf16_state(arch, 7)
    cfg = dataclasses.replace(tcfg.get_smoke(arch), dtype="bfloat16")
    _, state = convert.train_state(st, cfg, "cpu")
    _assert_dtypes(state)
    assert {p[-1] for p in _jax_paths(state.params)} & F32_LEAVES
    _assert_same(convert.export_train_state(state, st.params), st)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b"])
def test_bf16_checkpoint_across_packages(tmp_path, arch, direction):
    """A bf16 state saved by one package's Checkpointer and restored by the
    other's, bit for bit, chain verified: the JAX package's own bf16 files
    (2-byte voids) into the port, and the port's (bf16 leaves as f32) into
    the JAX package."""
    jm, st = _bf16_state(arch, 11)
    cfg = dataclasses.replace(tcfg.get_smoke(arch), dtype="bfloat16")
    _, like = convert.train_state(_bf16_state(arch, 12)[1], cfg, "cpu")
    jstate = jax.tree.map(jnp.asarray, st)
    path = str(tmp_path / "ck")
    if direction == "jax_to_port":
        ck = JCheckpointer(path)
        ck.save(3, jstate, blocking=True)
        ck.close()
        tck = Checkpointer(path)
        got, step = tck.restore(like)
        assert step == 3 and tck.verify_chain()
        tck.close()
        _assert_dtypes(got)
        _assert_same(convert.export_train_state(got, st.params), st)
    else:
        _, src = convert.train_state(st, cfg, "cpu")
        tck = Checkpointer(path)
        tck.save(3, src, blocking=True)
        tck.close()
        jlike = jax.tree.map(jnp.asarray, _bf16_state(arch, 12)[1])
        jck = JCheckpointer(path)
        got, step = jck.restore(jlike)
        assert step == 3 and jck.verify_chain()
        jck.close()
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jlike)):
            assert a.dtype == b.dtype
        _assert_same(convert.export_train_state(src, st.params), got)


@pytest.mark.parametrize("arch", ["qwen2-7b", *FAMILIES])
def test_attention_calls_count_k5_a_step(monkeypatch, arch):
    """``lm.attention_calls`` (the K5 launches a training step expects on
    the card) equals the calls of K5's forward and backward wrappers in
    one loss and gradient of each family's smoke config, hybrid with a
    last group shorter than ``attn_every``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.lm import LM, attention_calls, tree_leaves
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa_ops._forward, fa_ops.flash_attention_bwd

    def counting(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(fa_ops, "_forward", counting("fwd", fwd))
    monkeypatch.setattr(fa_ops, "flash_attention_bwd",
                        counting("bwd", bwd))
    cfg = tcfg.get_smoke(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every + 1)
    model = LM(cfg, vocab_chunk=16, device="cpu").init(
        torch.Generator().manual_seed(0))
    model.params.requires_grad_(True)
    _, batch = batches(cfg, seq=32)
    loss, _, _ = tts.value_and_grad(
        model, tree_leaves(model.params.tree()), batch)
    assert bool(torch.isfinite(loss))
    want = attention_calls(cfg)
    assert calls == {"fwd": want, "bwd": want}
    assert want == {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
                    "hybrid": 2, "encdec": 3 * cfg.n_layers}[cfg.family]
