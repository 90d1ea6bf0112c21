"""Training the moe, ssm, hybrid and encdec families, part 2, the port
against the JAX package on the CPU: three ``train_step``s from a converted
JAX ``TrainState`` at ``microbatches`` 1 and 2 for each family (encdec's
``enc_embeds`` split across microbatches, MoE's aux metric), the launcher
for each family (MoE at the reference launcher's capacity factor), and
kill and resume against a straight run. Part 3 holds the bf16 states
across packages and the K5 calls a step.

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

from repro.configs import base as jcfg
from repro.launch import train as jlaunch
from repro.models.lm import LM as JLM
from repro.training import optimizer as jopt, train_step as jts
from repro_torch import convert
from repro_torch.configs import base as tcfg
from repro_torch.launch import train as tlaunch
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
