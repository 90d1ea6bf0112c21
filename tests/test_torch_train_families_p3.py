"""Training the moe, ssm, hybrid and encdec families, part 3, the port
against the JAX package on the CPU: bf16 states whose f32 leaves (the
router, ``dt_bias``, ``A_log``, ``D``) and moments cross packages through
``convert`` and the checkpointers bit for bit, and ``lm.attention_calls``
against counted K5 wrappers in one loss and gradient of each family."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import base as tcfg
from repro_torch.models.lm import F32_LEAVES, _jax_paths, jax_leaves
from repro_torch.training import train_step as tts

from test_torch_train_families import FAMILIES, batches
from test_torch_train_families_p2 import _np_state


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
