"""The training slice's parts against the JAX package on the CPU, from the
same numpy inputs: the data pipeline and membership (bit-equal), the
optimizer (``schedule``, ``clip_by_global_norm``, ``apply`` with and
without ``skip``: f32 within ``atol=1e-7, rtol=1e-6``, the same
elementwise f32 formulas, the global norm's sum taken in another order),
``grad_digest`` and the ledger chain (bit-equal on gradients whose f32
sums are exact in any order: small integers), and the checkpointer
(round trips bit-exact in f32 and bf16, corruption and chain checks,
keep-N, and each package restoring the other's f32 directories)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import base as jcfg
from repro.core import ledger as jledger
from repro.data import pipeline as jpipe
from repro.ft import membership as jft
from repro.models.lm import LM as JLM
from repro.training import optimizer as jopt, train_step as jts
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import base as tcfg
from repro_torch.core import ledger as tledger, u32
from repro_torch.data import pipeline as tpipe
from repro_torch.ft import membership as tft
from repro_torch.models.lm import (LM, jax_leaves, tree_leaves,
                                   tree_unflatten)
from repro_torch.training import optimizer as topt, train_step as tts

OPT = dict(atol=1e-7, rtol=1e-6)


# -- data pipeline ----------------------------------------------------------

@pytest.mark.parametrize("dp_shards,step,ranks,n_prefix", [
    (4, 7, (1,), 0),          # test_step_determinism
    (4, 3, (0, 1, 2, 3), 0),  # test_shards_partition_global_batch
    (2, 9, (0, 1), 0),        # test_elastic_reshard_same_global_stream
    (1, 5, (0,), 4),          # a vision stub's prefix
])
def test_batches_bit_equal(dp_shards, step, ranks, n_prefix):
    kw = dict(vocab=256, seq_len=32, global_batch=8, dp_shards=dp_shards,
              n_prefix=n_prefix, d_model=16 if n_prefix else 0)
    jc, tc = jpipe.DataConfig(**kw), tpipe.DataConfig(**kw)
    np.testing.assert_array_equal(tpipe.doc_ids_for_step(tc, step),
                                  jpipe.doc_ids_for_step(jc, step))
    for r in ranks:
        want = jpipe.global_batch_for_step(jc, step, r)
        got = tpipe.global_batch_for_step(tc, step, r)
        for field in ("tokens", "labels", "prefix_embeds"):
            a, b = getattr(got, field), getattr(want, field)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# -- membership -------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_rendezvous_assignments_bit_equal():
    """The hypothesis test's ranges swept: every assignment, and after one
    worker leaves, equal; no live worker raises in both."""
    for n_workers in range(2, 17, 3):
        for n_shards in (8, 31, 64):
            for workers in (list(range(n_workers)),
                            list(range(n_workers - 1))):
                assert tft.rendezvous_assign(range(n_shards), workers) == \
                    jft.rendezvous_assign(range(n_shards), workers)
    for mod in (tft, jft):
        with pytest.raises(ValueError):
            mod.rendezvous_assign(range(4), [])


def test_heartbeat_and_elastic_plan_decisions_equal():
    """test_ft.py's heartbeat and elastic-plan sequences on both."""
    out = []
    for mod in (tft, jft):
        clk = FakeClock()
        mon = mod.HeartbeatMonitor(range(4), timeout_s=10, clock=clk)
        seen = []
        clk.t = 5
        for w in (0, 1, 2):
            mon.beat(w)
        clk.t = 12
        seen += [mon.check(), mon.live]
        mon.beat(3)
        clk.t = 30
        seen += [mon.live]
        mon.rejoin(3)
        seen += [mon.live, mon.check()]
        plan = mod.ElasticPlan.make(mon, n_shards=16, resume_step=42)
        seen += [plan.survivors, plan.assignment, plan.resume_step]
        out.append(seen)
    assert out[0] == out[1]
    assert out[0][0] == {3} and out[0][2] == [0, 1, 2]


def test_straggler_decisions_equal():
    durations = [1.0] * 8 + [4.0] * 8 + [0.5, 9.0, 2.0]
    probes = (0.5, 1.5, 2.5, 6.0, 8.5, 20.0)
    got = []
    for mod in (tft, jft):
        pol = mod.StragglerPolicy(beta=2.0, window=8)
        seq = []
        for d in durations:
            pol.observe(d)
            seq.append((pol.median, [pol.should_backup(p) for p in probes]))
        got.append(seq)
    assert got[0] == got[1]


# -- optimizer --------------------------------------------------------------

def _trees(seed):
    """A small params tree in both layouts (JAX: stacked; port: a list of
    layers) and a gradient tree."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    jp = {"embed": mk(6, 4), "layers": {"w": mk(2, 4, 3), "b": mk(2, 3)},
          "norm": {"scale": mk(4)}}
    jg = {"embed": mk(6, 4), "layers": {"w": mk(2, 4, 3), "b": mk(2, 3)},
          "norm": {"scale": mk(4)}}

    def port(t):
        top = {k: torch.from_numpy(v.copy()) for k, v in t.items()
               if not isinstance(v, dict)}
        top["norm"] = {"scale": torch.from_numpy(t["norm"]["scale"].copy())}
        top["layers"] = [{k: torch.from_numpy(v[i].copy())
                          for k, v in t["layers"].items()} for i in range(2)]
        return top

    return jp, jg, port(jp), port(jg)


def _stacked(tree) -> list:
    """The port tree's JAX leaves as numpy (stacked layers)."""
    return [np.stack([t.detach().numpy() for t in g]) if len(g) > 1
            else g[0].detach().numpy() for g in jax_leaves(tree)]


def test_schedule_matches_jax():
    cfg_j = jopt.AdamWConfig(lr=1e-3, warmup_steps=7, total_steps=50)
    cfg_t = topt.AdamWConfig(lr=1e-3, warmup_steps=7, total_steps=50)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jopt.schedule(cfg_j, jnp.asarray(steps)))
    got = topt.schedule(cfg_t, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, **OPT)


def test_clip_by_global_norm_matches_jax():
    jp, jg, tp, tg = _trees(1)
    for max_norm in (0.5, 100.0):  # clipped, and left alone
        want, wnorm = jopt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, jg), max_norm)
        grads = [t.clone() for t in tree_leaves(tg)]
        got, norm = topt.clip_by_global_norm(grads, max_norm)
        np.testing.assert_allclose(float(norm), float(wnorm), **OPT)
        got_tree = tree_unflatten(tg, got)
        for a, b in zip(_stacked(got_tree),
                        jax.tree.leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(a, b, **OPT)


@pytest.mark.parametrize("skip", [False, True])
def test_apply_matches_jax(skip):
    """Three AdamW steps on both from the same params, gradients and zero
    moments; with ``skip`` the params and moments stay and the step still
    advances."""
    jp, jg, tp, tg = _trees(2)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jopt.init(jparams)
    tstate = topt.init(tp)
    params = tree_leaves(tp)
    for _ in range(3):
        jparams, jstate, jlr = jopt.apply(
            jopt.AdamWConfig(**cfg), jstate, jparams,
            jax.tree.map(jnp.asarray, jg), skip=jnp.asarray(skip))
        tstate, tlr = topt.apply(topt.AdamWConfig(**cfg), tstate, params,
                                 tree_leaves(tg), skip=torch.tensor(skip))
        np.testing.assert_allclose(float(tlr), float(jlr), **OPT)
    assert int(tstate.step) == int(jstate.step) == 3
    for got, want in ((tp, jparams), (tstate.m, jstate.m),
                      (tstate.v, jstate.v)):
        for a, b in zip(_stacked(got),
                        jax.tree.leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(a, b, **OPT)
    if skip:
        np.testing.assert_array_equal(_stacked(tp)[0], jp["embed"])


def test_grad_digest_and_ledger_chain_bit_equal():
    """Integer gradients (exact f32 sums in any order) of the qwen2-7b
    smoke config's tree: each step's digest and the chained ledger head
    equal JAX's, word for word."""
    jm = JLM(jcfg.get_smoke("qwen2-7b"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    head_j = jnp.zeros((2,), jnp.uint32)
    head_t = torch.zeros(2, dtype=torch.int32)
    for step in range(3):
        ints = jax.tree.map(lambda s: rng.integers(-8, 9, s.shape).astype(
            np.float32), shapes)
        tree = convert.lm_params(ints, tcfg.get_smoke("qwen2-7b"),
                                 "cpu").params.tree()
        dj = jts.grad_digest(jax.tree.map(jnp.asarray, ints))
        dt = tts.grad_digest(tree)
        np.testing.assert_array_equal(u32.to_numpy(dt), np.asarray(dj))
        head_j = jledger.append_hash(head_j, jnp.uint32(step), dj)
        head_t = tledger.append_hash(head_t, torch.tensor(step,
                                                          dtype=torch.int32),
                                     dt)
        np.testing.assert_array_equal(u32.to_numpy(head_t),
                                      np.asarray(head_j))


# -- checkpointer -----------------------------------------------------------

def _port_state(dtype="float32", seed=0):
    cfg = dataclasses.replace(tcfg.get_smoke("qwen2-7b"), dtype=dtype)
    model = LM(cfg, device="cpu")
    state = tts.init_state(model, torch.Generator().manual_seed(seed))
    # Moments, step and head away from their zeros, so a round trip
    # shows them.
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for t in tree_leaves(state.opt.m) + tree_leaves(state.opt.v):
            t.copy_(torch.rand(t.shape, generator=g))
    state = state._replace(
        opt=state.opt._replace(step=torch.tensor(5, dtype=torch.int32)),
        ledger_head=u32.from_numpy(np.array([0x89ABCDEF, 7], np.uint32),
                                   "cpu"))
    return model, state


def _leaves(state):
    return [t.detach().clone() for g in tts.state_leaves(state) for t in g]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_bit_exact(tmp_path, dtype):
    _, state = _port_state(dtype)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(5, state, blocking=True)
    man = json.loads((tmp_path / "ck" / "step_00000005" /
                      "manifest.json").read_text())
    assert man["dtypes"][0] == dtype and man["dtypes"][-1] == "uint32"
    _, fresh = _port_state(dtype, seed=9)
    got, step = ck.restore(fresh)
    assert step == 5 and ck.verify_chain()
    for a, b in zip(_leaves(got), _leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ck.close()


def test_checkpoint_corruption_and_chain(tmp_path):
    """A corrupted arrays file is refused; keep-N drops the oldest; a
    manifest whose chain was edited breaks verify_chain."""
    _, state = _port_state()
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    for s in (1, 2, 3):
        ck.save(s, state, blocking=True)
    assert ck.list_steps() == [2, 3] and ck.verify_chain()
    path = tmp_path / "ck" / "step_00000003" / "arrays.npz"
    data = path.read_bytes()
    path.write_bytes(data[:-100] + bytes(100))
    with pytest.raises(Exception):
        ck.restore(_port_state()[1])
    man_path = tmp_path / "ck" / "step_00000003" / "manifest.json"
    man = json.loads(man_path.read_text())
    man["prev_chain"] ^= 1
    man_path.write_text(json.dumps(man))
    assert not ck.verify_chain()
    ck.close()


def _jax_state(seed=0):
    jm = JLM(jcfg.get_smoke("qwen2-7b"))
    st = jts.init_state(jm, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    bump = lambda t: jax.tree.map(lambda a: a + jnp.asarray(
        rng.random(a.shape).astype(np.float32)), t)
    return st._replace(opt=st.opt._replace(m=bump(st.opt.m),
                                           v=bump(st.opt.v),
                                           step=jnp.int32(4)),
                       ledger_head=jnp.asarray([3, 0xFFFFFFF0], jnp.uint32))


def test_port_restores_jax_checkpoint(tmp_path):
    jstate = _jax_state(1)
    ck = JCheckpointer(str(tmp_path / "ck"))
    ck.save(4, jstate, blocking=True)
    ck.close()
    _, like = _port_state(seed=3)
    tck = Checkpointer(str(tmp_path / "ck"))
    got, step = tck.restore(like)
    assert step == 4 and tck.verify_chain()
    tck.close()
    want = convert.export_train_state(got, jax.tree.map(np.asarray,
                                                        jstate.params))
    np_j = jax.tree.map(np.asarray, jstate)
    for a, b in zip(jax.tree.leaves((want.params, want.step, want.m, want.v,
                                     want.ledger_head)),
                    jax.tree.leaves(np_j)):
        np.testing.assert_array_equal(a, b)


def test_jax_restores_port_checkpoint(tmp_path):
    _, state = _port_state(seed=4)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(5, state, blocking=True)
    ck.close()
    like = _jax_state(2)
    jck = JCheckpointer(str(tmp_path / "ck"))
    got, step = jck.restore(like)
    assert step == 5 and jck.verify_chain()
    jck.close()
    want = convert.export_train_state(state, jax.tree.map(np.asarray,
                                                          like.params))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                    jax.tree.leaves((want.params, want.step, want.m, want.v,
                                     want.ledger_head))):
        np.testing.assert_array_equal(a, b)
