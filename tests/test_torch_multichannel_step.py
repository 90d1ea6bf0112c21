"""Several channels through the block pipeline: the port's fabric step at
C = 2 (depths 1 and 2) against the JAX step at C = 2 on a (1, 1) mesh,
every ``FabricMeshState`` field and the validity bits through u32 views;
the port's ``WindowCommitter(n_channels=2)`` at depth 2, channel 1
resized 128 -> 256 after two windows, against two one-channel committers
(the port of the JAX package's ``_multichannel_vs_oracles``), with the
chain hashes against JAX ``_chain_hashes``; the multi-channel window
engine's ``run_rounds`` against the JAX host-path engine; and K4 over NB
blocks (``ref.validate_blocks_ref``, ``ops.validate_blocks`` on the CPU,
``mvcc.validate_blocks``) against the JAX Pallas kernel in interpret mode
and JAX ``mvcc.validate`` a block. The MVCC calls are counted: one a
window position for all the channels of a shape group."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng, mvcc as jm, types as jt
from repro.kernels.mvcc_validate import kernel as jmvk
from repro.launch import fabric_step as jfs
from repro.pipeline import engine_bridge as jeb
from repro_torch.core import engine as teng, mvcc as tm, types as tt, u32
from repro_torch.kernels.mvcc_validate import ops as mv_ops
from repro_torch.kernels.mvcc_validate import ref as mv_ref
from repro_torch.launch import fabric_step as tfs
from repro_torch.pipeline import engine_bridge as teb

from torch_pipeline_inputs import (DIMS, MESH, TDIMS, numpy_state, port_cfg,
                                   window)

FF = jfs.FASTFABRIC_STEP
ALL_TRUE = {"chain_ok": True, "replica_ok": True, "replay_ok": True,
            "recovery_ok": True, "overflow_ok": True}


@pytest.fixture
def k4_calls(monkeypatch):
    """The NB of every ``ops.validate_blocks`` call (the CPU runs its plain
    version; on the card each call is one launch, or two when tiled)."""
    calls = []
    real = mv_ops.validate_blocks

    def counted(read_keys, *args, **kw):
        calls.append(read_keys.shape[0])
        return real(read_keys, *args, **kw)

    monkeypatch.setattr(mv_ops, "validate_blocks", counted)
    return calls


@functools.cache
def _jax_step(depth, nch, nb, b, wb):
    step = jax.jit(jfs.make_fabric_step(
        DIMS, dataclasses.replace(FF, pipeline_depth=depth), MESH))
    shape = (nch, b) if depth == 1 else (nch, depth, b)
    return step.lower(
        jfs.create_mesh_state(nch, DIMS, n_buckets=nb),
        jnp.zeros((*shape, wb), jnp.uint8),
        jnp.zeros((*shape, 2), jnp.uint32)).compile()


@pytest.mark.parametrize("depth", [1, 2])
def test_step_two_channels_matches_jax(depth, k4_calls):
    """Two windows a channel: channel 0 moves fresh accounts, channel 1's
    blocks read what its earlier blocks wrote, and its second window
    replays its first (all stale): the state after each step and the
    validity bits."""
    chans = [[window(2, seed=3 + 13 * k) for k in range(2)],
             [window(2, seed=9, read_your_write=True)] * 2]
    wire = np.stack([np.stack([chans[c][k][0] for c in range(2)])
                     for k in range(2)])  # (window, C, D, B, WB)
    idw = np.stack([np.stack([chans[c][k][1] for c in range(2)])
                    for k in range(2)])
    nch, b, wb = 2, wire.shape[3], wire.shape[4]
    jstep = _jax_step(depth, nch, 256, b, wb)
    tstep = tfs.make_fabric_step(
        TDIMS, dataclasses.replace(port_cfg(FF), pipeline_depth=depth))
    jst = jfs.create_mesh_state(nch, DIMS, n_buckets=256)
    tst = tfs.create_mesh_state(nch, TDIMS, 256, device="cpu")
    n_valid = np.zeros((2, 2), int)  # (window, channel)
    for k in range(wire.shape[0]):
        blocks = ([(wire[k], idw[k])] if depth == 2 else
                  [(wire[k][:, d], idw[k][:, d]) for d in range(2)])
        for w, i in blocks:
            jst, jv = jstep(jst, jnp.asarray(w), jnp.asarray(i))
            tst, tv = tstep(tst, torch.from_numpy(w.copy()),
                            u32.from_numpy(i))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            n_valid[k] += tv.numpy().reshape(nch, -1).sum(axis=1)
            for name, x, y in zip(tfs.FabricMeshState._fields,
                                  numpy_state(tst), numpy_state(jst)):
                assert x.dtype == y.dtype == np.uint32, name
                np.testing.assert_array_equal(x, y, err_msg=name)
    assert n_valid[0, 1] == 2 * b and n_valid[1, 1] == 0  # stale replay
    assert n_valid[:, 0].min() > b
    assert set(k4_calls) == {2} and len(k4_calls) == 4  # one a position


def test_committer_resize_matches_one_channel_committers(k4_calls):
    """Channels 0 and 1 in lockstep, channel 1 doubled after two windows
    (two shape groups from then on), against a one-channel committer a
    channel fed the same windows with the same epoch."""
    depth = 2
    streams = [[window(depth, seed=5 + 31 * w) for w in range(4)],
               [window(depth, seed=77 + 31 * w) for w in range(4)]]
    cfg = tfs.FabricStepConfig(pipeline_depth=depth)
    live = teb.WindowCommitter(TDIMS, cfg, n_buckets=128, n_channels=2,
                               device="cpu")
    res = []
    for w in range(4):
        if w == 2:
            info = live.resize(256, channel=1)
            assert (info.channel, info.old_n_buckets,
                    info.new_n_buckets) == (1, 128, 256)
            assert info.block_no == 2 * depth - 1
            assert [live.n_buckets_for(c) for c in (0, 1)] == [128, 256]
            with pytest.raises(ValueError, match="layouts"):
                live.state
        res.append(live.commit_windows(
            torch.from_numpy(np.stack([s[w][0] for s in streams])),
            u32.from_numpy(np.stack([s[w][1] for s in streams]))))
    assert k4_calls == [2] * 4 + [1] * 8  # one group, then two
    for c, wins in enumerate(streams):
        oracle = teb.WindowCommitter(TDIMS, cfg, n_buckets=128, device="cpu")
        prev = np.zeros(2, np.uint32)
        for w in range(4):
            if c == 1 and w == 2:
                oracle.resize(256)
            o = oracle.commit_window(torch.from_numpy(wins[w][0].copy()),
                                     u32.from_numpy(wins[w][1]))
            for got, want in ((res[w].valid[c], o.valid),
                              (res[w].prev_hash[c], o.prev_hash),
                              (res[w].block_hash[c], o.block_hash)):
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(want))
            # The store-chain links of channel c's window, by JAX.
            bno0 = np.uint32(w * depth)
            jp, jh = jax.device_get(jeb._chain_hashes(
                jnp.asarray(prev), jnp.asarray(bno0),
                jnp.asarray(wins[w][0]), jnp.asarray(o.valid.numpy())))
            np.testing.assert_array_equal(res[w].prev_hash[c], jp)
            np.testing.assert_array_equal(res[w].block_hash[c], jh)
            prev = jh[-1]
        for name, a, b in zip(tfs.FabricMeshState._fields,
                              numpy_state(live.channel_state(c)),
                              numpy_state(oracle.state)):
            np.testing.assert_array_equal(a, b, err_msg=f"ch{c}:{name}")
        np.testing.assert_array_equal(live.tree_head(c), oracle.tree_head())
        np.testing.assert_array_equal(live.journal_head_for(c),
                                      oracle.journal_head)
        np.testing.assert_array_equal(live.ledger_head_for(c),
                                      oracle.ledger_head_for(0))
        np.testing.assert_array_equal(live.state_digest(c),
                                      oracle.state_digest())
        assert live.overflow_bits_for(c) == oracle.overflow_bits == 0
        assert live.block_no_for(c) == 4 * depth
    stats = live.shard_stats((0, 1))
    assert [stats[c][2] for c in (0, 1)] == [128 * 8, 256 * 8]
    with pytest.raises(ValueError, match="commit_windows"):
        live.commit_window(torch.zeros((1, 16, 128), dtype=torch.uint8),
                           torch.zeros((1, 16, 2), dtype=torch.int32))


def _engine_cfg(mod, root):
    return mod.EngineConfig(
        dims=mod.types.TEST_DIMS, n_channels=2, n_buckets=256,
        orderer=dataclasses.replace(mod.FASTFABRIC.orderer, block_size=32),
        journal_dir=str(root / "j"))


def test_window_engine_run_rounds_matches_jax_host_engine(tmp_path,
                                                          k4_calls):
    """Two lockstep rounds of 128 a channel in blocks of 32 through a
    two-channel committer at depth 2 (two windows a round), against the
    JAX engine's host path on the same proposals."""
    wc = teb.WindowCommitter(TDIMS, tfs.FabricStepConfig(pipeline_depth=2),
                             n_buckets=256, n_channels=2, device="cpu")
    te = teng.FabricEngine(_engine_cfg(teng, tmp_path / "port"),
                           device="cpu", window_committer=wc)
    je = jeng.FabricEngine(_engine_cfg(jeng, tmp_path / "jax"))
    for r in range(2):
        props = [(7 * r + c) for c in range(2)]
        tst = te.run_rounds([te.make_proposals(128, seed=s) for s in props])
        jst = je.run_rounds([je.make_proposals(128, seed=s) for s in props])
        assert [s.n_valid for s in tst] == [s.n_valid for s in jst] == \
            [128, 128]
        assert tst[0].wall_s == tst[1].wall_s
    assert k4_calls == [2] * 8  # 4 block positions a round
    for eng in (te, je):
        eng.store.drain()
    for c in range(2):
        tchain, jchain = te.store.chains[c], je.store.chains[c]
        assert [sb.block_no for sb in tchain] == list(range(8))
        for x, y in zip(tchain, jchain):
            for f in ("prev_hash", "block_hash", "valid"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        for k, got, want in (
                ("digest", te._peer_digest(c), je._peer_digest(c)),
                ("journal", te._peer_journal_head(c),
                 je.chans[c].peer_state.journal_head),
                ("log", u32.to_numpy(te.chans[c].log_head),
                 je.chans[c].log_head)):
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f"ch{c} {k}")
    assert te.verify_all() == je.verify_all() == {0: ALL_TRUE, 1: ALL_TRUE}
    assert te.metrics() == {}  # obs off
    te.store.close()
    je.store.close()


def _mvcc_blocks(nblk, b, seed):
    """NB blocks of conflicting transfers with empty keys, stale reads and
    failed checks, as numpy (NB, B, ...)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in range(nblk):
        jb = jt.make_transfer_batch(jt.TEST_DIMS, b, seed=seed + n,
                                    n_accounts=48, conflict_rate=0.5)
        rk, wk = np.array(jb.read_keys), np.array(jb.write_keys)
        rk[rng.random(b) < 0.1, 1] = 0
        wk[rng.random(b) < 0.1, 0] = 0
        rv = rng.integers(0, 3, (b, 2)).astype(np.uint32)
        cur = np.where(rng.random((b, 2)) < 0.85, rv, rv + 1).astype(
            np.uint32)
        out.append((rk, rv, wk, cur, rng.random(b) < 0.9))
    return [np.stack(x) for x in zip(*out)]


def test_validate_blocks_matches_pallas_and_core():
    rk, rv, wk, cur, ok0 = _mvcc_blocks(3, 40, seed=11)
    T = lambda a: u32.from_numpy(a)
    t_ins = (T(rk), T(rv), T(wk), T(cur), torch.from_numpy(ok0))
    got = mv_ref.validate_blocks_ref(*t_ins).numpy()
    pallas = np.asarray(jmvk.validate_blocks(
        *(jnp.asarray(a) for a in (rk, rv, wk, cur, ok0)), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    for n in range(3):
        jb = jt.make_transfer_batch(jt.TEST_DIMS, 40)._replace(
            read_keys=jnp.asarray(rk[n]), read_vers=jnp.asarray(rv[n]),
            write_keys=jnp.asarray(wk[n]))
        core = jm.validate(jb, jnp.asarray(cur[n]),
                           checksum_ok=jnp.asarray(ok0[n]))
        np.testing.assert_array_equal(got[n], np.asarray(core.valid))
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(mv_ops.validate_blocks(*t_ins).numpy(), got)
    tb = tt.make_transfer_batch(tt.TEST_DIMS, 40, device="cpu")
    tb = tt.TxBatch(*(torch.stack([a] * 3) for a in tb))._replace(
        read_keys=T(rk), read_vers=T(rv), write_keys=T(wk))
    np.testing.assert_array_equal(tm.validate_blocks(
        tb, T(cur), checksum_ok=torch.from_numpy(ok0)).valid.numpy(), got)
    np.testing.assert_array_equal(
        mv_ops.validate(*(t[1] for t in t_ins)).numpy(), got[1])
