"""The port's FASTFABRIC engine on the CPU against the JAX engine on the same
proposals: store chain, log head, journal head, both state digests and
``verify()`` bit-equal, over a conflicting round and from carried state.
The JAX side runs once for the module."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import endorser as je, engine as jeng, orderer as jo
from repro.core import types as jt, world_state as jws
from repro_torch import convert
from repro_torch.core import committer as tcm, crypto as tc, endorser as te
from repro_torch.core import engine as teng, ledger as tl, orderer as to
from repro_torch.core import types as tt, u32
from repro_torch.core import world_state as tws
from repro_torch.core import unmarshal as tu

N_TXS = 200
BLOCK = 50


def _cfg(mod):
    return dataclasses.replace(
        mod.FASTFABRIC, n_buckets=256,
        orderer=dataclasses.replace(mod.FASTFABRIC.orderer, block_size=BLOCK))


def _conflicting(n, seed=9):
    """Transfers among 48 accounts: in-block conflicts, stale reads across
    blocks of the round, and src == dst transactions."""
    rng = np.random.default_rng(seed)
    return dict(
        src=rng.integers(0, 48, n, dtype=np.uint32),
        dst=rng.integers(0, 48, n, dtype=np.uint32),
        amount=rng.integers(1, 1000, n, dtype=np.uint32),
        client=rng.integers(0, 64, n, dtype=np.uint32),
        nonce=np.arange(n, dtype=np.uint32) + np.uint32(7 << 16),
    )


def _results_jax(eng):
    eng.store.drain()
    return dict(
        chain=[(sb.block_no, np.array(sb.prev_hash), np.array(sb.block_hash),
                np.array(sb.valid)) for sb in eng.store.chain],
        log_head=np.array(eng.log_head),
        journal_head=np.array(eng.peer_state.journal_head),
        peer=np.array(jws.state_digest(eng.peer_state.hash_state)),
        replica=np.array(jws.state_digest(eng.endorser_state)),
    )


def _results_torch(eng):
    eng.store.drain()
    return dict(
        chain=[(sb.block_no, sb.prev_hash, sb.block_hash, sb.valid)
               for sb in eng.store.chain],
        log_head=u32.to_numpy(eng.log_head),
        journal_head=u32.to_numpy(eng.peer_state.journal_head),
        peer=u32.to_numpy(tws.state_digest(eng.peer_state.hash_state)),
        replica=u32.to_numpy(tws.state_digest(eng.endorser_state)),
    )


def _export_jax(eng) -> convert.EngineState:
    eng.store.drain()
    arrays = lambda h: tuple(np.array(a) for a in h)
    ps = eng.peer_state
    return convert.EngineState(
        peer=arrays(ps.hash_state), endorser=arrays(eng.endorser_state),
        ledger_head=np.array(ps.ledger_head), block_no=int(ps.block_no),
        journal_head=np.array(ps.journal_head),
        log_head=np.array(eng.log_head), next_block_no=eng._next_block_no,
        overflow=bool(eng._overflow),
        chain=tuple((sb.block_no, np.array(sb.prev_hash),
                     np.array(sb.block_hash), np.array(sb.wire),
                     np.array(sb.valid)) for sb in eng.store.chain),
    )


@pytest.fixture(scope="module")
def jax_run():
    """Round 1 (disjoint transfers), then round 2 (conflicting)."""
    eng = jeng.FabricEngine(_cfg(jeng))
    s1 = eng.run_round(eng.make_proposals(N_TXS, seed=0))
    carried = _export_jax(eng)
    prop = je.Proposal(**{k: jnp.asarray(v)
                          for k, v in _conflicting(N_TXS).items()})
    s2 = eng.run_round(prop)
    out = _results_jax(eng)
    out.update(n_valid=(s1.n_valid, s2.n_valid), verify=eng.verify(),
               carried=carried)
    return out


def _round2(eng):
    prop = te.Proposal(**{k: u32.from_numpy(v, eng.device)
                          for k, v in _conflicting(N_TXS).items()})
    return eng.run_round(prop)


def _assert_same(got, want):
    assert len(got["chain"]) == len(want["chain"])
    for g, w in zip(got["chain"], want["chain"]):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    for key in ("log_head", "journal_head", "peer", "replica"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_engine_matches_jax_from_genesis(jax_run):
    eng = teng.FabricEngine(_cfg(teng), device="cpu")
    s1 = eng.run_round(eng.make_proposals(N_TXS, seed=0))
    s2 = _round2(eng)
    assert (s1.n_valid, s2.n_valid) == jax_run["n_valid"]
    assert s1.n_valid == N_TXS and 0 < s2.n_valid < N_TXS
    _assert_same(_results_torch(eng), jax_run)
    assert eng.verify() == jax_run["verify"]
    assert all(jax_run["verify"].values())
    assert s2.wall_s == pytest.approx(s2.order_s + s2.commit_s)
    eng.store.close()


def test_engine_matches_jax_from_carried_state(jax_run):
    eng = teng.FabricEngine(_cfg(teng), device="cpu")
    convert.load_engine(eng, jax_run["carried"])
    s2 = _round2(eng)
    assert s2.n_valid == jax_run["n_valid"][1]
    _assert_same(_results_torch(eng), jax_run)
    assert eng.verify() == jax_run["verify"]
    eng.store.close()


def test_convert_roundtrip(jax_run):
    st = jax_run["carried"]
    eng = teng.FabricEngine(_cfg(teng), device="cpu")
    convert.load_engine(eng, st)
    back = convert.export_engine(eng)
    for a, b in zip(back.peer + back.endorser, st.peer + st.endorser):
        np.testing.assert_array_equal(a, b)
    for key in ("ledger_head", "journal_head", "log_head"):
        np.testing.assert_array_equal(getattr(back, key), getattr(st, key))
    assert (back.block_no, back.next_block_no, back.overflow) == (
        st.block_no, st.next_block_no, st.overflow)
    assert len(back.chain) == len(st.chain) == N_TXS // BLOCK
    eng.store.close()


# -- pieces of the path ----------------------------------------------------------

def test_execute_and_endorse_matches(jax_run):
    """Endorsement against a non-empty replica (versions and balances)."""
    st = jax_run["carried"]
    eng = teng.FabricEngine(dataclasses.replace(_cfg(teng), store_blocks=False),
                            device="cpu")
    prop = eng.make_proposals(40, seed=0)  # accounts of round 1
    prop = {k: u32.to_numpy(v) for k, v in prop._asdict().items()}
    jb = je.execute_and_endorse(
        jws.HashState(*(jnp.asarray(a) for a in st.endorser)),
        je.Proposal(**{k: jnp.asarray(v) for k, v in prop.items()}),
        jt.TEST_DIMS)
    tb = te.execute_and_endorse(
        convert.hash_state(*st.endorser, "cpu"),
        te.Proposal(**{k: u32.from_numpy(v) for k, v in prop.items()}),
        tt.TEST_DIMS)
    for name in jt.TxBatch._fields:
        np.testing.assert_array_equal(u32.to_numpy(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)), name)
    assert u32.to_numpy(tb.read_vers).max() > 0


@pytest.mark.parametrize("separate,pipelined", [(False, False),
                                                (True, False)])
def test_order_batch_matches(separate, pipelined):
    """The orderer's other paths: serial admission and log chain, full-wire
    publication, on a small round with unregistered clients."""
    jb = jt.make_transfer_batch(jt.TEST_DIMS, 20, seed=6)
    tb = tt.make_transfer_batch(tt.TEST_DIMS, 20, seed=6, device="cpu")
    clients = np.arange(20, dtype=np.uint32) * np.uint32(0x1F000001)
    wire = tu.marshal(tb, tt.TEST_DIMS)
    head = np.array([3, 0xFFFFFFFF], np.uint32)
    got = to.order_batch(wire, tb.tx_id, u32.from_numpy(clients),
                         u32.from_numpy(head),
                         to.OrdererConfig(separate, pipelined, 10))
    want = jo.order_batch(jnp.asarray(wire.numpy()), jb.tx_id,
                          jnp.asarray(clients), jnp.asarray(head),
                          jo.OrdererConfig(separate, pipelined, 10))
    for name in jo.OrderedBlocks._fields:
        np.testing.assert_array_equal(u32.to_numpy(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    assert not got.auth_ok.all()


def test_hash_join_reports_misses():
    rng = np.random.default_rng(2)
    store = rng.integers(0, 1 << 32, (64, 2), dtype=np.uint32)
    store[:8, 0] = 0x80000000  # a run of equal high words
    query = np.concatenate([store[::-1],
                            rng.integers(0, 1 << 32, (6, 2), dtype=np.uint32)])
    got = to.hash_join(u32.from_numpy(query), u32.from_numpy(store))
    want = jo.hash_join(jnp.asarray(query), jnp.asarray(store))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    assert int(got.found.sum()) == 64


# -- entry points ------------------------------------------------------------------

def test_entry_points_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.FabricEngine(teng.FASTFABRIC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcm.create_peer_state(tt.TEST_DIMS)


def _replay_default_device():
    store = tl.BlockStore()
    try:
        store.replay_state(tt.TEST_DIMS, 8, 2)
    finally:
        store.close()


@pytest.mark.parametrize("call", [
    lambda: tws.create(8, 2, 4),
    lambda: tws.sorted_create(8, 4),
    _replay_default_device,
    lambda: tt.make_transfer_batch(tt.TEST_DIMS, 4),
    lambda: tc.endorser_keys(3),
], ids=["create", "sorted_create", "replay_state", "make_transfer_batch",
        "endorser_keys"])
def test_device_defaults_need_a_card(monkeypatch, call):
    """Without ``device`` these run on the card, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
