"""Bucket-sharded world state on a card, at TEST_DIMS: the sharded step
(depth 1 and depth 8) at M = 1, 2 and 4 against the replicated step on the
card and against itself on the CPU, with its K2 launches (one probe a
shard where the replicated step makes one); K2 and K3 on shard views of
1 to 2^18 buckets against their plain versions on the same views, the
rest of the table untouched; the butterfly resize against ``resize`` of
the merged table; an overflow at two buckets a shard; a four-shard
window committer with a resize, card against CPU. Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_sharding.py

Without a card every test here skips."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import endorser, engine, types, u32, unmarshal
from repro_torch.core import world_state as ws
from repro_torch.kernels.hash_table import ops as ht_ops
from repro_torch.kernels.hash_table import ref as ht_ref
from repro_torch.launch import fabric_step as fs
from repro_torch.launch import state_sharding as ss
from repro_torch.pipeline import engine_bridge as eb

pytestmark = pytest.mark.gpu
DIMS = types.TEST_DIMS
FIELDS = fs.FabricMeshState._fields


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _window(depth, n, seed, *, n_buckets=1 << 12, slots=8):
    """(D, B, WB) wire and (D, B, 2) ids of D endorsed blocks on the CPU;
    a tiny endorser table makes a same-sized peer table overflow."""
    eng = engine.FabricEngine(engine.EngineConfig(
        dims=DIMS, store_blocks=False, n_buckets=n_buckets, slots=slots),
        device="cpu")
    wires, ids = [], []
    for k in range(depth):
        txb = endorser.execute_and_endorse(
            eng.endorser_state, eng.make_proposals(n, seed=seed + 11 * k),
            DIMS)
        wires.append(unmarshal.marshal(txb, DIMS))
        ids.append(txb.tx_id)
    return torch.stack(wires), torch.stack(ids)


def _run(cfg, depth, m, wire, ids, dev, nb=256, slots=8):
    """The step over a window, as one depth-``depth`` step or depth-1
    steps; -> (state as u32 numpy, valid (D, B))."""
    step = fs.make_fabric_step(
        DIMS, dataclasses.replace(cfg, pipeline_depth=depth), n_shards=m)
    st = fs.create_mesh_state(1, DIMS, nb, slots, device=dev)
    w, i = wire.to(dev), ids.to(dev)
    if depth > 1:
        st, v = step(st, w[None], i[None])
        valid = v[0]
    else:
        vs = []
        for k in range(w.shape[0]):
            st, v = step(st, w[k][None], i[k][None])
            vs.append(v[0])
        valid = torch.stack(vs)
    return [u32.host_copy(a) for a in st], valid.cpu().numpy()


def _same(a, b, what):
    for name, x, y in zip(FIELDS, a[0], b[0]):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")
    np.testing.assert_array_equal(a[1], b[1], err_msg=f"{what} valid")


@pytest.mark.parametrize("m", (1, 2, 4))
def test_sharded_step_card_equals_replicated(cuda, m):
    wire, ids = _window(8, 32, seed=m)
    repl = _run(fs.FASTFABRIC_STEP, 8, 1, wire, ids, cuda)
    for depth, cfg in ((1, fs.FASTFABRIC_SHARDED_STEP),
                       (8, fs.FASTFABRIC_PIPELINED_STEP)):
        before = ht_ops.launches
        got = _run(cfg, depth, m, wire, ids, cuda)
        torch.cuda.synchronize()
        # Depth 1: the read and the vectorized commit's probe, a shard a
        # block; depth 8: the fill and the fused commit's probe, a shard.
        assert ht_ops.launches - before == (16 * m if depth == 1 else 2 * m)
        _same(got, repl, f"depth {depth}, M = {m}, against replicated")
        _same(got, _run(cfg, depth, m, wire, ids, "cpu"),
              f"depth {depth}, M = {m}, card against CPU")
    seq = dataclasses.replace(fs.FASTFABRIC_SHARDED_STEP,
                              sequential_commit=True)
    before = ht_ops.commit_launches
    got = _run(seq, 1, m, wire[:2], ids[:2], cuda)
    torch.cuda.synchronize()
    assert ht_ops.commit_launches - before == 2 * m  # K3 once a shard
    _same(got, _run(seq, 1, m, wire[:2], ids[:2], "cpu"),
          f"sequential, M = {m}, card against CPU")


def _filled_table(nb, s, vw, dev, seed, fill=1 / 3):
    """A table on ``dev`` with a random ``fill`` share of its slots taken,
    each key in its own bucket (word 0 = hi * nb + bucket, hi >= 1)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    hi = torch.randint(1, 1 << 10, (nb, s), generator=g, dtype=torch.int64)
    k0 = (hi * nb + torch.arange(nb)[:, None]).to(torch.int32)
    k1 = torch.randint(0, 1 << 30, (nb, s), generator=g, dtype=torch.int32)
    empty = torch.rand((nb, s), generator=g) >= fill
    keys = torch.where(empty[..., None], 0, torch.stack([k0, k1], -1))
    vers = torch.where(empty, 0, torch.randint(1, 1 << 30, (nb, s),
                                               generator=g,
                                               dtype=torch.int32))
    vals = torch.where(empty[..., None], 0, torch.randint(
        0, 1 << 30, (nb, s, vw), generator=g, dtype=torch.int32))
    return ws.HashState(keys.to(dev), vers.to(dev), vals.to(dev))


@pytest.mark.parametrize("nb_loc", (1, 2, 64, 1 << 12, 1 << 18))
def test_k2_k3_on_shard_views(cuda, nb_loc):
    """K2 and K3 on the views of shard 2 of 4 (a contiguous bucket range of
    a power-of-two count) against their plain versions on copies of the
    same view; the other shards stay as they were."""
    m, s, vw = 4, 8, 4
    table = _filled_table(m * nb_loc, s, vw, cuda, seed=nb_loc)
    view = ss.shard_views(table, m)[2]
    assert all(t.is_contiguous() for t in view)
    g = torch.Generator(device="cpu").manual_seed(1)
    q = view.keys.reshape(-1, 2)[torch.randint(0, nb_loc * s, (500,),
                                               generator=g).to(cuda)]
    q = torch.cat([q, torch.randint(1, 1 << 30, (100, 2), generator=g,
                                    dtype=torch.int32).to(cuda)])
    got = ht_ops.lookup(*view, q.contiguous())
    want = ht_ref.lookup_ref(*view, q)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    wk = q[:300].clone()
    wk[::7] = torch.randint(1, 1 << 30, (43, 2), generator=g,
                            dtype=torch.int32).to(cuda)  # new keys
    wv = torch.randint(0, 1 << 30, (300, vw), generator=g,
                       dtype=torch.int32).to(cuda)
    act = (torch.rand(300, generator=g) < 0.8).to(cuda)
    before = [t.clone() for t in table]
    plain = [t.clone() for t in view]
    ovf_want = ht_ref.commit_ref(*plain, wk, wv, act)
    ovf = ht_ops.commit(*view, wk, wv, act)
    torch.cuda.synchronize()
    assert bool(ovf) == bool(ovf_want)
    for x, y in zip(view, plain):
        assert torch.equal(x, y)
    lo, hi = 2 * nb_loc, 3 * nb_loc
    for x, y in zip(table, before):
        assert torch.equal(x[:lo], y[:lo]) and torch.equal(x[hi:], y[hi:])


def test_butterfly_resize_card_equals_merged_resize(cuda):
    """Grow, shrink, and a shrink of a full table, which drops entries."""
    for m in (1, 2, 4):
        for nb, new_nb, fill in ((256, 512, 1 / 3), (256, 128, 1 / 8),
                                 (64, 32, 1.0)):
            table = _filled_table(nb, 8, 4, cuda, seed=nb + m, fill=fill)
            res = ss.resize_sharded(ss.shard_views(table, m), new_nb // m,
                                    nb, m)
            want = ws.resize(table, new_nb)
            for name, parts, w in zip(ws.HashState._fields,
                                      zip(*res.state), want.state):
                assert torch.equal(torch.cat(parts), w), (m, nb, name)
            assert bool(res.overflow) == bool(want.overflow) == (fill == 1)
            cpu = ss.resize_sharded(
                ss.shard_views(ws.HashState(*(t.cpu() for t in table)), m),
                new_nb // m, nb, m)
            assert torch.equal(res.shard_overflow.cpu(), cpu.shard_overflow)


def test_sharded_overflow_at_two_buckets_a_shard(cuda):
    """An 8 x 2 table in 4 shards: inserts drop mid-window; the window and
    eight depth-1 steps give the same state and bits on the card and the
    CPU, and the bits name more than shard 0."""
    wire, ids = _window(8, 16, seed=7, n_buckets=8, slots=2)
    runs = {}
    for where, dev in (("card", cuda), ("cpu", "cpu")):
        runs[where] = [
            _run(fs.FASTFABRIC_PIPELINED_STEP, 8, 4, wire, ids, dev, 8, 2),
            _run(fs.FASTFABRIC_SHARDED_STEP, 1, 4, wire, ids, dev, 8, 2)]
    for a in runs["card"] + runs["cpu"][1:]:
        _same(a, runs["cpu"][0], "overflow")
    bits = ss.bits_to_int(runs["cpu"][0][0][FIELDS.index("overflow")][0])
    assert bits and bits != 1 and bits >> 4 == 0


def test_sharded_window_committer_card_equals_cpu(cuda):
    """A four-shard committer at depth 4: two windows, a doubling between
    them; states, bits, chain hashes, tree heads and shard stats."""
    wins = [_window(4, 32, seed=50 + w) for w in range(2)]
    out = {}
    for where, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        wc = eb.WindowCommitter(
            DIMS, dataclasses.replace(fs.FASTFABRIC_PIPELINED_STEP,
                                      pipeline_depth=4),
            n_buckets=256, n_shards=4, device=dev)
        res = []
        for w, (wire, ids) in enumerate(wins):
            if w == 1:
                wc.resize(512)
            r = wc.commit_window(wire.to(dev), ids.to(dev))
            res.append((r.valid.cpu().numpy(), r.prev_hash, r.block_hash))
        out[where] = (res, [u32.host_copy(a) for a in wc.state],
                         wc.tree_head(), wc.shard_stats([0])[0][0],
                         wc.hot_shard())
    for x, y in zip(out["card"][0], out["cpu"][0]):
        for a, b in zip(x, y):
            np.testing.assert_array_equal(a, b)
    for name, a, b in zip(FIELDS, out["card"][1], out["cpu"][1]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(out["card"][2:], out["cpu"][2:]):
        np.testing.assert_array_equal(a, b)
    assert out["cpu"][1][0].shape[1] == 512
