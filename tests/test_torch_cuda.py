"""Each integer CUDA kernel of the port (K1-K4) against its plain PyTorch
version on a card, bit-equal; and one smoke-config LM prefill on the card
against the CPU. Flash attention's (K5) cases are in
``test_torch_cuda_flash.py``. Imports no JAX, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py \
        tests/test_torch_cuda_flash.py

Without a card every test here skips."""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.core import types, u32
from repro_torch.core import world_state as ws
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.hash_table import ops as ht_ops, ref as ht_ref
from repro_torch.kernels.mvcc_validate import ops as mv_ops, ref as mv_ref
from repro_torch.kernels.sig_mac import ops as mac_ops, ref as mac_ref
from repro_torch.models.lm import LM, Batch

P31 = (1 << 31) - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,ne", [(100, 22, 3), (1000, 3, 1), (7, 1, 4)])
def test_mac_kernel(cuda, b, w, ne):
    rng = np.random.default_rng(b)
    msg = rng.integers(0, 1 << 32, (b, w), dtype=np.uint32)
    msg[0], msg[-1] = 0, 0xFFFFFFFF
    rs = rng.integers(0, P31, ne, dtype=np.uint32)
    ss = rng.integers(0, P31, ne, dtype=np.uint32)
    rs[0], ss[-1] = P31 - 1, 0
    args = [u32.from_numpy(a, cuda) for a in (msg, rs, ss)]
    _same([mac_ops.mac_many(*args)],
          [mac_ref.mac_many_ref(*(a.cpu() for a in args))])


@pytest.mark.gpu
@pytest.mark.parametrize("s", [8, 2, 16, 32, 3, 40])
def test_lookup_kernel(cuda, s):
    """Inserts that fill some buckets, then hits, misses and empty keys;
    a hot bucket filled to its last slot; a key stored twice in a row. S
    = 8 (the paths'), other group widths (2, 16, 32, and 3 in a group of
    4) and S = 40 (a row walked in two segments); VW = 4 (16-byte loads)
    and, at S = 3, VW = 3."""
    vw = 3 if s == 3 else 4
    tb = types.make_transfer_batch(types.TEST_DIMS, 600, seed=2,
                                   n_accounts=1 << 12, conflict_rate=0.2,
                                   device=cuda)
    st = ws.create(64, s, vw, cuda)
    ws.commit_vectorized(st, tb.write_keys,
                         tb.write_vals[..., :vw].contiguous(),
                         torch.ones(600, dtype=torch.bool, device=cuda))
    rng = np.random.default_rng(3)
    hot = u32.from_numpy(rng.integers(1, 1 << 32, (s, 2), dtype=np.uint32),
                         cuda)
    hot[:, 0] = (hot[:, 0] & ~63) | 5  # bucket 5
    st.keys[5] = hot
    st.keys[7, -1] = st.keys[7, 0]  # stored twice: the first slot wins
    qs = torch.cat([tb.read_keys.reshape(-1, 2), hot, st.keys[7, :1],
                    u32.from_numpy(rng.integers(0, 1 << 32, (300, 2),
                                                dtype=np.uint32), cuda)])
    qs[:5, 0] = 0
    got = ht_ops.lookup(*st, qs)
    _same(got, ht_ref.lookup_ref(*(t.cpu() for t in st), qs.cpu()))
    assert bool(got[0][1200:1200 + s].all())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 100, 1024])
def test_mvcc_kernel(cuda, b):
    rng = np.random.default_rng(b)
    tb = types.make_transfer_batch(types.TEST_DIMS, b, seed=b, n_accounts=64,
                                   conflict_rate=0.5, device=cuda)
    rv = u32.from_numpy(rng.integers(0, 3, (b, 2)).astype(np.uint32), cuda)
    cur = torch.where(torch.from_numpy(rng.random((b, 2)) < 0.9).to(cuda),
                      rv, u32.add(rv, 1))
    ok0 = torch.from_numpy(rng.random(b) < 0.95).to(cuda)
    args = [t.contiguous() for t in (tb.read_keys, rv, tb.write_keys, cur)]
    args.append(ok0)
    _same([mv_ops.validate(*args)],
          [mv_ref.validate_ref(*(a.cpu() for a in args))])


@pytest.mark.gpu
def test_mvcc_kernel_takes_blocks_over_1024(cuda):
    """33 chunks on both routes (B = 1025; the one CTA forced, the tiled
    route by size) and 64 on the tiled route (B = 2048), conflict-heavy,
    against the plain version."""
    for b, route in ((1025, "cta"), (1025, "tiled"), (2048, "tiled")):
        rng = np.random.default_rng(b)
        tb = types.make_transfer_batch(types.TEST_DIMS, b, seed=b,
                                       n_accounts=256, conflict_rate=0.5,
                                       device=cuda)
        ok0 = torch.from_numpy(rng.random(b) < 0.95).to(cuda)
        args = [t.contiguous() for t in (tb.read_keys, tb.read_vers,
                                         tb.write_keys, tb.read_vers)]
        args.append(ok0)
        assert mv_ops.route_for(b, 2, 2, cuda) == "tiled"
        got = mv_ops.validate(*args, route=route)
        want = mv_ref.validate_ref(*(a.cpu() for a in args))
        _same([got], [want])
        assert 0 < int(want.sum()) < b


def _commit_case(nb, s, k, seed, *, hot=0):
    """A half-filled table and K writes: updates, inserts, duplicates,
    inactive and empty-key writes; ``hot`` > 0 sends every write to one
    bucket, drawn from that many keys."""
    rng = np.random.default_rng(seed)
    table = [torch.zeros(shape, dtype=torch.int32)
             for shape in ((nb, s, 2), (nb, s), (nb, s, 4))]
    fill = u32.from_numpy(rng.integers(1, 1 << 32, (nb * s // 2, 2),
                                       dtype=np.uint32))
    ht_ref.commit_ref(*table, fill, torch.ones((len(fill), 4),
                                               dtype=torch.int32),
                      torch.ones(len(fill), dtype=torch.bool))
    wk = rng.integers(1, 1 << 32, (k, 2), dtype=np.uint32)
    wk[: k // 4] = u32.to_numpy(fill)[rng.integers(0, len(fill), k // 4)]
    wk[k // 4: k // 2] = wk[rng.integers(0, k // 4, k // 4)]  # duplicates
    if hot:
        pool = rng.integers(1, 1 << 32, (hot, 2), dtype=np.uint32)
        pool[:, 0] = (pool[:, 0] & ~np.uint32(nb - 1)) | np.uint32(nb // 2)
        wk = pool[rng.integers(0, hot, k)]
    wk[rng.random(k) < 0.05, 0] = 0
    wv = rng.integers(0, 1 << 32, (k, 4), dtype=np.uint32)
    act = rng.random(k) < 0.85
    return table, [u32.from_numpy(a) for a in (wk, wv)] + [
        torch.from_numpy(act)]


@pytest.mark.gpu
@pytest.mark.parametrize("nb,s,k,hot", [
    (1 << 12, 8, 200, 0), (4, 2, 64, 0), (64, 8, 2048, 0), (1, 8, 64, 6),
    (64, 8, 3000, 5), (1 << 16, 8, 40000, 0), (256, 16, 500, 0),
    (64, 32, 900, 0), (8, 40, 300, 0)])
def test_commit_kernel(cuda, nb, s, k, hot):
    """Updates, inserts, full buckets (overflow), duplicate keys, inactive
    and empty-key writes: the kernel on the card against the plain version
    on a copy of the same table, bit-equal, overflow flag included. The
    hot bucket (64 writes of 6 keys; 3,000 writes of 5 keys, more than a
    CTA stages at once), K past the 1,024-part limit (40,000), other group
    widths (S = 2, 16, 32) and S = 40 (a row walked in memory)."""
    table, args = _commit_case(nb, s, k, k + s, hot=hot)
    on_card = [t.to(cuda) for t in table]
    before = ht_ops.commit_launches
    ovf = ht_ops.commit(*on_card, *(a.to(cuda) for a in args))
    assert ht_ops.commit_launches == before + 1
    want = ht_ref.commit_ref(*table, *args)
    _same(on_card + [ovf], table + [want])


@pytest.fixture
def no_tf32(monkeypatch):
    """Full-f32 matrix products in the plain versions, stated, not assumed."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.gpu
def test_lm_prefill_on_card_matches_cpu(cuda, no_tf32):
    """qwen2-7b smoke (f32): the card's prefill, K5 in every layer, against
    the CPU's plain one, same weights."""
    cfg = cfg_base.get_smoke("qwen2-7b")
    on_cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(on_cpu).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 37)))
    want, wcache = on_cpu.prefill(Batch(tokens=toks), on_cpu.init_cache(2, 40))
    before = fa_ops.launches
    got, gcache = on_card.prefill(Batch(tokens=toks.to(cuda)),
                                  on_card.init_cache(2, 40))
    assert fa_ops.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gcache.k.cpu(), wcache.k, atol=1e-4, rtol=1e-4)
