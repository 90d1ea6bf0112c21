"""Each CUDA kernel of the port against its plain PyTorch version, on a card:
bit-equal for the integer kernels; flash attention within f32 ``atol=rtol=
2e-5`` (TF32 off) and bf16 ``3e-2``, the JAX kernel tests' tolerances. Also
one smoke-config LM prefill on the card against the CPU. Imports no JAX, so
it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Without a card every test here skips."""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.core import types, u32
from repro_torch.core import world_state as ws
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
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
def test_lookup_kernel(cuda):
    """Inserts that fill some buckets, then hits, misses and empty keys."""
    tb = types.make_transfer_batch(types.TEST_DIMS, 600, seed=2,
                                   n_accounts=1 << 12, conflict_rate=0.2,
                                   device=cuda)
    st = ws.create(64, 8, 4, cuda)
    ws.commit_vectorized(st, tb.write_keys, tb.write_vals,
                         torch.ones(600, dtype=torch.bool, device=cuda))
    rng = np.random.default_rng(3)
    qs = torch.cat([tb.read_keys.reshape(-1, 2), u32.from_numpy(
        rng.integers(0, 1 << 32, (300, 2), dtype=np.uint32), cuda)])
    qs[:5, 0] = 0
    _same(ht_ops.lookup(*st, qs),
          ht_ref.lookup_ref(*(t.cpu() for t in st), qs.cpu()))


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
def test_mvcc_kernel_refuses_blocks_over_1024(cuda):
    keys = torch.zeros((1025, 2, 2), dtype=torch.int32, device=cuda)
    vers = torch.zeros((1025, 2), dtype=torch.int32, device=cuda)
    ok0 = torch.ones(1025, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="at most 1024"):
        mv_ops.validate(keys, vers, keys, vers, ok0)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,s,k", [(1 << 12, 8, 200), (4, 2, 64),
                                    (64, 8, 2048)])
def test_commit_kernel(cuda, nb, s, k):
    """Updates, inserts, full buckets (overflow), duplicate keys, inactive
    and empty-key writes: the kernel on the card against the plain version
    on a copy of the same table, bit-equal, overflow flag included."""
    rng = np.random.default_rng(k)
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
    wk[rng.random(k) < 0.05, 0] = 0
    wv = rng.integers(0, 1 << 32, (k, 4), dtype=np.uint32)
    act = rng.random(k) < 0.85
    args = [u32.from_numpy(a) for a in (wk, wv)] + [torch.from_numpy(act)]
    on_card = [t.to(cuda) for t in table]
    ovf = ht_ops.commit(*on_card, *(a.to(cuda) for a in args))
    want = ht_ref.commit_ref(*table, *args)
    _same(on_card + [ovf], table + [want])


@pytest.fixture
def no_tf32(monkeypatch):
    """Full-f32 matrix products in the plain versions, stated, not assumed."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,skv,h,kv,d,dtype,causal", [
    (1, 2048, 2048, 28, 4, 128, torch.bfloat16, True),  # Qwen2-7B prefill
    (1, 777, 777, 28, 4, 128, torch.bfloat16, True),    # ragged tail
    (2, 300, 300, 32, 32, 96, torch.float32, True),     # MHA at D = 96
    (2, 64, 64, 4, 1, 16, torch.float32, True),         # MQA
    (2, 100, 100, 4, 2, 16, torch.bfloat16, True),
    (1, 130, 130, 8, 8, 64, torch.bfloat16, False),
    (1, 70, 70, 6, 2, 32, torch.float32, False),
    (1, 45, 170, 4, 2, 64, torch.bfloat16, True),       # Skv != S
])
def test_flash_attention_kernel(cuda, no_tf32, b, s, skv, h, kv, d, dtype,
                                causal):
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n_s, n, d)).astype(
        np.float32)).to(cuda, dtype)
        for n_s, n in ((s, h), (skv, kv), (skv, kv)))
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


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
