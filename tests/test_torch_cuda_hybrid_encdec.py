"""The hybrid (zamba2) and encoder-decoder (seamless) families on a card
against the CPU (f32, TF32 off): the LM's prefill and greedy decode at the
smoke configs (zamba2 at 4 layers, two sites, and at 5, three sites the
last of one layer; seamless at 2 + 2 layers with encoder lengths on and
off a key tile), K5 launched once a site in a hybrid prefill and three
times a layer in an encdec one (encoder, self- and cross-attention) and
nowhere in decode, and K5 at the bf16 D = 64 shapes these families give it
at full width, without the causal mask and with Skv != S among them.
Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_hybrid_encdec.py

Logits within atol = rtol = 1e-4 (LOGITS_TOL of ``chip_smoke.py``): both
sides sum the same f32 products in other orders, ~1e-6 apart; caches
within 1e-5. K5 in bf16 against its plain version in f32 on the same
inputs within ``ref.BF16_ATOL`` + ``ref.BF16_RTOL`` |want|. Without a card
every test here skips."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.hash_table import ops as ht_ops
from repro_torch.kernels.mvcc_validate import ops as mv_ops
from repro_torch.kernels.sig_mac import ops as mac_ops
from repro_torch.models.lm import LM, Batch

TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
ZAMBA, SEAMLESS = "zamba2-1.2b", "seamless-m4t-medium"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_tf32(monkeypatch):
    """Full-f32 matrix products on the card, stated, not assumed."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _model(arch, **changes):
    cfg = dataclasses.replace(cfg_base.get_smoke(arch), **changes)
    return LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))


def _batch(cfg, s, enc_len, seed):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (2, s), generator=g)
    enc = (torch.randn((2, enc_len, cfg.d_model), generator=g)
           if cfg.family == "encdec" else None)
    return Batch(tokens=toks, enc_embeds=enc)


def _run(model, batch, dev, steps=4):
    """Prefill then ``steps`` greedy decode steps on ``dev``: the logits of
    each call and the caches after the last, all on the CPU."""
    moved = Batch(tokens=batch.tokens.to(dev),
                  enc_embeds=None if batch.enc_embeds is None
                  else batch.enc_embeds.to(dev))
    s = batch.tokens.shape[1]
    logits, cache = model.prefill(moved, model.init_cache(2, s + steps))
    out = [logits.cpu()]
    for i in range(steps):
        logits, cache = model.decode_step(cache, torch.argmax(logits, -1),
                                          s + i)
        out.append(logits.cpu())
    fields = ("hyb_k", "hyb_v", "conv", "ssm_state", "k", "v", "cross_k",
              "cross_v")
    return out, {f: getattr(cache, f).cpu() for f in fields
                 if getattr(cache, f) is not None}


@pytest.mark.gpu
@pytest.mark.parametrize("arch,changes,s,enc_len", [
    (ZAMBA, {}, 40, 0),
    (ZAMBA, {"n_layers": 5}, 33, 0),
    (SEAMLESS, {}, 40, 13),     # frames below a 128-key tile
    (SEAMLESS, {}, 33, 130),    # frames past one tile, Skv > S
], ids=["zamba2", "zamba2-5", "seamless-13", "seamless-130"])
def test_card_matches_cpu(cuda, no_tf32, arch, changes, s, enc_len):
    model = _model(arch, **changes)
    batch = _batch(model.cfg, s, enc_len, seed=s)
    want, want_cache = _run(model, batch, "cpu")
    model.to(cuda)
    got, got_cache = _run(model, batch, cuda)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    assert [g.argmax(-1).tolist() for g in got] == [
        w.argmax(-1).tolist() for w in want]
    assert got_cache.keys() == want_cache.keys()
    for name in want_cache:
        torch.testing.assert_close(got_cache[name], want_cache[name],
                                   **CACHE_TOL)


def _counts():
    return {"mac_many": mac_ops.launches, "lookup": ht_ops.launches,
            "commit": ht_ops.commit_launches, "validate": mv_ops.launches,
            "flash_attention": fa_ops.launches,
            "flash_attention_bwd": fa_ops.launches_bwd}


@pytest.mark.gpu
@pytest.mark.parametrize("arch,changes,per_prefill", [
    (ZAMBA, {"n_layers": 5}, 3),   # one a site: groups (0,2), (2,4), (4,5)
    (SEAMLESS, {}, 6),             # 3 a layer: encoder, self, cross
])
def test_k5_launches_per_prefill(cuda, arch, changes, per_prefill):
    """K5 launched once a site in a hybrid prefill and three times a layer
    in an encdec one, no other kernel, and none in the decode steps."""
    model = _model(arch, **changes).to(cuda)
    batch = _batch(model.cfg, 24, 16, seed=1)
    before = _counts()
    _run(model, batch, cuda, steps=2)
    torch.cuda.synchronize()
    after = _counts()
    diff = {k: after[k] - before[k] for k in after}
    assert diff == {**{k: 0 for k in diff}, "flash_attention": per_prefill}


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,skv,h,kv,causal", [
    (4, 2048, 2048, 32, 32, True),   # zamba2's shared block
    (4, 2048, 2048, 16, 16, True),   # seamless's decoder self-attention
    (4, 512, 512, 16, 16, False),    # seamless's encoder
    (4, 2048, 512, 16, 16, False),   # seamless's cross-attention
    (1, 300, 77, 16, 16, False),     # Skv below one key tile
    (2, 16, 512, 16, 16, False),     # Skv far above S
])
def test_k5_at_the_families_shapes(cuda, no_tf32, b, s, skv, h, kv, causal):
    rng = np.random.default_rng(s + skv)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n_s, n, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
        for n_s, n in ((s, h), (skv, kv), (skv, kv)))
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal=causal)
    torch.testing.assert_close(got.float(), want, atol=fa_ref.BF16_ATOL,
                               rtol=fa_ref.BF16_RTOL)
