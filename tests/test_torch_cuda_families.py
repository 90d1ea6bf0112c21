"""The moe and ssm families on a card against the CPU (f32, TF32 off):
``moe_mlp`` at the smoke configs (both dispatches, two groups) and at
Qwen1.5-MoE's full width (2,048 tokens x 60 experts, top-4, at capacity
factor 2.0, and a 4-slot decode at one slot an expert), ``ssd_chunked``
and a full-width Mamba2 block, the LM's prefill and decode at the smoke
configs, a bf16 MoE prefill repeated bit for bit, K5 launched once a layer
in a MoE prefill and no kernel on the SSM path. Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_families.py

Outputs within atol = rtol = 1e-4 (LOGITS_TOL of ``chip_smoke.py``): both
sides sum the same f32 products in other orders, ~1e-6 apart. Routes must
be identical: at these seeds no token's k-th and (k+1)-th probabilities
lie within the two sides' ~1e-7 of each other. Without a card every test
here skips."""

import dataclasses

import pytest
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.hash_table import ops as ht_ops
from repro_torch.kernels.mvcc_validate import ops as mv_ops
from repro_torch.kernels.sig_mac import ops as mac_ops
from repro_torch.models import moe, ssm
from repro_torch.models.lm import LM, Batch

TOL = dict(atol=1e-4, rtol=1e-4)


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


def _moe_params(cfg, seed):
    return moe.init_moe(cfg, "cpu", torch.Generator().manual_seed(seed))


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _card_vs_cpu(cuda, p, cfg, x, **kw):
    stats = {}
    want, aux = moe.moe_mlp(p, cfg, x, **kw)
    got, gaux = moe.moe_mlp(_to(p, cuda), cfg, x.to(cuda), stats=stats, **kw)
    xr = x.reshape(-1, x.shape[-1])
    assert torch.equal(moe.route(p["router"], xr, cfg.top_k)[1],
                       moe.route(p["router"].to(cuda), xr.to(cuda),
                                 cfg.top_k)[1].cpu())
    torch.testing.assert_close(got.cpu(), want, **TOL)
    torch.testing.assert_close(gaux.cpu(), aux, **TOL)
    return stats


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("kw", [dict(dispatch="sort"), dict(dispatch="cumsum"),
                                dict(groups=2)], ids=str)
def test_moe_mlp_smoke_card_matches_cpu(cuda, no_tf32, arch, kw):
    cfg = cfg_base.get_smoke(arch)
    p = _moe_params(cfg, 0)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    for cf in (1e-9, 1.0, float(cfg.n_experts)):
        _card_vs_cpu(cuda, p, cfg, x, capacity_factor=cf, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("tokens,want_cap", [(2048, 273), (4, 1)])
def test_moe_mlp_full_width_card_matches_cpu(cuda, no_tf32, tokens,
                                             want_cap):
    """Qwen1.5-MoE's layer in f32: a 2,048-token prefill at cf 2.0 (273
    slots an expert) and a 4-slot decode step (one slot an expert, most
    assignments dropped)."""
    cfg = dataclasses.replace(cfg_base.get("qwen2-moe-a2.7b"),
                              dtype="float32")
    assert moe.capacity(2.0, tokens, cfg.top_k, cfg.n_experts) == want_cap
    p = _moe_params(cfg, 2)
    x = torch.randn((1, tokens, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    stats = _card_vs_cpu(cuda, p, cfg, x, capacity_factor=2.0)
    if tokens == 4:
        assert int(stats["dropped"]) > 0


@pytest.mark.gpu
def test_ssd_chunked_card_matches_cpu(cuda, no_tf32):
    """Mamba2-2.7B's heads (80 of 64, state 128), 2 x 512 tokens, chunks
    of 256: y and the final state, and the chunked state against the
    sequential reference on the card (1e-4 of the largest magnitude)."""
    g = torch.Generator().manual_seed(4)
    b, s, h, p, n = 2, 512, 80, 64, 128
    args = (torch.randn((b, s, h, p), generator=g),
            torch.rand((b, s, h), generator=g) * 0.1 + 1e-3,
            -torch.arange(1, h + 1).float(),
            torch.randn((b, s, n), generator=g),
            torch.randn((b, s, n), generator=g))
    want = ssm.ssd_chunked(*args, chunk=256)
    got = ssm.ssd_chunked(*(a.to(cuda) for a in args), chunk=256)
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt.cpu(), wt, **TOL)
    seq = ssm.ssd_sequential_reference(*(a.to(cuda) for a in args))
    for gt, st in zip(got, seq):
        assert (gt - st).abs().max() <= 1e-4 * st.abs().max()


@pytest.mark.gpu
def test_mamba_block_full_width_card_matches_cpu(cuda, no_tf32):
    """One Mamba2-2.7B block in f32: a 2 x 256-token forward with its conv
    tails and states, then two decode steps from them."""
    cfg = dataclasses.replace(cfg_base.get("mamba2-2.7b"), dtype="float32")
    p = ssm.init_mamba(cfg, "cpu", torch.Generator().manual_seed(5))
    pc = _to(p, cuda)
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 256, cfg.d_model), generator=g)
    want = ssm.mamba_forward(p, cfg, x, return_state=True)
    got = ssm.mamba_forward(pc, cfg, x.to(cuda), return_state=True)
    for _ in range(2):
        for gt, wt in zip(got, want):
            torch.testing.assert_close(gt.cpu(), wt, **TOL)
        x = torch.randn((2, 1, cfg.d_model), generator=g)
        want = ssm.mamba_decode_step(p, cfg, x, *want[1:])
        got = ssm.mamba_decode_step(pc, cfg, x.to(cuda), *got[1:])


def _counts():
    return (mac_ops.launches, ht_ops.launches, ht_ops.commit_launches,
            mv_ops.launches, fa_ops.launches, fa_ops.launches_bwd)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b"])
def test_lm_prefill_decode_card_matches_cpu(cuda, no_tf32, arch):
    """The smoke LM (capacity factor 1.0: drops) prefilled with 2 x 32
    tokens and decoded 4 greedy steps: logits, tokens and caches. K5 runs
    once a moe layer in the prefill; the SSM path launches no kernel."""
    cfg = cfg_base.get_smoke(arch)
    cpu = LM(cfg, moe_capacity_factor=1.0, ssd_chunk=16, device="cpu").init(
        torch.Generator().manual_seed(7))
    card = LM(cfg, moe_capacity_factor=1.0, ssd_chunk=16, device="cpu").init(
        torch.Generator().manual_seed(7)).to(cuda)
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(8))
    before = _counts()
    out = []
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        logits, cache = m.prefill(Batch(tokens=toks.to(dev)),
                                  m.init_cache(2, 40))
        run = [logits.cpu()]
        for i in range(4):
            logits, cache = m.decode_step(
                cache, torch.argmax(logits, dim=-1), 32 + i)
            run.append(logits.cpu())
        out.append((run, [c.cpu() for c in dataclasses.astuple(cache)
                          if c is not None]))
    after = _counts()
    for gl, wl in zip(out[1][0], out[0][0]):
        torch.testing.assert_close(gl, wl, **TOL)
        assert torch.equal(gl.argmax(-1), wl.argmax(-1))
    for gc, wc in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(gc, wc, **TOL)
    k5 = after[4] - before[4]
    if cfg.family == "moe":
        assert k5 == cfg.n_layers
    else:
        assert after == before


@pytest.mark.gpu
def test_moe_prefill_repeats_bit_for_bit(cuda):
    """Qwen1.5-MoE at full width cut to 2 layers, bf16: a 512-token
    prefill twice gives identical logits and caches (no atomics in the
    dispatch or the combine)."""
    cfg = dataclasses.replace(cfg_base.get("qwen2-moe-a2.7b"), n_layers=2)
    model = LM(cfg, moe_capacity_factor=2.0, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(9))
    toks = torch.randint(0, cfg.vocab, (1, 512), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    runs = [model.prefill(Batch(tokens=toks), model.init_cache(1, 512))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1].k, runs[1][1].k)
    assert torch.equal(runs[0][1].v, runs[1][1].v)
