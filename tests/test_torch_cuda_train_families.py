"""Training the moe, ssm, hybrid and encdec families on a card against
their plain PyTorch versions: flash attention's (K5) backward at the
shapes these families train at (D = 64: seamless's encoder and
cross-attention without the mask at Skv != S, its decoder self-attention
and zamba2's shared block causal, Skv below one 128-key tile; D = 128:
Qwen1.5-MoE's 16 MHA heads at 4 x 2,048 tokens; bf16 against the plain
backward on the inputs cast to f32 within ``ref.BWD_BF16_ATOL`` +
``ref.BWD_BF16_RTOL`` |want|, f32 within ``ref.BWD_F32_TOL``, TF32 off),
one smoke train step per family card against CPU (f32), and a smoke run
repeated bit for bit under torch's deterministic algorithms. Imports no
JAX:

    PYTHONPATH=src python -m pytest -q -m gpu \\
        tests/test_torch_cuda_train_families.py

Without a card every test here skips."""

import os

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

# cuBLAS repeats a product bit for bit under torch's deterministic
# algorithms only with its workspace fixed before CUDA starts.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
BF16, F32 = torch.bfloat16, torch.float32
FAMILIES = ["qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-1.2b",
            "seamless-m4t-medium"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_tf32(monkeypatch):
    """Full-f32 matrix products in the plain versions, stated, not assumed."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _bwd_against_plain(cuda, b, s, skv, h, kv, d, causal, dtype):
    """K5's forward (O, LSE) and backward (dQ, dK, dV) at one shape
    against the plain versions on the inputs cast to f32; one launch
    each."""
    rng = np.random.default_rng(s + skv + d)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, n_s, n, d)).astype(
        np.float32)).to(cuda, dtype)
        for n_s, n in ((s, h), (skv, kv), (skv, kv), (s, h)))
    f0, b0 = fa_ops.launches, fa_ops.launches_bwd
    out, lse = fa_ops._forward(q, k, v, causal, with_lse=True)
    got = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.launches_bwd) == (f0 + 1, b0 + 1)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o_ref, lse_ref = fa_ref.flash_attention_lse_ref(qf, kf, vf,
                                                    causal=causal)
    torch.testing.assert_close(lse, lse_ref, atol=fa_ref.LSE_TOL,
                               rtol=fa_ref.LSE_TOL)
    fwd_tol = ((fa_ref.F32_TOL, fa_ref.F32_TOL) if dtype == F32
               else (fa_ref.BF16_ATOL, fa_ref.BF16_RTOL))
    torch.testing.assert_close(out.float(), o_ref, atol=fwd_tol[0],
                               rtol=fwd_tol[1])
    want = fa_ref.flash_attention_bwd_ref(qf, kf, vf, o_ref, dof, lse_ref,
                                          causal)
    atol, rtol = ((fa_ref.BWD_F32_TOL, fa_ref.BWD_F32_TOL) if dtype == F32
                  else (fa_ref.BWD_BF16_ATOL, fa_ref.BWD_BF16_RTOL))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,skv,h,kv,causal,dtype", [
    (4, 512, 512, 16, 16, False, BF16),     # seamless's encoder
    (4, 2048, 512, 16, 16, False, BF16),    # its cross-attention
    (4, 2048, 2048, 16, 16, True, BF16),    # its decoder self-attention
    (4, 2048, 2048, 32, 32, True, BF16),    # zamba2's shared block
    (1, 200, 72, 16, 16, False, BF16),      # Skv below one key tile
    (2, 300, 77, 16, 16, False, F32),       # f32, no mask, Skv != S
])
def test_flash_attention_bwd_d64(cuda, no_tf32, b, s, skv, h, kv, causal,
                                 dtype):
    """dQ, dK, dV at D = 64 from the kernels' own forward (O and LSE)
    against the plain backward on the inputs cast to f32; one launch
    each."""
    _bwd_against_plain(cuda, b, s, skv, h, kv, 64, causal, dtype)


@pytest.mark.gpu
def test_flash_attention_moe_training_shape(cuda, no_tf32):
    """Qwen1.5-MoE's training shape, 16 MHA heads at D = 128, causal, bf16,
    4 x 2,048 tokens (the wgmma backward with a GQA group of 1): O, LSE,
    dQ, dK, dV against the plain versions."""
    _bwd_against_plain(cuda, 4, 2048, 2048, 16, 16, 128, True, BF16)


def _build(arch, device):
    from repro_torch.launch import train
    return train.build(arch, smoke=True, seq=64, batch=4, microbatches=2,
                       lr=1e-3, total_steps=10, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_card_against_cpu(cuda, no_tf32, arch):
    """One train step (2 microbatches of 2 x 64) of each family's smoke
    config (f32) from the same weights and batch on the card and on the
    CPU: loss and grad norm within 1e-4 relative, every moment within 1e-4
    of its leaf's largest magnitude, every parameter within that plus 2 lr
    (AdamW moves a parameter by up to lr whatever its gradient's size), and
    K5's forward and backward launched once an attention layer or site a
    microbatch on the card."""
    from repro_torch.launch import train
    from repro_torch.models.lm import attention_calls, jax_leaves, map_tree

    cfg, model_c, tcfg, dcfg = _build(arch, "cpu")
    state_c = train.ts_lib.init_state(model_c,
                                      torch.Generator().manual_seed(0))
    _, model_g, _, _ = _build(arch, cuda)
    model_g.load_params(map_tree(lambda t: t.detach().to(cuda),
                                 state_c.params))
    state_g = train.ts_lib.init_state(model_g)
    batch = train.pipeline.global_batch_for_step(dcfg, 0)
    f0, b0 = fa_ops.launches, fa_ops.launches_bwd
    state_g, mg = train.ts_lib.make_train_step(model_g, tcfg)(
        state_g, train.device_batch(batch, cuda))
    torch.cuda.synchronize()
    per_step = attention_calls(cfg) * tcfg.microbatches
    assert fa_ops.launches - f0 == per_step
    assert fa_ops.launches_bwd - b0 == per_step
    state_c, mc = train.ts_lib.make_train_step(model_c, tcfg)(
        state_c, train.device_batch(batch, "cpu"))
    assert int(mg["skipped"]) == int(mc["skipped"]) == 0
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(mg[key].cpu(), mc[key], atol=1e-5,
                                   rtol=1e-4)
    lr = float(mc["lr"])
    for tree_g, tree_c, extra in ((state_g.params, state_c.params, 2 * lr),
                                  (state_g.opt.m, state_c.opt.m, 0.0),
                                  (state_g.opt.v, state_c.opt.v, 0.0)):
        for grp_g, grp_c in zip(jax_leaves(tree_g), jax_leaves(tree_c)):
            for a, w in zip(grp_g, grp_c):
                a, w = a.detach().cpu(), w.detach()
                assert a.dtype == w.dtype
                scale = float(w.abs().max()) or 1.0
                assert float((a - w).abs().max()) <= 1e-4 * scale + extra


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_steps_repeat_bit_for_bit(cuda, arch):
    """Three bf16 smoke steps, twice from the same seed, under torch's
    deterministic algorithms (strict, as ``launch.train`` runs them: the
    SSD's f32 cumsum, MoE's scatters and sorts, the embedding's backward):
    params, moments and ledger head equal bit for bit."""
    import dataclasses
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    cfg, built, tcfg, dcfg = _build(arch, cuda)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    batches = [train.device_batch(train.pipeline.global_batch_for_step(
        dcfg, i), cuda) for i in range(3)]
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            model = LM(cfg, vocab_chunk=16, moe_capacity_factor=built.moe_cf,
                       device=cuda)
            state = train.ts_lib.init_state(
                model, torch.Generator(cuda).manual_seed(3))
            step = train.ts_lib.make_train_step(model, tcfg)
            for b in batches:
                state, _ = step(state, b)
            runs.append([t.detach().clone()
                         for g in train.ts_lib.state_leaves(state)
                         for t in g])
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
