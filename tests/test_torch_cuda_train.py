"""The training slice on a card against its plain PyTorch versions:
flash attention's (K5) backward kernels and the forward's log-sum-exp
against ``kernels/flash_attention/ref.py`` (f32 within ``ref.BWD_F32_TOL``
and ``ref.LSE_TOL``, TF32 off; bf16 against the plain version on the inputs
cast to f32, within ``ref.BWD_BF16_ATOL`` + ``ref.BWD_BF16_RTOL`` |want|,
the limit ``tools/flash_tolerance.py --backward`` holds against planted
faults), O unchanged when the LSE is asked for, the autograd Function's
launch counts, and one smoke train step card against CPU (f32, TF32 off).
Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_train.py

Without a card every test here skips."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

BF16, F32 = torch.bfloat16, torch.float32


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


def _inputs(cuda, b, s, skv, h, kv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, n_s, n, d)).astype(
        np.float32)).to(cuda, dtype)
        for n_s, n in ((s, h), (skv, kv), (skv, kv), (s, h))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,skv,h,kv,d,dtype,causal", [
    (2, 300, 300, 32, 32, 96, F32, True),     # MHA at D = 96
    (2, 64, 64, 4, 1, 16, F32, True),         # MQA
    (1, 70, 90, 6, 2, 32, F32, False),        # Skv > S, no mask
    (1, 200, 200, 28, 4, 128, F32, True),
    (1, 777, 777, 28, 4, 128, BF16, True),    # ragged tail, GQA of 7
    (1, 129, 129, 28, 4, 128, BF16, True),    # one row past a tile
    (2, 300, 300, 32, 32, 96, BF16, True),    # MHA, D = 96
    (2, 100, 100, 4, 2, 16, BF16, True),      # D = 16
    (1, 130, 130, 8, 8, 64, BF16, False),     # D = 64, no mask
    (2, 45, 170, 8, 2, 32, BF16, True),       # Skv > S
    (1, 300, 100, 28, 4, 128, BF16, True),    # Skv < S
    (1, 1, 1, 28, 4, 128, BF16, True),        # one row, one key
    (1, 65, 65, 28, 4, 128, BF16, True),      # one row past a 64-row q tile
    (1, 333, 333, 16, 2, 64, BF16, True),     # D = 64, GQA of 8
    (1, 2048, 2048, 32, 32, 96, BF16, True),  # phi3-mini's MHA, D = 96
    (1, 200, 72, 28, 4, 128, BF16, True),     # Skv < S, not a tile multiple
])
def test_flash_attention_bwd_kernel(cuda, no_tf32, b, s, skv, h, kv, d,
                                    dtype, causal):
    """dQ, dK, dV from the kernels' own forward (O and LSE) against the
    plain backward on the inputs cast to f32; the LSE against the plain
    forward's; one launch each."""
    q, k, v, do = _inputs(cuda, b, s, skv, h, kv, d, dtype, s + d)
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
    want = fa_ref.flash_attention_bwd_ref(qf, kf, vf, o_ref, dof, lse_ref,
                                          causal)
    atol, rtol = ((fa_ref.BWD_F32_TOL, fa_ref.BWD_F32_TOL) if dtype == F32
                  else (fa_ref.BWD_BF16_ATOL, fa_ref.BWD_BF16_RTOL))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype", [(128, BF16), (96, BF16), (16, BF16),
                                     (64, F32)])
def test_forward_unchanged_by_lse(cuda, d, dtype):
    """O with the LSE written equals O without it bit for bit (serving
    passes a null pointer), on each of the three forward kernels."""
    q, k, v, _ = _inputs(cuda, 2, 200, 200, 8, 2, d, dtype, d)
    plain, none = fa_ops._forward(q, k, v, True, with_lse=False)
    with_lse, lse = fa_ops._forward(q, k, v, True, with_lse=True)
    assert none is None and lse.shape == (2, 8, 200)
    assert torch.equal(plain, with_lse)


@pytest.mark.gpu
def test_function_launches_and_grads(cuda):
    """Under grad the Function runs the forward with its LSE and the
    backward once; under no_grad the forward alone, with no LSE."""
    q, k, v, do = _inputs(cuda, 1, 150, 150, 8, 2, 64, BF16, 3)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    f0, b0 = fa_ops.launches, fa_ops.launches_bwd
    out = fa_ops.flash_attention(q, k, v, causal=True)
    out.backward(do)
    assert (fa_ops.launches, fa_ops.launches_bwd) == (f0 + 1, b0 + 1)
    o2, lse = fa_ops._forward(q.detach(), k.detach(), v.detach(), True,
                              with_lse=True)
    want = fa_ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                      o2, do, lse, causal=True)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g, w)  # no atomics: repeatable bit for bit
    with torch.no_grad():
        fa_ops.flash_attention(q, k, v, causal=True)
    assert (fa_ops.launches, fa_ops.launches_bwd) == (f0 + 3, b0 + 2)


@pytest.mark.gpu
def test_flash_attention_bwd_repeatable(cuda):
    """Two backward launches at the training shape (4, 2048, 28, 4, 128)
    bf16 causal give dQ, dK and dV equal bit for bit: every element is
    summed by one thread in a fixed order, with no atomics."""
    q, k, v, do = _inputs(cuda, 4, 2048, 2048, 28, 4, 128, BF16, 23)
    out, lse = fa_ops._forward(q, k, v, True, with_lse=True)
    first = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    # Another launch in between leaves other values in the freed memory.
    fa_ops.flash_attention_bwd(q, k, v, out, do * 2, lse, causal=True)
    second = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name
        assert bool(torch.isfinite(a.float()).all()), name


@pytest.mark.gpu
def test_smoke_train_step_card_against_cpu(cuda, no_tf32):
    """One train step of the qwen2-7b smoke config (f32) from the same
    weights and batch on the card and on the CPU: loss, grad norm and
    every moment within 1e-4 of the leaf's largest magnitude (the same f32
    math summed in other orders), every parameter within that plus 2 lr,
    and K5's forward and backward launched once a layer on the card."""
    from repro_torch.launch import train
    from repro_torch.models.lm import jax_leaves, map_tree

    kw = dict(smoke=True, seq=64, batch=4, microbatches=1, lr=1e-3,
              total_steps=10)
    cfg, model_c, tcfg, dcfg = train.build("qwen2-7b", device="cpu", **kw)
    state_c = train.ts_lib.init_state(model_c,
                                      torch.Generator().manual_seed(0))
    _, model_g, _, _ = train.build("qwen2-7b", device=cuda, **kw)
    model_g.load_params(map_tree(lambda t: t.detach().to(cuda),
                                 state_c.params))
    state_g = train.ts_lib.init_state(model_g)
    batch = train.pipeline.global_batch_for_step(dcfg, 0)
    f0, b0 = fa_ops.launches, fa_ops.launches_bwd
    state_g, mg = train.ts_lib.make_train_step(model_g, tcfg)(
        state_g, train.device_batch(batch, cuda))
    torch.cuda.synchronize()
    assert fa_ops.launches - f0 == cfg.n_layers
    assert fa_ops.launches_bwd - b0 == cfg.n_layers
    state_c, mc = train.ts_lib.make_train_step(model_c, tcfg)(
        state_c, train.device_batch(batch, "cpu"))
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(mg[key].cpu(), mc[key], atol=1e-5,
                                   rtol=1e-4)
    # AdamW moves a parameter by up to lr whatever its gradient's size, so
    # where a gradient sits at the rounding level (as some of the zero-
    # initialized biases' do) the two sides' updates may differ by ~lr:
    # params get 2 lr on top of the relative limit.
    lr = float(mc["lr"])
    for tree_g, tree_c, extra in ((state_g.params, state_c.params, 2 * lr),
                                  (state_g.opt.m, state_c.opt.m, 0.0),
                                  (state_g.opt.v, state_c.opt.v, 0.0)):
        for grp_g, grp_c in zip(jax_leaves(tree_g), jax_leaves(tree_c)):
            for a, w in zip(grp_g, grp_c):
                a, w = a.detach().cpu(), w.detach()
                scale = float(w.abs().max()) or 1.0
                assert float((a - w).abs().max()) <= 1e-4 * scale + extra
