"""Flash attention (K5) on a card against its plain PyTorch version: f32
within ``atol=rtol=2e-5`` (TF32 off), the JAX kernel tests' tolerance;
bf16 against the plain version on the inputs cast to f32, within
``ref.BF16_ATOL`` + ``ref.BF16_RTOL`` |want| (``ref.py`` says why, and
``tools/flash_tolerance.py`` shows that planted faults exceed it). The
bf16 cases at D = 64, 96 and 128 run the Hopper kernel (TMA ring, wgmma)
and sit on its edges: S around the 128-row q tile and 128-key K/V tile,
GQA groups of 7 and 8, MHA at D = 96 (64-byte swizzle), two batches with a
ragged S (TMA must zero-fill each batch's tail, not read the next batch),
no causal mask, Skv above and below S. K and V are random and not
symmetric, so a wrong shared-memory layout shows as wrong numbers. Imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py \\
        tests/test_torch_cuda_flash.py

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


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,skv,h,kv,d,dtype,causal", [
    (1, 2048, 2048, 28, 4, 128, BF16, True),  # Qwen2-7B prefill
    (1, 777, 777, 28, 4, 128, BF16, True),    # ragged tail
    (2, 300, 300, 32, 32, 96, F32, True),     # MHA at D = 96
    (2, 64, 64, 4, 1, 16, F32, True),         # MQA
    (2, 100, 100, 4, 2, 16, BF16, True),      # mma.sync kernel
    (1, 130, 130, 8, 8, 64, BF16, False),
    (1, 70, 70, 6, 2, 32, F32, False),
    (1, 45, 170, 4, 2, 64, BF16, True),       # Skv != S
    # The Hopper kernel's edges.
    (1, 1, 1, 28, 4, 128, BF16, True),        # one row, one key
    (1, 127, 127, 28, 4, 128, BF16, True),
    (1, 128, 128, 28, 4, 128, BF16, True),    # exactly one tile
    (1, 129, 129, 28, 4, 128, BF16, True),    # one row into the next
    (1, 2047, 2047, 28, 4, 128, BF16, True),
    (2, 300, 300, 32, 32, 96, BF16, True),    # MHA, D = 96
    (1, 333, 333, 16, 2, 64, BF16, True),     # group of 8, D = 64
    (2, 200, 200, 28, 4, 128, BF16, True),    # ragged S in both batches
    (1, 300, 300, 28, 4, 128, BF16, False),   # no causal mask
    (2, 45, 170, 8, 2, 96, BF16, False),      # Skv > S, second key tile
    (1, 300, 100, 28, 4, 128, BF16, True),    # Skv < S
    (1, 2048, 2048, 16, 16, 128, BF16, True),  # Qwen1.5-MoE prefill, MHA
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
    want = fa_ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal=causal)
    atol, rtol = ((fa_ref.F32_TOL, fa_ref.F32_TOL) if dtype == F32
                  else (fa_ref.BF16_ATOL, fa_ref.BF16_RTOL))
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_flash_attention_kernel_choice(cuda):
    """The kernel that actually runs for each dtype and head dim, read from
    the profiler: the Hopper kernel for bf16 at every full-width head dim,
    the mma.sync kernel for bf16 at D = 16, 32, the CUDA-core one for f32."""
    from torch.profiler import ProfilerActivity, profile
    for dtype in (F32, BF16):
        for d in fa_ops.HEAD_DIMS:
            q, k, v = (torch.randn((1, 64, 2, d), device=cuda).to(dtype)
                       for _ in range(3))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fa_ops.flash_attention(q, k, v)
                torch.cuda.synchronize()
            ran = {ev.key for ev in prof.key_averages()
                   if "flash_fwd" in ev.key}
            want = ("flash_fwd_f32_kernel" if dtype == F32
                    else "flash_fwd_wgmma_kernel" if d >= 64
                    else "flash_fwd_bf16_kernel")
            assert len(ran) == 1 and want in ran.pop(), (dtype, d, ran)


@pytest.mark.gpu
def test_flash_attention_bwd_kernel_choice(cuda):
    """The backward's kernels that actually run for each dtype and head
    dim, read from the profiler: the wgmma dQ and dK/dV kernels for bf16 at
    every full-width head dim, the mma.sync ones for bf16 at D = 16, 32,
    the CUDA-core ones for f32; the delta pass always."""
    from torch.profiler import ProfilerActivity, profile
    for dtype in (F32, BF16):
        for d in fa_ops.HEAD_DIMS:
            q, k, v, do = (torch.randn((1, 64, 2, d), device=cuda).to(dtype)
                           for _ in range(4))
            out, lse = fa_ops._forward(q, k, v, True, with_lse=True)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fa_ops.flash_attention_bwd(q, k, v, out, do, lse,
                                           causal=True)
                torch.cuda.synchronize()
            ran = {ev.key for ev in prof.key_averages()
                   if "flash_bwd" in ev.key}
            kind = ("f32" if dtype == F32 else "wgmma" if d >= 64
                    else "bf16")
            want = [f"flash_bwd_dq_{kind}_kernel",
                    f"flash_bwd_dkdv_{kind}_kernel", "flash_bwd_delta_kernel"]
            assert len(ran) == 3, (dtype, d, ran)
            assert all(any(w in r for r in ran) for w in want), (dtype, d,
                                                                  ran)
