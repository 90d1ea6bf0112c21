"""Plain PyTorch version of the flash-attention kernel: ``attn_naive`` of
``models/layers.py`` (scores materialized, f32 inside, output in the
input's dtype)."""

from __future__ import annotations

from repro_torch.models import layers

# How close a kernel's output must come to this version on the same inputs.
# f32: computed in f32 on both sides (TF32 off), the JAX kernel tests'
# tolerance. bf16: against this version on the inputs cast to f32, output
# left in f32. The kernels round P to bf16 for the P V product and O to
# bf16 at the end, which needs atol up to ~3.3e-3 at rtol 1e-2 on random
# inputs (largest at rows of few keys whose outputs cancel to ~0), so the
# worst sound case sits at ~0.7 of this limit, while a fault that moves a
# late causal row (|out| ~0.036 at S = 2048) by 1e-2 exceeds it.
# ``tools/flash_tolerance.py`` measures both on a card.
F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL = 5e-3, 1e-2


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """(B,S,H,D) x (B,Skv,Hkv,D) -> (B,S,H,D), scores materialized."""
    return layers.attn_naive(q, k, v, causal=causal)
