"""Plain PyTorch version of the flash-attention kernel: ``attn_naive`` of
``models/layers.py`` (scores materialized, f32 inside, output in the
input's dtype)."""

from __future__ import annotations

from repro_torch.models import layers


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """(B,S,H,D) x (B,Skv,Hkv,D) -> (B,S,H,D), scores materialized."""
    return layers.attn_naive(q, k, v, causal=causal)
