"""Plain PyTorch versions of the flash-attention kernels: the forward is
``attn_naive`` of ``models/layers.py`` (scores materialized, f32 inside,
output in the input's dtype); ``flash_attention_lse_ref`` also returns each
row's log-sum-exp, and ``flash_attention_bwd_ref`` is the backward that
the training path's kernels compute, written from the formulas and not
from the kernels."""

from __future__ import annotations

import math

import torch

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
# The log-sum-exp the forward kernels write, against this version's on the
# same inputs (bf16 ones cast to f32): f32 sums of the same exponentials
# in another order, the bf16 kernels' scores from bf16 products with f32
# accumulation as here; |lse| ~ log(S) + a few, so 1e-4 is ~10x the
# rounding of a 2,048-term sum, and a dropped key tile moves a row's lse
# by log(1 + its share), >= 1e-3 for any tile of a row's last 2,048 keys.
LSE_TOL = 1e-4
# The backward kernels' dQ, dK, dV against ``flash_attention_bwd_ref``.
# f32: the same f32 products summed in another order (tiles, shuffles),
# ~1e-6 relative on gradients of size ~1 (measured on the card: at most
# 5e-6 absolute); 1e-4 absolute and relative.
# bf16: against this version on the inputs cast to f32 (its own O and
# LSE), the result left in f32. The kernels round P and dS to bf16 for
# their four products, and dQ, dK, dV to bf16 at the end; at the training
# shape (4, 2048, 28, 4, 128) dK and dV sum 7 x 2,048 such terms, and
# |dV| reaches ~12 on random inputs. ``tools/flash_tolerance.py
# --backward`` (nine shapes, two seeds, one H100) measured the sound
# kernels' worst error at 0.0372 absolute, 0.0161 beyond 2e-2 |want|:
# 0.845 of a limit of 2e-2 + 2e-2 |want|, too close for other seeds, so
# the limit is 3e-2 + 3e-2 |want|; the planted faults, a dK/dV CTA that
# skips its diagonal q tile and dS without its - delta, exceeded the
# 2e-2 limit 142x and 550x (errors of 15-18), so they stay far beyond
# this one. The wgmma kernels that bf16 at D = 64, 96, 128 now runs round
# P and dS at the same places; on 13 shapes and three seeds the tool
# measured them at 0.563 of this limit at worst (0.0372 absolute), and the
# same two faults planted in them at 71x and 357x. The tool's runs at this
# limit are recorded in PERF.md.
BWD_F32_TOL = 1e-4
BWD_BF16_ATOL, BWD_BF16_RTOL = 3e-2, 3e-2


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """(B,S,H,D) x (B,Skv,Hkv,D) -> (B,S,H,D), scores materialized."""
    return layers.attn_naive(q, k, v, causal=causal)


def _scores(q, k, causal: bool) -> torch.Tensor:
    """(B, H, S, Skv) f32 scaled scores, -inf where masked; K expanded to
    the query heads."""
    d = q.shape[-1]
    k = layers._expand_kv(k, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = layers._causal_mask(q.shape[1], k.shape[1], 0, q.device)
        s = s.masked_fill(~mask, float("-inf"))
    return s


def flash_attention_lse_ref(q, k, v, *, causal: bool = True):
    """The forward and each row's log-sum-exp of the scaled, masked scores:
    (out (B, S, H, D) in q's dtype, lse (B, H, S) f32)."""
    lse = torch.logsumexp(_scores(q, k, causal), dim=-1)
    return (flash_attention_ref(q, k, v, causal=causal).contiguous(),
            lse.contiguous())


def flash_attention_bwd_ref(q, k, v, o, do, lse, causal: bool = True):
    """The backward of attention from the forward's output ``o`` and
    log-sum-exp ``lse`` (B, H, S), in f32 inside: delta = rowsum(dO o O),
    P = exp(S - lse), dV = P^T dO, dP = dO V^T, dS = P o (dP - delta),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D). K/V heads are shared by
    groups of query heads (GQA), so dK and dV sum over each group.
    Returns (dq, dk, dv) in the inputs' dtype."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    kf, vf = (layers._expand_kv(x, h).float() for x in (k, v))
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # (B, H, S)
    p = torch.exp(_scores(q, k, causal) - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    fold = lambda t: t.reshape(b, skv, hkv, g, d).sum(3)
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)
