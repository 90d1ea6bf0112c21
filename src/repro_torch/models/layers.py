"""Transformer substrate (port of repro.models.layers): norms, rotary
embeddings, GQA attention, SwiGLU, embeddings, on torch tensors.

Layouts are the JAX package's at every public function: weights are
(d_in, d_out) and used as ``x @ w``, activations are (B, S, H, D), and
parameters are nested mappings (``p["wq"]``, ``p.get("bq")``,
``p["q_norm"]["scale"]``), so the tests compare like with like.

Attention has the JAX package's implementations of one function:
  * ``attn_naive``   -- materialized (Sq, Sk) scores, f32 inside;
  * ``attn_chunked`` -- online softmax over KV chunks, each Q chunk visiting
    only the chunks its causal mask reaches;
  * ``attn_grouped`` -- GQA without expanding K/V, for cached decode.
Self-attention over a CUDA tensor runs the flash-attention kernel
(``kernels/flash_attention``, K5); over a CPU tensor it takes the kernel's
plain version (``attn_naive``) or, under ``impl="chunked"`` for sequences
longer than ``q_chunk``, ``attn_chunked``, as the JAX package chooses.
Cached decode (one new query against a masked cache) is not K5's function
and stays plain torch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops

# ---------------------------------------------------------------------------
# Initializers (the JAX package's distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


def _dense_init(d_in: int, d_out: int, dtype, device, generator
                ) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], / sqrt(d_in); drawn in f32."""
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def init_attention(cfg: ModelConfig, device, generator) -> dict:
    dt = cfg.torch_dtype
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {
        "wq": _dense_init(d, h * hd, dt, device, generator),
        "wk": _dense_init(d, kv * hd, dt, device, generator),
        "wv": _dense_init(d, kv * hd, dt, device, generator),
        "wo": _dense_init(h * hd, d, dt, device, generator),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((n * hd,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dt, device)
        p["k_norm"] = init_rmsnorm(hd, dt, device)
    return p


def init_mlp(d_model: int, d_ff: int, dtype, device, generator) -> dict:
    return {
        "w_gate": _dense_init(d_model, d_ff, dtype, device, generator),
        "w_up": _dense_init(d_model, d_ff, dtype, device, generator),
        "w_down": _dense_init(d_ff, d_model, dtype, device, generator),
    }


def init_embedding(vocab: int, d_model: int, dtype, device, generator
                   ) -> torch.Tensor:
    """N(0, 0.02), drawn in f32."""
    w = torch.randn((vocab, d_model), dtype=torch.float32, device=device,
                    generator=generator)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norm and rotary position embeddings
# ---------------------------------------------------------------------------


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (d_head/2,) f32."""
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x (B, S, H, D), positions (S,) or (B, S) -> rotated x (same dtype)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)  # (D/2,)
    ang = positions[..., None].float() * inv  # (..., S, D/2)
    if ang.dim() == 2:  # (S, D/2) -> broadcast over batch
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]  # (B|1, S, 1, D/2)
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D) by group broadcast."""
    b, s, hkv, d = k.shape
    if hkv == n_heads:
        return k
    group = n_heads // hkv
    return k[:, :, :, None, :].expand(b, s, hkv, group, d).reshape(
        b, s, n_heads, d)


def _causal_mask(sq: int, sk: int, q_offset, device) -> torch.Tensor:
    """(Sq, Sk) bool: query i (at position i + q_offset) sees key j <= it."""
    qpos = torch.arange(sq, device=device) + q_offset
    return qpos[:, None] >= torch.arange(sk, device=device)[None, :]


def attn_grouped(q, k, v, *, causal: bool, q_offset=0) -> torch.Tensor:
    """GQA attention without expanding KV: q is reshaped to (Hkv, G)
    groups. q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = _causal_mask(sq, k.shape[1], q_offset, q.device)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def attn_naive(q, k, v, *, causal: bool, q_offset=0) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> (B,Sq,H,D). Scores materialized.

    ``q_offset``: absolute position of q[0] relative to k[0] (decode: Sk-1).
    """
    h = q.shape[2]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, q.device)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def attn_chunked(q, k, v, *, causal: bool, q_chunk: int = 2048,
                 kv_chunk: int = 2048) -> torch.Tensor:
    """Online-softmax attention; memory ~ one (B,H,qc,kc) tile.

    Each Q chunk visits only the KV chunks its causal mask can reach, so
    the work is the exact causal N^2/2.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"seq ({sq},{sk}) not divisible by chunks "
                         f"({q_chunk},{kv_chunk})")
    scale = 1.0 / math.sqrt(d)
    nq = sq // q_chunk
    nk = sk // kv_chunk
    kc = k.reshape(b, nk, kv_chunk, h, d)
    vc = v.reshape(b, nk, kv_chunk, h, d)

    outs = []
    for iq in range(nq):
        qi = q[:, iq * q_chunk:(iq + 1) * q_chunk].float()
        # Causal: only kv chunks that start at or before this q chunk's end.
        hi = nk if not causal else min(
            nk, (iq + 1) * q_chunk // kv_chunk
            + (1 if q_chunk % kv_chunk else 0))
        hi = max(hi, 1)
        acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, q_chunk), float("-inf"), device=q.device)
        l = torch.zeros((b, h, q_chunk), device=q.device)
        for ik in range(hi):
            s = torch.einsum("bqhd,bkhd->bhqk", qi,
                             kc[:, ik].float()) * scale  # (B, H, qc, kc)
            if causal:
                qpos = iq * q_chunk + torch.arange(q_chunk, device=q.device)
                kpos = ik * kv_chunk + torch.arange(kv_chunk,
                                                    device=q.device)
                s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]),
                                  float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))  # (B, H, qc)
            # Renormalize the running accumulator.
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vc[:, ik].float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-37)
        outs.append(out.transpose(1, 2))  # (B, qc, H, D)
    return torch.cat(outs, dim=1).to(q.dtype)


def attention(p, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, causal: bool = True,
              kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
              cache_len: int | None = None, impl: str = "naive",
              memory: torch.Tensor | None = None, q_chunk: int = 2048,
              kv_chunk: int = 2048):
    """Full attention sub-layer: projections + rope + core + output.

    Modes:
      * self-attention over x (prefill): kv_cache None; returns (out,
        (k, v)) with this call's K/V.
      * cached decode: kv_cache=(k, v) (B, Smax, Hkv, D), cache_len = filled
        length; x is the new token(s). The new K/V rows are written into
        the cache IN PLACE at cache_len (the JAX package returns updated
        copies); returns (out, (k, v)), the same cache tensors.
    Cross-attention (``memory``) belongs to the encoder-decoder family.
    """
    if memory is not None:
        raise NotImplementedError(
            "cross-attention (memory=...) is not ported: it comes with the "
            "encoder-decoder family (ROADMAP.md, the model-families slice)")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim

    def proj(w, bias, nh):
        y = x @ w.to(x.dtype)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.reshape(b, s, nh, hd)

    q = proj(p["wq"], p.get("bq"), h)
    key = proj(p["wk"], p.get("bk"), kv)
    val = proj(p["wv"], p.get("bv"), kv)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        key = rmsnorm(p["k_norm"], key, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    key = apply_rope(key, positions, cfg.rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache
        ck[:, cache_len:cache_len + s] = key.to(ck.dtype)
        cv[:, cache_len:cache_len + s] = val.to(cv.dtype)
        kv_out = (ck, cv)
        # Attend over the whole cache; entries past cache_len + s are masked
        # by the causal offset.
        out = attn_grouped(q, ck, cv, causal=True, q_offset=cache_len)
    else:
        kv_out = (key, val)
        if impl == "chunked" and s > q_chunk and q.device.type == "cpu":
            out = attn_chunked(q, key, val, causal=causal, q_chunk=q_chunk,
                               kv_chunk=kv_chunk)
        else:  # K5 on the card, its plain version on the CPU
            out = fa_ops.flash_attention(q, key, val, causal=causal)

    out = out.reshape(b, s, h * hd) @ p["wo"].to(x.dtype)
    return out, kv_out


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    return (torch.nn.functional.silu(g.float()).to(dt) * u) @ p[
        "w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, *,
            transpose: bool) -> torch.Tensor:
    """Logits in f32. ``transpose``: table is (V, D) tied embedding."""
    w = table_or_head.float()
    return x.float() @ (w.T if transpose else w)
