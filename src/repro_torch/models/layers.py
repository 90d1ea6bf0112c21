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
Self- and cross-attention over a CUDA tensor run the flash-attention
kernel (``kernels/flash_attention``, K5; cross-attention without the causal
mask, at Skv = the memory's length); over a CPU tensor they take the
kernel's plain version (``attn_naive``) or, under ``impl="chunked"`` for
sequences longer than ``q_chunk``, ``attn_chunked``, as the JAX package
chooses. Cached decode (one new query against a masked cache) is not K5's
function and stays plain torch. The ``*_mesh`` functions at the end are
the rank-local forms of these sub-layers over one data row of a mesh.
"""

from __future__ import annotations

import dataclasses
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


class _RMSNorm(torch.autograd.Function):
    """RMS norm with the JAX package's hand-written VJP
    (``repro.models.layers._rmsnorm_bwd``), formula for formula: the
    boundary tensors stay in the input dtype, f32 inside."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * scale.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        xf = x.float()
        gf = dy.float() * scale.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        r = torch.rsqrt(var + ctx.eps)
        xhat = xf * r
        dx = r * (gf - xhat * (gf * xhat).mean(dim=-1, keepdim=True))
        dscale = (dy.float() * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _RMSNorm.apply(x, p["scale"], eps)


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
      * cross-attention: ``memory`` (B, Sm, Dm) provides K/V (biases and
        qk_norm as for self-attention; no rope, no causal mask). Cached
        decode with ``memory`` does not occur in the reference and raises.
    """
    if memory is not None and kv_cache is not None:
        raise NotImplementedError(
            "cached decode with memory=: the encoder-decoder's decode step "
            "projects the cached cross K/V itself (models/lm.py)")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim

    def proj(w, bias, src, nh):
        y = src @ w.to(src.dtype)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.reshape(src.shape[0], src.shape[1], nh, hd)

    kv_src = memory if memory is not None else x
    q = proj(p["wq"], p.get("bq"), x, h)
    key = proj(p["wk"], p.get("bk"), kv_src, kv)
    val = proj(p["wv"], p.get("bv"), kv_src, kv)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        key = rmsnorm(p["k_norm"], key, cfg.norm_eps)
    if memory is None:  # rope only for self-attention
        q = apply_rope(q, positions, cfg.rope_theta)
        key = apply_rope(key, positions, cfg.rope_theta)
    causal = causal and memory is None

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


# ---------------------------------------------------------------------------
# Rank-local sub-layers over one data row of a mesh (models.lm.MeshLM)
# ---------------------------------------------------------------------------
#
# Each function takes the row's per-rank inputs as lists (``ps[m]``: rank
# m's params, ``xs[m]``: its activations on its device, equal on every
# rank), runs each rank's share on its device and meets the others through
# the mesh's counted collectives (``launch.mesh.Mesh``), as the reference's
# GSPMD partition of the same layer does. Params are laid out by
# ``launch.sharding.param_specs``.


@dataclasses.dataclass(frozen=True)
class RankHeads:
    """One model rank's share of an attention layer: ``rows`` (r0, r1) of
    wo (= its wq/bq columns; all of them when not split), the Q heads
    (h0, h1) whose outputs those rows read, the KV heads (k0, k1) those Q
    heads read, and ``kv_index``, each Q head's KV head among (k0, k1),
    where it is not the uniform grouping K5 takes (None)."""

    rows: tuple
    heads: tuple
    kv: tuple
    kv_index: tuple | None


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """How an attention layer falls on the model ranks, read from its param
    specs. ``q_split``: wq/bq columns and wo rows over ``model``;
    ``kv_split``: wk/wv/bk/bv columns. ``gather_q``: some rank's columns
    are not whole heads, so the Q projection is all-gathered; ``gather_kv``
    (prefill): some rank's wk columns are not the KV heads its Q heads
    read, so the K/V projections are all-gathered. Where K/V are split on
    head boundaries, each rank's KV heads are its Q heads' and the cache's
    reshard (heads -> sequence) is an all-to-all."""

    q_split: bool
    kv_split: bool
    gather_q: bool
    gather_kv: bool
    kv_cols: tuple  # per rank, (c0, c1) of its wk columns
    ranks: tuple  # per rank, RankHeads


def head_plan(cfg: ModelConfig, specs: dict, msize: int) -> HeadPlan:
    """The :class:`HeadPlan` of an attention layer whose params have
    ``specs`` (``launch.sharding.param_specs``) over ``msize`` model
    ranks."""
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = h // kv
    q_split = specs["wq"][-1] == "model"
    kv_split = specs["wk"][-1] == "model"
    ranks, kv_cols = [], []
    for m in range(msize):
        r0, r1 = ((m * h * hd // msize, (m + 1) * h * hd // msize)
                  if q_split else (0, h * hd))
        h0, h1 = r0 // hd, -(-r1 // hd)
        k0, k1 = h0 // g, (h1 - 1) // g + 1
        nh, nk = h1 - h0, k1 - k0
        idx = tuple((h0 + i) // g - k0 for i in range(nh))
        uniform = nh % nk == 0 and idx == tuple(i // (nh // nk)
                                                for i in range(nh))
        ranks.append(RankHeads((r0, r1), (h0, h1), (k0, k1),
                               None if uniform else idx))
        kv_cols.append((m * kv * hd // msize, (m + 1) * kv * hd // msize)
                       if kv_split else (0, kv * hd))
    gather_q = q_split and h % msize != 0
    gather_kv = kv_split and any(c != (r.kv[0] * hd, r.kv[1] * hd)
                                 for c, r in zip(kv_cols, ranks))
    return HeadPlan(q_split, kv_split, gather_q, gather_kv, tuple(kv_cols),
                    tuple(ranks))


def _proj(p, w: str, b: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ p[w].to(x.dtype)
    bias = p.get(b)
    return y if bias is None else y + bias.to(y.dtype)


def _gather_cols(mesh, d: int, parts: list, widths: tuple, kind: str
                 ) -> list:
    """``parts[m]``: rank m's column shards of several projections side by
    side (widths ``widths``) -> per rank, each projection's full columns
    (rank order), from ONE all-gather."""
    got = mesh.all_gather(d, [p[None] for p in parts], 0, kind)
    out = []
    for g_ in got:  # (M, ..., sum(widths))
        pieces, at = [], 0
        for w in widths:
            piece = g_[..., at:at + w]
            pieces.append(piece.movedim(0, -2).reshape(
                *piece.shape[1:-1], piece.shape[0] * w))
            at += w
        out.append(pieces)
    return out


def _heads(y: torch.Tensor, c0: int, span: tuple, hd: int) -> torch.Tensor:
    """Heads ``span`` of a projection whose columns start at ``c0``:
    (B, S, cols) -> (B, S, n, hd)."""
    a, b = span[0] * hd - c0, span[1] * hd - c0
    return y[..., a:b].reshape(*y.shape[:-1], span[1] - span[0], hd)


def _qk(p, cfg: ModelConfig, q, k, positions):
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _out_rows(p, rk: RankHeads, o: torch.Tensor, hd: int) -> torch.Tensor:
    """The rank's Q heads' outputs (B, S, nh, hd) -> its rows of wo's
    input, times its rows of wo (the row-parallel partial product)."""
    o = o.reshape(*o.shape[:2], -1)
    a = rk.rows[0] - rk.heads[0] * hd
    return o[..., a:a + rk.rows[1] - rk.rows[0]] @ p["wo"].to(o.dtype)


def attention_mesh(ps: list, cfg: ModelConfig, xs: list, plan: HeadPlan,
                   mesh, d: int, *, positions: list, causal: bool = True,
                   impl: str = "naive", q_chunk: int = 2048,
                   kv_chunk: int = 2048):
    """Self-attention (prefill) over one data row: each rank projects its
    columns, runs its Q heads against the KV heads they read (K5 on the
    card, as :func:`attention`), and multiplies by its rows of wo; the
    partial products are summed over the row (``psum``) when wo is split.
    Returns (outputs a rank, the K/V for the cache a rank: every KV head
    where they are replicated or gathered, else the rank's own)."""
    hd = cfg.head_dim
    qs = [_proj(p, "wq", "bq", x) for p, x in zip(ps, xs)]
    ks = [_proj(p, "wk", "bk", x) for p, x in zip(ps, xs)]
    vs = [_proj(p, "wv", "bv", x) for p, x in zip(ps, xs)]
    q_at = [r.rows[0] for r in plan.ranks]
    kv_at = [c[0] for c in plan.kv_cols]
    if plan.gather_q:
        qs = [g[0] for g in _gather_cols(mesh, d, qs, (qs[0].shape[-1],),
                                         "attn_q")]
        q_at = [0] * len(qs)
    if plan.gather_kv:
        w = ks[0].shape[-1]
        got = _gather_cols(mesh, d, [torch.cat([k, v], -1)
                                     for k, v in zip(ks, vs)], (w, w),
                           "attn_kv")
        ks, vs = [g[0] for g in got], [g[1] for g in got]
        kv_at = [0] * len(ks)
    outs, kvs = [], []
    for m, (p, rk) in enumerate(zip(ps, plan.ranks)):
        nkv = ks[m].shape[-1] // hd
        span = (kv_at[m] // hd, kv_at[m] // hd + nkv)
        q, k = _qk(p, cfg, _heads(qs[m], q_at[m], rk.heads, hd),
                   _heads(ks[m], kv_at[m], span, hd), positions[m])
        v = _heads(vs[m], kv_at[m], span, hd)
        kvs.append((k, v))
        a, b = rk.kv[0] - span[0], rk.kv[1] - span[0]
        k, v = k[:, :, a:b], v[:, :, a:b]
        if rk.kv_index is not None:  # one KV head a Q head (no host copy)
            k, v = (torch.cat([t[:, :, j:j + 1] for j in rk.kv_index], 2)
                    for t in (k, v))
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if (impl == "chunked" and q.shape[1] > q_chunk
                and q.device.type == "cpu"):
            o = attn_chunked(q, k, v, causal=causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
        else:  # K5 on the card, its plain version on the CPU
            o = fa_ops.flash_attention(q, k, v, causal=causal)
        outs.append(_out_rows(p, rk, o, hd))
    if plan.q_split:
        outs = mesh.psum(d, outs, "attn_out")
    return outs, kvs


def attn_partial(q, k, v, *, pos: int, offset: int):
    """One query a sequence, q (B, 1, H, D), over a slice of the cache, k/v
    (B, Sk, Hkv, D) holding positions offset..offset+Sk-1, the keys past
    ``pos`` masked -> (B, H, D + 2) f32: the exp-weighted sum of V, the
    slice's largest score and its sum of exp(score - largest). A slice
    whose every key is masked gives -inf, 0 and 0, and no NaN."""
    b, _, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * (1.0 / math.sqrt(d))
    keys = torch.arange(offset, offset + k.shape[1], device=q.device)
    s = s.masked_fill(keys > pos, float("-inf"))
    mx = s.amax(dim=-1)
    p = torch.exp(s - torch.where(mx == float("-inf"), 0.0, mx)[..., None])
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return torch.cat([o, mx[..., None], p.sum(dim=-1)[..., None]],
                     dim=-1).reshape(b, h, d + 2)


def combine_partials(parts: torch.Tensor) -> torch.Tensor:
    """(M, B, H, D + 2) partials of :func:`attn_partial`, one a slice of the
    keys -> the attention output (B, H, D) f32 over all of them. The first
    slice always holds key 0, so the largest score is finite, and a fully
    masked slice weighs exp(-inf) = 0."""
    o, mx, l = parts[..., :-2], parts[..., -2], parts[..., -1]
    w = torch.exp(mx - mx.amax(dim=0))  # (M, B, H)
    return (w[..., None] * o).sum(dim=0) / (w * l).sum(dim=0)[..., None]


def attention_decode_mesh(ps: list, cfg: ModelConfig, xs: list,
                          plan: HeadPlan, mesh, d: int, *, caches: list,
                          pos: int, positions: list) -> list:
    """Cached decode of one token a sequence over one data row, the cache's
    sequence over the model ranks (flash-decode): ``caches[m]`` = (k, v),
    rank m's slice (B, Sc, Hkv, D) of this layer, positions m*Sc... Every
    rank gets every head's Q and the new K/V row (one all-gather of the
    split projections); the rank that holds ``pos`` writes the row in
    place; each rank forms partials over its slice for every head (one
    all-gather); each combines its Q heads' and multiplies by its rows of
    wo, summed over the row when split."""
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv
    cols = [("wq", "bq")] if plan.q_split else []
    cols += [("wk", "bk"), ("wv", "bv")] if plan.kv_split else []
    local = [[_proj(p, w, b, x) for w, b in cols] for p, x in zip(ps, xs)]
    full = ([[]] * len(xs) if not cols else _gather_cols(
        mesh, d, [torch.cat(y, -1) for y in local],
        tuple(y.shape[-1] for y in local[0]), "decode_qkv"))
    sc = caches[0][0].shape[1]
    owner = pos // sc
    qkv = []
    for m, (p, x) in enumerate(zip(ps, xs)):
        got = dict(zip([w for w, _ in cols], full[m]))
        for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
            if w not in got:
                got[w] = _proj(p, w, b, x)
        q, k = _qk(p, cfg, _heads(got["wq"], 0, (0, h), hd),
                   _heads(got["wk"], 0, (0, kv), hd), positions[m])
        qkv.append((q, k, _heads(got["wv"], 0, (0, kv), hd)))
    ck, cv = caches[owner]
    _, k_new, v_new = qkv[owner]
    ck[:, pos - owner * sc] = k_new[:, 0].to(ck.dtype)
    cv[:, pos - owner * sc] = v_new[:, 0].to(cv.dtype)
    partials = [attn_partial(q, ck_, cv_, pos=pos, offset=m * sc)[None]
                for m, ((q, _, _), (ck_, cv_)) in enumerate(zip(qkv, caches))]
    partials = mesh.all_gather(d, partials, 0, "decode_partials")
    outs = []
    for p, rk, (q, _, _), part in zip(ps, plan.ranks, qkv, partials):
        o = combine_partials(part[:, :, rk.heads[0]:rk.heads[1]])
        outs.append(_out_rows(p, rk, o[:, None].to(q.dtype), hd))
    if plan.q_split:
        outs = mesh.psum(d, outs, "attn_out")
    return outs


def mlp_mesh(ps: list, xs: list, split: bool, mesh, d: int) -> list:
    """SwiGLU over one data row: gate/up column- and down row-split, the
    partial products summed over the row; replicated when not split."""
    ys = [mlp(p, x) for p, x in zip(ps, xs)]
    return mesh.psum(d, ys, "mlp_out") if split else ys


def embed_mesh(tables: list, tokens: list, split: bool, mesh, d: int
               ) -> list:
    """Embedding with the vocab rows over the row's ranks: each rank looks
    up the tokens in its rows (zero elsewhere), then the row sums them,
    exactly (every token's row is non-zero on one rank)."""
    if not split:
        return [embed(t, x) for t, x in zip(tables, tokens)]
    parts = []
    for m, (t, x) in enumerate(zip(tables, tokens)):
        n = t.shape[0]
        local = x.long() - m * n
        inside = (local >= 0) & (local < n)
        parts.append(t[local.clamp(0, n - 1)].masked_fill(
            ~inside[..., None], 0))
    return mesh.psum(d, parts, "embed")


def logits_mesh(tables: list, xs: list, split: bool, vocab: int, mesh,
                d: int) -> list:
    """Logits (f32) with the vocab over the row's ranks: each rank's rows,
    all-gathered along V and cut to ``vocab``."""
    parts = [unembed(t, x, transpose=True) for t, x in zip(tables, xs)]
    if split:
        parts = mesh.all_gather(d, parts, -1, "logits")
    return [y[..., :vocab] for y in parts]
