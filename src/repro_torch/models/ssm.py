"""Mamba2 / SSD (state-space duality) block (port of repro.models.ssm).

Prefill runs the chunked SSD algorithm: attention-like batched products
*within* a chunk and a linear recurrence *between* chunks (a loop over the
chunks' states). Decode is the O(1) recurrent update.
``ssd_sequential_reference`` is the step-by-step oracle that the chunked
path is held against.

Recurrence (per head h, with dt folded in):
    H_t = exp(dt_t * A_h) * H_{t-1} + dt_t * B_t x_t^T      (P x N state)
    y_t = C_t . H_t + D_h x_t

No kernel of the port runs here: every step is a torch product or an
elementwise op, as the JAX package computes it with ``jnp.einsum``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

# The leaves that ``init_mamba`` makes f32 whatever ``cfg.dtype``.
F32_LEAVES = frozenset({"dt_bias", "A_log", "D"})


def init_mamba(cfg: ModelConfig, device, generator) -> dict:
    """The JAX package's distributions; ``dt_bias`` (softplus of it spans
    [1e-3, 1e-1], the mamba2 default), ``A_log`` (A = -exp(A_log) = -1..-H)
    and ``D`` stay f32 whatever ``cfg.dtype``."""
    dt = cfg.torch_dtype
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n  # x, B, C all pass the causal conv
    in_proj = layers._dense_init(d, 2 * di + 2 * n + nh, dt, device,
                                 generator)
    conv_w = torch.randn((cfg.d_conv, conv_ch), dtype=torch.float32,
                         device=device, generator=generator)
    u = torch.empty((nh,), dtype=torch.float32, device=device).uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator)
    dt_bias = torch.log(torch.expm1(torch.exp(u)))  # inverse softplus
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.mul_(1.0 / math.sqrt(cfg.d_conv)).to(dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "norm": layers.init_rmsnorm(di, dt, device),
        "out_proj": layers._dense_init(di, d, dt, device, generator),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    if dt.shape[-1] != nh:
        raise ValueError(f"projection width {zxbcdt.shape[-1]} does not "
                         f"match the config's {nh} heads")
    return z, xbc, dt


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                prev: torch.Tensor | None = None):
    """Depthwise causal conv1d. xbc (B, S, C); w (K, C). Returns (y, tail).

    ``prev`` (B, K-1, C): trailing context from the previous segment (the
    decode cache); zeros when None. ``tail`` is the new trailing context,
    the last K-1 rows of ``prev`` followed by ``xbc``. The taps are summed
    in f32 in tap order.
    """
    k = w.shape[0]
    bsz, s, c = xbc.shape
    if prev is None:
        prev = torch.zeros((bsz, k - 1, c), dtype=xbc.dtype,
                           device=xbc.device)
    full = torch.cat([prev.to(xbc.dtype), xbc], dim=1)  # (B, K-1+S, C)
    y = torch.zeros((bsz, s, c), dtype=torch.float32, device=xbc.device)
    for i in range(k):  # K is tiny (4): unrolled taps
        y = y + full[:, i: i + s].float() * w[i].float()
    y = F.silu(y + b.float())
    tail = full[:, full.shape[1] - (k - 1):]
    return y.to(xbc.dtype), tail


def ssd_chunked(x, dt, a_neg, bmat, cmat, *, chunk: int):
    """Chunked SSD. x (B,S,H,P); dt (B,S,H); a_neg (H,); B/C (B,S,N) f32.

    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32). Raises
    ``ValueError`` when ``min(chunk, S)`` does not divide S.
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    c = s // chunk

    xe = (x * dt[..., None]).reshape(b, c, chunk, h, p)  # dt-folded input
    da = (dt * a_neg[None, None, :]).reshape(b, c, chunk, h)  # log-decay
    bm = bmat.reshape(b, c, chunk, n)
    cm = cmat.reshape(b, c, chunk, n)

    acs = torch.cumsum(da, dim=2)  # (b,c,l,h) inclusive
    # Intra-chunk: L[l,m] = exp(acs[l]-acs[m]) for l>=m (decay m+1..l).
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]  # (b,c,l,m,h)
    ltri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    decay_lm = torch.where(ltri[None, None, :, :, None], torch.exp(diff),
                           0.0)
    del diff
    scores = torch.einsum("bcln,bcmn->bclm", cm, bm)  # (b,c,l,m)
    # "bclm,bclmh,bcmhp->bclhp" in two steps, so that no (b,c,l,m,h,p)
    # product is ever formed: the weights, then one product over m.
    wlmh = scores[..., None] * decay_lm  # (b,c,l,m,h)
    del decay_lm
    y_diag = torch.matmul(wlmh.permute(0, 1, 4, 2, 3),  # (b,c,h,l,m)
                          xe.permute(0, 1, 3, 2, 4))  # (b,c,h,m,p)
    y_diag = y_diag.permute(0, 1, 3, 2, 4)  # (b,c,l,h,p)
    del wlmh

    # Chunk-final states: sum_m exp(acs[-1]-acs[m]) * B_m (x) xe_m.
    decay_end = torch.exp(acs[:, :, -1:, :] - acs)  # (b,c,l,h)
    states = torch.einsum("bcln,bclhp->bchpn", bm,
                          xe * decay_end[..., None])

    # Inter-chunk recurrence (the only sequential part): each chunk's
    # carried-in state, and the final one.
    chunk_decay = torch.exp(acs[:, :, -1, :])  # (b,c,h)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev_states = []
    for i in range(c):
        prev_states.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev_states, dim=1)  # (b,c,h,p,n)

    # Contribution of the carried-in state: C_l . (decay(start..l) * H_in).
    decay_in = torch.exp(acs)  # (b,c,l,h)
    y_prev = torch.einsum("bcln,bchpn->bclhp", cm, prev_states) * \
        decay_in[..., None]
    y = (y_diag + y_prev).reshape(b, s, h, p)
    return y, carry


def _step(state, xt, dtt, bt, ct, a_neg):
    """One recurrent step: state (b,h,p,n), xt (b,h,p), dtt (b,h), bt/ct
    (b,n) -> (new state, y (b,h,p))."""
    dec = torch.exp(dtt * a_neg[None, :])  # (b,h)
    upd = bt[:, None, None, :] * (xt * dtt[..., None])[..., None]
    state = state * dec[:, :, None, None] + upd
    return state, torch.einsum("bn,bhpn->bhp", ct, state)


def _sequential(state, x, dt, a_neg, bmat, cmat):
    ys = []
    for t in range(x.shape[1]):
        state, y = _step(state, x[:, t], dt[:, t], bmat[:, t], cmat[:, t],
                         a_neg)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def ssd_sequential_reference(x, dt, a_neg, bmat, cmat):
    """Step-by-step oracle of the same recurrence. Returns (y, final_state)."""
    b, _, h, p = x.shape
    zero = torch.zeros((b, h, p, bmat.shape[-1]), dtype=torch.float32,
                       device=x.device)
    return _sequential(zero, x, dt, a_neg, bmat, cmat)


def mamba_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  chunk: int = 256, conv_state: torch.Tensor | None = None,
                  ssm_state: torch.Tensor | None = None,
                  return_state: bool = False):
    """Full Mamba2 block forward. x (B, S, D) -> (B, S, D) [+ (conv tail,
    final state)]. Chunked SSD when no state is carried in, the sequential
    recurrence from ``ssm_state`` when one is (decode, short segments)."""
    bsz, s, _ = x.shape
    di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc, conv_tail = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs = xbc[..., :di]
    bmat = xbc[..., di: di + n].float()
    cmat = xbc[..., di + n:].float()
    # softplus as jax.nn.softplus computes it: logaddexp(v, 0), no
    # threshold.
    v = dt_raw.float() + p["dt_bias"].float()
    dt = torch.logaddexp(v, torch.zeros_like(v))
    a_neg = -torch.exp(p["A_log"].float())  # (H,)

    xh = xs.reshape(bsz, s, nh, hp).float()
    if ssm_state is None:
        y, final = ssd_chunked(xh, dt, a_neg, bmat, cmat, chunk=chunk)
    else:
        y, final = _sequential(ssm_state.float(), xh, dt, a_neg, bmat, cmat)

    y = y + xh * p["D"].float()[None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)  # gate
    y = layers.rmsnorm(p["norm"], y, cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, conv_tail, final
    return out


def mamba_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One-token recurrent update. x (B, 1, D). Returns (y, conv, ssm)."""
    return mamba_forward(p, cfg, x, conv_state=conv_state,
                         ssm_state=ssm_state, return_state=True)
