"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``).

A CUDA tensor launches a kernel, a CPU tensor takes the plain version in
``ref.py``; there is no fallback between them. The C entry picks the kernel
by dtype and head dim: bf16 at D = 64, 96, 128 (every full-width model)
runs the Hopper kernel (TMA ring, producer warp, wgmma), bf16 at D = 16 or
32 (smoke configurations) the mma.sync kernel, f32 the CUDA-core kernel.
All three are named ``flash_fwd_*``; ``launches`` counts launches of each,
``launches_by_device`` the same by device (``"cuda:1"``).

Training differentiates through :class:`FlashAttention`: its forward is
the same launch with each row's log-sum-exp written beside O, its backward
one call of ``flash_attention_bwd`` (a delta pass, a dQ kernel and a dK/dV
kernel, ``flash_bwd_*``: wgmma kernels fed by TMA rings for bf16 at D = 64,
96, 128, mma.sync ones at D = 16, 32, CUDA-core ones for f32; no atomics,
so a launch repeats bit for bit), counted by ``launches_bwd``. ``flash_attention``
takes it only when grad is enabled and an input needs a gradient; under
``no_grad``/``inference_mode`` it runs as serving always has, with no LSE.
"""

from __future__ import annotations

import collections

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 96, 128)  # the kernels' instances of D
DTYPES = (torch.float32, torch.bfloat16)

launches = 0
launches_by_device = collections.Counter()
launches_bwd = 0


def _check(q, k, v) -> None:
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, expected one of "
                        f"{DTYPES}")
    build.check("q", q, q.dtype, (b, s, h, d), q.device)
    build.check("k", k, q.dtype, (b, skv, hkv, d), q.device)
    build.check("v", v, q.dtype, (b, skv, hkv, d), q.device)
    if hkv == 0 or h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")


def _aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")


def _forward(q, k, v, causal: bool, with_lse: bool):
    """(out, lse or None): K5 on a CUDA tensor, the plain version on a CPU
    one; the LSE (B, H, S) f32 only when asked."""
    global launches
    _check(q, k, v)
    if not build.dispatch(q.device):
        if with_lse:
            return ref.flash_attention_lse_ref(q, k, v, causal=causal)
        return ref.flash_attention_ref(q, k, v, causal=causal), None
    _aligned(q=q, k=k, v=v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    f = build.c_function("flash_attention", "flash_attention_fwd", 5, 8)
    build.launch(f, "flash_attention_fwd", q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None, b, s, k.shape[1], h,
                 k.shape[2], d, int(q.dtype == torch.bfloat16), int(causal))
    launches += 1
    launches_by_device[str(q.device)] += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True):
    """The backward of ``flash_attention`` from its output ``o``, the
    output's gradient ``do`` and the forward's ``lse``: (dq, dk, dv) in the
    inputs' dtype. A CUDA tensor launches ``flash_attention_bwd``, a CPU
    one takes ``ref.flash_attention_bwd_ref``."""
    global launches_bwd
    _check(q, k, v)
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    build.check("o", o, q.dtype, (b, s, h, d), q.device)
    build.check("do", do, q.dtype, (b, s, h, d), q.device)
    build.check("lse", lse, torch.float32, (b, h, s), q.device)
    if not build.dispatch(q.device):
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    _aligned(q=q, k=k, v=v, o=o, do=do, lse=lse)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:  # nothing to sum: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    f = build.c_function("flash_attention", "flash_attention_bwd", 10, 8)
    build.launch(f, "flash_attention_bwd", q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, s, skv, h, hkv, d,
                 int(q.dtype == torch.bfloat16), int(causal))
    launches_bwd += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward kernel with its LSE, the
    backward kernels (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward, GQA by head grouping: q (B, S, H, D), k/v
    (B, Skv, Hkv, D) -> (B, S, H, D) in q's dtype. Query head h reads KV
    head h // (H / Hkv); ``causal`` masks key j > query i (both from 0).
    Any S and Skv: the kernel masks the ragged tail itself. Differentiable
    (through :class:`FlashAttention`) when grad is enabled and an input
    needs a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]
