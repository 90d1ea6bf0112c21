"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

A CUDA tensor launches the kernel, a CPU tensor takes the plain version in
``ref.py``; there is no fallback between them. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 96, 128)  # the kernel's instances of D
DTYPES = (torch.float32, torch.bfloat16)

launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward, GQA by head grouping: q (B, S, H, D), k/v
    (B, Skv, Hkv, D) -> (B, S, H, D) in q's dtype. Query head h reads KV
    head h // (H / Hkv); ``causal`` masks key j > query i (both from 0).
    Any S and Skv: the kernel masks the ragged tail itself."""
    global launches
    dev = q.device
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, expected one of "
                        f"{DTYPES}")
    build.check("q", q, q.dtype, (b, s, h, d), dev)
    build.check("k", k, q.dtype, (b, skv, hkv, d), dev)
    build.check("v", v, q.dtype, (b, skv, hkv, d), dev)
    if hkv == 0 or h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if not build.dispatch(dev):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    f = build.c_function("flash_attention", "flash_attention_fwd", 4, 8)
    build.launch(f, "flash_attention_fwd", dev, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, s, skv, h, hkv, d,
                 int(q.dtype == torch.bfloat16), int(causal))
    launches += 1
    return out
