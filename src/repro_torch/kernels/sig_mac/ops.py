"""Wrapper of the endorsement-MAC kernel (``csrc/sig_mac.cu``).

A CUDA tensor launches the kernel, a CPU tensor takes the plain version in
``ref.py``; there is no fallback between them. ``launches`` counts kernel
launches, ``launches_by_device`` the same by device (``"cuda:1"``).
"""

from __future__ import annotations

import collections

import torch

from repro_torch.core import u32
from repro_torch.kernels import build
from repro_torch.kernels.sig_mac import ref

launches = 0
launches_by_device = collections.Counter()


def mac_many(msg: torch.Tensor, rs: torch.Tensor, ss: torch.Tensor,
             step: int | None = None) -> torch.Tensor:
    """Tags of every message under every key: (B, W) u32 messages x (NE,)
    keys (r, s) in [0, p) -> (B, NE) u32, one launch for all keys.

    ``step`` (rows a step; default all B) shapes only the card's schedule:
    with ``step < B`` one thread block computes the rows in order, ``step``
    rows at a time with a barrier between steps (the reference's scan over
    transactions or tiles, in one launch). The tags are the same bits for
    every ``step``."""
    global launches
    dev = msg.device
    b, w = msg.shape
    ne = rs.shape[0]
    build.check("msg", msg, u32.WORD, (None, None), dev)
    build.check("rs", rs, u32.WORD, (ne,), dev)
    build.check("ss", ss, u32.WORD, (ne,), dev)
    if step is not None and step < 1:
        raise ValueError(f"step {step}: at least one row a step")
    if not build.dispatch(dev):
        return ref.mac_many_ref(msg, rs, ss, step)
    tags = torch.empty((b, ne), dtype=u32.WORD, device=dev)
    if b * ne == 0:
        return tags
    f = build.c_function("sig_mac", "mac_many", 4, 4)
    build.launch(f, "mac_many", dev, msg.data_ptr(), rs.data_ptr(),
                 ss.data_ptr(), tags.data_ptr(), b, w, ne,
                 b if step is None else min(step, b))
    launches += 1
    launches_by_device[str(dev)] += 1
    return tags
