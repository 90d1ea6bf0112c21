"""Plain PyTorch version of the endorsement-MAC kernel, and the GF(2^31-1)
arithmetic it is built from.

A Carter-Wegman polynomial MAC by Horner's rule: for each message row and
each key (r, s), ``tag = s + sum_i mod31(m_i) * r^(W-i) mod p`` with
p = 2^31 - 1. The arithmetic runs on int64: a product of two residues is
below 2^62, and a Mersenne fold ``(x & p) + (x >> 31)`` reduces it. Every
result is the canonical residue in [0, p), so it is bit-equal to the JAX
package's 16-bit-limb form (repro.core.crypto), for keys in [0, p).
"""

from __future__ import annotations

import torch

from repro_torch.core import u32

P31 = (1 << 31) - 1


def _fold(x: torch.Tensor) -> torch.Tensor:
    return (x & P31) + (x >> 31)


def _reduce(x: torch.Tensor) -> torch.Tensor:
    """int64 x in [0, 2^62 + 2^31) -> canonical residue (int64)."""
    x = _fold(_fold(_fold(x)))
    return torch.where(x == P31, 0, x)


def mod31(x: torch.Tensor) -> torch.Tensor:
    """Reduce u32 words -> [0, p)."""
    return _reduce(u32.to_u64(x)).to(u32.WORD)


def addmod31(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(a.long() + b.long()).to(u32.WORD)


def mulmod31(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p for residues a, b in [0, p)."""
    return _reduce(a.long() * b.long()).to(u32.WORD)


def mac_many_ref(msg: torch.Tensor, rs: torch.Tensor, ss: torch.Tensor,
                 step: int | None = None) -> torch.Tensor:
    """(B, W) u32 messages x (NE,) keys in [0, p) -> (B, NE) tags. All rows
    at once whatever ``step`` is: a row's tag does not depend on the
    schedule, which ``step`` sets only on the card."""
    m = _reduce(u32.to_u64(msg))
    r = rs.long()[None, :]
    acc = torch.zeros((msg.shape[0], rs.shape[0]), dtype=torch.int64,
                      device=msg.device)
    for i in range(msg.shape[1]):
        acc = _reduce(acc * r + m[:, i:i + 1])
    return _reduce(acc + ss.long()[None, :]).to(u32.WORD)
