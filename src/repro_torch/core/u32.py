"""u32 words on torch: int32 storage, unsigned arithmetic.

torch's ``uint32`` is a shell dtype on the CPU (``+``, ``>>`` and ``<`` raise
``NotImplementedError``), so every u32 word of the port is stored as an
``int32`` tensor holding the same 32 bits. The bytes are those of the JAX
package's u32 arrays, so a CUDA kernel takes the pointer as ``uint32_t*``
with no copy, and numpy crosses over through ``.view(np.uint32)``.

What differs from unsigned semantics is handled here and only here:

* add/sub/mul wrap through int64 (the product of two int32 values always
  fits), never through signed int32 overflow;
* right shift is *logical*: torch's int32 ``>>`` is arithmetic;
* compares flip bit 31 first;
* sort keys widen to int64 in ``[0, 2**32)``.

Constants are Python ints in ``[0, 2**32)``; :func:`s32` turns one into the
int32 with the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

WORD = torch.int32
MASK = 0xFFFFFFFF
_BIT31 = -(1 << 31)  # bit 31 alone, as an int32 value


def s32(v: int) -> int:
    """The int32 value with the bits of the u32 value ``v``."""
    v &= MASK
    return v - (1 << 32) if v >> 31 else v


def _wide(x):
    """int64 with the same low 32 bits: a tensor widens, a constant maps."""
    return x.long() if isinstance(x, torch.Tensor) else s32(x)


def add(a, b) -> torch.Tensor:
    return (_wide(a) + _wide(b)).to(WORD)


def sub(a, b) -> torch.Tensor:
    return (_wide(a) - _wide(b)).to(WORD)


def mul(a, b) -> torch.Tensor:
    """Wrapping product: |int32 * int32| <= 2**62, so int64 holds it."""
    return (_wide(a) * _wide(b)).to(WORD)


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift by ``k`` in [0, 31]."""
    return (x >> k) & ((1 << (32 - k)) - 1) if k else x


def lt(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a < b``."""
    bb = b ^ _BIT31 if isinstance(b, torch.Tensor) else s32(b) ^ _BIT31
    return (a ^ _BIT31) < bb


def to_u64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of each word, as int64 in [0, 2**32)."""
    return x.long() & MASK


def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order is the unsigned lexicographic order of
    ``(hi, lo)``: flipping bit 31 of ``hi`` makes its signed order unsigned."""
    return (hi ^ _BIT31).long() * (1 << 32) + to_u64(lo)


def full(shape, v: int, device) -> torch.Tensor:
    return torch.full(shape, s32(v), dtype=WORD, device=device)


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy array -> tensor on ``device``; u32 becomes int32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy on the host; int32 words come back as u32."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def host_copy(x) -> np.ndarray:
    """A tensor of words, or an array of u32 words, as a host u32 array of
    its own: a CPU tensor's numpy view would follow the tensor's in-place
    updates (a card's tensor comes back as a fresh array already)."""
    if not isinstance(x, torch.Tensor):
        return np.array(x, dtype=np.uint32)
    a = to_numpy(x)
    return a.copy() if x.device.type == "cpu" else a
