"""32-bit integer hashing on int32-stored u32 words (port of repro.core.hashing).

State keys and transaction IDs are paired independent u32 hashes: two
murmur3 finalizers with different seeds. Every function is shape-polymorphic
and bit-equal to the JAX package's.
"""

from __future__ import annotations

import torch

from repro_torch.core import u32

EMPTY_KEY = 0  # "no key in this slot"; hash outputs are remapped away from it

SEED_A = 0x9E3779B9  # golden ratio
SEED_B = 0x85EBCA6B  # murmur3 c1

_FNV_PRIME = 0x01000193


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer."""
    x = x ^ u32.shr(x, 16)
    x = u32.mul(x, 0x85EBCA6B)
    x = x ^ u32.shr(x, 13)
    x = u32.mul(x, 0xC2B2AE35)
    return x ^ u32.shr(x, 16)


def hash_u32(x: torch.Tensor, seed: int = SEED_A) -> torch.Tensor:
    """Hash u32 -> u32 with a seed. Bijective for a fixed seed."""
    return _fmix32(x ^ u32.s32(seed))


def hash_pair(x: torch.Tensor, seed: int = SEED_A):
    """Paired hash (h1, h2) of a u32 input."""
    return hash_u32(x, seed), hash_u32(x, seed ^ SEED_B)


def combine(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fold a u32 word into a running hash (boost::hash_combine style)."""
    h64 = u32.to_u64(h)
    t = (u32.to_u64(_fmix32(x)) + 0x9E3779B9 + ((h64 << 6) & u32.MASK)
         + (h64 >> 2))
    return h ^ t.to(u32.WORD)


def fold(h: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """:func:`combine` the words ``xs`` (N,) into ``h`` one after another
    (``h`` any shape; each word folds into every element). The finalizer
    of every word runs at once, as it does not depend on ``h``; a step of
    the chain is then a few int64 operations."""
    t = u32.to_u64(_fmix32(xs)) + 0x9E3779B9
    h64 = u32.to_u64(h)
    for i in range(xs.shape[0]):
        h64 = h64 ^ ((t[i] + ((h64 << 6) & u32.MASK) + (h64 >> 2))
                     & u32.MASK)
    return h64.to(u32.WORD)


def hash_words(words: torch.Tensor, seed=SEED_A, axis: int = -1
               ) -> torch.Tensor:
    """Hash u32 words along ``axis`` into one u32: an FNV-style
    multiply-accumulate chain, mixed at the end.

    The chain runs on int64 holding values in [0, 2**32): ``h * P`` stays
    below 2**57, so no step can overflow. ``seed`` is an int or an int32
    tensor that broadcasts against the result.
    """
    w = u32.to_u64(words.movedim(axis, 0))
    shape = w.shape[1:]
    if isinstance(seed, torch.Tensor):
        h = u32.to_u64(seed).expand(shape).clone()
    else:
        h = torch.full(shape, seed & u32.MASK, dtype=torch.int64,
                       device=words.device)
    for i in range(w.shape[0]):
        h.mul_(_FNV_PRIME).add_(w[i]).bitwise_and_(u32.MASK)
        h ^= h >> 15
    return _fmix32(h.to(u32.WORD))


def nonzero_key(h: torch.Tensor) -> torch.Tensor:
    """Remap a hash away from the sentinels: 0 -> 1, 0xFFFFFFFF -> ...E."""
    h = torch.where(h == EMPTY_KEY, 1, h)
    return torch.where(h == u32.s32(0xFFFFFFFF), u32.s32(0xFFFFFFFE), h)


def lex_searchsorted(s_hi, s_lo, q_hi, q_lo) -> torch.Tensor:
    """Left insertion point of (q_hi, q_lo) pairs in a (hi, lo)-lexsorted
    store, (B,) int32 in [0, N]. Exact, as the JAX bisection is: the pair
    maps to one int64 key whose order is the unsigned pair order."""
    pos = torch.searchsorted(u32.pair_key(s_hi, s_lo),
                             u32.pair_key(q_hi, q_lo))
    return pos.to(torch.int32)
