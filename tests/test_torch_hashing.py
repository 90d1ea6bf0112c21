"""The port's u32 word layer and hashing, bit-equal to the JAX package on
the same numpy inputs (CPU). Part 2 holds the types, the wire format and
the digests."""

import numpy as np
import jax.numpy as jnp
import pytest

from repro.core import hashing as jh
from repro_torch.core import hashing as th, u32

EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32)


def _words(seed, *shape):
    """Random u32 words with the edge values 0 and 0xFFFFFFFF mixed in."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, shape, dtype=np.uint32).reshape(-1)
    a[: len(EDGES)] = EDGES[: a.size]
    return a.reshape(shape)


def T(a):
    return u32.from_numpy(a, "cpu")


def N(t):
    return u32.to_numpy(t)


def _eq(got, want):
    np.testing.assert_array_equal(N(got), np.asarray(want))


# -- u32 layer ----------------------------------------------------------------

A = _words(1, 64)
B = np.concatenate([EDGES[::-1], _words(2, 58)])


@pytest.mark.parametrize("op,ref", [
    (u32.add, lambda a, b: a + b),
    (u32.sub, lambda a, b: a - b),
    (u32.mul, lambda a, b: a * b),
])
def test_u32_wrapping_arithmetic(op, ref):
    with np.errstate(over="ignore"):
        _eq(op(T(A), T(B)), ref(A, B))
        _eq(op(T(A), 0x85EBCA6B), ref(A, np.uint32(0x85EBCA6B)))


@pytest.mark.parametrize("k", [0, 1, 2, 6, 13, 15, 16, 31])
def test_u32_right_shift_is_logical(k):
    _eq(u32.shr(T(A), k), A >> np.uint32(k))


def test_u32_unsigned_compare_and_sort_keys():
    np.testing.assert_array_equal(u32.lt(T(A), T(B)).numpy(), A < B)
    np.testing.assert_array_equal(u32.lt(T(A), 1 << 16).numpy(), A < 1 << 16)
    np.testing.assert_array_equal(u32.to_u64(T(A)).numpy(),
                                  A.astype(np.int64))
    hi, lo = _words(3, 200) % 7, _words(4, 200)  # many equal hi words
    hi[:3] = [0, 0x80000000, 0xFFFFFFFF]
    key = u32.pair_key(T(hi), T(lo)).numpy()
    np.testing.assert_array_equal(np.argsort(key, kind="stable"),
                                  np.lexsort((lo, hi)))


# -- hashing ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [th.SEED_A, th.SEED_B, 0x1234ABCD])
def test_hash_u32_pair_fmix(seed):
    x = _words(5, 97)
    _eq(th._fmix32(T(x)), jh._fmix32(jnp.asarray(x)))
    _eq(th.hash_u32(T(x), seed), jh.hash_u32(jnp.asarray(x), np.uint32(seed)))
    for got, want in zip(th.hash_pair(T(x), seed),
                         jh.hash_pair(jnp.asarray(x), np.uint32(seed))):
        _eq(got, want)
    _eq(th.nonzero_key(T(x)), jh.nonzero_key(jnp.asarray(x)))


def test_combine():
    h, x = _words(6, 50), _words(7, 50)
    _eq(th.combine(T(h), T(x)), jh.combine(jnp.asarray(h), jnp.asarray(x)))


@pytest.mark.parametrize("shape,axis", [((5, 13), -1), ((13, 5), 0),
                                        ((2, 3, 7), -1), ((4, 0), -1)])
def test_hash_words(shape, axis):
    w = _words(8, *shape)
    for seed in (th.SEED_A, th.SEED_B):
        _eq(th.hash_words(T(w), seed=seed, axis=axis),
            jh.hash_words(jnp.asarray(w), seed=np.uint32(seed), axis=axis))


def test_hash_words_tensor_seed():
    w, seed = _words(9, 1, 11), _words(10, 2)
    for i in range(2):
        _eq(th.hash_words(T(w), seed=T(seed)[i]),
            jh.hash_words(jnp.asarray(w), seed=jnp.asarray(seed)[i]))


def test_lex_searchsorted():
    rng = np.random.default_rng(11)
    hi = rng.integers(0, 4, 300).astype(np.uint32) * np.uint32(0x40000001)
    lo = _words(12, 300)
    order = np.lexsort((lo, hi))
    s_hi, s_lo = hi[order], lo[order]
    q_hi = np.concatenate([s_hi[::7], _words(13, 40) % 5, EDGES])
    q_lo = np.concatenate([s_lo[::7], _words(14, 40), EDGES[::-1]])
    _eq(th.lex_searchsorted(T(s_hi), T(s_lo), T(q_hi), T(q_lo)),
        jh.lex_searchsorted(*(jnp.asarray(a) for a in (s_hi, s_lo, q_hi,
                                                        q_lo))))
