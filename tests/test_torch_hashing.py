"""The port's u32 word layer, hashing, types, wire format and digests,
bit-equal to the JAX package on the same numpy inputs (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import hashing as jh, ledger as jl, types as jt
from repro.core import unmarshal as ju
from repro.storage import journal as jj
from repro_torch.core import hashing as th, ledger as tl, types as tt
from repro_torch.core import u32, unmarshal as tu
from repro_torch.storage import journal as tj

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


# -- types --------------------------------------------------------------------

def _assert_txb_equal(tb, jb):
    for name in jt.TxBatch._fields:
        _eq(getattr(tb, name), getattr(jb, name))


@pytest.mark.parametrize("conflict_rate", [0.0, 0.5])
def test_make_transfer_batch_and_message_words(conflict_rate):
    dims = jt.TEST_DIMS
    kw = dict(seed=3, n_accounts=1 << 10, conflict_rate=conflict_rate)
    tb = tt.make_transfer_batch(tt.TEST_DIMS, 37, device="cpu", **kw)
    jb = jt.make_transfer_batch(dims, 37, **kw)
    _assert_txb_equal(tb, jb)
    _eq(tt.message_words(tb), jt.message_words(jb))
    _eq(tt.tx_body_hash(tb), jt.tx_body_hash(jb))


def test_dims_match():
    for name in ("PAPER_DIMS", "TEST_DIMS"):
        assert (getattr(tt, name).struct_words
                == getattr(jt, name).struct_words)
    with pytest.raises(ValueError):
        tt.FabricDims(payload_words=8)


# -- wire format --------------------------------------------------------------

@pytest.mark.parametrize("dims_name", ["TEST_DIMS", "PAPER_DIMS"])
def test_marshal_bytes_and_unmarshal_roundtrip(dims_name):
    jd, td = getattr(jt, dims_name), getattr(tt, dims_name)
    jb = jt.make_transfer_batch(jd, 9, seed=5)
    tb = tt.make_transfer_batch(td, 9, seed=5, device="cpu")
    tags = _words(15, 9, jd.ne)
    jb = jb._replace(endorse_tags=jnp.asarray(tags))
    tb = tb._replace(endorse_tags=T(tags))
    wire = tu.marshal(tb, td, fill_seed=7)
    assert wire.dtype == torch.uint8 and wire.shape == (9, 4 * td.payload_words)
    np.testing.assert_array_equal(wire.numpy(),
                                  np.asarray(ju.marshal(jb, jd, fill_seed=7)))
    dec = tu.unmarshal(wire, td)
    _assert_txb_equal(dec.txb, jb)
    assert dec.checksum_ok.all()
    _eq(tu.payload_checksum(tu.wire_words(wire)),
        ju.payload_checksum(jnp.asarray(N(tu.wire_words(wire)))))


def test_unmarshal_checksum_catches_corruption():
    td, jd = tt.TEST_DIMS, jt.TEST_DIMS
    wire = tu.marshal(tt.make_transfer_batch(td, 6, seed=1, device="cpu"), td)
    wire[2, 4 * td.payload_words - 1] ^= 0x10  # opaque payload byte
    wire[4, 0] ^= 0x01  # header byte: covered by the MACs, not the checksum
    got = tu.unmarshal(wire, td).checksum_ok.numpy()
    want = np.asarray(ju.unmarshal(jnp.asarray(wire.numpy()), jd).checksum_ok)
    np.testing.assert_array_equal(got, want)
    assert list(got) == [True, True, False, True, True, True]


# -- ledger and journal digests -----------------------------------------------

def test_block_and_journal_digests():
    rng = np.random.default_rng(16)
    wire = rng.integers(0, 256, (12, 4 * 32), dtype=np.uint8)
    valid = rng.random(12) < 0.6
    d_t = tl.block_body_digest(torch.from_numpy(wire), torch.from_numpy(valid))
    d_j = jl.block_body_digest(jnp.asarray(wire), jnp.asarray(valid))
    _eq(d_t, d_j)
    prev = _words(17, 2)
    for bno in (0, 7, 0xFFFFFFFF):
        _eq(tl.append_hash(T(prev), bno, d_t),
            jl.append_hash(jnp.asarray(prev), jnp.uint32(bno), d_j))
    wk, wv = _words(18, 12, 2, 2), _words(19, 12, 2, 4)
    w_t = tj.write_set_digest(T(wk), T(wv), torch.from_numpy(valid))
    w_j = jj.write_set_digest(jnp.asarray(wk), jnp.asarray(wv),
                              jnp.asarray(valid))
    _eq(w_t, w_j)
    _eq(tj.update_head(T(prev), T(np.uint32(5)).reshape(()), w_t),
        jj.update_head(jnp.asarray(prev), jnp.uint32(5), w_j))
