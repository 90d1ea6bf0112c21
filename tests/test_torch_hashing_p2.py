"""The port's types, wire format and ledger and journal digests, bit-equal
to the JAX package on the same numpy inputs (CPU); part 2 of
test_torch_hashing.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ledger as jl, types as jt
from repro.core import unmarshal as ju
from repro.storage import journal as jj
from repro_torch.core import ledger as tl, types as tt
from repro_torch.core import unmarshal as tu
from repro_torch.storage import journal as tj

from test_torch_hashing import N, T, _eq, _words


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
