"""The schedules of the two redesigned kernels, on the CPU.

MVCC validation (K4): a plain mirror of the kernel's two phases on both of
its routes (the conflict matrix as bit words, then the scan over 32-tx
chunks with the cross-chunk OR and the chain inside each chunk, in one
warp or split across 32 warps, ``kernels/mvcc_validate/ref.py``) against
the plain version, the JAX ``repro.core.mvcc.validate`` and the JAX Pallas
kernel (interpret mode), at block sizes around the chunk borders and on
hand-made blocks (``kernels/mvcc_validate/cases.py``); bit-equal. Blocks
past 32 chunks are in ``test_torch_validate_tiled.py``.

Endorsement MAC (K1): one call a block with ``step`` rows a step. The
committer's serial, tiled and whole-block checks and the serial orderer's
admission against the JAX ``lax.scan`` paths on the same numpy inputs;
bit-equal. The kernels themselves are held against the plain versions on a
card in ``test_torch_cuda_validate.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import committer as jcm, crypto as jc, mvcc as jm
from repro.core import orderer as jo, types as jt
from repro.kernels.mvcc_validate import kernel as jmvk
from repro_torch.core import committer as tcm, crypto as tc, orderer as to
from repro_torch.core import types as tt, u32, unmarshal as tu
from repro_torch.kernels.mvcc_validate import cases, ref as mv_ref
from repro_torch.kernels.sig_mac import ops as mac_ops


def T(a):
    return u32.from_numpy(np.asarray(a), "cpu")


def _torch_inputs(rk, rv, wk, cur, ok0):
    return [T(a) for a in (rk, rv, wk, cur)] + [torch.from_numpy(ok0)]


def _jax_validate(rk, rv, wk, cur, ok0):
    b = rk.shape[0]
    jb = jt.make_transfer_batch(jt.TEST_DIMS, b)._replace(
        read_keys=jnp.asarray(rk), read_vers=jnp.asarray(rv),
        write_keys=jnp.asarray(wk))
    return np.asarray(jm.validate(jb, jnp.asarray(cur),
                                  checksum_ok=jnp.asarray(ok0)).valid), jb


def _unpack(words, b):
    """(nch, B) u32 words -> (B, B) bool, [j, i] = bit j % 32 of word
    (j // 32, i)."""
    j = np.arange(b)
    return (words[j // 32, :] >> (j % 32)[:, None] & 1).astype(bool)


# -- K4: the chunked scan ------------------------------------------------------

@pytest.mark.parametrize("b", [1, 31, 32, 33, 63, 64, 65, 100])
def test_chunked_scan_matches_ref_and_jax(b):
    ins = cases.random_block(b, seed=b)
    t_ins = _torch_inputs(*ins)
    want, jb = _jax_validate(*ins)
    for route in ("cta", "tiled"):
        got = mv_ref.validate_chunked(*t_ins, route=route)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=route)
    np.testing.assert_array_equal(mv_ref.validate_ref(*t_ins).numpy(), want)
    # The conflict words hold the strict lower triangle of JAX's matrix.
    words = mv_ref.conflict_words(t_ins[0], t_ins[2]).numpy()
    assert words.shape == (-(-b // 32), b)
    assert words.min() >= 0 and words.max() < 1 << 32
    conf = np.asarray(jm.conflict_matrix(jb))
    np.testing.assert_array_equal(_unpack(words, b),
                                  np.triu(conf, k=1))
    if b >= 64:
        assert 0 < want.sum() < b


@pytest.mark.parametrize("b", [1023, 1024])
def test_chunked_scan_matches_ref_at_full_chunks(b):
    t_ins = _torch_inputs(*cases.random_block(b, seed=b, n_accounts=400))
    want = mv_ref.validate_ref(*t_ins)
    for route in ("cta", "tiled"):
        assert torch.equal(mv_ref.validate_chunked(*t_ins, route=route),
                           want), route
    assert 0 < int(want.sum()) < b


def test_chunked_scan_matches_pallas():
    ins = cases.random_block(100, seed=7)
    got = mv_ref.validate_chunked(*_torch_inputs(*ins))
    pallas = jmvk.validate_blocks(*(jnp.asarray(a)[None] for a in ins),
                                  interpret=True)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_chunked_scan_hand_made_blocks(name):
    ins, want = cases.CASES[name]()
    t_ins = _torch_inputs(*ins)
    for route in ("cta", "tiled"):
        np.testing.assert_array_equal(
            mv_ref.validate_chunked(*t_ins, route=route).numpy(), want,
            err_msg=route)
    np.testing.assert_array_equal(mv_ref.validate_ref(*t_ins).numpy(), want)
    np.testing.assert_array_equal(_jax_validate(*ins)[0], want)


# -- K1: one launch a block, ordered steps ---------------------------------------

def _blocks(b=37):
    """The same block in both packages, endorsed, three tags corrupted."""
    jb = jt.make_transfer_batch(jt.TEST_DIMS, b, seed=11)
    tb = tt.make_transfer_batch(tt.TEST_DIMS, b, seed=11, device="cpu")
    tags = u32.to_numpy(tc.endorse_batch(tb)).copy()
    tags[[0, 16, b - 1], [1, 0, 2]] ^= 1
    return (jb._replace(endorse_tags=jnp.asarray(tags)),
            tb._replace(endorse_tags=T(tags)))


@pytest.mark.parametrize("parallel,tx_par", [(False, 0), (True, 16),
                                             (True, 5), (True, 0)],
                         ids=["serial", "tiled16", "tiled5", "whole"])
def test_verify_endorsements_match_jax_scan(parallel, tx_par):
    jb, tb = _blocks()
    want = np.asarray(jcm._verify_endorsements(jb, parallel, tx_par))
    got = tcm._verify_endorsements(tb, parallel, tx_par)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((~want).sum()) == 3


def test_serial_admission_matches_jax_scan():
    """The serial orderer's stamps and auth_ok (one MAC call a round, one
    proposal a step) against the reference's scan of one-proposal
    admissions; then the whole serial round."""
    n = 200
    jb = jt.make_transfer_batch(jt.TEST_DIMS, n, seed=6)
    tb = tt.make_transfer_batch(tt.TEST_DIMS, n, seed=6, device="cpu")
    clients = np.arange(n, dtype=np.uint32) * np.uint32(0x01F00001)

    def step(_, x):  # repro/core/orderer.py's serial admission
        st, ok = jo._admission(x[0][None], x[1][None])
        return None, (st[0], ok[0])

    _, (j_stamp, j_ok) = jax.lax.scan(step, None,
                                      (jb.tx_id, jnp.asarray(clients)))
    stamp, auth_ok = to._admission(tb.tx_id, T(clients), step=1)
    np.testing.assert_array_equal(u32.to_numpy(stamp), np.asarray(j_stamp))
    np.testing.assert_array_equal(auth_ok.numpy(), np.asarray(j_ok))
    assert 0 < int(auth_ok.sum()) < n
    wire = tu.marshal(tb, tt.TEST_DIMS)
    head = np.array([9, 0x80000001], np.uint32)
    got = to.order_batch(wire, tb.tx_id, T(clients), T(head),
                         to.OrdererConfig(True, False, 100))
    want = jo.order_batch(jnp.asarray(wire.numpy()), jb.tx_id,
                          jnp.asarray(clients), jnp.asarray(head),
                          jo.OrdererConfig(True, False, 100))
    for name in jo.OrderedBlocks._fields:
        np.testing.assert_array_equal(u32.to_numpy(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)


def test_mac_step_is_schedule_only():
    """Every ``step`` gives the JAX package's tags; the endorser keys are
    derived once per (NE, device); a step below 1 is refused; an empty
    batch has no tags."""
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 1 << 32, (23, 4), dtype=np.uint32)
    r, s = tc.endorser_keys(3, "cpu")
    assert tc.endorser_keys(3, "cpu")[0] is r
    jr, js = jc.endorser_keys(3)
    want = np.stack([np.asarray(jc.poly_mac(jnp.asarray(msg), jr[e], js[e]))
                     for e in range(3)], axis=1)
    for step in (None, 1, 5, 22, 23, 100):
        np.testing.assert_array_equal(
            u32.to_numpy(mac_ops.mac_many(T(msg), r, s, step)), want)
    with pytest.raises(ValueError, match="step"):
        mac_ops.mac_many(T(msg), r, s, 0)
    assert mac_ops.mac_many(T(msg[:0]), r, s).shape == (0, 3)
    assert mac_ops.launches == 0
