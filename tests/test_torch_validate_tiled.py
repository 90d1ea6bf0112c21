"""MVCC validation (K4) past 32 chunks, on the CPU: blocks of more than
1,024 transactions, which the kernel takes on both of its routes (one CTA
while the keys and conflict words fit its shared memory, else a grid of
conflict-word tiles and a scan CTA). The plain mirror of each route's
schedule (``kernels/mvcc_validate/ref.validate_chunked``), the plain
version and the wrapper on CPU tensors against the JAX
``repro.core.mvcc.validate`` on the same numpy inputs; bit-equal. The
kernel is held against the plain version on a card in
``test_torch_cuda_validate.py``."""

import numpy as np
import pytest

from repro_torch.kernels.mvcc_validate import cases, ops as mv_ops
from repro_torch.kernels.mvcc_validate import ref as mv_ref

from test_torch_validate_sched import _jax_validate, _torch_inputs


@pytest.mark.parametrize("b,n_accounts", [(1025, 64), (1025, 700),
                                          (2048, 96), (2048, 1500)])
def test_blocks_past_32_chunks_match_jax(b, n_accounts):
    """Conflict-heavy blocks (48 accounts a few hundred txs apart) and
    sparser ones, where valid txs spread over every chunk: both routes'
    schedules, the plain version and the wrapper against JAX."""
    ins = cases.random_block(b, seed=b + n_accounts, n_accounts=n_accounts)
    t_ins = _torch_inputs(*ins)
    want, _ = _jax_validate(*ins)
    assert 0 < want.sum() < b
    for route in ("cta", "tiled"):
        got = mv_ref.validate_chunked(*t_ins, route=route)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=route)
    np.testing.assert_array_equal(mv_ref.validate_ref(*t_ins).numpy(), want)
    np.testing.assert_array_equal(mv_ops.validate(*t_ins).numpy(), want)
    assert mv_ops.launches == 0


def test_chain_across_64_chunks_matches_jax():
    """The hand-made chain (tx i reads key i-1, writes key i) over 2,048
    txs: each verdict flips its successor's, across every chunk border."""
    ins, want = cases.chain(2048)
    np.testing.assert_array_equal(_jax_validate(*ins)[0], want)
    t_ins = _torch_inputs(*ins)
    for route in ("cta", "tiled"):
        np.testing.assert_array_equal(
            mv_ref.validate_chunked(*t_ins, route=route).numpy(), want,
            err_msg=route)


def test_tiled_words_never_read_below_the_diagonal():
    """The tiled route leaves the words with i < 32k unwritten: its scan's
    mirror reads none of them (they hold all ones here) and still gives
    the one-warp scan's verdicts."""
    t_ins = _torch_inputs(*cases.random_block(1100, seed=3, n_accounts=80))
    words = mv_ref.conflict_words(t_ins[0], t_ins[2], tiled=True)
    assert (words == mv_ref.UNWRITTEN).sum() > 0
    ok = t_ins[4] & mv_ref.read_fresh(*t_ins[:2], t_ins[3])
    want = mv_ref.scan_chunks(mv_ref.conflict_words(t_ins[0], t_ins[2]), ok)
    assert (mv_ref.scan_split(words, ok) == want).all()
