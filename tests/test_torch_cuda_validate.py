"""The two redesigned kernels on a card against their plain PyTorch
versions, bit-equal: MVCC validation (K4: conflict bit words, then a
scan over 32-tx chunks; one CTA, or a grid and a scan CTA) on both routes
around its chunk borders, on hand-made blocks, at other key counts and
at blocks past one CTA's shared memory; the endorsement MAC (K1) at every
``step``; and one launch for a serial block's endorsement check and a
serial round's admission. Imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_validate.py

Without a card every test here skips."""

import numpy as np
import pytest
import torch

from repro_torch.core import committer, crypto, orderer, types, u32
from repro_torch.kernels.mvcc_validate import cases, ops as mv_ops
from repro_torch.kernels.mvcc_validate import ref as mv_ref
from repro_torch.kernels.sig_mac import ops as mac_ops, ref as mac_ref

P31 = (1 << 31) - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(arrays, device):
    rk, rv, wk, cur, ok0 = arrays
    return ([u32.from_numpy(a, device) for a in (rk, rv, wk, cur)]
            + [torch.from_numpy(ok0).to(device)])


def _validate_both(arrays, cuda, route=None):
    """The kernel on ``route`` (None: by shape) and the plain version; the
    one-CTA route is one launch, the tiled route two."""
    ins = _inputs(arrays, cuda)
    b, nr, _ = ins[0].shape
    taken = route or mv_ops.route_for(b, nr, ins[2].shape[1], cuda)
    before = mv_ops.launches
    got = mv_ops.validate(*ins, route=route)
    torch.cuda.synchronize()
    assert mv_ops.launches == before + (1 if taken == "cta" else 2)
    return got.cpu(), mv_ref.validate_ref(*_inputs(arrays, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 31, 32, 33, 63, 64, 65, 100, 1023, 1024])
def test_mvcc_kernel_chunk_borders(cuda, b):
    arrays = cases.random_block(b, seed=b,
                                n_accounts=48 if b <= 100 else 400)
    for route in mv_ops.ROUTES:
        got, want = _validate_both(arrays, cuda, route)
        assert torch.equal(got, want), route
    # by size: one CTA up to 160 txs, where it is the faster route
    assert mv_ops.route_for(b, 2, 2, cuda) == ("cta" if b <= 160
                                               else "tiled")


@pytest.mark.gpu
def test_mvcc_kernel_hand_made_blocks(cuda):
    for name, make in cases.CASES.items():
        arrays, want = make()
        for route in mv_ops.ROUTES:
            got, plain = _validate_both(arrays, cuda, route)
            assert torch.equal(plain, torch.from_numpy(want)), name
            assert torch.equal(got, plain), (name, route)


@pytest.mark.gpu
@pytest.mark.parametrize("b,nr,nw", [(100, 4, 4), (1024, 4, 4),
                                     (333, 3, 1)])
def test_mvcc_kernel_other_key_counts(cuda, b, nr, nw):
    """Key counts read at run time (the paths' RK = WK = 2 is compiled
    with fixed counts): RK = WK = 4, at B = 1024 with 196,736 bytes of
    shared memory, and RK = 3, WK = 1; on both routes."""
    arrays = cases.random_block(b, seed=b + nr, nr=nr, nw=nw, n_accounts=600)
    for route in mv_ops.ROUTES:
        got, want = _validate_both(arrays, cuda, route)
        assert torch.equal(got, want), route


@pytest.mark.gpu
@pytest.mark.parametrize("b,nr,nw,route", [
    (1025, 2, 2, "tiled"), (2048, 2, 2, "tiled"), (4096, 2, 2, "tiled"),
    (1024, 8, 8, "tiled")])
def test_mvcc_kernel_takes_shapes_past_one_cta(cuda, b, nr, nw, route):
    """Shapes the kernel once refused: 33 chunks (B = 1025), also on one
    CTA, forced; conflict words past a thread block's shared memory (B =
    2048 and 4096; RK = WK = 8 at B = 1024, 262,272 bytes), where forcing
    one CTA is refused by name. Dense conflicts, against the plain
    version."""
    arrays = cases.random_block(b, seed=b + nr, nr=nr, nw=nw,
                                n_accounts=max(48, b // 3))
    assert mv_ops.route_for(b, nr, nw, cuda) == route
    got, want = _validate_both(arrays, cuda)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < b
    if mv_ops.fits_one_cta(b, nr, nw, cuda):
        got, _ = _validate_both(arrays, cuda, "cta")
        assert torch.equal(got, want)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            mv_ops.validate(*_inputs(arrays, cuda), route="cta")


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,ne", [(100, 22, 3), (1000, 3, 1),
                                    (1000, 22, 2), (3, 9000, 1)])
def test_mac_kernel_every_step(cuda, b, w, ne):
    """The verify block and a round's admission; rows over several staged
    tiles of 8,192 words; rows too long to stage."""
    rng = np.random.default_rng(b)
    msg = rng.integers(0, 1 << 32, (b, w), dtype=np.uint32)
    msg[0], msg[-1] = 0, 0xFFFFFFFF
    rs = rng.integers(0, P31, ne, dtype=np.uint32)
    ss = rng.integers(0, P31, ne, dtype=np.uint32)
    rs[0], ss[-1] = P31 - 1, 0
    args = [u32.from_numpy(a, cuda) for a in (msg, rs, ss)]
    want = mac_ref.mac_many_ref(*(a.cpu() for a in args))
    for step in (1, 5, 16, b):
        got = mac_ops.mac_many(*args, step=step)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), step


def _mac_kernel_launches(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if "mac_kernel" in ev.key)


@pytest.mark.gpu
def test_serial_checks_are_one_launch(cuda):
    """A serial block's endorsement check and a serial round's admission
    are each one ``mac_kernel`` launch, by the profiler and the count."""
    tb = types.make_transfer_batch(types.TEST_DIMS, 100, seed=3, device=cuda)
    tb = tb._replace(endorse_tags=crypto.endorse_batch(tb))
    ok = committer._verify_endorsements(tb, False, 0)  # warm-up
    assert bool(ok.all())
    before = mac_ops.launches
    assert _mac_kernel_launches(
        lambda: committer._verify_endorsements(tb, False, 0)) == 1
    clients = torch.arange(300, dtype=torch.int32, device=cuda)
    ids = torch.arange(600, dtype=torch.int32, device=cuda).reshape(300, 2)
    assert _mac_kernel_launches(
        lambda: orderer._admission(ids, clients, step=1)) == 1
    assert mac_ops.launches == before + 2
    stamp, _ = orderer._admission(ids, clients, step=1)
    assert torch.equal(stamp.cpu(),
                       orderer._admission(ids.cpu(), clients.cpu())[0])
