"""The hash-table sequential commit (K3): its plain version, reached
through the wrapper on CPU tensors, against both the JAX Pallas kernel
(interpret mode) and ``commit_sequential``, the JAX engine's function;
bit-equal, overflow flag included. The CUDA kernel is held against the
plain version in test_torch_cuda.py, on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import world_state as jws
from repro.kernels.hash_table import kernel as jhtk
from repro_torch.core import world_state as tws
from repro_torch.kernels.hash_table import ops as ht_ops

from test_torch_kernels import N, T, _eq, _table


def _saturation_case(seed):
    """Writes from a tiny key pool into a table of <= 8 slots, so most cases
    overflow: duplicate active keys, interleaved drops, inactive writes and
    empty keys. K is fixed at 12 (one compile of the Pallas kernel per
    table shape)."""
    rng = np.random.default_rng(seed)
    nb, s = [1, 2, 4][seed % 3], [1, 2][seed // 3 % 2]
    k = 12
    keys = np.stack([rng.integers(1, 9, k), rng.integers(1, 5, k)],
                    axis=1).astype(np.uint32)
    keys[rng.random(k) < 0.15, 0] = 0  # empty keys never apply
    active = rng.random(k) < 0.75
    return nb, s, keys, active


def _commit_all(tk, tv, tva, wk, wv, act):
    """The port's wrapper (in place), the Pallas kernel and the engine's
    commit_sequential on the same inputs: three (keys, versions, values,
    overflow) results as numpy."""
    st = [T(a) for a in (tk, tv, tva)]
    ovf = ht_ops.commit(*st, T(wk), T(wv), torch.from_numpy(act))
    port = (*(N(t) for t in st), bool(ovf))
    j = [jnp.asarray(a) for a in (tk, tv, tva, wk, wv, act)]
    pallas = jhtk.commit(*j, interpret=True)
    core = jws.commit_sequential(jws.HashState(*j[:3]), j[3][:, None],
                                 j[4][:, None], j[5])
    as_np = lambda r: (*(np.asarray(a) for a in r[:3]), bool(r[3]))
    return port, as_np(pallas), as_np((*core.state, core.overflow))


@pytest.mark.parametrize("seed", range(12))
def test_commit_overflow_parity_to_saturation(seed):
    nb, s, wk, act = _saturation_case(seed)
    k = len(wk)
    wv = (np.arange(k, dtype=np.uint32) + 1)[:, None].repeat(2, axis=1)
    z = lambda *shape: np.zeros(shape, np.uint32)
    port, pallas, core = _commit_all(z(nb, s, 2), z(nb, s), z(nb, s, 2), wk,
                                     wv, act)
    for name, g, p, c in zip(("keys", "versions", "values", "overflow"),
                             port, pallas, core):
        np.testing.assert_array_equal(g, p, err_msg=name)
        np.testing.assert_array_equal(g, c, err_msg=name)


def test_commit_updates_inserts_and_overflow():
    """A filled table: updates (one key twice), inserts into partly filled
    and full buckets, a u32 version wrap, inactive and empty-key writes."""
    rng = np.random.default_rng(11)
    keys, vers, vals = _table(12, 64, 4, 4, 120)
    occ = np.argwhere(keys[..., 0] != 0)
    k = 200
    wk = rng.integers(1, 1 << 32, (k, 2), dtype=np.uint32)
    upd = occ[rng.integers(0, len(occ), 60)]
    wk[:60] = keys[tuple(upd.T)]
    wk[60] = wk[0]  # the same key again: applied twice
    wk[61, 0] = 0
    vers[tuple(upd[1])] = 0xFFFFFFFF  # wraps to 0
    wv = rng.integers(0, 1 << 32, (k, 4), dtype=np.uint32)
    act = rng.random(k) < 0.9
    act[[0, 1, 60]] = True
    port, pallas, core = _commit_all(keys, vers, vals, wk, wv, act)
    for name, g, p, c in zip(("keys", "versions", "values", "overflow"),
                             port, pallas, core):
        np.testing.assert_array_equal(g, p, err_msg=name)
        np.testing.assert_array_equal(g, c, err_msg=name)
    assert port[3]


def test_commit_sequential_matches_core():
    """world_state.commit_sequential on block-shaped writes (a transfer
    with src == dst writes one key twice) against the JAX engine's."""
    rng = np.random.default_rng(5)
    keys, vers, vals = _table(3, 16, 2, 4, 20)
    b = 30
    wk = rng.integers(1, 1 << 32, (b, 2, 2), dtype=np.uint32)
    wk[:5, 0] = keys[keys[..., 0] != 0][:5]
    wk[7, 1] = wk[7, 0]
    wv = rng.integers(0, 1 << 32, (b, 2, 4), dtype=np.uint32)
    active = rng.random(b) < 0.8
    active[7] = True
    st = tws.HashState(T(keys), T(vers), T(vals))
    res = tws.commit(st, T(wk), T(wv), torch.from_numpy(active),
                     sequential=True)
    want = jws.commit(
        jws.HashState(*(jnp.asarray(a) for a in (keys, vers, vals))),
        jnp.asarray(wk), jnp.asarray(wv), jnp.asarray(active),
        sequential=True)
    assert res.state is st
    for got, w in zip(res.state, want.state):
        _eq(got, w)
    assert bool(res.overflow) == bool(want.overflow)
