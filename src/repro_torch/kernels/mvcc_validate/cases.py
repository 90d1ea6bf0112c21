"""Hand-made blocks that probe the MVCC kernel's chunked scan, with the
verdicts they must get. Used by the CPU and card tests and by
``chip_smoke.py``; nothing on the engine's path imports it.

Each case is (read_keys, read_vers, write_keys, current_versions, ok0) as
numpy arrays (u32 words, ok0 bool) and the expected (B,) bool verdicts.
"""

from __future__ import annotations

import numpy as np

U32 = np.uint32


def _key(n: int) -> tuple[int, int]:
    """A non-empty key for a small integer."""
    return (n + 1) * 0x9E3779B1 % (1 << 32) or 1, 0xC0FFEE00 + n


def _block(b: int, nr: int = 2, nw: int = 2):
    rk = np.zeros((b, nr, 2), U32)
    wk = np.zeros((b, nw, 2), U32)
    rv = np.zeros((b, nr), U32)
    return rk, rv, wk, rv.copy(), np.ones(b, bool)


def chain(b: int = 100):
    """Tx i reads key i-1 and writes key i, so each tx conflicts with the
    one before it alone: valid[i] = ok0[i] & !valid[i-1]. The verdicts
    alternate, and each ok0 = False flips the parity of all that follow,
    across the chunk borders at 32, 64 and 96."""
    rk, rv, wk, cur, ok0 = _block(b)
    for i in range(b):
        rk[i, 0] = _key(i - 1) if i else (0, 0)
        wk[i, 0] = _key(i)
    ok0[[31, 32, 64, 97]] = False
    want = np.zeros(b, bool)
    for i in range(b):
        want[i] = ok0[i] and not (i and want[i - 1])
    return (rk, rv, wk, cur, ok0), want


def one_key(b: int = 100):
    """Every tx reads and writes one key; ok0 alternates from False, so tx
    1 is valid and blocks every later tx."""
    rk, rv, wk, cur, ok0 = _block(b)
    rk[:, 0] = _key(7)
    wk[:, 0] = _key(7)
    ok0[::2] = False
    want = np.zeros(b, bool)
    want[1] = True
    return (rk, rv, wk, cur, ok0), want


def write_write(b: int = 70):
    """Blind writes only (no reads) of five keys: the first ok writer of
    each key is valid, every later writer of it is not."""
    rk, rv, wk, cur, ok0 = _block(b)
    pool = np.random.default_rng(b).integers(0, 5, b)
    for i, p in enumerate(pool):
        wk[i, 1] = _key(int(p))
    ok0[[0, 40]] = False
    want = np.zeros(b, bool)
    seen = set()
    for i, p in enumerate(pool):
        want[i] = ok0[i] and p not in seen
        if want[i]:
            seen.add(p)
    return (rk, rv, wk, cur, ok0), want


def empty_keys(b: int = 65):
    """Every key is empty (first word 0) with equal second words, and the
    empty reads carry stale versions: nothing conflicts and nothing is
    stale, so valid = ok0."""
    rk, rv, wk, cur, ok0 = _block(b)
    rk[..., 1] = 5
    wk[..., 1] = 5
    cur[:] = 1
    ok0[1::3] = False
    return (rk, rv, wk, cur, ok0), ok0.copy()


def write_twice(b: int = 64):
    """Even txs write one key twice (the diagonal must not block them); odd
    txs read the key their predecessor writes, so each is blocked."""
    rk, rv, wk, cur, ok0 = _block(b)
    for i in range(b):
        if i % 2 == 0:
            wk[i, 0] = wk[i, 1] = _key(i)
        else:
            rk[i, 1] = _key(i - 1)
            wk[i, 0] = _key(1000 + i)
    want = np.arange(b) % 2 == 0
    return (rk, rv, wk, cur, ok0), want


def stale(b: int = 33):
    """Every tx reads a key whose version moved on: none is valid."""
    rk, rv, wk, cur, ok0 = _block(b)
    for i in range(b):
        rk[i, 0] = _key(i)
        wk[i, 0] = _key(i)
    rv[:, 0] = 3
    cur[:, 0] = 4
    return (rk, rv, wk, cur, ok0), np.zeros(b, bool)


CASES = {f.__name__: f for f in (chain, one_key, write_write, empty_keys,
                                  write_twice, stale)}


def random_block(b: int, seed: int, nr: int = 2, nw: int = 2,
                 n_accounts: int = 48):
    """Random transfers among few accounts, so conflicts are dense: empty
    read and write slots, some txs writing one key twice, stale reads and
    ok0 = False sprinkled in."""
    g = np.random.default_rng(seed)
    keys = np.stack([g.integers(1, 1 << 32, n_accounts, dtype=U32),
                     g.integers(0, 1 << 32, n_accounts, dtype=U32)], -1)
    rk = keys[g.integers(0, n_accounts, (b, nr))]
    wk = keys[g.integers(0, n_accounts, (b, nw))]
    wk[:, : min(nr, nw)] = np.where(g.random((b, 1, 1)) < 0.7,
                                    rk[:, : min(nr, nw)],
                                    wk[:, : min(nr, nw)])
    rk[g.random((b, nr)) < 0.08, 0] = 0
    wk[g.random((b, nw)) < 0.08, 0] = 0
    twice = g.random(b) < 0.05
    wk[twice, -1] = wk[twice, 0]
    rv = g.integers(0, 3, (b, nr)).astype(U32)
    cur = np.where(g.random((b, nr)) < 0.9, rv, rv + 1).astype(U32)
    ok0 = g.random(b) < 0.95
    return rk, rv, wk, cur, ok0
