"""Plain PyTorch version of the MVCC validation kernel.

Same function as repro.core.mvcc.validate: read freshness, the pairwise
conflict matrix, then the B-step scan
``valid[i] = ok0[i] & fresh[i] & ~any_{j<i}(valid[j] & conf[j, i])``.
"""

from __future__ import annotations

import torch


def keys_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Paired-key equality, (..., 2) vs (..., 2); the empty key (0, *) of
    ``a`` never matches."""
    return (a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1]) & (a[..., 0] != 0)


def read_fresh(read_keys, read_vers, current_versions) -> torch.Tensor:
    """(B,) bool: every non-empty read key still has its recorded version."""
    active = read_keys[..., 0] != 0
    return (~active | (current_versions == read_vers)).all(dim=1)


def conflict_matrix(read_keys, write_keys) -> torch.Tensor:
    """conf[j, i] = tx j's writes meet tx i's reads or writes. (B, B) bool."""
    touched = torch.cat([read_keys, write_keys], dim=1)  # (B, T, 2)
    eq = keys_eq(write_keys[:, None, :, None, :],
                 touched[None, :, None, :, :])  # (j, i, WK, T)
    return eq.flatten(2).any(dim=2)


def validate_ref(read_keys, read_vers, write_keys, current_versions, ok0):
    """(B,RK,2),(B,RK),(B,WK,2),(B,RK),(B,) bool -> valid (B,) bool."""
    ok = ok0 & read_fresh(read_keys, read_vers, current_versions)
    conf = conflict_matrix(read_keys, write_keys)
    valid = torch.zeros_like(ok)
    for i in range(ok.shape[0]):
        valid[i] = ok[i] & ~(conf[:i, i] & valid[:i]).any()
    return valid


# -- a plain mirror of the kernel's two phases (tests only) --------------------

def conflict_words(read_keys, write_keys) -> torch.Tensor:
    """Phase 1 of the kernel: the strict lower triangle of the conflict
    matrix as bit words, (ceil(B/32), B) int64 holding u32 values with
    ``words[k, i]`` bit t = conf[32k+t, i] for 32k+t < i."""
    b = read_keys.shape[0]
    nch = -(-b // 32)
    conf = conflict_matrix(read_keys, write_keys)
    j = torch.arange(b, device=conf.device)
    conf = conf & (j[:, None] < j[None, :])  # clear j >= i, the diagonal
    conf = torch.cat([conf, conf.new_zeros((nch * 32 - b, b))])
    bits = conf.reshape(nch, 32, b).long() << torch.arange(
        32, device=conf.device)[None, :, None]
    return bits.sum(dim=1)


def scan_chunks(words: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Phase 2 of the kernel, one 32-tx chunk at a time: a tx is a
    candidate when it is ok and no valid tx of an earlier chunk conflicts
    with it (the OR of ``words[k, i] & V[k]`` over k < c); then the chain
    inside the chunk as the kernel runs it, ``v <- {t : candidate t and
    not words[c, i_t] & v}`` from v = the candidates until v stops
    changing (at most 33 rounds). (B,) bool."""
    b = ok.shape[0]
    w = words.tolist()
    ok_l = ok.tolist()
    v_words = []
    for c in range(len(w)):
        lanes = list(enumerate(range(32 * c, min(32 * c + 32, b))))
        cand = 0
        for t, i in lanes:
            blocked = 0
            for k in range(c):
                blocked |= w[k][i] & v_words[k]
            if ok_l[i] and not blocked:
                cand |= 1 << t
        v = cand
        for _ in range(33):
            nv = sum(1 << t for t, i in lanes
                     if cand >> t & 1 and not w[c][i] & v)
            if nv == v:
                break
            v = nv
        else:
            raise AssertionError("the chunk's chain did not settle")
        v_words.append(v)
    return torch.tensor([bool(v_words[i // 32] >> (i % 32) & 1)
                         for i in range(b)], dtype=torch.bool,
                        device=ok.device)


def validate_chunked(read_keys, read_vers, write_keys, current_versions,
                     ok0):
    """The kernel's schedule in plain PyTorch: freshness, conflict words,
    chunked scan. Same function as :func:`validate_ref`."""
    ok = ok0 & read_fresh(read_keys, read_vers, current_versions)
    return scan_chunks(conflict_words(read_keys, write_keys), ok)
