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


def validate_blocks_ref(read_keys, read_vers, write_keys, current_versions,
                        ok0):
    """NB independent blocks, (NB,B,RK,2),(NB,B,RK),(NB,B,WK,2),(NB,B,RK),
    (NB,B) bool -> valid (NB,B) bool: :func:`validate_ref` a block."""
    valid = torch.zeros_like(ok0)
    for n in range(ok0.shape[0]):
        valid[n] = validate_ref(read_keys[n], read_vers[n], write_keys[n],
                                current_versions[n], ok0[n])
    return valid


# -- a plain mirror of the kernel's two routes (tests only) --------------------

UNWRITTEN = 0xFFFFFFFF  # the tiled route's scratch words that it never writes


def conflict_words(read_keys, write_keys, *, tiled: bool = False
                   ) -> torch.Tensor:
    """Phase 1 of the kernel: the strict lower triangle of the conflict
    matrix as bit words, (ceil(B/32), B) int64 holding u32 values with
    ``words[k, i]`` bit t = conf[32k+t, i] for 32k+t < i. ``tiled``: as the
    tiled route leaves its scratch buffer, every word with i < 32k (which
    no scan reads) set to :data:`UNWRITTEN`."""
    b = read_keys.shape[0]
    nch = -(-b // 32)
    conf = conflict_matrix(read_keys, write_keys)
    j = torch.arange(b, device=conf.device)
    conf = conf & (j[:, None] < j[None, :])  # clear j >= i, the diagonal
    conf = torch.cat([conf, conf.new_zeros((nch * 32 - b, b))])
    bits = conf.reshape(nch, 32, b).long() << torch.arange(
        32, device=conf.device)[None, :, None]
    words = bits.sum(dim=1)
    if tiled:
        k = torch.arange(nch, device=conf.device)
        words[j[None, :] < 32 * k[:, None]] = UNWRITTEN
    return words


def _chain(cand: int, diag: list) -> int:
    """The chain inside one chunk as the kernel runs it: ``v <- {t :
    candidate t and not diag[t] & v}`` from v = the candidates until v
    stops changing (at most 33 rounds)."""
    v = cand
    for _ in range(33):
        nv = sum(1 << t for t, d in enumerate(diag)
                 if cand >> t & 1 and not d & v)
        if nv == v:
            return v
        v = nv
    raise AssertionError("the chunk's chain did not settle")


def scan_chunks(words: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Phase 2 of the one-CTA route, one 32-tx chunk at a time, for any
    number of chunks: a tx is a candidate when it is ok and no valid tx of
    an earlier chunk conflicts with it (the OR of ``words[k, i] & V[k]``
    over k < c); then the chain inside the chunk (:func:`_chain`). (B,)
    bool."""
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
        v_words.append(_chain(cand, [w[c][i] for _, i in lanes]))
    return _bits(v_words, b, ok.device)


def _bits(v_words: list, b: int, device) -> torch.Tensor:
    """Valid words -> (B,) bool, bit t of word k being tx 32k+t."""
    return torch.tensor([bool(v_words[i // 32] >> (i % 32) & 1)
                         for i in range(b)], dtype=torch.bool, device=device)


def scan_split(words: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Phase 2 of the tiled route, as its one CTA of 32 warps runs it:
    chunk c's cross-chunk OR is the OR of 32 partial words, warp w's over
    k = w, w+32, ... < c, each computed one chunk ahead over k < c - 1 and
    completed by warp (c-1) % 32's term for k = c - 1 once V[c-1] is known;
    then the chain inside the chunk. Reads only the words with i >= 32k.
    Same verdicts as :func:`scan_chunks`. (B,) bool."""
    b = ok.shape[0]
    nch = len(words)
    w = words.tolist()
    ok_l = ok.tolist()
    part = [[0] * 32 for _ in range(32)]  # [warp][lane], for the next chunk
    v_words = []
    for c in range(nch):
        lanes = range(32 * c, min(32 * c + 32, b))
        cand = 0
        for t, i in enumerate(lanes):
            blocked = 0
            for warp in range(32):
                blocked |= part[warp][t]
            if ok_l[i] and not blocked:
                cand |= 1 << t
        v = _chain(cand, [w[c][i] for i in lanes])
        v_words.append(v)
        for warp in range(32):
            for t in range(32):
                i = 32 * (c + 1) + t
                acc = 0
                if c + 1 < nch and i < b:
                    for k in range(warp, c, 32):
                        acc |= w[k][i] & v_words[k]
                    if warp == c % 32:
                        acc |= w[c][i] & v
                part[warp][t] = acc
    return _bits(v_words, b, ok.device)


def validate_chunked(read_keys, read_vers, write_keys, current_versions,
                     ok0, *, route: str = "cta"):
    """The kernel's schedule in plain PyTorch, by ``route`` ("cta" or
    "tiled"): freshness, conflict words, chunked scan. Same function as
    :func:`validate_ref`."""
    ok = ok0 & read_fresh(read_keys, read_vers, current_versions)
    if route == "cta":
        return scan_chunks(conflict_words(read_keys, write_keys), ok)
    return scan_split(conflict_words(read_keys, write_keys, tiled=True), ok)
