"""Plain PyTorch versions of the hash-table kernels: the probe and the
sequential commit.

The probe is repro.core.world_state.lookup: each (Q, 2) paired key is
compared against every slot of its bucket row (bucket = k0 & (NB-1)); the
first matching slot gives found/version/values/slot, and a query whose k0 is
the empty key 0 never matches. The commit is
repro.core.world_state.commit_sequential. Below them, plain mirrors of the
kernels' schedules, which the tests hold against the JAX package.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import u32


def lookup_ref(tkeys, tvers, tvals, queries):
    """(NB,S,2),(NB,S),(NB,S,VW),(Q,2) -> found (Q,) bool, versions (Q,),
    values (Q,VW), slots (Q,) int32 (0 when not found)."""
    nb = tkeys.shape[0]
    b = (queries[:, 0] & (nb - 1)).long()
    rows_k = tkeys[b]  # (Q, S, 2)
    match = ((rows_k[..., 0] == queries[:, None, 0])
             & (rows_k[..., 1] == queries[:, None, 1])
             & (queries[:, None, 0] != 0))
    found = match.any(dim=1)
    slot = torch.argmax(match.to(u32.WORD), dim=1)  # first True, 0 if none
    vers = torch.where(found, tvers[b, slot], 0)
    vals = torch.where(found[:, None], tvals[b, slot], 0)
    return found, vers, vals, slot.to(torch.int32)


def commit_ref(tkeys, tvers, tvals, wkeys, wvals, active):
    """Sequential insert-or-update of (K, 2) keys / (K, VW) values, write by
    write in flat order, IN PLACE on the (NB,S,2)/(NB,S)/(NB,S,VW) table, as
    repro.core.world_state.commit_sequential. Returns the overflow flag, a
    () bool: some active write found neither its key nor an empty slot.

    Write i applies when ``active[i]`` and its k0 is not the empty key: the
    first slot of bucket k0 & (NB-1) holding its key gets version + 1
    (wrapping), else the first empty slot gets the key and version 1, and
    the values are written. Tensor ops only, no host sync: the same code
    runs on a CUDA tensor, where chip_smoke.py holds the kernel against it.
    """
    nb, s, _ = tkeys.shape
    dev = wkeys.device
    keys = tkeys.view(nb * s, 2)
    vers = tvers.view(nb * s)
    vals = tvals.view(nb * s, -1)
    act = active & (wkeys[:, 0] != 0)
    # Flat slot indices of each write's bucket row, (K, S).
    rows = ((wkeys[:, 0] & (nb - 1)).long()[:, None] * s
            + torch.arange(s, device=dev))
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(wkeys.shape[0]):
        row_k = keys[rows[i]]
        nonempty = row_k[:, 0] != 0
        match = ((row_k[:, 0] == wkeys[i, 0]) & (row_k[:, 1] == wkeys[i, 1])
                 & nonempty)
        exists = match.any()
        has_empty = (~nonempty).any()
        pick = torch.where(exists, match.to(u32.WORD).argmax(),
                           (~nonempty).to(u32.WORD).argmax())
        slot = rows[i][pick].reshape(1)
        ok = act[i] & (exists | has_empty)
        ovf = ovf | (act[i] & ~exists & ~has_empty)
        old_ver = vers[slot]
        new_ver = torch.where(exists, u32.add(old_ver, 1), 1)
        keys[slot] = torch.where(ok, wkeys[i], keys[slot])
        vers[slot] = torch.where(ok, new_ver, old_ver)
        vals[slot] = torch.where(ok, wvals[i], vals[slot])
    return ovf


# -- plain mirrors of the kernels' schedules (tests only) ----------------------


def _kernel_constants() -> dict[str, int]:
    """The integer ``constexpr`` constants of ``csrc/hash_table.cu``, read
    from the source, so that the mirrors below follow the kernel's schedule
    and cannot drift from it."""
    src = (Path(__file__).resolve().parents[1] / "csrc"
           / "hash_table.cu").read_text()
    return {m[1]: int(m[2].rstrip("uU"), 0) for m in re.finditer(
        r"constexpr\s+\w+\s+(k\w+)\s*=\s*(0x[0-9a-fA-F]+u?|\d+)\s*;",
        src)}


_K = _kernel_constants()
LOOKUP_MAX_GROUP = 32  # lanes a probe, a warp; wider rows are walked
COMMIT_THREADS = _K["kCommitThreads"]  # threads of a commit CTA
COMMIT_CAP = _K["kCap"]  # writes a commit CTA stages at a time
COMMIT_PART_WRITES = _K["kPartWrites"]  # writes a part gets, about
COMMIT_MAX_PART_BITS = _K["kMaxPartBits"]  # log2 of the most parts (CTAs)
GOLDEN = _K["kGolden"]  # the multiplicative hash of a bucket to its part


def group_lanes(s: int) -> int:
    """Lanes a query or a run: S rounded up to a power of two, at most 32."""
    g = 1
    while g < s and g < LOOKUP_MAX_GROUP:
        g *= 2
    return g


def commit_part_bits(k: int) -> int:
    """log2 of the parts (CTAs) of a commit of k writes: a power of two
    near k / 32, at most 1,024."""
    bits = 0
    while bits < COMMIT_MAX_PART_BITS and (COMMIT_PART_WRITES << bits) < k:
        bits += 1
    return bits


def lookup_grouped(tkeys, tvers, tvals, queries):
    """The probe kernel's schedule in plain PyTorch: a group of G lanes a
    query walks the row G slots at a time (once when S <= 32); the lowest
    set bit of the first segment's match ballot that has one is the hit.
    Same outputs as :func:`lookup_ref`."""
    nb, s, _ = tvals.shape
    g = group_lanes(s)
    dev = queries.device
    b = (queries[:, 0] & (nb - 1)).long()
    hit = torch.full((queries.shape[0],), -1, dtype=torch.long, device=dev)
    lane = torch.arange(g, device=dev)
    for seg in range(0, s, g):
        sl = seg + lane
        in_row = sl < s
        row = tkeys[b][:, sl.clamp(max=s - 1)]  # (Q, G, 2)
        m = (in_row & (row[..., 0] == queries[:, None, 0])
             & (row[..., 1] == queries[:, None, 1])
             & (queries[:, None, 0] != 0))
        ballot = (m.long() << lane).sum(dim=1)
        first = torch.where(ballot != 0,
                            (ballot & -ballot).float().log2().long(), 0)
        hit = torch.where((hit < 0) & (ballot != 0), seg + first, hit)
    found = hit >= 0
    slot = torch.where(found, hit, 0)
    vers = torch.where(found, tvers[b, slot], 0)
    vals = torch.where(found[:, None], tvals[b, slot], 0)
    return found, vers, vals, slot.to(torch.int32)


def commit_grouped(tkeys, tvers, tvals, wkeys, wvals, active):
    """The commit kernel's schedule (``commit_runs_kernel``) in plain
    Python, IN PLACE; same function as :func:`commit_ref`. Each part
    (a CTA) stages its applying writes in flat order, a tile of 256 at a
    time, and applies them once more than COMMIT_CAP - 256 are staged or
    the writes end: each bucket's run, from its leader, walks a copy of the
    row (the lanes' registers) with first-match / first-empty choices, and
    only the slots it took are written back, once, with the values of the
    last write each took (past 32 slots the kernel writes each slot as it
    takes it, to the same end). Returns the () bool overflow flag."""
    nb, s, vw = tvals.shape
    k = wkeys.shape[0]
    keys = u32.to_numpy(tkeys).reshape(nb, s, 2)
    vers = u32.to_numpy(tvers).reshape(nb, s)
    vals = u32.to_numpy(tvals).reshape(nb, s, vw)
    wk = u32.to_numpy(wkeys)
    wv = u32.to_numpy(wvals)
    act = active.cpu().numpy()
    bits = commit_part_bits(k)
    bkt = wk[:, 0] & (nb - 1)
    part = ((bkt.astype(np.uint64) * GOLDEN) & 0xFFFFFFFF) >> (32 - bits) \
        if bits else np.zeros(k, np.uint64)
    overflow = False

    def apply(staged):
        nonlocal overflow
        leaders = [p for p, i in enumerate(staged)
                   if all(bkt[j] != bkt[i] for j in staged[:p])]
        for p in leaders:
            run = [i for i in staged[p:] if bkt[i] == bkt[staged[p]]]
            b = bkt[staged[p]]
            rk, rv = keys[b].copy(), vers[b].copy()
            src = [-1] * s
            for i in run:
                match = [t for t in range(s)
                         if rk[t, 0] == wk[i, 0] and rk[t, 1] == wk[i, 1]]
                empty = [t for t in range(s) if rk[t, 0] == 0]
                if match:
                    t = match[0]
                    rv[t] = (int(rv[t]) + 1) & 0xFFFFFFFF
                elif empty:
                    t = empty[0]
                    rk[t] = wk[i]
                    rv[t] = 1
                else:
                    overflow = True
                    continue
                src[t] = i
            for t in range(s):
                if src[t] >= 0:
                    keys[b, t], vers[b, t] = rk[t], rv[t]
                    vals[b, t] = wv[src[t]]

    for cta in range(1 << bits):
        staged = []
        for base in range(0, k, COMMIT_THREADS):
            tile = range(base, min(base + COMMIT_THREADS, k))
            staged += [i for i in tile
                       if act[i] and wk[i, 0] != 0 and part[i] == cta]
            if (len(staged) > COMMIT_CAP - COMMIT_THREADS
                    or base + COMMIT_THREADS >= k):
                apply(staged)
                staged = []
    for t, a in ((tkeys, keys), (tvers, vers), (tvals, vals)):
        t.copy_(u32.from_numpy(a, t.device).reshape(t.shape))
    return torch.tensor(overflow, device=wkeys.device)
