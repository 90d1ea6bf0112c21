"""Plain PyTorch versions of the hash-table kernels: the probe and the
sequential commit.

The probe is repro.core.world_state.lookup: each (Q, 2) paired key is
compared against every slot of its bucket row (bucket = k0 & (NB-1)); the
first matching slot gives found/version/values/slot, and a query whose k0 is
the empty key 0 never matches. The commit is
repro.core.world_state.commit_sequential.
"""

from __future__ import annotations

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
