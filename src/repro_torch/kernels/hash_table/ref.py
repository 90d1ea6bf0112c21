"""Plain PyTorch version of the hash-table probe kernel.

Same function as repro.core.world_state.lookup: each (Q, 2) paired key is
compared against every slot of its bucket row (bucket = k0 & (NB-1)); the
first matching slot gives found/version/values/slot, and a query whose k0 is
the empty key 0 never matches.
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
