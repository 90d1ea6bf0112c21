"""The on-path head of the authenticated state journal (port of
``write_set_digest`` and ``update_head`` of repro.storage.journal).

The committer folds each block's validated write sets into a running (2,)
u32 head, domain-separated from the ledger chain by a tag word. The journal
itself (records, spill, recovery) is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing, u32

_JOURNAL_TAG = 0x4A524E4C  # "JRNL"


def write_set_digest(write_keys: torch.Tensor, write_vals: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Content digest of a block's write sets + validity flags, (2,) u32,
    order-dependent over transactions."""
    n = write_keys.shape[0]
    words = torch.cat([write_keys.reshape(n, -1), write_vals.reshape(n, -1)],
                      dim=1)
    d1 = hashing.hash_words(words, seed=hashing.SEED_A)  # (N,)
    d2 = hashing.hash_words(words, seed=hashing.SEED_B)
    v = valid.to(u32.WORD)
    return torch.stack([
        hashing.hash_words((d1 ^ v)[None, :], seed=hashing.SEED_A)[0],
        hashing.hash_words((d2 ^ (v << 1))[None, :], seed=hashing.SEED_B)[0],
    ])


def update_head(prev_head: torch.Tensor, block_no: torch.Tensor,
                ws_digest: torch.Tensor) -> torch.Tensor:
    """Chain: H(tag || prev || block_no || write-set digest). (2,) u32."""
    tag = u32.full((1,), _JOURNAL_TAG, prev_head.device)
    words = torch.cat([tag, prev_head, block_no.reshape(1).to(u32.WORD),
                       ws_digest])[None, :]
    return torch.stack([hashing.hash_words(words, seed=hashing.SEED_A)[0],
                        hashing.hash_words(words, seed=hashing.SEED_B)[0]])
