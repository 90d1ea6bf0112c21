"""Endorsement MACs: Carter-Wegman polynomial MAC over the Mersenne prime
2^31 - 1 (port of repro.core.crypto).

The paper verifies every transaction's endorsement signatures on the
critical path; the JAX package substitutes a per-endorser polynomial MAC,
``tag_e = s_e + sum_i m_i * r_e^(W-i) mod p``, and so does the port. Tags
come from the MAC kernel (kernels/sig_mac), one launch for all endorsers;
the field arithmetic is that kernel's plain version.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import resolve_device
from repro_torch.core import hashing, types, u32
from repro_torch.kernels.sig_mac import ops as mac_ops
from repro_torch.kernels.sig_mac.ref import P31, addmod31, mod31, mulmod31

__all__ = ["P31", "mod31", "addmod31", "mulmod31", "endorser_keys",
           "poly_mac", "endorse_batch", "verify_tags"]


def endorser_keys(n_endorsers: int, device=None):
    """(r, s) MAC keys of each endorser: two (NE,) u32 tensors in [1, p),
    on ``device`` (default: the card). The keys are constants, derived once
    per (NE, device) and cached: every call returns the same two tensors,
    and no caller writes into them."""
    return _keys(n_endorsers, resolve_device(device))


@functools.cache
def _keys(n_endorsers: int, device: torch.device):
    e = torch.arange(n_endorsers, dtype=u32.WORD, device=device)
    r = mod31(hashing.hash_u32(e, seed=0x1234ABCD))
    s = mod31(hashing.hash_u32(e, seed=0xFEED5EED))
    return r.clamp_min(1), s.clamp_min(1)


def poly_mac(words: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
             step: int | None = None) -> torch.Tensor:
    """MAC of (B, W) u32 messages under one key (r, s). (B,) in [0, p).
    ``step`` rows a step on the card (default all; see mac_ops.mac_many)."""
    return mac_ops.mac_many(words, r.reshape(1), s.reshape(1), step)[:, 0]


def endorse_batch(txb: types.TxBatch, n_endorsers: int | None = None,
                  step: int | None = None) -> torch.Tensor:
    """Endorsement tags (B, NE) of a batch (the endorsers' side), ``step``
    rows a step on the card."""
    ne = n_endorsers or txb.endorse_tags.shape[1]
    r, s = endorser_keys(ne, device=txb.tx_id.device)
    return mac_ops.mac_many(types.message_words(txb), r, s, step)


def verify_tags(txb: types.TxBatch, step: int | None = None
                ) -> torch.Tensor:
    """All-of endorsement policy: every tag must verify. (B,) bool. One
    MAC launch, ``step`` transactions a step on the card (default all),
    then the compare and the reduction."""
    return (endorse_batch(txb, step=step) == txb.endorse_tags).all(dim=1)
