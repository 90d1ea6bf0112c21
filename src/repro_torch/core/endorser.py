"""Endorser role: speculative chaincode execution + endorsement tags (port of
repro.core.endorser).

Endorsers execute a client's transaction against their replica of world
state, record the read/write sets with the versions they observed, and tag
the result. Under FastFabric they no longer validate: they apply the deltas
of validated blocks to their replica.

The chaincode is the paper's money transfer: read two accounts, write both
(word 0 of a value is the balance, word 1 carries an asset tag).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import crypto, hashing, types, u32
from repro_torch.core import world_state as ws


class Proposal(NamedTuple):
    """Client proposals for the transfer chaincode, (B,) u32 each."""

    src: torch.Tensor  # account ids
    dst: torch.Tensor
    amount: torch.Tensor
    client: torch.Tensor
    nonce: torch.Tensor  # makes tx ids unique


def _account_key(acct: torch.Tensor) -> torch.Tensor:
    h1, h2 = hashing.hash_pair(acct)
    return torch.stack([hashing.nonzero_key(h1), h2], dim=-1)  # (B, 2)


def execute_and_endorse(state: ws.HashState, prop: Proposal,
                        dims: types.FabricDims, *,
                        n_endorsers: int | None = None) -> types.TxBatch:
    """Execute the transfer chaincode on the replica and endorse the result.

    Reads the src/dst balances, computes the balances after the transfer
    (wrapping, from empty accounts too: validity is about versions, not
    business rules) and records the read versions as observed.
    """
    if dims.rk < 2 or dims.wk < 2:
        raise ValueError("transfer chaincode needs rk>=2, wk>=2")
    b = prop.src.shape[0]
    dev = prop.src.device
    k_src = _account_key(prop.src)
    k_dst = _account_key(prop.dst)
    look_src = ws.lookup(state, k_src)
    look_dst = ws.lookup(state, k_dst)
    z = lambda *shape: torch.zeros(shape, dtype=u32.WORD, device=dev)

    read_keys = z(b, dims.rk, 2)
    read_keys[:, 0] = k_src
    read_keys[:, 1] = k_dst
    read_vers = z(b, dims.rk)
    read_vers[:, 0] = look_src.versions
    read_vers[:, 1] = look_dst.versions
    write_vals = z(b, dims.wk, dims.vw)
    write_vals[:, 0, 0] = u32.sub(look_src.values[:, 0], prop.amount)
    write_vals[:, 1, 0] = u32.add(look_dst.values[:, 0], prop.amount)
    if dims.vw > 1:
        write_vals[:, 0, 1] = prop.src
        write_vals[:, 1, 1] = prop.dst

    tx_id = torch.stack(hashing.hash_pair(
        hashing.hash_u32(prop.nonce) ^ prop.src ^ u32.mul(prop.dst, 3)), -1)
    txb = types.TxBatch(
        tx_id=tx_id,
        client=prop.client,
        channel=z(b),
        read_keys=read_keys,
        read_vers=read_vers,
        write_keys=read_keys[:, :dims.wk],
        write_vals=write_vals,
        endorse_tags=z(b, dims.ne),
    )
    tags = crypto.endorse_batch(txb, n_endorsers or dims.ne)
    return txb._replace(endorse_tags=tags)


def apply_validated(state: ws.HashState, txb: types.TxBatch,
                    valid: torch.Tensor) -> ws.HashState:
    """Endorser replica update: apply a validated block's deltas without
    re-validating (in place, see world_state)."""
    return ws.commit_vectorized(state, txb.write_keys, txb.write_vals,
                                valid).state
