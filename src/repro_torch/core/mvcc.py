"""MVCC read/write-set validation (port of repro.core.mvcc).

A transaction is valid iff (a) every key in its read set still has the
version the endorser observed, and (b) no earlier valid transaction of the
same block wrote a key it reads or writes. (a) is parallel; (b) becomes the
pairwise conflict matrix plus a B-step scan that propagates one bit per
transaction. :func:`validate` runs both through the MVCC kernel
(kernels/mvcc_validate), and :func:`validate_blocks` runs NB independent
blocks (a leading block dim) through one launch of it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import types, world_state
from repro_torch.kernels.mvcc_validate import ops as mvcc_ops
from repro_torch.kernels.mvcc_validate import ref as mvcc_ref


def conflict_matrix(txb: types.TxBatch) -> torch.Tensor:
    """conflict[j, i] = tx j's writes intersect tx i's reads | writes.
    (B, B) bool; only the strict lower triangle j < i matters."""
    return mvcc_ref.conflict_matrix(txb.read_keys, txb.write_keys)


class MvccResult(NamedTuple):
    valid: torch.Tensor  # (B,) bool


def _ok0(bsz, device, checksum_ok, endorse_ok) -> torch.Tensor:
    ok0 = torch.ones((bsz,), dtype=torch.bool, device=device)
    for flag in (checksum_ok, endorse_ok):
        if flag is not None:
            ok0 = ok0 & flag
    return ok0


def validate(
    txb: types.TxBatch,
    current_versions: torch.Tensor,
    *,
    checksum_ok: torch.Tensor | None = None,
    endorse_ok: torch.Tensor | None = None,
) -> MvccResult:
    """Full MVCC validation of one block.

    ``current_versions``: (B, RK) committed version of each read key (0 if
    absent). ``checksum_ok``/``endorse_ok`` fold the earlier stages' flags
    into validity (invalid transactions stay in the block, flagged).
    """
    rk = txb.read_keys.contiguous()
    ok0 = _ok0(txb.batch, rk.device, checksum_ok, endorse_ok)
    return MvccResult(valid=mvcc_ops.validate(
        rk, txb.read_vers.contiguous(), txb.write_keys.contiguous(),
        current_versions.contiguous(), ok0))


def validate_blocks(
    txb: types.TxBatch,
    current_versions: torch.Tensor,
    *,
    checksum_ok: torch.Tensor | None = None,
) -> MvccResult:
    """MVCC validation of NB independent blocks at once: ``txb`` fields and
    ``current_versions`` (NB, B, RK) carry a leading block dim, as does
    ``checksum_ok`` (NB, B); each block is validated on its own, in one
    kernel call. ``valid`` is (NB, B)."""
    rk = txb.read_keys.contiguous()
    nblk, bsz = rk.shape[:2]
    ok0 = torch.ones((nblk, bsz), dtype=torch.bool, device=rk.device)
    if checksum_ok is not None:
        ok0 = ok0 & checksum_ok
    return MvccResult(valid=mvcc_ops.validate_blocks(
        rk, txb.read_vers.contiguous(), txb.write_keys.contiguous(),
        current_versions.contiguous(), ok0))


def validate_sequential_reference(
    txb: types.TxBatch,
    state: world_state.HashState,
    *,
    checksum_ok: torch.Tensor | None = None,
    endorse_ok: torch.Tensor | None = None,
) -> torch.Tensor:
    """Oracle: Fabric's literal per-tx walk with an explicit update map —
    check freshness against the block-start state, check the keys written by
    earlier valid transactions, then add this one's writes if it is valid.
    (B,) bool."""
    bsz = txb.batch
    ok0 = _ok0(bsz, txb.read_keys.device, checksum_ok, endorse_ok)
    cur = world_state.lookup(state, txb.read_keys.reshape(-1, 2)
                             ).versions.reshape(bsz, -1)
    fresh = mvcc_ref.read_fresh(txb.read_keys, txb.read_vers, cur)
    dirty = txb.write_keys.new_zeros((0, 2))
    valid = []
    for i in range(bsz):
        touched = torch.cat([txb.read_keys[i], txb.write_keys[i]])
        conflict = mvcc_ref.keys_eq(dirty[:, None, :],
                                    touched[None, :, :]).any()
        v_i = bool(fresh[i] & ok0[i] & ~conflict)
        if v_i:
            dirty = torch.cat([dirty, txb.write_keys[i]])
        valid.append(v_i)
    return torch.tensor(valid, dtype=torch.bool, device=ok0.device)
