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
