"""Fixed-shape transaction types (port of repro.core.types).

A block of transactions is a struct of rectangular u32 tensors (int32
storage, see :mod:`repro_torch.core.u32`); sentinel keys mark unused slots.
Sizes live in :class:`FabricDims`; the wire format in
:mod:`repro_torch.core.unmarshal`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hashing, u32


@dataclasses.dataclass(frozen=True)
class FabricDims:
    """Static shape parameters of the transaction format.

    Attributes:
      rk: read-set slots per transaction.
      wk: write-set slots per transaction.
      vw: u32 value words per write (value width).
      ne: endorsement slots per transaction.
      payload_words: u32 words per marshaled transaction on the wire,
        opaque application payload included (the paper's 2.9 KB
        transaction is 736 words).
    """

    rk: int = 2
    wk: int = 2
    vw: int = 4
    ne: int = 3
    payload_words: int = 64

    @property
    def struct_words(self) -> int:
        """Words of structured data per tx (header + rw sets + tags)."""
        return 4 + 3 * self.rk + (2 + self.vw) * self.wk + self.ne

    def __post_init__(self):
        if self.payload_words < self.struct_words:
            raise ValueError(
                f"payload_words={self.payload_words} < struct_words="
                f"{self.struct_words}; the wire must hold the structured part"
            )


# The paper's experiments use 2.9 KB payloads.
PAPER_DIMS = FabricDims(rk=2, wk=2, vw=4, ne=3, payload_words=736)
# Small dims for tests.
TEST_DIMS = FabricDims(rk=2, wk=2, vw=4, ne=3, payload_words=32)


class TxBatch(NamedTuple):
    """B structured (unmarshaled) transactions, all u32 words.

    A key of (0, _) is an empty slot. ``read_vers`` is the version the
    endorser observed; MVCC validation checks it against the world state.
    """

    tx_id: torch.Tensor  # (B, 2)
    client: torch.Tensor  # (B,)
    channel: torch.Tensor  # (B,)
    read_keys: torch.Tensor  # (B, RK, 2)
    read_vers: torch.Tensor  # (B, RK)
    write_keys: torch.Tensor  # (B, WK, 2)
    write_vals: torch.Tensor  # (B, WK, VW)
    endorse_tags: torch.Tensor  # (B, NE)

    @property
    def batch(self) -> int:
        return self.tx_id.shape[0]


def message_words(txb: TxBatch) -> torch.Tensor:
    """The per-tx words the endorsement MACs cover: header + rw sets.

    (B, 4 + 3*RK + (2+VW)*WK) contiguous; the tags are excluded.
    """
    b = txb.batch
    parts = (txb.tx_id, txb.client, txb.channel, txb.read_keys,
             txb.read_vers, txb.write_keys, txb.write_vals)
    return torch.cat([p.reshape(b, -1) for p in parts], dim=1)


def tx_body_hash(txb: TxBatch) -> torch.Tensor:
    """Content hash of a transaction batch, (B, 2) paired."""
    msg = message_words(txb)
    return torch.stack([hashing.hash_words(msg, seed=hashing.SEED_A),
                        hashing.hash_words(msg, seed=hashing.SEED_B)], -1)


def make_transfer_batch(
    dims: FabricDims,
    batch: int,
    *,
    seed: int = 0,
    n_accounts: int = 1 << 16,
    conflict_rate: float = 0.0,
    versions: torch.Tensor | None = None,
    device=None,
) -> TxBatch:
    """B money-transfer transactions (read 2 accounts, write both), drawn
    from numpy's generator exactly as the JAX package draws them.

    ``conflict_rate=0`` gives disjoint account pairs; otherwise the first
    ``batch * conflict_rate`` transactions share one hot account.
    ``versions``: optional (B, RK) expected versions (default zeros).
    ``device``: default the card; without one this raises unless
    ``device='cpu'``.
    """
    if dims.rk < 2 or dims.wk < 2:
        raise ValueError("transfer workload needs rk>=2 and wk>=2")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if conflict_rate > 0.0:
        src = rng.integers(0, n_accounts, size=batch, dtype=np.uint32)
        dst = rng.integers(0, n_accounts, size=batch, dtype=np.uint32)
        n_conf = int(batch * conflict_rate)
        if n_conf:
            src[:n_conf] = 7
    else:
        base = rng.integers(0, 1 << 20, dtype=np.uint32)
        src = (np.arange(batch, dtype=np.uint32) * 2 + base).astype(np.uint32)
        dst = src + 1

    def paired(accounts):
        h1, h2 = hashing.hash_pair(u32.from_numpy(accounts, device))
        return torch.stack([hashing.nonzero_key(h1), h2], dim=-1)

    read_keys = torch.zeros((batch, dims.rk, 2), dtype=u32.WORD,
                            device=device)
    read_keys[:, 0] = paired(src)
    read_keys[:, 1] = paired(dst)
    write_keys = torch.zeros((batch, dims.wk, 2), dtype=u32.WORD,
                             device=device)
    write_keys[:, :2] = read_keys[:, :2]
    if versions is None:
        read_vers = torch.zeros((batch, dims.rk), dtype=u32.WORD,
                                device=device)
    else:
        read_vers = versions.to(device=device, dtype=u32.WORD)
    amounts = u32.from_numpy(
        rng.integers(1, 1000, size=(batch, dims.wk, dims.vw),
                     dtype=np.uint32), device)
    ids = u32.add(torch.arange(batch, dtype=u32.WORD, device=device),
                  seed * 7919)
    tx_id = torch.stack(hashing.hash_pair(ids), dim=-1)
    client = u32.from_numpy(
        rng.integers(0, 64, size=batch, dtype=np.uint32), device)
    return TxBatch(
        tx_id=tx_id,
        client=client,
        channel=torch.zeros((batch,), dtype=u32.WORD, device=device),
        read_keys=read_keys,
        read_vers=read_vers,
        write_keys=write_keys,
        write_vals=amounts,
        endorse_tags=torch.zeros((batch, dims.ne), dtype=u32.WORD,
                                 device=device),
    )
