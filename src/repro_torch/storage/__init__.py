"""Authenticated state journal + snapshot storage, the durability layer
(port of repro.storage).

* :mod:`repro_torch.storage.journal`: append-only, digest-chained journal
  of per-block validated write sets;
* :mod:`repro_torch.storage.snapshot`: world-state snapshots as per-shard
  ``shard_*.npz`` files + a ``manifest_*.npz`` commitment, manifest last;
* :mod:`repro_torch.storage.recovery`: cold start from the latest snapshot
  + the journal suffix, both digest chains verified, resize re-anchor
  epochs crossed.
"""

from repro_torch.storage import journal, recovery, snapshot  # noqa: F401
