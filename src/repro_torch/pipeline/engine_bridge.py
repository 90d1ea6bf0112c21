"""The engine's window committer on one device (port of
repro.pipeline.engine_bridge, one channel).

``FabricEngine(cfg, window_committer=WindowCommitter(...))`` orders each
round as before, slices it into windows of ``pipeline_depth`` blocks and
hands each to :meth:`WindowCommitter.commit_window`, which runs the fabric
step on the window (launch/fabric_step: one endorsement launch, one probe
and one fused commit for D blocks) and returns what the storage role needs
per block: the validity bits and the store-chain hashes
(:func:`_chain_hashes`). A round's tail shorter than the depth runs as one
shallower window; a window of one block takes the depth-1 step.

The committer owns the peer's table and heads (a ``FabricMeshState`` with
one channel); the engine reads the state, digests, heads and overflow bits
through it, and resizes through :meth:`WindowCommitter.resize` between
windows. Several channels and bucket-sharded state are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch import resolve_device
from repro_torch.core import ledger, types, u32
from repro_torch.core import world_state as ws
from repro_torch.launch import fabric_step as fs
from repro_torch.launch import state_sharding


class ReanchorInfo(NamedTuple):
    """What one resize epoch commits to the journal: the boundary block,
    the layout change, the new table's digest-tree head and the sticky
    overflow bitmask."""

    block_no: int  # last committed block: the resize lands after it
    old_n_buckets: int
    new_n_buckets: int
    n_shards: int
    tree_head: np.ndarray  # (2,) u32
    overflow_bits: int
    channel: int = 0


class WindowResult(NamedTuple):
    """Per-block outputs of one committed window, block-major."""

    valid: torch.Tensor  # (D, B) bool, ingest order
    prev_hash: np.ndarray  # (D, 2) u32 store-chain prev of each block
    block_hash: np.ndarray  # (D, 2) u32 store-chain hash of each block


def _chain_hashes(prev_hash: torch.Tensor, block_no0: torch.Tensor,
                  wire: torch.Tensor, valid: torch.Tensor):
    """Store-chain hashes of a window, from each block's wire (D, B, WB)
    and validity bits (D, B) in ingest order and the first block's number:
    (prevs (D, 2), hashes (D, 2)). The body digests of all D blocks are
    hashed at once; the links then follow in order."""
    digests = ledger.block_body_digest(wire, valid)  # (D, 2)
    prevs, hashes = [], []
    for k in range(wire.shape[0]):
        prevs.append(prev_hash)
        prev_hash = ledger.append_hash(prev_hash, u32.add(block_no0, k),
                                       digests[k])
        hashes.append(prev_hash)
    return torch.stack(prevs), torch.stack(hashes)


class WindowCommitter:
    """The committer role backed by the windowed fabric step: one channel,
    one device (default: the card; raises without one unless
    ``device='cpu'``)."""

    n_channels = 1
    n_shards = 1  # the table is one bucket shard

    def __init__(self, dims: types.FabricDims, cfg: fs.FabricStepConfig, *,
                 n_buckets: int = 1 << 12, slots: int = 8, device=None):
        if cfg.shard_state:
            raise ValueError("shard_state=True: sharded state "
                             + fs._NOT_PORTED)
        self.dims = dims
        self.cfg = cfg
        self.slots = slots
        self.device = resolve_device(device)
        self.state = fs.create_mesh_state(1, dims, n_buckets, slots,
                                          device=self.device)
        self.prev_hash = torch.zeros((2,), dtype=u32.WORD,
                                     device=self.device)
        self._steps: dict = {}
        self.obs = obs_mod.Obs.disabled()

    def attach_obs(self, obs) -> None:
        """Route window spans and metrics through ``obs``. Per window:
        ``window.fill`` covers the step's launches and the chain hashes
        (host enqueue), ``window.steady`` ends on a device sync, and
        ``window.drain`` covers the host copy of the chain hashes."""
        self.obs = obs

    @property
    def depth(self) -> int:
        return max(self.cfg.pipeline_depth, 1)

    @property
    def n_buckets(self) -> int:
        return self.state.keys.shape[1]

    def _step_for(self, d: int):
        if d not in self._steps:
            self._steps[d] = fs.make_fabric_step(
                self.dims, dataclasses.replace(self.cfg, pipeline_depth=d))
        return self._steps[d]

    def commit_window(self, wire: torch.Tensor, tx_ids: torch.Tensor
                      ) -> WindowResult:
        """Commit ``wire`` (D, B, WB) / ``tx_ids`` (D, B, 2), 1 <= D <=
        depth, in block order."""
        d = wire.shape[0]
        if not 1 <= d <= self.depth:
            raise ValueError(f"a window holds 1 to {self.depth} blocks, "
                             f"got {d}")
        tracer, reg = self.obs.tracer, self.obs.registry
        t0 = time.perf_counter()
        with tracer.span("window.fill", depth=d):
            step = self._step_for(d)
            if d == 1:
                self.state, valid = step(self.state, wire, tx_ids)
            else:
                self.state, valid = step(self.state, wire[None],
                                         tx_ids[None])
            valid = valid.reshape(d, -1)
            bno0 = u32.sub(self.state.block_no[0], d)
            prevs, hashes = _chain_hashes(self.prev_hash, bno0, wire, valid)
            self.prev_hash = hashes[-1]
        with tracer.span("window.steady", depth=d,
                         sync=lambda: self.state.ledger_head):
            pass  # the device finishes the window inside this span
        with tracer.span("window.drain", depth=d):
            prevs, hashes = u32.to_numpy(prevs), u32.to_numpy(hashes)
        # Blocks of a window retire together: the per-block latency is the
        # window's, amortized.
        dt = (time.perf_counter() - t0) / d
        hist = reg.histogram("commit.latency")
        for _ in range(d):
            hist.record(dt)
        reg.counter("window.commits").inc()
        reg.counter("blocks.committed").inc(d)
        return WindowResult(valid=valid, prev_hash=prevs, block_hash=hashes)

    # -- elastic state ---------------------------------------------------------

    def resize(self, new_n_buckets: int, channel: int = 0) -> ReanchorInfo:
        """Halve or double the table between windows (nothing is in flight:
        the window write log assumes one layout a window) and latch any
        shrink overflow; returns the epoch's :class:`ReanchorInfo`."""
        self._check_channel(channel)
        old_nb = self.n_buckets
        if new_n_buckets == old_nb:
            raise ValueError(f"resize to current size {old_nb}")
        res = ws.resize(self.hash_state(), new_n_buckets)
        self.state = self.state._replace(
            keys=res.state.keys[None], versions=res.state.versions[None],
            values=res.state.values[None],
            overflow=self.state.overflow
            | state_sharding.overflow_bits(res.overflow[None]))
        info = ReanchorInfo(
            block_no=self.block_no_for(0) - 1, old_n_buckets=old_nb,
            new_n_buckets=new_n_buckets, n_shards=self.n_shards,
            tree_head=self.tree_head(), overflow_bits=self.overflow_bits,
            channel=channel)
        self.obs.tracer.event(
            "reanchor.epoch", block_no=info.block_no, channel=channel,
            old_n_buckets=old_nb, new_n_buckets=new_n_buckets,
            overflow_bits=info.overflow_bits)
        return info

    def shard_stats(self, channels=(0,)) -> dict:
        """channel -> (per-shard occupancy (M,), min free slots, per-shard
        slot capacity, sticky overflow bits), in one stacked read."""
        for c in channels:
            self._check_channel(c)
        st = self.hash_state()
        m = self.n_shards
        host = torch.cat([ws.shard_occupancy(st, m), ws.shard_min_free(st, m),
                          u32.to_u64(self.state.overflow[0])]).cpu().numpy()
        stats = (host[:m], int(host[m:2 * m].min()),
                 self.n_buckets // m * self.slots,
                 state_sharding.bits_to_int(host[2 * m:]))
        return {c: stats for c in channels}

    def hot_shard(self, channel: int = 0) -> int:
        """The shard a grow should relieve: the first overflowed one, else
        the fullest."""
        self._check_channel(channel)
        return ws.hot_shard(self.overflow_bits, ws.shard_occupancy(
            self.hash_state(), self.n_shards))

    # -- state accessors -------------------------------------------------------

    def _check_channel(self, channel: int) -> None:
        if channel != 0:
            raise ValueError(f"channel {channel} out of range for 1 channel")

    def hash_state(self, channel: int = 0) -> ws.HashState:
        """The committed table (views of the live tensors)."""
        self._check_channel(channel)
        return ws.HashState(self.state.keys[0], self.state.versions[0],
                            self.state.values[0])

    def state_digest(self, channel: int = 0) -> np.ndarray:
        return u32.to_numpy(ws.state_digest(self.hash_state(channel)))

    def tree_head(self, channel: int = 0) -> np.ndarray:
        """(2,) u32 digest-tree head of the table's shards."""
        return u32.to_numpy(ws.tree_head(self.hash_state(channel),
                                         self.n_shards))

    @property
    def journal_head(self) -> np.ndarray:
        return self.journal_head_for(0)

    def journal_head_for(self, channel: int) -> np.ndarray:
        self._check_channel(channel)
        return u32.to_numpy(self.state.journal_head[0])

    def ledger_head_for(self, channel: int) -> np.ndarray:
        self._check_channel(channel)
        return u32.to_numpy(self.state.ledger_head[0])

    def block_no_for(self, channel: int) -> int:
        self._check_channel(channel)
        return int(u32.to_numpy(self.state.block_no[0]))

    @property
    def overflow(self) -> bool:
        """Sticky: some commit dropped a write on a full bucket."""
        return bool(self.state.overflow.any())

    @property
    def overflow_bits(self) -> int:
        """The sticky per-shard bitmask as one int (bit 0: the table)."""
        return self.overflow_bits_for(0)

    def overflow_bits_for(self, channel: int) -> int:
        self._check_channel(channel)
        return state_sharding.bits_to_int(self.state.overflow[0])

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
