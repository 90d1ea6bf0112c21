"""The engine's window committer on one device (port of
repro.pipeline.engine_bridge).

``FabricEngine(cfg, window_committer=WindowCommitter(...))`` orders each
round as before, slices it into windows of ``pipeline_depth`` blocks and
hands each to :meth:`WindowCommitter.commit_window`, which runs the fabric
step on the window (launch/fabric_step: one endorsement launch, one probe
and one fused commit for D blocks) and returns what the storage role needs
per block: the validity bits and the store-chain hashes
(:func:`_chain_hashes`). A round's tail shorter than the depth runs as one
shallower window; a window of one block takes the depth-1 step.

The committer drives ``n_channels`` independent channels. Channels that
share a bucket layout form a shape group (``_ChannelGroup``), whose state is
one ``FabricMeshState`` with a leading channel dim; a multi-channel engine
calls :meth:`WindowCommitter.commit_windows` once a window position, which
runs one step a group (one MVCC call a block position for all the group's
channels). A per-channel resize splits its channel out of its group and
merges it into a group at the new layout, if there is one. The engine
reads each channel's state, digests, heads and overflow bits through the
``*_for(channel)`` accessors, and resizes between windows. With one channel
the single-channel surface (``state``, ``commit_window``, ``journal_head``,
``overflow_bits``, ``resize(nb)``) is unchanged.

``n_shards`` is the size of the reference's ``model`` axis. Under a
``shard_state`` config each channel's table is that many bucket shards
(views of the channel's table, launch/state_sharding): the steps route
their reads and commits over them, a resize is the butterfly exchange
(``state_sharding.resize_sharded``), and the shard stats, hot shard, digest
tree and the engine's snapshots and re-anchor records follow the shards.
With replicated state a table is one shard.

``mesh=`` (launch/mesh) is the counterpart of the reference's
``MeshWindowCommitter``: each shape group's state is placed over the
mesh's (data, model) devices (``fabric_step.MeshState``), its channels
split over ``data`` exactly when the group's size divides it, and each
window runs the mesh step. A resize runs where the channel lives (the
butterfly across its row's shard devices, or every replica); the shard
stats, hot shard, digests and snapshots read each shard on its device;
the gathers of channels between groups at a resize go through the mesh's
first device, as the reference's go through the host. The committer's
``device`` is then the mesh's first, where the orderer runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch import resolve_device
from repro_torch.core import hashing, ledger, types, u32
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


class MultiWindowResult(NamedTuple):
    """Per-channel, per-block outputs of one window on every channel."""

    valid: torch.Tensor  # (C, D, B) bool, ingest order
    prev_hash: np.ndarray  # (C, D, 2) u32
    block_hash: np.ndarray  # (C, D, 2) u32


def _chain_hashes(prev_hash: torch.Tensor, block_no0: torch.Tensor,
                  wire: torch.Tensor, valid: torch.Tensor):
    """Store-chain hashes of a window on one channel or several: each
    block's wire (..., D, B, WB) and validity bits (..., D, B) in ingest
    order, the channel's chain head (..., 2) and first block number (...)
    -> (prevs (..., D, 2), hashes (..., D, 2)). The body digests of every
    channel's D blocks are hashed in one pass; the links then follow block
    by block, every channel's at once."""
    lead = tuple(prev_hash.shape[:-1])
    d, b, wb = wire.shape[-3:]
    digests = ledger.block_body_digest(
        wire.reshape(-1, b, wb), valid.reshape(-1, b)).reshape(-1, d, 2)
    prev = prev_hash.reshape(-1, 2)
    bno0 = block_no0.reshape(-1, 1)
    prevs, hashes = [], []
    for k in range(d):
        prevs.append(prev)
        # ledger.append_hash on every channel's row at once.
        words = torch.cat([prev, u32.add(bno0, k), digests[:, k]], dim=1)
        prev = torch.stack([hashing.hash_words(words, seed=hashing.SEED_A),
                            hashing.hash_words(words, seed=hashing.SEED_B)],
                           dim=1)
        hashes.append(prev)
    return (torch.stack(prevs, dim=1).reshape(*lead, d, 2),
            torch.stack(hashes, dim=1).reshape(*lead, d, 2))


def stats_pass(tables: list, overflow: list, device) -> torch.Tensor:
    """The device part of :meth:`WindowCommitter.shard_stats`: for each
    channel, its shards' occupancy, then their least free slots a bucket,
    then its overflow lanes, each counted where its shard lives and stacked
    on ``device`` as one vector of u32 words for one host read.
    ``tables[k]`` is channel k's shard tables, ``overflow[k]`` its lanes."""
    parts = []
    for tabs, lanes in zip(tables, overflow):
        for count in (ws.shard_occupancy, ws.shard_min_free):
            parts += [count(t, 1).to(u32.WORD).to(device) for t in tabs]
        parts.append(lanes.to(device))
    return torch.cat(parts)


class _ChannelGroup:
    """Channels sharing one bucket layout, stacked in one state."""

    __slots__ = ("channels", "state")

    def __init__(self, channels: tuple, state: fs.FabricMeshState):
        self.channels = channels
        self.state = state

    @property
    def n_buckets(self) -> int:
        if isinstance(self.state, fs.MeshState):
            return self.state.n_buckets
        return self.state.keys.shape[1]


def _take(state: fs.FabricMeshState, idx: list) -> fs.FabricMeshState:
    """The channels ``idx`` of a stacked state, as a state of their own."""
    return fs.FabricMeshState(*(a[idx] for a in state))


class WindowCommitter:
    """The committer role backed by the windowed fabric step: ``n_channels``
    channels on one device (default: the card; raises without one unless
    ``device='cpu'``), or over ``mesh``. Each channel's results equal a
    one-channel committer's fed that channel's blocks. ``n_shards`` is the
    reference's ``model`` size (with a mesh, the mesh's): the bucket shards
    of a table under ``cfg.shard_state`` (a power of two dividing
    ``n_buckets``)."""

    def __init__(self, dims: types.FabricDims, cfg: fs.FabricStepConfig, *,
                 n_buckets: int = 1 << 12, slots: int = 8,
                 n_channels: int = 1, n_shards: int = 1, device=None,
                 mesh=None):
        if n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {n_channels}")
        if mesh is not None:
            if n_shards not in (1, mesh.model_size):
                raise ValueError(f"n_shards={n_shards} on a mesh of "
                                 f"{mesh.model_size} model ranks")
            if device is not None:
                raise ValueError("a mesh committer runs on the mesh's "
                                 "devices: pass mesh= or device=, not both")
            n_shards = mesh.model_size
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if cfg.shard_state:
            state_sharding.check_shard_count(n_shards)
            ws.shard_buckets(n_buckets, n_shards)
        self.dims = dims
        self.cfg = cfg
        self.model_size = n_shards
        self.slots = slots
        self.n_channels = n_channels
        self.mesh = mesh
        self.device = mesh.first if mesh is not None else resolve_device(
            device)
        self.groups = [_ChannelGroup(
            tuple(range(n_channels)),
            fs.create_mesh_state(n_channels, dims, n_buckets, slots,
                                 device=self.device)
            if mesh is None else fs.create_mesh_state(
                n_channels, dims, n_buckets, slots, mesh=mesh,
                shard_state=cfg.shard_state,
                channels_over_data=self._over_data(n_channels)))]
        self._prev_hash = [torch.zeros((2,), dtype=u32.WORD,
                                       device=self.device)
                           for _ in range(n_channels)]
        self._steps: dict = {}
        self._auditor = None
        self._audited: dict = {}
        self.obs = obs_mod.Obs.disabled()

    def attach_obs(self, obs) -> None:
        """Route window spans and metrics through ``obs``. Per window:
        ``window.fill`` covers the steps' launches and the chain hashes
        (host enqueue), ``window.steady`` ends on a device sync, and
        ``window.drain`` covers the host copy of the chain hashes."""
        self.obs = obs

    def attach_retrace_auditor(self, auditor) -> None:
        """Route every program this committer builds or calls (window
        steps, the stats pass, the resize exchange) through
        ``auditor.wrap`` (repro_torch.analysis.retrace.RetraceAuditor).
        Attach before the first window: steps built earlier are not
        wrapped."""
        self._auditor = auditor

    def _program(self, name: str, fn):
        """``fn``, wrapped once under ``name`` when an auditor is
        attached."""
        if self._auditor is None:
            return fn
        key = (name, fn)
        if key not in self._audited:
            self._audited[key] = self._auditor.wrap(name, fn)
        return self._audited[key]

    # -- channels --------------------------------------------------------------

    def _over_data(self, n: int) -> bool:
        """A group of ``n`` channels splits over ``data`` when it divides."""
        return n % self.mesh.dp_size == 0

    def _take(self, state, idx: list):
        """The channels ``idx`` of a group's state, as a state of their own
        (on a mesh: gathered on its first device and placed again)."""
        if self.mesh is None:
            return _take(state, idx)
        return self._place(_take(fs.gather_state(state), idx))

    def _place(self, state: fs.FabricMeshState) -> fs.MeshState:
        return fs.place_state(
            state, self.mesh, shard_state=self.cfg.shard_state,
            channels_over_data=self._over_data(state.keys.shape[0]))

    def _field(self, g: _ChannelGroup, name: str) -> torch.Tensor:
        """A field of a group's state, channel dim leading, on the
        committer's device."""
        if self.mesh is None:
            return getattr(g.state, name)
        return fs.gather_field(g.state, name)

    def _locate(self, channel: int) -> tuple:
        for g in self.groups:
            if channel in g.channels:
                return g, g.channels.index(channel)
        raise ValueError(f"channel {channel} out of range for "
                         f"{self.n_channels} channel(s)")

    @property
    def depth(self) -> int:
        return max(self.cfg.pipeline_depth, 1)

    @property
    def n_shards(self) -> int:
        """Bucket shards of a channel's table: the ``model`` size when the
        state is sharded, else 1."""
        return self.model_size if self.cfg.shard_state else 1

    @property
    def state(self) -> fs.FabricMeshState:
        """THE state, while every channel shares one layout (always, with
        one channel); on a mesh, gathered on its first device (a copy)."""
        if len(self.groups) != 1:
            raise ValueError("channels hold different bucket layouts: use "
                             "channel_state(c)")
        g = self.groups[0]
        return g.state if self.mesh is None else fs.gather_state(g.state)

    def channel_state(self, channel: int) -> fs.FabricMeshState:
        """One channel's state with a channel dim of 1 (views; on a mesh a
        gathered copy), shaped as a one-channel committer's ``state``."""
        g, pos = self._locate(channel)
        st = g.state if self.mesh is None else fs.gather_state(g.state)
        return fs.FabricMeshState(*(a[pos:pos + 1] for a in st))

    @property
    def n_buckets(self) -> int:
        """Channel 0's CURRENT bucket count."""
        return self.n_buckets_for(0)

    def n_buckets_for(self, channel: int) -> int:
        return self._locate(channel)[0].n_buckets

    def _step_for(self, d: int, channels: tuple):
        key = (d, channels)
        if key not in self._steps:
            step = fs.make_fabric_step(
                self.dims, dataclasses.replace(self.cfg, pipeline_depth=d),
                n_shards=self.model_size,
                channel=None if self.n_channels == 1 else channels,
                mesh=self.mesh,
                channels_over_data=(self.mesh is None
                                    or self._over_data(len(channels))))
            if self._auditor is not None:
                step = self._auditor.wrap(f"pipeline/window_step/d{d}",
                                          step)
            self._steps[key] = step
        return self._steps[key]

    # -- windows ---------------------------------------------------------------

    def commit_window(self, wire: torch.Tensor, tx_ids: torch.Tensor
                      ) -> WindowResult:
        """Commit ``wire`` (D, B, WB) / ``tx_ids`` (D, B, 2), 1 <= D <=
        depth, in block order: the one-channel surface."""
        if self.n_channels != 1:
            raise ValueError("commit_window drives one channel: use "
                             f"commit_windows for {self.n_channels} channels")
        res = self.commit_windows(wire[None], tx_ids[None])
        return WindowResult(valid=res.valid[0], prev_hash=res.prev_hash[0],
                            block_hash=res.block_hash[0])

    def commit_windows(self, wires: torch.Tensor, tx_ids: torch.Tensor
                       ) -> MultiWindowResult:
        """Commit one window on EVERY channel: ``wires`` (C, D, B, WB) /
        ``tx_ids`` (C, D, B, 2), 1 <= D <= depth; one step a shape group
        (one while no channel's layout diverged)."""
        if wires.shape[0] != self.n_channels:
            raise ValueError(f"expected {self.n_channels} channel windows, "
                             f"got {wires.shape[0]}")
        d = wires.shape[1]
        if not 1 <= d <= self.depth:
            raise ValueError(f"a window holds 1 to {self.depth} blocks, "
                             f"got {d}")
        tracer, reg = self.obs.tracer, self.obs.registry
        t0 = time.perf_counter()
        nch = self.n_channels
        valid_c, prevs_c, hashes_c = [None] * nch, [None] * nch, [None] * nch
        with tracer.span("window.fill", depth=d):
            for g in self.groups:
                chans = list(g.channels)
                if chans == list(range(nch)):
                    wire_g, ids_g = wires, tx_ids
                else:
                    wire_g, ids_g = wires[chans], tx_ids[chans]
                step = self._step_for(d, g.channels)
                if d == 1:
                    g.state, valid = step(g.state, wire_g[:, 0], ids_g[:, 0])
                    valid = valid[:, None]
                else:
                    g.state, valid = step(g.state, wire_g, ids_g)
                prevs, hashes = _chain_hashes(
                    torch.stack([self._prev_hash[c] for c in chans]),
                    u32.sub(self._field(g, "block_no"), d), wire_g, valid)
                for i, c in enumerate(chans):
                    self._prev_hash[c] = hashes[i, -1]
                    valid_c[c], prevs_c[c], hashes_c[c] = (
                        valid[i], prevs[i], hashes[i])
        with tracer.span("window.steady", depth=d, sync=self.sync_target):
            pass  # the device finishes the window inside this span
        with tracer.span("window.drain", depth=d):
            prevs = u32.to_numpy(torch.stack(prevs_c))
            hashes = u32.to_numpy(torch.stack(hashes_c))
        # Blocks of a window retire together: the per-block latency is the
        # window's, amortized.
        dt = (time.perf_counter() - t0) / d
        hist = reg.histogram("commit.latency")
        for _ in range(d):
            hist.record(dt)
        reg.counter("window.commits").inc()
        reg.counter("blocks.committed").inc(d * nch)
        if nch > 1:
            for c in range(nch):
                reg.counter("blocks.committed", channel=c).inc(d)
        return MultiWindowResult(valid=torch.stack(valid_c), prev_hash=prevs,
                                 block_hash=hashes)

    # -- elastic state ---------------------------------------------------------

    def resize(self, new_n_buckets: int, channel: int = 0) -> ReanchorInfo:
        """Halve or double ONE channel's table between windows (nothing is
        in flight: the window write log assumes one layout a window): split
        the channel out of its shape group, rehash it (under
        ``cfg.shard_state`` the butterfly exchange of its shards, one
        doubling or halving at a time; on a mesh where it lives), merge it
        into a group at the new layout if there is one, and latch any
        shrink overflow on the bits of the shards that dropped entries.
        Other channels are untouched. Returns the epoch's
        :class:`ReanchorInfo`."""
        g, pos = self._locate(channel)
        old_nb = g.n_buckets
        if new_n_buckets == old_nb:
            raise ValueError(f"resize to current size {old_nb}")
        m = self.n_shards
        if self.cfg.shard_state:
            # Refuse before the channel leaves its group.
            if new_n_buckets not in (2 * old_nb, old_nb // 2):
                raise ValueError(
                    f"resize_sharded steps by 2x only: nb_loc={old_nb // m}"
                    f" -> {new_n_buckets // m}")
            ws.shard_buckets(new_n_buckets, m)
        lone = self._take(g.state, [pos])
        if len(g.channels) > 1:
            g.state = self._take(g.state, [i for i in range(len(g.channels))
                                           if i != pos])
            g.channels = tuple(c for c in g.channels if c != channel)
        else:
            self.groups.remove(g)
        if self.mesh is None:
            lone = self._resize_one(lone, old_nb, new_n_buckets)
        else:
            lone = lone._replace(ranks=tuple(
                self._resize_row(d, row, old_nb, new_n_buckets)
                for d, row in enumerate(lone.ranks)))
        target = next((h for h in self.groups
                       if h.n_buckets == new_n_buckets), None)
        if target is None:
            self.groups.append(_ChannelGroup((channel,), lone))
        else:
            chans = target.channels + (channel,)
            order = sorted(range(len(chans)), key=chans.__getitem__)
            if self.mesh is None:
                parts = (target.state, lone)
            else:
                parts = (fs.gather_state(target.state),
                         fs.gather_state(lone))
            merged = _take(fs.FabricMeshState(*(torch.cat(a) for a in
                                                zip(*parts))), order)
            target.state = merged if self.mesh is None else self._place(
                merged)
            target.channels = tuple(sorted(chans))
        info = ReanchorInfo(
            block_no=self.block_no_for(channel) - 1, old_n_buckets=old_nb,
            new_n_buckets=new_n_buckets, n_shards=self.n_shards,
            tree_head=self.tree_head(channel),
            overflow_bits=self.overflow_bits_for(channel), channel=channel)
        self.obs.tracer.event(
            "reanchor.epoch", block_no=info.block_no, channel=channel,
            old_n_buckets=old_nb, new_n_buckets=new_n_buckets,
            overflow_bits=info.overflow_bits)
        return info

    def _resize_one(self, lone: fs.FabricMeshState, old_nb: int,
                    new_nb: int) -> fs.FabricMeshState:
        """A one-channel state rehashed to ``new_nb`` buckets on one device:
        the butterfly over its shard views, or ``world_state.resize``."""
        m = self.n_shards
        tab = ws.HashState(lone.keys[0], lone.versions[0], lone.values[0])
        if self.cfg.shard_state:
            res = self._program("pipeline/resize_exchange",
                                state_sharding.resize_sharded)(
                state_sharding.shard_views(tab, m), new_nb // m, old_nb, m)
            new = ws.HashState(*(torch.cat(a) for a in zip(*res.state)))
            ovf = res.shard_overflow
        else:
            res = self._program("pipeline/resize_exchange", ws.resize)(
                tab, new_nb)
            new, ovf = res.state, res.overflow[None]
        return lone._replace(
            keys=new.keys[None], versions=new.versions[None],
            values=new.values[None],
            overflow=lone.overflow | state_sharding.overflow_bits(ovf))

    def _resize_row(self, d: int, row: tuple, old_nb: int, new_nb: int
                    ) -> tuple:
        """Data row ``d``'s copy of a lone channel rehashed where it lives:
        the butterfly across the row's shard devices (each rank's flag
        reduced onto every rank), or every replica on its own device."""
        if not self.cfg.shard_state:
            return tuple(self._resize_one(r, old_nb, new_nb) for r in row)
        m = self.n_shards
        res = self._program("pipeline/resize_exchange",
                            state_sharding.resize_sharded)(
            [fs.table(r.keys, r.versions, r.values, 0) for r in row],
            new_nb // m, old_nb, m, mesh=self.mesh, row=d)
        out = []
        for r, new in zip(row, res.state):
            bits = state_sharding.overflow_bits(
                res.shard_overflow.to(r.keys.device))
            out.append(r._replace(
                keys=new.keys[None], versions=new.versions[None],
                values=new.values[None], overflow=r.overflow | bits))
        return tuple(out)

    def shard_stats(self, channels=(0,)) -> dict:
        """channel -> (per-shard occupancy (M,), min free slots, per-shard
        slot capacity, sticky overflow bits): each shard counted on its
        device, in one host read for all ``channels``."""
        channels = list(channels)
        for c in channels:
            self._locate(c)
        m = self.n_shards
        host = u32.to_numpy(self._program("pipeline/stats_pass", stats_pass)(
            [self.shard_tables(c) for c in channels],
            [self._head("overflow", c) for c in channels],
            self.device)).astype(np.int64)
        w = 2 * m + state_sharding.OVERFLOW_LANES
        out = {}
        for k, c in enumerate(channels):
            row = host[k * w:(k + 1) * w]
            out[c] = (row[:m], int(row[m:2 * m].min()),
                      self.n_buckets_for(c) // m * self.slots,
                      state_sharding.bits_to_int(row[2 * m:]))
        return out

    def hot_shard(self, channel: int = 0) -> int:
        """The shard a grow should relieve: the first overflowed one, else
        the fullest."""
        return ws.hot_shard(self.overflow_bits_for(channel), torch.cat([
            ws.shard_occupancy(t, 1).cpu()
            for t in self.shard_tables(channel)]))

    # -- state accessors -------------------------------------------------------

    def shard_tables(self, channel: int = 0) -> list:
        """A channel's ``n_shards`` tables where they live (views): on one
        device the shard views of its table, on a mesh its shards on their
        devices, or its replica at model rank 0."""
        g, pos = self._locate(channel)
        if self.mesh is not None:
            return g.state.tables(pos)
        return state_sharding.shard_views(self.hash_state(channel),
                                          self.n_shards)

    def hash_state(self, channel: int = 0) -> ws.HashState:
        """A channel's committed table: views of the live tensors on one
        device; on a mesh its shards (or its replica) gathered on the
        committer's device."""
        if self.mesh is not None:
            return ws.HashState(*(torch.cat([x.to(self.device) for x in a])
                                  for a in zip(*self.shard_tables(channel))))
        g, pos = self._locate(channel)
        return ws.HashState(g.state.keys[pos], g.state.versions[pos],
                            g.state.values[pos])

    def state_digest(self, channel: int = 0) -> np.ndarray:
        return u32.to_numpy(state_sharding.sharded_state_digest(
            self.shard_tables(channel), self.device))

    def tree_head(self, channel: int = 0) -> np.ndarray:
        """(2,) u32 digest-tree head of a channel's table's shards."""
        return u32.to_numpy(state_sharding.sharded_digest(
            self.shard_tables(channel), self.device))

    def _head(self, name: str, channel: int) -> torch.Tensor:
        g, pos = self._locate(channel)
        if self.mesh is not None:
            d, i = g.state.rank_of(pos)
            return getattr(g.state.ranks[d][0], name)[i]
        return getattr(g.state, name)[pos]

    @property
    def journal_head(self) -> np.ndarray:
        return self.journal_head_for(0)

    def journal_head_for(self, channel: int) -> np.ndarray:
        return u32.to_numpy(self._head("journal_head", channel))

    def ledger_head_for(self, channel: int) -> np.ndarray:
        return u32.to_numpy(self._head("ledger_head", channel))

    def block_no_for(self, channel: int) -> int:
        return int(u32.to_numpy(self._head("block_no", channel)))

    @property
    def overflow(self) -> bool:
        """Sticky: some commit on some channel dropped a write on a full
        bucket."""
        return any(bool(self._field(g, "overflow").any())
                   for g in self.groups)

    @property
    def overflow_bits(self) -> int:
        """Channel 0's sticky per-shard bitmask as one int (bit m: shard m;
        bit 0 for a replicated table)."""
        return self.overflow_bits_for(0)

    def overflow_bits_for(self, channel: int) -> int:
        return state_sharding.bits_to_int(self._head("overflow", channel))

    def sync_target(self) -> tuple:
        """The tensors a sync on the committed windows waits for: on a mesh
        every rank's, so that the sync covers every device."""
        if self.mesh is None:
            return tuple(g.state.ledger_head for g in self.groups)
        return tuple(r.ledger_head for g in self.groups
                     for row in g.state.ranks for r in row)

    def block_until_ready(self) -> None:
        """Wait for the committer's device, or every card of its mesh."""
        if self.mesh is not None:
            self.mesh.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
