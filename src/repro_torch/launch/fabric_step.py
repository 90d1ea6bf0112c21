"""The FastFabric step over C channels on one device (port of
repro.launch.fabric_step).

Per block: the syntactic check and endorsement MACs where the block was
ingested, consensus replication of the published rows (the whole wire, or
under O-I only the structured prefix) into the log head, the deterministic
order, the decode of the replicated rows, the read-set probe, MVCC and the
commit, then the ledger and journal heads. With
``FabricStepConfig.pipeline_depth`` D > 1 the step takes a window of D
blocks (pipeline/schedule): one endorsement launch, one probe a channel
and one fused commit a channel for the whole window, bit-identical to D
depth-1 steps.

The reference runs this under ``shard_map`` over a (data, model) mesh and
vmaps the channel math over the ``data`` axis; here the C channels are a
leading dim on one device with one replica, so its collectives are
identities. The channels share no state: the syntax check, endorsement
MACs and decode run over every channel's rows at once (they are per row),
the probes and commits run a channel at a time on its own table, and each
block position's MVCC runs once for every channel's block (one K4 call,
``mvcc.validate_blocks``). The tables are committed in place, as every
commit of the port is: the state a step returns shares its table tensors
with the state it was given.

Bucket-sharded state (``FabricStepConfig.shard_state``) splits each
channel's table into the ``n_shards`` bucket shards of the reference's
``model`` axis (launch/state_sharding): the state keeps the global layout
(C, NB, S, ...), a shard is a view of it, reads route to their owner shard
(one K2 probe a shard) and commits apply on the owner only. The overflow
bits then name the shards that dropped a write. Sharded and replicated
steps give identical tables, heads and validity bits; with replicated
state ``n_shards`` changes nothing. On one device every row of a block is
processed where it is.

Over a (data, model) mesh of devices (``mesh=``, launch/mesh) the step
follows the reference's ``shard_map`` body rank by rank. The state is a
:class:`MeshState`: data rank d holds C/data channels (``channels_over_data``)
or every channel, and model rank m of it a replica of each of its
channels' tables or, under ``shard_state``, bucket shard m, as tensors of
its own on its device; the heads are on every rank. Rank (d, m) ingests
rows [m B/M, (m+1) B/M) of each block of its channels and runs the syntax
check and the endorsement MACs (K1) on them; the consensus gathers the
published rows (the O-I prefix, or every word under Fabric 1.2), the ids
and the flags to every model rank of the row in rank order; every rank
orders, decodes, reads (K2 on its replica, or its shard's part of the
routed read, summed over the row), validates (K4) and commits (on its
replica, or the entries its shard owns; K3 under ``sequential_commit``);
each keeps its slice of the validity bits. :attr:`Mesh.moved` counts the
gathered bytes (:func:`consensus_bytes` a block).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import mvcc, orderer, types, u32, unmarshal
from repro_torch.core import world_state as ws
from repro_torch.launch import state_sharding
from repro_torch.pipeline import stages

TABLE_FIELDS = ("keys", "versions", "values")

class FabricMeshState(NamedTuple):
    """Per-channel peer state, channel dim leading."""

    keys: torch.Tensor  # (C, NB, S, 2)
    versions: torch.Tensor  # (C, NB, S)
    values: torch.Tensor  # (C, NB, S, VW)
    log_head: torch.Tensor  # (C, 2)
    ledger_head: torch.Tensor  # (C, 2)
    journal_head: torch.Tensor  # (C, 2) state-journal digest chain
    block_no: torch.Tensor  # (C,) next block number
    overflow: torch.Tensor  # (C, LANES) sticky per-shard overflow bitmask
    # (state_sharding): bit m once shard m (bit 0: a replicated table)
    # dropped a write on a full bucket, after which the channel's version
    # accounting is untrusted


class MeshState(NamedTuple):
    """A :class:`FabricMeshState` placed over a mesh: ``ranks[d][m]`` is
    rank (d, m)'s state on its device, holding the channels ``channels[d]``
    (positions in the global channel dim, in order) with a full replica of
    each channel's table or, under ``shard_state``, its bucket shard m. The
    heads are on every rank. With ``over_data`` the data ranks split the
    channels, else every data rank holds every channel."""

    mesh: object
    channels: tuple
    ranks: tuple
    shard_state: bool
    over_data: bool

    @property
    def n_channels(self) -> int:
        return sum(len(c) for c in self.channels) if self.over_data else len(
            self.channels[0])

    @property
    def n_buckets(self) -> int:
        """Global buckets of a channel's table."""
        return self.ranks[0][0].keys.shape[1] * (
            self.mesh.model_size if self.shard_state else 1)

    def rank_of(self, channel: int) -> tuple:
        """(data rank, position in its local channel dim) of ``channel``."""
        for d, chans in enumerate(self.channels):
            if channel in chans:
                return d, chans.index(channel)
        raise ValueError(f"channel {channel} not in {self.channels}")

    def tables(self, channel: int) -> list:
        """A channel's tables where they live: its M shards on their
        devices, or the replica of model rank 0."""
        d, i = self.rank_of(channel)
        ranks = self.ranks[d] if self.shard_state else self.ranks[d][:1]
        return [table(r.keys, r.versions, r.values, i) for r in ranks]


def _channel_rows(n_channels: int, mesh, over_data: bool) -> tuple:
    if not over_data:
        return (tuple(range(n_channels)),) * mesh.dp_size
    if n_channels % mesh.dp_size:
        raise ValueError(f"{n_channels} channels do not split over "
                         f"{mesh.dp_size} data ranks")
    per = n_channels // mesh.dp_size
    return tuple(tuple(range(d * per, (d + 1) * per))
                 for d in range(mesh.dp_size))


def create_mesh_state(n_channels: int, dims: types.FabricDims,
                      n_buckets: int = 1 << 10, slots: int = 8, *,
                      device=None, mesh=None, shard_state: bool = False,
                      channels_over_data: bool = True):
    """A fresh state of ``n_channels`` channels on ``device`` (default: the
    card; raises without one unless ``device='cpu'``). With ``mesh`` a
    :class:`MeshState` instead, each rank's tensors made on its device:
    ``shard_state`` splits each table into the mesh's ``model`` bucket
    shards, ``channels_over_data`` splits the channels over ``data`` (C
    must divide)."""
    if n_channels < 1:
        raise ValueError(f"n_channels must be >= 1, got {n_channels}")
    if mesh is not None:
        rows = _channel_rows(n_channels, mesh, channels_over_data)
        nb = (ws.shard_buckets(n_buckets, mesh.model_size) if shard_state
              else n_buckets)
        ranks = tuple(tuple(
            create_mesh_state(len(rows[d]), dims, nb, slots, device=dev)
            for dev in mesh.row(d)) for d in range(mesh.dp_size))
        return MeshState(mesh, rows, ranks, shard_state, channels_over_data)
    table = ws.create(n_buckets, slots, dims.vw, device=device)
    dev = table.keys.device
    z = lambda *shape: torch.zeros(shape, dtype=u32.WORD, device=dev)
    rep = lambda t: t[None].repeat(n_channels, *([1] * t.dim()))
    return FabricMeshState(
        keys=rep(table.keys), versions=rep(table.versions),
        values=rep(table.values), log_head=z(n_channels, 2),
        ledger_head=z(n_channels, 2), journal_head=z(n_channels, 2),
        block_no=z(n_channels),
        overflow=z(n_channels, state_sharding.OVERFLOW_LANES))


def place_state(state: FabricMeshState, mesh, *, shard_state: bool = False,
                channels_over_data: bool = True) -> MeshState:
    """A global state copied onto ``mesh`` as :func:`create_mesh_state`
    with ``mesh=`` lays it out: every rank's tensors its own copies."""
    rows = _channel_rows(state.keys.shape[0], mesh, channels_over_data)
    m_size = mesh.model_size
    nb_loc = (ws.shard_buckets(state.keys.shape[1], m_size) if shard_state
              else state.keys.shape[1])
    ranks = []
    for d, chans in enumerate(rows):
        idx = list(chans)
        row = []
        for m, dev in enumerate(mesh.row(d)):
            part = [a[idx] for a in state]
            if shard_state:
                for f in range(len(TABLE_FIELDS)):
                    part[f] = part[f][:, m * nb_loc:(m + 1) * nb_loc]
            row.append(FabricMeshState(*(a.to(dev, copy=True)
                                         for a in part)))
        ranks.append(tuple(row))
    return MeshState(mesh, rows, tuple(ranks), shard_state,
                     channels_over_data)


def gather_field(ms: MeshState, name: str, device=None) -> torch.Tensor:
    """One field of the global state (C, ...) on ``device`` (default: the
    mesh's first), a copy: a table from each channel's shards or replica
    at model rank 0, a head from model rank 0."""
    dev = ms.mesh.first if device is None else torch.device(device)
    rows = range(len(ms.channels)) if ms.over_data else (0,)
    parts = []
    for d in rows:
        ranks = ms.ranks[d]
        if ms.shard_state and name in TABLE_FIELDS:
            parts.append(torch.cat([getattr(r, name).to(dev) for r in ranks],
                                   dim=1))
        else:
            parts.append(getattr(ranks[0], name).to(dev, copy=True))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def gather_state(ms: MeshState, device=None) -> FabricMeshState:
    """The global :class:`FabricMeshState` of a placed state on ``device``
    (default: the mesh's first), a copy."""
    return FabricMeshState(*(gather_field(ms, name, device)
                             for name in FabricMeshState._fields))


def consensus_bytes(dims: types.FabricDims, cfg, b: int, m: int) -> int:
    """Bytes the consensus gather of one block of ``b`` transactions moves
    between the ``m`` model ranks of a data row: every rank takes the other
    ranks' b/m published rows (the ``spw``-word O-I prefix, or all
    ``payload_words`` under Fabric 1.2), their ids (two words) and their
    flags (one byte)."""
    words = (unmarshal.struct_prefix_words(dims) if cfg.separate_metadata
             else dims.payload_words)
    return (m - 1) * b * (4 * words + 8 + 1)


@dataclasses.dataclass(frozen=True)
class FabricStepConfig:
    separate_metadata: bool = True  # O-I
    pipelined: bool = True  # O-II
    sequential_commit: bool = False  # paper-faithful serial commit (K3)
    tree_hash: bool = False  # O(log B) pairwise log and ledger folds
    shard_state: bool = False  # bucket-sharded state (state_sharding)
    pipeline_depth: int = 1  # P-II device-side block pipeline: blocks a
    # step; D > 1 takes a (C, D, B, ...) window

    @property
    def name(self) -> str:
        base = "fastfabric" if self.separate_metadata else "fabric-1.2"
        return (base + ("+tree" if self.tree_hash else "")
                + ("+shard" if self.shard_state else "")
                + (f"+pipe{self.pipeline_depth}"
                   if self.pipeline_depth > 1 else ""))


FASTFABRIC_STEP = FabricStepConfig()
FASTFABRIC_SHARDED_STEP = FabricStepConfig(shard_state=True)
FASTFABRIC_PIPELINED_STEP = FabricStepConfig(shard_state=True,
                                             pipeline_depth=8)
FABRIC_V12_STEP = FabricStepConfig(
    separate_metadata=False, pipelined=False, sequential_commit=True)


def table(keys, vers, vals, c: int) -> ws.HashState:
    """Channel ``c``'s table: views of the stacked state's tensors, so a
    commit into it commits into the state."""
    return ws.HashState(keys=keys[c], versions=vers[c], values=vals[c])


def ingest(wire: torch.Tensor, dims: types.FabricDims, cfg) -> tuple:
    """The syntax check and endorsement MACs where the rows were ingested:
    wire (..., b, WB) u8 -> (published rows (..., b, P): the O-I prefix, or
    every word; ok (..., b) bool), one K1 launch for every row."""
    lead = tuple(wire.shape[:-1])
    words, txb, checksum_ok = stages.stage_syntax(
        wire.reshape(-1, wire.shape[-1]), dims)
    ok = (checksum_ok & stages.stage_endorse(txb)).reshape(lead)
    if cfg.separate_metadata:
        words = words[:, :unmarshal.struct_prefix_words(dims)]
    return words.reshape(*lead, -1), ok


def _order(published, ids, ok, dims: types.FabricDims) -> tuple:
    """The consensus order of C replicated blocks and their decode:
    (orders, ordered rows (C, B, P), txb (C, B, ...), ok_ord (C, B))."""
    nch, b = ids.shape[:2]
    orders = [orderer.consensus_order(ids[c]) for c in range(nch)]
    ordered_words = torch.stack([published[c][o]
                                 for c, o in enumerate(orders)])
    txb = types.TxBatch(*(a.reshape(nch, b, *a.shape[1:]) for a in
                          stages.decode_published(
                              ordered_words.reshape(nch * b, -1), dims)))
    ok_ord = torch.stack([ok[c][o] for c, o in enumerate(orders)])
    return orders, ordered_words, txb, ok_ord


def _heads(cfg, state, blk_ovf, published, ordered_words, txb, valid,
           orders) -> tuple:
    """The block's log, ledger and journal folds over ``state``'s heads,
    the next block numbers, the latched overflow lanes and the validity
    bits in ingest order."""
    heads = []
    for c, order in enumerate(orders):
        heads.append((
            stages.fold_log_head(state.log_head[c], published[c], cfg),
            stages.fold_ledger_head(state.ledger_head[c], ordered_words[c],
                                    valid[c], cfg),
            stages.advance_journal_head(
                state.journal_head[c], state.block_no[c],
                types.TxBatch(*(a[c] for a in txb)), valid[c]),
            state.overflow[c] | blk_ovf[c],
            valid[c][torch.argsort(order)]))
    log_h, led, jrn, ovf, valid = (torch.stack(x) for x in zip(*heads))
    return log_h, led, jrn, u32.add(state.block_no, 1), ovf, valid


def _block_body(dims: types.FabricDims, cfg: FabricStepConfig,
                n_shards: int, channel):
    """The depth-1 step of C channels: one block a channel, every stage in
    order; the syntax check, MACs and decode over all channels' rows at
    once, one MVCC call for the C blocks. Under ``cfg.shard_state`` the
    read and the commit route over ``n_shards`` bucket shards."""

    def body(state: FabricMeshState, wire, ids):
        nch, b = ids.shape[:2]
        published, ok = ingest(wire, dims, cfg)
        orders, ordered_words, txb, ok_ord = _order(published, ids, ok, dims)
        tables = [table(state.keys, state.versions, state.values, c)
                  for c in range(nch)]
        cur = torch.stack([
            stages.stage_read(tables[c], txb.read_keys[c].reshape(-1, 2),
                              cfg, n_shards).reshape(b, -1)
            for c in range(nch)])
        valid, blk_ovf = stages.stage_mvcc_commit(
            tables, txb, ok_ord, cur, cfg, n_shards=n_shards,
            channel=channel)
        *heads, valid = _heads(cfg, state, blk_ovf, published,
                               ordered_words, txb, valid, orders)
        return FabricMeshState(state.keys, state.versions, state.values,
                               *heads), valid

    return body


def _mesh_block_body(dims: types.FabricDims, cfg: FabricStepConfig, mesh,
                     channel):
    """One data row's depth-1 step over its M model ranks (see the module
    docstring): ``row(d, ranks, wire, ids)`` takes the row's rank states
    and its channels' blocks (C_loc, B, WB) / (C_loc, B, 2) on any device,
    and returns the new rank states and each rank's validity slice
    (C_loc, B/M) on its device."""
    msize = mesh.model_size
    mvcc_cfg = dataclasses.replace(cfg, shard_state=False)

    def row(d, ranks, wire, ids):
        devs = mesh.row(d)
        nch, b = ids.shape[:2]
        sl = rank_slices(b, msize)
        ing = [ingest(wire[:, sl[m]].to(dev), dims, cfg)
               for m, dev in enumerate(devs)]
        log = mesh.all_gather(d, [p for p, _ in ing], 1, "consensus")
        idg = mesh.all_gather(d, [ids[:, sl[m]].to(dev)
                                  for m, dev in enumerate(devs)],
                              1, "consensus")
        okg = mesh.all_gather(d, [o for _, o in ing], 1, "consensus")
        ords = [_order(log[m], idg[m], okg[m], dims) for m in range(msize)]
        tabs = [[table(r.keys, r.versions, r.values, c) for c in range(nch)]
                for r in ranks]
        if cfg.shard_state:
            nbg = ranks[0].keys.shape[1] * msize
            cur = mesh.psum(d, [torch.stack([
                state_sharding.rank_versions(
                    tabs[m][c], m, ords[m][2].read_keys[c].reshape(-1, 2),
                    nbg, msize) for c in range(nch)])
                for m in range(msize)], "routed_read")
            valid = [mvcc.validate_blocks(
                o[2], cur[m].reshape(nch, b, -1), checksum_ok=o[3]).valid
                for m, o in enumerate(ords)]
            onehot = []
            for m, dev in enumerate(devs):
                txb = ords[m][2]
                hot = torch.zeros((nch, msize), dtype=torch.bool, device=dev)
                for c in range(nch):
                    hot[c, m] = state_sharding.rank_commit(
                        tabs[m][c], m, txb.write_keys[c], txb.write_vals[c],
                        valid[m][c], nbg, msize,
                        sequential=cfg.sequential_commit)
                onehot.append(hot)
            shard_ovf = mesh.psum(d, onehot, "overflow_reduce")
            blk = [torch.stack([state_sharding.overflow_bits(
                s[c], channel=channel) for c in range(nch)])
                for s in shard_ovf]
        else:
            res = [stages.stage_mvcc_commit(
                tabs[m], o[2], o[3], torch.stack([
                    stages.stage_read(tabs[m][c],
                                      o[2].read_keys[c].reshape(-1, 2),
                                      mvcc_cfg, 1).reshape(b, -1)
                    for c in range(nch)]), mvcc_cfg, channel=channel)
                for m, o in enumerate(ords)]
            valid, blk = [v for v, _ in res], [o for _, o in res]
        out, mine = [], []
        for m, r in enumerate(ranks):
            orders, ordered_words, txb, _ = ords[m]
            *heads, v = _heads(cfg, r, blk[m], log[m], ordered_words, txb,
                               valid[m], orders)
            out.append(FabricMeshState(r.keys, r.versions, r.values, *heads))
            mine.append(v[:, sl[m]])
        return out, mine

    return row


def rank_slices(b: int, msize: int) -> list:
    """The rows each model rank ingests of a block of ``b``."""
    if b % msize:
        raise ValueError(f"a block of {b} txs does not split over "
                         f"{msize} model ranks")
    bl = b // msize
    return [slice(m * bl, (m + 1) * bl) for m in range(msize)]


def on_mesh(row):
    """The step over a :class:`MeshState` from a data row's body (see
    :func:`_mesh_block_body`): ``apply(ms, wire, ids) -> (ms, valid)``,
    ``valid`` (C, [D,] B) on the mesh's first device, gathered from every
    rank's slice."""

    def apply(ms: MeshState, wire, ids):
        first = ms.mesh.first
        ranks, valid = [], []
        for d, chans in enumerate(ms.channels):
            # A row's channels are a contiguous range (_channel_rows): a
            # slice, where a list index would copy it to the card first.
            sl = slice(chans[0], chans[-1] + 1)
            out, mine = row(d, ms.ranks[d], wire[sl], ids[sl])
            ranks.append(tuple(out))
            if ms.over_data or d == 0:
                valid.append(torch.cat([v.to(first) for v in mine], dim=-1))
        return (ms._replace(ranks=tuple(ranks)),
                torch.cat(valid) if len(valid) > 1 else valid[0])

    return apply


def make_fabric_step(dims: types.FabricDims, cfg: FabricStepConfig, *,
                     n_shards: int = 1, channel=None, mesh=None,
                     channels_over_data: bool = True):
    """The step ``apply(state, wire, ids) -> (state, valid)`` for the C
    channels of ``state`` on its device.

    Depth 1: ``wire`` (C, B, WB) u8, ``ids`` (C, B, 2), ``valid`` (C, B).
    Depth D: ``wire`` (C, D, B, WB), ``ids`` (C, D, B, 2), ``valid``
    (C, D, B), bit-identical to D depth-1 steps. ``valid`` is in ingest
    order, and each channel's results equal a one-channel step fed that
    channel's blocks. ``n_shards`` is the size of the reference's
    ``model`` axis: under ``cfg.shard_state`` each table is split into that
    many bucket shards (a power of two, at most
    ``state_sharding.MAX_OVERFLOW_SHARDS``, dividing the bucket count).
    ``channel`` names the channel(s) in errors.

    With ``mesh`` the state is a :class:`MeshState` placed by
    :func:`create_mesh_state` on that mesh with the same
    ``channels_over_data`` and ``cfg.shard_state``, ``n_shards`` is the
    mesh's ``model`` size, B must split over it, and ``valid`` lands on the
    mesh's first device; the results equal the one-device step's."""
    if mesh is not None:
        n_shards = mesh.model_size
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if cfg.shard_state:
        state_sharding.check_shard_count(n_shards, channel=channel)
    depth = cfg.pipeline_depth
    if depth > 1:
        from repro_torch.pipeline import schedule  # layering stays one-way
        body = (schedule.make_mesh_window_body(dims, cfg, depth, mesh,
                                               channel=channel)
                if mesh is not None else
                schedule.make_window_body(dims, cfg, depth,
                                          n_shards=n_shards,
                                          channel=channel))
    else:
        body = (_mesh_block_body(dims, cfg, mesh, channel)
                if mesh is not None else
                _block_body(dims, cfg, n_shards, channel))
    if mesh is not None:
        body = on_mesh(body)

    def apply(state, wire, ids):
        if mesh is not None:
            if (state.mesh is not mesh or state.over_data
                    != channels_over_data
                    or state.shard_state != cfg.shard_state):
                raise ValueError(
                    "the state is not placed for this step's mesh, "
                    "channels_over_data and shard_state")
            nch, nb = state.n_channels, state.n_buckets
        else:
            nch, nb = state.keys.shape[:2]
        if wire.shape[0] != nch:
            raise ValueError(
                f"a state of {nch} channels got a wire of "
                f"{wire.shape[0]} channels")
        if cfg.shard_state:
            ws.shard_buckets(nb, n_shards)  # the split
        if depth > 1 and (wire.ndim != 4 or wire.shape[1] != depth):
            raise ValueError(
                f"pipeline_depth={depth} expects wire (C, {depth}, B, WB); "
                f"got {tuple(wire.shape)}")
        return body(state, wire, ids)

    return apply
