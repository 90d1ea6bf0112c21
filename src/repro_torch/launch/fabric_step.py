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
state ``n_shards`` changes nothing. The reference also splits each block's
ingest over the ``model`` ranks and gathers it; here every row is processed
where it is, which gives the same results.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import orderer, types, u32, unmarshal
from repro_torch.core import world_state as ws
from repro_torch.launch import state_sharding
from repro_torch.pipeline import stages

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


def create_mesh_state(n_channels: int, dims: types.FabricDims,
                      n_buckets: int = 1 << 10, slots: int = 8, *,
                      device=None) -> FabricMeshState:
    """A fresh state of ``n_channels`` channels on ``device`` (default: the
    card; raises without one unless ``device='cpu'``)."""
    if n_channels < 1:
        raise ValueError(f"n_channels must be >= 1, got {n_channels}")
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


def _block_body(dims: types.FabricDims, cfg: FabricStepConfig,
                n_shards: int, channel):
    """The depth-1 step of C channels: one block a channel, every stage in
    order; the syntax check, MACs and decode over all channels' rows at
    once, one MVCC call for the C blocks. Under ``cfg.shard_state`` the
    read and the commit route over ``n_shards`` bucket shards."""
    spw = unmarshal.struct_prefix_words(dims)

    def body(keys, vers, vals, log_head, ledger_head, journal_head, bno,
             ovf, wire, ids):
        nch, b, wb = wire.shape
        words, txb_loc, checksum_ok = stages.stage_syntax(
            wire.reshape(nch * b, wb), dims)
        ok = (checksum_ok & stages.stage_endorse(txb_loc)).reshape(nch, b)
        published = (words[:, :spw] if cfg.separate_metadata
                     else words).reshape(nch, b, -1)
        orders = [orderer.consensus_order(ids[c]) for c in range(nch)]
        ordered_words = torch.stack([published[c][o]
                                     for c, o in enumerate(orders)])
        txb = types.TxBatch(*(a.reshape(nch, b, *a.shape[1:]) for a in
                              stages.decode_published(
                                  ordered_words.reshape(nch * b, -1), dims)))
        tables = [table(keys, vers, vals, c) for c in range(nch)]
        cur = torch.stack([
            stages.stage_read(tables[c], txb.read_keys[c].reshape(-1, 2),
                              cfg, n_shards).reshape(b, -1)
            for c in range(nch)])
        ok_ord = torch.stack([ok[c][o] for c, o in enumerate(orders)])
        valid, blk_ovf = stages.stage_mvcc_commit(
            tables, txb, ok_ord, cur, cfg, n_shards=n_shards,
            channel=channel)
        heads = []
        for c, order in enumerate(orders):
            heads.append((
                stages.fold_log_head(log_head[c], published[c], cfg),
                stages.fold_ledger_head(ledger_head[c], ordered_words[c],
                                        valid[c], cfg),
                stages.advance_journal_head(
                    journal_head[c], bno[c],
                    types.TxBatch(*(a[c] for a in txb)), valid[c]),
                ovf[c] | blk_ovf[c],
                valid[c][torch.argsort(order)]))
        log_h, led, jrn, ovf, valid = (torch.stack(x) for x in zip(*heads))
        return (keys, vers, vals, log_h, led, jrn, u32.add(bno, 1), ovf,
                valid)

    return body


def make_fabric_step(dims: types.FabricDims, cfg: FabricStepConfig, *,
                     n_shards: int = 1, channel=None):
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
    ``channel`` names the channel(s) in errors."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if cfg.shard_state:
        state_sharding.check_shard_count(n_shards, channel=channel)
    depth = cfg.pipeline_depth
    if depth > 1:
        from repro_torch.pipeline import schedule  # layering stays one-way
        body = schedule.make_window_body(dims, cfg, depth, n_shards=n_shards,
                                         channel=channel)
    else:
        body = _block_body(dims, cfg, n_shards, channel)

    def apply(state: FabricMeshState, wire, ids):
        if wire.shape[0] != state.keys.shape[0]:
            raise ValueError(
                f"a state of {state.keys.shape[0]} channels got a wire of "
                f"{wire.shape[0]} channels")
        if cfg.shard_state:
            ws.shard_buckets(state.keys.shape[1], n_shards)  # the split
        if depth > 1 and (wire.ndim != 4 or wire.shape[1] != depth):
            raise ValueError(
                f"pipeline_depth={depth} expects wire (C, {depth}, B, WB); "
                f"got {tuple(wire.shape)}")
        out = body(*state, wire, ids)
        return FabricMeshState(*out[:-1]), out[-1]

    return apply
