"""The FastFabric step over one channel on one device (port of
repro.launch.fabric_step).

Per block: the syntactic check and endorsement MACs where the block was
ingested, consensus replication of the published rows (the whole wire, or
under O-I only the structured prefix) into the log head, the deterministic
order, the decode of the replicated rows, the read-set probe, MVCC and the
commit, then the ledger and journal heads. With
``FabricStepConfig.pipeline_depth`` D > 1 the step takes a window of D
blocks (pipeline/schedule): one endorsement launch, one probe and one fused
commit for the whole window, bit-identical to D depth-1 steps.

The reference runs this under ``shard_map`` over a (data, model) mesh;
here there is one device, one channel (C = 1) and one replica, so its
collectives are identities. Bucket-sharded state (``shard_state``) and
several channels are not ported yet: both are refused with a ValueError.
The table is committed in place, as every commit of the port is: the
state a step returns shares its table tensors with the state it was given.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import orderer, types, u32, unmarshal
from repro_torch.core import world_state as ws
from repro_torch.launch import state_sharding
from repro_torch.pipeline import stages

_NOT_PORTED = ("come with multi-channel and sharded state, which are not "
               "ported yet")


class FabricMeshState(NamedTuple):
    """Per-channel peer state, channel dim leading (C = 1 here)."""

    keys: torch.Tensor  # (C, NB, S, 2)
    versions: torch.Tensor  # (C, NB, S)
    values: torch.Tensor  # (C, NB, S, VW)
    log_head: torch.Tensor  # (C, 2)
    ledger_head: torch.Tensor  # (C, 2)
    journal_head: torch.Tensor  # (C, 2) state-journal digest chain
    block_no: torch.Tensor  # (C,) next block number
    overflow: torch.Tensor  # (C, LANES) sticky per-shard overflow bitmask
    # (state_sharding): bit 0 once a commit dropped a write on a full
    # bucket, after which the channel's version accounting is untrusted


def _one_channel(n_channels: int) -> None:
    if n_channels != 1:
        raise ValueError(f"{n_channels} channels: several channels "
                         + _NOT_PORTED)


def create_mesh_state(n_channels: int, dims: types.FabricDims,
                      n_buckets: int = 1 << 10, slots: int = 8, *,
                      device=None) -> FabricMeshState:
    """A fresh state of ``n_channels`` (= 1) channels on ``device``
    (default: the card; raises without one unless ``device='cpu'``)."""
    _one_channel(n_channels)
    table = ws.create(n_buckets, slots, dims.vw, device=device)
    dev = table.keys.device
    z = lambda *shape: torch.zeros(shape, dtype=u32.WORD, device=dev)
    return FabricMeshState(
        keys=table.keys[None], versions=table.versions[None],
        values=table.values[None], log_head=z(1, 2), ledger_head=z(1, 2),
        journal_head=z(1, 2), block_no=z(1),
        overflow=z(1, state_sharding.OVERFLOW_LANES))


@dataclasses.dataclass(frozen=True)
class FabricStepConfig:
    separate_metadata: bool = True  # O-I
    pipelined: bool = True  # O-II
    sequential_commit: bool = False  # paper-faithful serial commit (K3)
    tree_hash: bool = False  # O(log B) pairwise log and ledger folds
    shard_state: bool = False  # bucket-sharded state: not ported, refused
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


def _block_body(dims: types.FabricDims, cfg: FabricStepConfig, channel):
    """The depth-1 step of one channel: one block, every stage in order."""
    spw = unmarshal.struct_prefix_words(dims)

    def body(keys, vers, vals, log_head, ledger_head, journal_head, bno,
             ovf, wire, ids):
        words, txb_loc, checksum_ok = stages.stage_syntax(wire, dims)
        ok = checksum_ok & stages.stage_endorse(txb_loc)
        published = words[:, :spw] if cfg.separate_metadata else words
        log_head = stages.fold_log_head(log_head, published, cfg)
        order = orderer.consensus_order(ids)
        ordered_words = published[order]
        txb = stages.decode_published(ordered_words, dims)
        st = ws.HashState(keys=keys, versions=vers, values=vals)
        cur = ws.lookup(st, txb.read_keys.reshape(-1, 2)).versions
        st, valid, blk_ovf = stages.stage_mvcc_commit(
            st, txb, ok[order], cur.reshape(txb.batch, -1), cfg,
            channel=channel)
        led = stages.fold_ledger_head(ledger_head, ordered_words, valid, cfg)
        jrn = stages.advance_journal_head(journal_head, bno, txb, valid)
        return (st.keys, st.versions, st.values, log_head, led, jrn,
                u32.add(bno, 1), ovf | blk_ovf, valid[torch.argsort(order)])

    return body


def make_fabric_step(dims: types.FabricDims, cfg: FabricStepConfig, *,
                     channel=None):
    """The step ``apply(state, wire, ids) -> (state, valid)`` for one
    channel on the state's device.

    Depth 1: ``wire`` (1, B, WB) u8, ``ids`` (1, B, 2), ``valid`` (1, B).
    Depth D: ``wire`` (1, D, B, WB), ``ids`` (1, D, B, 2), ``valid``
    (1, D, B), bit-identical to D depth-1 steps. ``valid`` is in ingest
    order. ``channel`` names the channel in errors."""
    if cfg.shard_state:
        raise ValueError("shard_state=True: sharded state " + _NOT_PORTED)
    depth = cfg.pipeline_depth
    if depth > 1:
        from repro_torch.pipeline import schedule  # layering stays one-way
        body = schedule.make_window_body(dims, cfg, depth, channel=channel)
    else:
        body = _block_body(dims, cfg, channel)

    def apply(state: FabricMeshState, wire, ids):
        _one_channel(state.keys.shape[0])
        _one_channel(wire.shape[0])
        if depth > 1 and (wire.ndim != 4 or wire.shape[1] != depth):
            raise ValueError(
                f"pipeline_depth={depth} expects wire (C, {depth}, B, WB); "
                f"got {tuple(wire.shape)}")
        out = body(*(a[0] for a in state), wire[0], ids[0])
        return FabricMeshState(*(o[None] for o in out[:-1])), out[-1][None]

    return apply
