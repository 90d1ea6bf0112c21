"""The port's hot-path programs, by the reference's names (port of
repro.analysis.registry).

The reference's hot-path modules register jit builders that the analyzer
lowers without running. A torch program is checked by running it, so a
builder here takes a :class:`BuildContext` (a (1, M) mesh, small fabric
dims, table sizing) and returns a :class:`BuiltProgram`: the port's
callable, concrete small inputs made from a seed, and which of its tensors
must come back in place. The seven programs are registered below, under
the reference's names, each from the port's counterpart of the
reference's builder:

  * ``fabric_step/*`` -- ``make_fabric_step(..., mesh=)``, as the
    reference's ``_register_step`` (``launch/fabric_step.py``).
  * ``pipeline/stats_pass`` -- ``engine_bridge.stats_pass``, the device
    part of ``WindowCommitter.shard_stats``.
  * ``pipeline/resize_exchange`` -- ``state_sharding.resize_sharded`` over
    the mesh row, one channel 256 -> 512 buckets.
  * ``serving/decode_step`` -- ``serving.engine.decode_step_slots`` at the
    qwen2-7b smoke config, 2 slots of 16.

Import direction: nothing here is imported by the hot paths; the builders
import them when called.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

_PROGRAMS: dict[str, "Registered"] = {}


@dataclasses.dataclass(frozen=True)
class BuildContext:
    """Sizing for the checked programs: small enough to run in seconds on
    the CPU, the same stages, collectives and commit as production."""

    mesh: object  # launch/mesh.Mesh of shape (1, M)
    dims: object  # types.FabricDims (TEST_DIMS in the gate)
    b_loc: int = 8  # txs per model rank per block
    n_buckets: int = 256  # global bucket count (divisible by model ranks)
    slots: int = 8
    n_channels: int = 1


@dataclasses.dataclass
class BuiltProgram:
    """One runnable hot-path program.

    ``fn(*args)`` is the warm-up call; ``again(out)`` gives the recorded
    call's arguments from the warm-up's output (None: ``args`` again).
    ``donated(args)`` lists (label, tensor) of the state fields that must
    come back in place and ``donated_out(out)`` the same labels in the
    result; ``tables(args)`` lists (label, {field: tensor}) of the tables a
    call commits into (None for a program that commits nothing), for the
    commit-pass count and the copy check. ``mesh`` is the mesh whose
    collectives the program calls, None for a one-device program.
    """

    name: str
    fn: Callable
    args: tuple
    again: Optional[Callable] = None
    donated: Optional[Callable] = None
    donated_out: Optional[Callable] = None
    tables: Optional[Callable] = None
    mesh: object = None
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Registered:
    name: str
    builder: Callable[[BuildContext], BuiltProgram]
    description: str = ""


def register(name: str, *, description: str = ""):
    """Decorator: register ``builder(ctx) -> BuiltProgram`` under ``name``.
    Re-registration overwrites."""

    def deco(builder):
        _PROGRAMS[name] = Registered(name, builder, description)
        return builder

    return deco


def discover() -> dict[str, Registered]:
    """The registry, name-sorted (every builder is registered at import)."""
    return dict(sorted(_PROGRAMS.items()))


def get(name: str) -> Registered:
    return _PROGRAMS[name]


# ---------------------------------------------------------------------------
# Inputs and state views
# ---------------------------------------------------------------------------

TABLE_FIELDS = ("keys", "versions", "values")
SEED = 0  # the programs' inputs and weights


def endorsed_blocks(dims, n_blocks: int, b: int, seed: int, device
                    ) -> tuple:
    """(n_blocks, b, WB) u8 wire and (n_blocks, b, 2) ids of endorsed
    transfer blocks made by the port's endorser from ``seed``."""
    from repro_torch.core import endorser, engine, unmarshal

    eng = engine.FabricEngine(engine.EngineConfig(
        dims=dims, store_blocks=False), device=device)
    wires, ids = [], []
    for k in range(n_blocks):
        txb = endorser.execute_and_endorse(
            eng.endorser_state,
            eng.make_proposals(b, seed=seed * 1000 + k), dims)
        wires.append(unmarshal.marshal(txb, dims))
        ids.append(txb.tx_id)
    return torch.stack(wires), torch.stack(ids)


def mesh_tables(ms) -> list:
    """(label, {field: tensor}) of every rank's table of every channel of
    a placed state."""
    out = []
    for d, row in enumerate(ms.ranks):
        for m, r in enumerate(row):
            for c in range(r.keys.shape[0]):
                out.append((f"rank({d},{m})/channel {c}",
                            {f: getattr(r, f)[c] for f in TABLE_FIELDS}))
    return out


def mesh_fields(ms) -> list:
    """(label, tensor) of every rank's table fields of a placed state."""
    return [(f"rank({d},{m}).{f}", getattr(r, f))
            for d, row in enumerate(ms.ranks) for m, r in enumerate(row)
            for f in TABLE_FIELDS]


# ---------------------------------------------------------------------------
# fabric_step/*
# ---------------------------------------------------------------------------


def step_program(ctx: BuildContext, name: str, cfg, depth: int,
                 n_channels: int = 1) -> BuiltProgram:
    """The mesh step of ``cfg`` at ``depth`` over ``ctx.mesh``, on a fresh
    placed state; the warm-up and the recorded call commit two different
    windows of endorsed blocks."""
    from repro_torch.launch import fabric_step as fs

    dcfg = dataclasses.replace(cfg, pipeline_depth=depth)
    mesh = ctx.mesh
    step = fs.make_fabric_step(ctx.dims, dcfg, mesh=mesh)
    state = fs.create_mesh_state(
        n_channels, ctx.dims, ctx.n_buckets, ctx.slots, mesh=mesh,
        shard_state=dcfg.shard_state)
    b = ctx.b_loc * mesh.model_size

    def window(seed):
        blocks = [endorsed_blocks(ctx.dims, depth, b, seed + 17 * c,
                                  mesh.first) for c in range(n_channels)]
        wire, ids = (torch.stack(x) for x in zip(*blocks))
        return (wire, ids) if depth > 1 else (wire[:, 0], ids[:, 0])

    first, second = window(SEED), window(SEED + 1)
    return BuiltProgram(
        name=name, fn=step, args=(state, *first),
        again=lambda out: (out[0], *second),
        donated=lambda args: mesh_fields(args[0]),
        donated_out=lambda out: mesh_fields(out[0]),
        tables=lambda args: mesh_tables(args[0]), mesh=mesh,
        meta={"depth": depth, "n_channels": n_channels,
              "config": dcfg.name, "block_txs": b})


def _register_step(name: str, cfg_name: str, depth: int,
                   n_channels: int = 1, description: str = "") -> None:
    @register(name, description=description)
    def _build(ctx):
        from repro_torch.launch import fabric_step as fs

        return step_program(ctx, name, getattr(fs, cfg_name), depth,
                            n_channels)


_register_step("fabric_step/repl/d1", "FASTFABRIC_STEP", 1,
               description="replicated-state single-block step (the oracle)")
_register_step("fabric_step/shard/d1", "FASTFABRIC_SHARDED_STEP", 1,
               description="bucket-sharded single-block step (routed MVCC)")
_register_step("fabric_step/shard/d8", "FASTFABRIC_PIPELINED_STEP", 8,
               description="sharded depth-8 window step (fused commit)")
_register_step("fabric_step/shard/d4/c2", "FASTFABRIC_SHARDED_STEP", 4,
               n_channels=2,
               description="two channels through a depth-4 window")


# ---------------------------------------------------------------------------
# pipeline/*
# ---------------------------------------------------------------------------


def _sharded_state(ctx: BuildContext, n_channels: int = 1):
    """A placed sharded state whose tables hold the commits of one depth-1
    step (so the stats and the resize see occupied buckets)."""
    from repro_torch.launch import fabric_step as fs

    built = step_program(ctx, "fill", fs.FASTFABRIC_SHARDED_STEP, 1,
                         n_channels)
    return built.fn(*built.args)[0]


@register("pipeline/stats_pass",
          description="stacked per-shard occupancy/min-free reductions")
def _build_stats_pass(ctx):
    from repro_torch.pipeline import engine_bridge

    nch = max(ctx.n_channels, 1)
    ms = _sharded_state(ctx, nch)

    def lanes(c):
        d, i = ms.rank_of(c)
        return ms.ranks[d][0].overflow[i]

    return BuiltProgram(
        name="pipeline/stats_pass", fn=engine_bridge.stats_pass,
        args=([ms.tables(c) for c in range(nch)],
              [lanes(c) for c in range(nch)], ctx.mesh.first),
        mesh=ctx.mesh, meta={"n_shards": ctx.mesh.model_size})


@register("pipeline/resize_exchange",
          description="butterfly bucket-shard exchange of one channel's "
                      "table")
def _build_resize_exchange(ctx):
    from repro_torch.launch import state_sharding

    ms = _sharded_state(ctx)
    m, nb = ctx.mesh.model_size, ctx.n_buckets

    def exchange(tables):
        return state_sharding.resize_sharded(
            tables, 2 * nb // m, nb, m, mesh=ctx.mesh, row=0)

    return BuiltProgram(
        name="pipeline/resize_exchange", fn=exchange, args=(ms.tables(0),),
        mesh=ctx.mesh, meta={"old_n_buckets": nb, "new_n_buckets": 2 * nb})


# ---------------------------------------------------------------------------
# serving/decode_step
# ---------------------------------------------------------------------------


@register("serving/decode_step",
          description="slot-batched decode step with per-slot positions")
def _build_decode_step(ctx):
    from functools import partial

    from repro_torch.configs import base as cfg_base
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import decode_step_slots

    dev = ctx.mesh.first
    cfg = cfg_base.get_smoke("qwen2-7b")
    model = LM(cfg, vocab_chunk=8, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    slots, max_len = 2, 16
    cache = model.init_cache(slots, max_len)
    gen = torch.Generator().manual_seed(SEED)
    token = torch.randint(0, cfg.vocab, (2, slots), generator=gen,
                          dtype=torch.int32).to(dev)
    pos = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    active = torch.tensor([True, False], device=dev)
    kv = lambda c: [("k", c.k), ("v", c.v)]
    return BuiltProgram(
        name="serving/decode_step", fn=partial(decode_step_slots, model),
        args=(cache, token[0], pos, active),
        again=lambda out: (out[1], token[1], pos + 1, active),
        donated=lambda args: kv(args[0]),
        donated_out=lambda out: kv(out[1]),
        meta={"arch": "qwen2-7b-smoke", "slots": slots, "max_len": max_len})
