"""Sharding rules (port of repro.launch.sharding): params, optimizer state,
batches and decode caches over a (data, model) :class:`~repro_torch.launch.
mesh.Mesh`, and the placement that cuts tensors by them.

The layout is the reference's DP (data) x TP (model):
  * vocab/embedding over ``model``;
  * attention QKV output dim and MLP hidden over ``model`` (Megatron
    column/row split: wq/wk/wv/w_gate/w_up column-, wo/w_down row-parallel);
  * MoE experts over ``model`` (expert parallelism), or TP inside each
    expert where the expert count does not divide;
  * Mamba inner channels / SSD heads over ``model``;
  * decode KV caches: batch over ``data`` when divisible, sequence over
    ``model`` (flash-decode); batch 1 shards the sequence over every axis;
  * ZeRO-1: optimizer moments take the param sharding plus a ``data``
    shard on the first replicated, divisible dim.

A spec is a :class:`P`: one entry a dimension, an axis name, a tuple of
axis names (major first) or None (not split). The port's params hold one
dict a layer in ``layers``/``enc_layers`` where the reference stacks a
leading L dimension, so a port leaf's :func:`param_specs` entry is the
reference's spec without its leading entry. The rules see only trailing
dimensions (and, for ``embed``/``lm_head``, an unstacked leaf's first), so
they are the reference's, leaf for leaf. ZeRO-1 may pick the stacked L
dimension itself, so :func:`opt_specs` gives a moment under a layer list
the spec of the stacked leaf, the list's entry first.

:func:`place` cuts a one-device tree (tensors or numpy arrays) into one
tree a position, each leaf the position's block on its device, and
:func:`gather` puts such trees back together on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.launch import mesh as mesh_lib

# Param-leaf names that shard their LAST dim over `model`.
_COL = {"wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up", "in_proj",
        "conv_w", "conv_b", "dt_bias", "A_log", "D"}
# Param-leaf names that shard their SECOND-TO-LAST dim over `model`.
_ROW = {"wo", "w_down", "out_proj"}
# Fully replicated.
_REPL = {"scale", "router"}
# The port's lists of per-layer dicts (one stacked dict each in JAX).
LAYER_LISTS = ("layers", "enc_layers")


class P(tuple):
    """A partition spec: ``P("model", None)`` splits dim 0 over ``model``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def param_pspec(path, leaf, msize: int) -> P:
    """Sharding rule for one param leaf at ``path`` (its keys; list indices
    are skipped). ``msize``: model-axis width.

    A dim is only sharded if divisible by the axis width and at least as
    large. Fallbacks: MoE experts not divisible (qwen2-moe: 60 on 16) ->
    tensor parallelism inside each expert; anything else non-divisible ->
    replicate."""
    names = [p for p in path if isinstance(p, str)]
    last = names[-1]
    nd = len(leaf.shape)
    div = lambda i: leaf.shape[i] % msize == 0 and leaf.shape[i] >= msize
    if last in ("embed", "lm_head"):
        return P("model", None) if div(0) else P(None, None)
    if last in _REPL:
        return P(*((None,) * nd))
    in_moe = "moe" in names and "shared" not in names
    if in_moe and last in ("w_gate", "w_up", "w_down"):
        # (E, D, F): experts over model (EP)...
        if div(nd - 3):
            return P(*((None,) * (nd - 3)), "model", None, None)
        # ...else TP inside each expert (column for gate/up, row for down).
        if last in ("w_gate", "w_up") and div(nd - 1):
            return P(*((None,) * (nd - 1)), "model")
        if last == "w_down" and div(nd - 2):
            return P(*((None,) * (nd - 2)), "model", None)
        return P(*((None,) * nd))
    if last in _COL:
        return (P(*((None,) * (nd - 1)), "model") if div(nd - 1)
                else P(*((None,) * nd)))
    if last in _ROW:
        return (P(*((None,) * (nd - 2)), "model", None) if div(nd - 2)
                else P(*((None,) * nd)))
    return P(*((None,) * nd))


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists (a :class:`P` and
    None are leaves)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def leaves_with_path(tree) -> list:
    """[(path, leaf)] of a tree, in :func:`map_with_path`'s order."""
    out = []
    map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def param_specs(params_shape, mesh=None) -> Any:
    """The tree of :class:`P` for a params tree (of tensors, meta tensors
    included)."""
    msize = mesh_lib.model_size(mesh) if mesh is not None else 16
    return map_with_path(lambda pth, lf: param_pspec(pth, lf, msize),
                         params_shape)


def zero1_pspec(spec: P, shape, dp: tuple, dp_total: int) -> P:
    """Add a `data` shard to the first replicated divisible dim (ZeRO-1)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dp_total == 0 and dim >= dp_total:
            entries[i] = dp if len(dp) > 1 else dp[0]
            return P(*entries)
    return spec


def opt_specs(params_shape, mesh, *, zero1: bool = True):
    """AdamWState specs: moments = param spec (+ZeRO-1), step replicated.
    A moment under a layer list of L layers has the spec of the stacked
    (L, ...) leaf (see the module docstring)."""
    from repro_torch.training.optimizer import AdamWState

    dp = mesh_lib.dp_axes(mesh)
    dpt = mesh_lib.dp_size(mesh)
    msize = mesh_lib.model_size(mesh)

    def moment(path, leaf):
        spec, shape = param_pspec(path, leaf, msize), tuple(leaf.shape)
        if path[0] in LAYER_LISTS:
            spec = P(None, *spec)
            shape = (len(params_shape[path[0]]),) + shape
        return zero1_pspec(spec, shape, dp, dpt) if zero1 else spec

    mspecs = map_with_path(moment, params_shape)
    return AdamWState(step=P(), m=mspecs, v=mspecs)


def _dp_entry(mesh):
    dp = mesh_lib.dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def batch_pspecs(batch_shape, mesh):
    """Batch specs (a ``models.lm.Batch`` of :class:`P` or None): leading
    batch dim over the DP axes."""
    dpa = _dp_entry(mesh)
    spec = lambda x: (None if x is None
                      else P(dpa, *((None,) * (len(x.shape) - 1))))
    return dataclasses.replace(batch_shape, **{
        f.name: spec(getattr(batch_shape, f.name))
        for f in dataclasses.fields(batch_shape)})


def _batch_divides(b: int, mesh) -> bool:
    dpt = mesh_lib.dp_size(mesh)
    return b % dpt == 0 and b >= dpt


def cache_pspecs(cache_shape, mesh):
    """DecodeCache specs (see the module docstring for the layout)."""
    from repro_torch.models.lm import DecodeCache

    dpa = _dp_entry(mesh)

    def kv_spec(x):
        # (L|Sites, B, S, H, Dh)
        if x is None:
            return None
        if _batch_divides(x.shape[1], mesh):
            return P(None, dpa, "model", None, None)
        # batch too small (long-context b=1): shard S over everything.
        return P(None, None, tuple(mesh.axis_names), None, None)

    def conv_spec(x):
        # (L, B, K-1, C)
        if x is None:
            return None
        bspec = dpa if _batch_divides(x.shape[1], mesh) else None
        return P(None, bspec, None, "model")

    def ssm_spec(x):
        # (L, B, H, P, N)
        if x is None:
            return None
        bspec = dpa if _batch_divides(x.shape[1], mesh) else None
        return P(None, bspec, "model", None, None)

    c = cache_shape
    return DecodeCache(
        k=kv_spec(c.k), v=kv_spec(c.v), cross_k=kv_spec(c.cross_k),
        cross_v=kv_spec(c.cross_v), conv=conv_spec(c.conv),
        ssm_state=ssm_spec(c.ssm_state), hyb_k=kv_spec(c.hyb_k),
        hyb_v=kv_spec(c.hyb_v))


def token_pspec(batch_size: int, mesh) -> P:
    return P(_dp_entry(mesh)) if _batch_divides(batch_size, mesh) else P()


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def _blocks(spec, shape, mesh, d: int, m: int) -> tuple:
    """The index (a tuple of slices) of position (d, m)'s block of an array
    of ``shape`` under ``spec``. Raises where a split dim does not divide."""
    rank = {"data": d, "model": m}
    index = []
    for dim, entry in enumerate(tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if entry is None:
            index.append(slice(None))
            continue
        at, size = 0, 1
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            at, size = at * mesh.shape[axis] + rank[axis], size * mesh.shape[
                axis]
        if shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {entry!r} ({size})")
        step = shape[dim] // size
        index.append(slice(at * step, (at + 1) * step))
    return tuple(index)


def _to_device(block, path, device) -> torch.Tensor:
    """A contiguous copy of a tensor block on ``device``."""
    return torch.empty(block.shape, dtype=block.dtype, device=device
                       ).copy_(block)


def place(tree, specs, mesh, put=_to_device) -> list:
    """``tree`` (one device, or numpy) cut by ``specs`` (a tree of the same
    structure) -> ``out[d][m]``, position (d, m)'s tree, each leaf
    ``put(block, path, device)`` of its block (default: a contiguous copy
    on the position's device, never a view of the source)."""
    spec_of = dict(leaves_with_path(specs))
    return [[map_with_path(
        lambda path, x, d=d, m=m, dev=dev: put(
            x[_blocks(spec_of[path], x.shape, mesh, d, m)], path, dev),
        tree) for m, dev in enumerate(row)]
        for d, row in enumerate(mesh.devices)]


def gather(parts: list, specs, mesh, device) -> Any:
    """The inverse of :func:`place`: ``parts[d][m]`` trees -> one tree on
    ``device``, each leaf assembled from its positions' blocks."""
    spec_of = dict(leaves_with_path(specs))
    flat = [[dict(leaves_with_path(t)) for t in row] for row in parts]

    def leaf(path, x):
        spec = spec_of[path]
        shape = list(x.shape)
        for dim, entry in enumerate(spec):
            for axis in (() if entry is None else entry
                         if isinstance(entry, tuple) else (entry,)):
                shape[dim] *= mesh.shape[axis]
        out = torch.empty(shape, dtype=x.dtype, device=device)
        for d, row in enumerate(flat):
            for m, blocks in enumerate(row):
                out[_blocks(spec, shape, mesh, d, m)] = blocks[path].to(device)
        return out

    return map_with_path(leaf, parts[0][0])
