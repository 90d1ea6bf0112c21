"""Mixture-of-Experts MLP (port of repro.models.moe): shared experts plus
routed top-k, capacity-bounded dispatch.

Token->expert assignments are packed into an (E, C, D) buffer, the experts
run as batched products over it, and the outputs are gathered back and
combined by the router's weights. Assignments past an expert's capacity
are *dropped* (their residual passes through). The JAX package's
expert-parallel mesh hook (``shard_group``) has no counterpart here;
``moe_mlp_mesh`` runs the layer over a mesh with the experts over
``model`` (or split inside each expert), as ``launch.sharding`` lays
them out.

Every step is deterministic, on the card too: the router's top k come from
a stable sort (the lower expert id first among equal probabilities, as
``jax.lax.top_k``), each buffer row that an output reads is written once
(kept (expert, position) pairs are unique), and each token's k
contributions are summed in a fixed order (``_combine``), never by an
atomic scatter-add. Nothing syncs the host: a dropped assignment is
written to a scratch row that no output reads.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

# The leaves that ``init_moe`` makes f32 whatever ``cfg.dtype``.
F32_LEAVES = frozenset({"router"})


def init_moe(cfg: ModelConfig, device, generator) -> dict:
    """The router (f32 whatever ``cfg.dtype``), the experts' SwiGLU weights
    (E, d_in, d_out), each a standard normal truncated to [-2, 2] over
    sqrt(d_in), and the shared experts as one MLP n_shared times as wide."""
    dt = cfg.torch_dtype
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def ew(din, dout):
        w = torch.empty((e, din, dout), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return w.mul_(1.0 / math.sqrt(din)).to(dt)

    p = {
        "router": layers._dense_init(d, e, torch.float32, device, generator),
        "w_gate": ew(d, f),
        "w_up": ew(d, f),
        "w_down": ew(f, d),
    }
    if cfg.n_shared:
        p["shared"] = layers.init_mlp(d, cfg.n_shared * f, dt, device,
                                      generator)
    return p


def route(router_w: torch.Tensor, x2d: torch.Tensor, top_k: int):
    """Router: (T, D) -> (weights (T, K) f32, experts (T, K) int64, aux).
    The top k by a stable descending sort: among equal probabilities the
    lower expert id comes first, as in ``jax.lax.top_k``."""
    logits = x2d.float() @ router_w.float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = srt[:, :top_k], idx[:, :top_k]
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    # Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e.
    e = router_w.shape[1]
    hits = _onehot(experts[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(hits * probs.mean(dim=0))
    return weights, experts, aux


def _onehot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """(..., ) ids -> (..., E) int64 one-hot (``F.one_hot`` without its
    range check, which reads the ids back to the host)."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).long()


def capacity(capacity_factor: float, t: int, k: int, e: int) -> int:
    """Slots per expert for t tokens: the reference's Python-float rule."""
    return int(max(1, capacity_factor * t * k / e))


def _count(stats: dict | None, keep: torch.Tensor) -> None:
    """Add the call's assignments (an int) and dropped assignments (a
    device tensor: no sync) to ``stats``."""
    if stats is not None:
        stats["assignments"] = stats.get("assignments", 0) + keep.numel()
        stats["dropped"] = stats.get("dropped", 0) + (~keep).sum()


def _experts(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its rows: buf (E, C, D) -> (E, C, D).
    silu in f32, cast back to the buffer's dtype, times the up product."""
    dt = buf.dtype
    g = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    act = torch.nn.functional.silu(g.float()).to(dt) * u
    return torch.bmm(act, p["w_down"].to(dt))


def _combine(contrib: torch.Tensor) -> torch.Tensor:
    """(T, K, D) f32 contributions, each token's in the order the
    reference's scatter-add meets them -> (T, D), summed left to right from
    zero (a fixed order: no atomics, repeat runs bit-identical)."""
    y = torch.zeros_like(contrib[:, 0])
    for j in range(contrib.shape[1]):
        y = y + contrib[:, j]
    return y


def _shared(p: dict, cfg: ModelConfig, x2d: torch.Tensor, y: torch.Tensor):
    if cfg.n_shared:
        y = y + layers.mlp(p["shared"], x2d).float()
    return y


def moe_mlp(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
            capacity_factor: float = 1.25, dispatch: str = "sort",
            groups: int = 1, stats: dict | None = None):
    """(B, S, D) -> ((B, S, D), aux loss). Shared experts always on.

    ``dispatch``: "sort" (a stable sort of the assignments by expert,
    positions from the experts' counts) or "cumsum" (positions from an
    exclusive running count of each expert's assignments); both keep and
    drop the same assignments. ``groups`` > 1 (when it divides the token
    count): capacity is enforced per group of tokens, each group packing
    its own buffer. ``stats``, when given, accumulates the assignments
    routed and dropped (``_count``).
    """
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    x2d = x.reshape(t, d)
    weights, experts, aux = route(p["router"], x2d, k)
    if groups > 1 and t % groups == 0:
        y = _moe_grouped(p, cfg, x2d, weights, experts, capacity_factor,
                         groups, stats)
        return _shared(p, cfg, x2d, y).reshape(b, s, d).to(x.dtype), aux

    flat_e = experts.reshape(t * k)
    cap = capacity(capacity_factor, t, k, e)
    slot = torch.arange(t * k, device=x.device)
    pos = _positions(flat_e, e, dispatch)
    keep = pos < cap  # overflow drops
    _count(stats, keep)
    # Pack the assignments into the (E, C + 1, D) buffer. A dropped one
    # lands in the scratch row C, which no output reads (the reference's
    # out-of-bounds write with mode="drop"): never over a kept row.
    safe = torch.where(keep, pos, cap)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, safe] = x2d[slot // k].to(x.dtype)
    out_buf = _experts(p, buf)

    # Gather back, weight, and combine each token's k assignments: the
    # sorted dispatch's scatter-add meets them by ascending expert id, the
    # cumsum one in slot order.
    y_slot = torch.where(keep[:, None], out_buf[flat_e, safe].float(), 0.0)
    y = _shared(p, cfg, x2d, _weighted(y_slot, weights, experts, dispatch))
    return y.reshape(b, s, d).to(x.dtype), aux


def _positions(flat_e: torch.Tensor, e: int, dispatch: str) -> torch.Tensor:
    """Each assignment's position among its expert's (TK,): "sort" (a
    stable sort by expert, positions from the experts' counts) or "cumsum"
    (an exclusive running count of each expert's assignments)."""
    if dispatch == "sort":
        order = torch.sort(flat_e, stable=True).indices  # (TK,)
        # bincount (whose CUDA version reads the largest id back to the
        # host) as an integer scatter-add: exact in any order.
        counts = torch.zeros(e, dtype=torch.long, device=flat_e.device
                             ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(flat_e.numel(), device=flat_e.device)
        pos = torch.empty_like(slot)
        pos[order] = slot - starts[flat_e[order]]
        return pos
    if dispatch == "cumsum":
        onehot = _onehot(flat_e, e)  # (TK, E)
        pos_all = torch.cumsum(onehot, dim=0) - onehot  # exclusive
        return torch.gather(pos_all, 1, flat_e[:, None])[:, 0]
    raise ValueError(dispatch)


def _weighted(y_slot, weights, experts, dispatch: str) -> torch.Tensor:
    """(TK, D) f32 per-slot outputs -> (T, D), each token's k slots weighted
    and combined in the order the reference's scatter-add meets them: by
    ascending expert id for the sorted dispatch, in slot order for the
    cumsum one."""
    t, k = experts.shape
    d = y_slot.shape[-1]
    contrib = (y_slot * weights.reshape(t * k, 1)).reshape(t, k, d)
    if dispatch == "sort":
        by_expert = torch.sort(experts, dim=1, stable=True).indices
        contrib = torch.gather(contrib, 1,
                               by_expert[..., None].expand(t, k, d))
    return _combine(contrib)


def _moe_grouped(p, cfg, x2d, weights, experts, capacity_factor, groups,
                 stats):
    """Per-group dispatch (see ``moe_mlp``): G groups of T/G tokens, each
    with capacity for its own tokens; returns the routed part (T, D) f32."""
    t, d = x2d.shape
    k, e, g = cfg.top_k, cfg.n_experts, groups
    tg = t // g
    cap = capacity(capacity_factor, tg, k, e)
    eg = experts.reshape(g, tg * k)
    onehot = _onehot(eg, e)  # (G, TgK, E)
    pos_all = torch.cumsum(onehot, dim=1) - onehot  # exclusive, per group
    pos = torch.gather(pos_all, 2, eg[..., None])[..., 0]  # (G, TgK)
    keep = pos < cap
    _count(stats, keep)
    safe = torch.where(keep, pos, cap)  # dropped -> the scratch row
    gidx = torch.arange(g, device=x2d.device)[:, None]
    upd = x2d.reshape(g, tg, d)[gidx, torch.arange(tg * k,
                                                   device=x2d.device) // k]
    buf = torch.zeros((g, e, cap + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf[gidx, eg, safe] = upd
    # Every group's rows of an expert in one batched product.
    out = _experts(p, buf.transpose(0, 1).reshape(e, g * (cap + 1), d))
    out_buf = out.reshape(e, g, cap + 1, d).transpose(0, 1)
    y_slot = torch.where(keep[..., None], out_buf[gidx, eg, safe].float(),
                         0.0)
    contrib = y_slot.reshape(t, k, d) * weights.reshape(t, k, 1)
    return _combine(contrib)


def moe_mlp_dense_oracle(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Reference: every expert over every token, combined by the router's
    weights. Equal to ``moe_mlp`` when no assignment is dropped."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, experts, aux = route(p["router"], x2d, cfg.top_k)
    dt = x2d.dtype
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for ei in range(cfg.n_experts):
        g = x2d @ p["w_gate"][ei].to(dt)
        u = x2d @ p["w_up"][ei].to(dt)
        o = (torch.nn.functional.silu(g.float()).to(dt) * u) @ p[
            "w_down"][ei].to(dt)
        w_e = torch.where(experts == ei, weights, 0.0).sum(dim=1)
        y = y + o.float() * w_e[:, None]
    y = _shared(p, cfg, x2d, y)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_mesh_mode(specs: dict) -> str:
    """How ``launch.sharding`` laid out an MoE layer's experts over
    ``model``: "ep" (experts split), "tp" (each expert's hidden dim split)
    or "replicated"."""
    spec = specs["w_gate"]
    return ("ep" if spec[0] == "model" else "tp" if spec[-1] == "model"
            else "replicated")


def moe_mlp_mesh(ps: list, cfg: ModelConfig, xs: list, mode: str,
                 shared_split: bool, mesh, *, capacity_factor: float = 1.25,
                 dispatch: str = "sort") -> list:
    """:func:`moe_mlp` over a mesh: ``xs[d][m]`` (B/data, S, D) on position
    (d, m), equal along a row; ``ps[d][m]`` its params; ``mode`` from
    :func:`moe_mesh_mode`. Returns the outputs, ``out[d][m]``.

    The router is replicated, so every rank of a row computes the same
    routes. Dispatch is the reference's over the whole batch: the capacity
    counts every data row's tokens, and an assignment's position among its
    expert's adds the assignments of the rows before it (one all-gather of
    each row's per-expert counts over ``data``). Under "ep" each rank packs
    and runs only its experts' buffer rows; under "tp" every rank runs
    every expert on its columns of gate/up and rows of down. The per-slot
    outputs (under "ep" each non-zero on one rank, so their sum is exact),
    and the shared experts' partial products when they are split, are
    summed over the row in one ``psum`` before the fixed-order combine."""
    k, e = cfg.top_k, cfg.n_experts
    n_rows, n_ranks = len(xs), len(xs[0])
    n_local = e // n_ranks if mode == "ep" else e
    t_all = sum(r[0].shape[0] * r[0].shape[1] for r in xs)
    cap = capacity(capacity_factor, t_all, k, e)
    routed = [[] for _ in xs]
    routes = [[] for _ in xs]
    for d in range(n_rows):
        for p, x in zip(ps[d], xs[d]):
            weights, experts, _ = route(p["router"], x.reshape(-1, x.shape[2]),
                                        k)
            flat_e = experts.reshape(-1)
            counts = torch.zeros(e, dtype=torch.long, device=x.device
                                 ).scatter_add_(0, flat_e,
                                                torch.ones_like(flat_e))
            routes[d].append((weights, experts, flat_e,
                              _positions(flat_e, e, dispatch), counts))
    if n_rows > 1:  # the rows before each row: its positions' offsets
        for m in range(n_ranks):
            got = mesh.column_gather(m, [routes[d][m][4][None]
                                         for d in range(n_rows)], 0,
                                     "moe_counts")
            for d in range(n_rows):
                w, ex, fe, pos, c = routes[d][m]
                before = got[d][:d].sum(dim=0)
                routes[d][m] = (w, ex, fe, pos + before[fe], c)
    shared = [[] for _ in xs]
    for d in range(n_rows):
        for m, (p, x) in enumerate(zip(ps[d], xs[d])):
            _, _, flat_e, pos, _ = routes[d][m]
            x2d = x.reshape(-1, x.shape[2])
            e0 = m * n_local if mode == "ep" else 0
            mine = (pos < cap) & (flat_e >= e0) & (flat_e < e0 + n_local)
            # The rank's kept slots into its (n_local, C + 1, D) buffer;
            # every other slot lands in the scratch row C of its first
            # expert, which no output reads.
            le = torch.where(mine, flat_e - e0, 0)
            safe = torch.where(mine, pos, cap)
            buf = torch.zeros((n_local, cap + 1, x.shape[2]), dtype=x.dtype,
                              device=x.device)
            slot = torch.arange(flat_e.numel(), device=x.device)
            buf[le, safe] = x2d[slot // k].to(x.dtype)
            routed[d].append(torch.where(
                mine[:, None], _experts(p, buf)[le, safe].float(), 0.0))
            shared[d].append(layers.mlp(p["shared"], x2d).float()
                             if cfg.n_shared else None)
    summed = (mode != "replicated", cfg.n_shared > 0 and shared_split)
    outs = []
    for d in range(n_rows):
        if any(summed):
            tk = routed[d][0].shape[0]
            got = mesh.psum(d, [torch.cat([y for y, on in zip(pair, summed)
                                           if on])
                                for pair in zip(routed[d], shared[d])],
                            "moe_out")
            if summed[0]:
                routed[d] = [g[:tk] for g in got]
            if summed[1]:
                shared[d] = [g[tk:] if summed[0] else g for g in got]
        row = []
        for x, y, sh, (w, ex, _, _, _) in zip(xs[d], routed[d], shared[d],
                                              routes[d]):
            out = _weighted(y, w, ex, dispatch)
            if sh is not None:
                out = out + sh
            row.append(out.reshape(x.shape).to(x.dtype))
        outs.append(row)
    return outs
