"""AdamW from scratch (port of repro.training.optimizer): f32 moments,
decoupled weight decay.

Moments are f32 whatever the param dtype; the update upcasts params to
f32, applies the step and casts back, the pattern for bf16 params trained
without a separate master copy. Plain torch over the leaves of a params
tree (nested dicts and lists of tensors, ``models.lm.map_tree``): the JAX
optimizer is no Pallas kernel. Unlike the JAX package, which returns new
trees, ``apply`` updates params and moments IN PLACE (a full-width state
is tens of GB) and returns the new step counter; ``skip`` is a device
tensor and the update a ``torch.where`` on it, so nothing waits for the
host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.lm import map_tree, tree_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict
    v: dict


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=map_tree(zeros, params), v=map_tree(zeros, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac; f32 on step's device."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, f32, summed leaf by leaf
    in the order given."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + (g.float() ** 2).sum()
    return torch.sqrt(total)


def clip_by_global_norm(grads: list, max_norm: float):
    """Scale every leaf IN PLACE so the global norm is at most
    ``max_norm``; returns (grads, norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def apply(cfg: AdamWConfig, state: AdamWState, params: list, grads: list,
          *, skip: torch.Tensor | None = None):
    """One AdamW step over matching lists of param, grad (and the state's
    moment) leaves, IN PLACE. ``skip``: () bool tensor; where True (no
    microbatch endorsed) moments and params keep their values but the step
    counter still advances. Returns (new AdamWState, lr)."""
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    keep = (torch.logical_not(skip) if skip is not None
            else torch.ones((), dtype=torch.bool, device=step.device))
    for p, g, m, v in zip(params, grads, tree_leaves(state.m),
                          tree_leaves(state.v)):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        mhat = m2 / bc1
        vhat = v2 / bc2
        pf = p.float()
        step_vec = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
        p2 = pf - lr * step_vec
        p.copy_(torch.where(keep, p2, pf).to(p.dtype))
        m.copy_(torch.where(keep, m2, m))
        v.copy_(torch.where(keep, v2, v))
    return AdamWState(step=step, m=state.m, v=state.v), lr
