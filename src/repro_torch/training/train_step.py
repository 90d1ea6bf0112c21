"""Training step (port of repro.training.train_step): CE loss -> grads ->
AdamW, with the FastFabric endorse -> order -> commit pipeline applied to
gradient blocks.

A microbatch's gradient is a *transaction*:
  endorse  -- the microbatch's loss and every gradient finite;
  order    -- microbatches combine in a fixed order (a Python loop here,
              the JAX package's ``lax.scan``), so every replica commits the
              same update: the optimizer state is the world state;
  commit   -- AdamW applies only endorsed microbatches; a failed
              endorsement (NaN/inf from a bad node) is flagged and skipped
              without stalling the step, and the step's gradient digest is
              chained into a ledger head that checkpoints verify against.

Every decision (endorsement, the skip when no microbatch endorsed) is a
device tensor used through ``torch.where``: a step never waits for the
host. The state is updated IN PLACE (params and moments; the step counter
and ledger head are new tensors in the returned state).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import hashing, ledger
from repro_torch.models.lm import (LM, Batch, jax_leaves, tree_leaves,
                                   tree_unflatten)
from repro_torch.training import optimizer


class TrainState(NamedTuple):
    params: Any  # the model's parameter tree (``ParamTree.tree()``)
    opt: optimizer.AdamWState
    ledger_head: torch.Tensor  # (2,) u32 (int32 words): chained digests


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: optimizer.AdamWConfig = optimizer.AdamWConfig()
    clip_norm: float = 1.0
    microbatches: int = 1  # grad accumulation steps (endorse per microbatch)
    endorse_grads: bool = True  # finite-check each microbatch (fabric mode)
    accum_dtype: str = "float32"  # grad-accumulator dtype (microbatches > 1)


def init_state(model: LM, generator: torch.Generator | None = None
               ) -> TrainState:
    """Draw the weights from ``generator`` (or keep the ones the model has
    loaded), turn their gradients on, and zero the moments and the ledger
    head."""
    if generator is not None:
        model.init(generator)
    model.params.requires_grad_(True)
    params = model.params.tree()
    return TrainState(params=params, opt=optimizer.init(params),
                      ledger_head=torch.zeros(2, dtype=torch.int32,
                                              device=model.device))


def state_leaves(state: TrainState) -> list[list[torch.Tensor]]:
    """The JAX flatten order of a ``TrainState``: params, ``opt.step``,
    ``opt.m``, ``opt.v``, ``ledger_head``; each leaf as the list of the
    port's tensors it stacks (``models.lm.jax_leaves``)."""
    return (jax_leaves(state.params) + [[state.opt.step]]
            + jax_leaves(state.opt.m) + jax_leaves(state.opt.v)
            + [[state.ledger_head]])


def grad_digest(grads) -> torch.Tensor:
    """Cheap content digest of a gradient tree, (2,) u32 (int32 words).

    Hashes the f32 sums of the JAX leaves, in the JAX flatten order, their
    bits as words: an integrity stamp for the ledger chain, not a
    cryptographic commitment. A stacked JAX leaf is the sum over its
    layers here; it equals JAX's bit for bit wherever the f32 sums are
    exact in any order (small integers, say)."""
    sums = torch.stack([sum(g.float().sum() for g in group)
                        for group in jax_leaves(grads)])
    words = sums.view(torch.int32)[None, :]
    return torch.stack([hashing.hash_words(words, seed=hashing.SEED_A)[0],
                        hashing.hash_words(words, seed=hashing.SEED_B)[0]])


def _split_batch(batch: Batch, n: int) -> Batch:
    """(B, ...) -> (n, B/n, ...), one microbatch a row."""
    def r(x):
        return None if x is None else x.reshape(n, x.shape[0] // n,
                                                *x.shape[1:])

    return Batch(tokens=r(batch.tokens), labels=r(batch.labels),
                 prefix_embeds=r(batch.prefix_embeds),
                 enc_embeds=r(batch.enc_embeds))


def _index_batch(batch: Batch, i: int) -> Batch:
    g = lambda x: None if x is None else x[i]
    return Batch(tokens=g(batch.tokens), labels=g(batch.labels),
                 prefix_embeds=g(batch.prefix_embeds),
                 enc_embeds=g(batch.enc_embeds))


def value_and_grad(model: LM, params: list, batch: Batch):
    """(loss, metrics, grads): the loss of ``batch`` and its gradient with
    respect to each tensor of ``params``."""
    loss, metrics = model.loss(batch)
    grads = list(torch.autograd.grad(loss, params))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _endorse(grads: list, loss: torch.Tensor) -> torch.Tensor:
    """Per-microbatch endorsement: the loss and every gradient finite."""
    finite = torch.isfinite(loss)
    for g in grads:
        finite = finite & torch.isfinite(g).all()
    return finite


def make_train_step(model: LM, cfg: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); ``batch``
    holds tensors on the model's device."""

    def train_step(state: TrainState, batch: Batch):
        params = tree_leaves(state.params)
        dev = params[0].device
        n_mb = cfg.microbatches
        if n_mb == 1:
            loss, metrics, grads = value_and_grad(model, params, batch)
            ok = (_endorse(grads, loss) if cfg.endorse_grads
                  else torch.ones((), dtype=torch.bool, device=dev))
            n_ok = ok.float()
            grads = [torch.where(ok, g, 0) for g in grads]
        else:
            mbs = _split_batch(batch, n_mb)
            acc_dt = getattr(torch, cfg.accum_dtype)
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=dev)
                     for p in params]
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            n_ok = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_mb):
                loss, _, mb_grads = value_and_grad(
                    model, params, _index_batch(mbs, i))
                ok = (_endorse(mb_grads, loss) if cfg.endorse_grads
                      else torch.ones((), dtype=torch.bool, device=dev))
                okf = ok.float()
                for a, g in zip(grads, mb_grads):
                    a.add_(torch.where(ok, g, 0).to(acc_dt))
                del mb_grads
                # A flagged microbatch's loss may be NaN: select, not
                # multiply by 0 (XLA rewrites the reference's okf * loss
                # into this select, so its mean stays finite too).
                loss_sum = loss_sum + torch.where(ok, loss, 0.0)
                n_ok = n_ok + okf
            denom = torch.clamp(n_ok, min=1.0)
            grads = [(g / denom.to(g.dtype)).to(g.dtype) for g in grads]
            loss = loss_sum / denom
            metrics = {"ce": loss}

        grads, gnorm = optimizer.clip_by_global_norm(grads, cfg.clip_norm)
        # Commit: skip the whole block only if *no* microbatch endorsed.
        skip = n_ok < 0.5
        opt, lr = optimizer.apply(cfg.opt, state.opt, params, grads,
                                  skip=skip)
        # Ledger append: chain the step digest (audit for checkpoints).
        grad_tree = tree_unflatten(state.params, grads)
        head = ledger.append_hash(state.ledger_head, state.opt.step,
                                  grad_digest(grad_tree))
        out_metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": lr,
            "endorsed_mb": n_ok,
            "skipped": skip.to(torch.int32),
        }
        out_metrics.update(
            {k: v for k, v in metrics.items() if k not in out_metrics})
        return TrainState(state.params, opt, head), out_metrics

    return train_step

