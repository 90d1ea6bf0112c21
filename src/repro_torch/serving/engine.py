"""Serving engine: continuous batching on FastFabric principles (port of
repro.serving.engine, dense family).

Paper mapping:
  * O-I  metadata-plane scheduling -- admission orders fixed-width request
    IDs only (``core.orderer.consensus_order``); prompts stay in the local
    queue and join back at slot assignment.
  * P-I  world state -- the request ledger is the core hash table: key =
    request id, value = (slot, steps, done, 0), version-bumped on every
    transition (assign, retire), through the hash-table probe kernel (K2).
  * P-II role separation -- prefill (endorser) and decode (committer) are
    separate calls, here in turn on one device.
  * P-III decode-once -- each prompt is prefilled exactly once (every
    layer's self-attention through the flash-attention kernel, K5, on the
    card); its KV cache slot is reused only after its request retires.

Decode attention (one new query per slot against the masked cache) stays
plain torch, with the JAX engine's masking and f32 softmax. The cache and
the ledger are updated in place.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import hashing, orderer, u32
from repro_torch.core import world_state as ws
from repro_torch.models import layers
from repro_torch.models.lm import LM, Batch, DecodeCache
from repro_torch.obs import health as health_mod
from repro_torch.obs.metrics import Registry


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


# ---------------------------------------------------------------------------
# Batched decode with per-slot positions (continuous batching core).
# ---------------------------------------------------------------------------


def decode_step_slots(model: LM, cache: DecodeCache, token: torch.Tensor,
                      pos_b: torch.Tensor, active: torch.Tensor):
    """One decode step with per-slot positions.

    token (B,) int; pos_b (B,) int -- each slot's current length; active
    (B,) bool -- inactive slots compute but commit nothing (their cache rows
    keep their contents), the Fabric invalid-tx-stays-in-block rule.
    Returns (logits (B, V) f32, cache updated in place).
    """
    cfg = model.cfg
    p = model.params
    x = layers.embed(p["embed"], token)[:, None, :]
    bsz = token.shape[0]
    brange = torch.arange(bsz, device=x.device)
    pos_b = pos_b.long()
    hd, hkv = cfg.head_dim, cfg.n_kv
    g = cfg.n_heads // hkv
    smax = cache.k.shape[2]
    mask = (torch.arange(smax, device=x.device)[None, :]
            <= pos_b[:, None])  # (B, S)

    for i, lp in enumerate(p["layers"]):
        ck, cv = cache.k[i], cache.v[i]
        at = lp["attn"]
        nrm = layers.rmsnorm(lp["norm1"], x, cfg.norm_eps)

        def proj(w, b, nh):
            y = nrm @ w.to(nrm.dtype)
            if b is not None:
                y = y + b.to(y.dtype)
            return y.reshape(bsz, 1, nh, hd)

        q = proj(at["wq"], at.get("bq"), cfg.n_heads)
        k = proj(at["wk"], at.get("bk"), hkv)
        v = proj(at["wv"], at.get("bv"), hkv)
        if cfg.qk_norm:
            q = layers.rmsnorm(at["q_norm"], q, cfg.norm_eps)
            k = layers.rmsnorm(at["k_norm"], k, cfg.norm_eps)
        q = layers.apply_rope(q, pos_b[:, None], cfg.rope_theta)
        k = layers.apply_rope(k, pos_b[:, None], cfg.rope_theta)

        # Per-slot write of the new K/V row (inactive slots keep theirs).
        act = active[:, None, None]
        ck[brange, pos_b] = torch.where(act, k[:, 0].to(ck.dtype),
                                        ck[brange, pos_b])
        cv[brange, pos_b] = torch.where(act, v[:, 0].to(cv.dtype),
                                        cv[brange, pos_b])

        # Attention over each slot's prefix (mask by per-slot position).
        qg = q.reshape(bsz, 1, hkv, g, hd).float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                              ck.float()) / math.sqrt(hd)
        scores = scores.masked_fill(~mask[:, None, None, None, :],
                                    float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        att = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv.float())
        att = att.reshape(bsz, 1, cfg.n_heads * hd).to(x.dtype)
        x = x + att @ at["wo"].to(x.dtype)
        x = x + layers.mlp(lp["mlp"], layers.rmsnorm(lp["norm2"], x,
                                                     cfg.norm_eps))
    x = layers.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    table = p["embed"] if cfg.tie_embeddings else p["lm_head"]
    logits = layers.unembed(table, x, transpose=True)[:, 0][:, : cfg.vocab]
    return logits, cache


def insert_prefill(cache: DecodeCache, slot_cache: DecodeCache,
                   slot: int) -> DecodeCache:
    """Copy a single-request prefill cache (B=1) into batch slot ``slot``,
    in place; positions past the prompt are zeroed."""
    sp = slot_cache.k.shape[2]
    for big, small in ((cache.k, slot_cache.k), (cache.v, slot_cache.v)):
        big[:, slot, :sp] = small[:, 0].to(big.dtype)
        big[:, slot, sp:] = 0
    return cache


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class ServeEngine:
    """Slot-based continuous batching with fabric-style bookkeeping, on the
    model's device. ``step`` = ``admit`` (prefill queued requests into free
    slots) + ``decode`` (one batched token for every active slot)."""

    def __init__(self, model: LM, *, slots: int = 4, max_len: int = 256,
                 registry: Registry | None = None):
        self.model = model
        self.device = model.device
        self.n_slots = slots
        self.max_len = max_len
        # Admission-queue depth, active slots, decode-step latency,
        # token/request counters: host-side bookkeeping, always on.
        self.registry = registry if registry is not None else Registry()
        self.cache = model.init_cache(slots, max_len)
        self.pos = np.zeros((slots,), np.int32)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []
        # P-I world state: request ledger (rid -> slot/steps), versioned.
        self.state = ws.create(n_buckets=256, slots=8, value_width=4,
                               device=self.device)
        self.decode_fn = functools.partial(decode_step_slots, model)
        self.prefill_fn = model.prefill
        self.steps = 0
        self.tokens_out = 0

    # ---- fabric bookkeeping ----

    def _words(self, values) -> torch.Tensor:
        return torch.tensor([u32.s32(v) for v in values], dtype=u32.WORD,
                            device=self.device)

    def _rid_key(self, rid: int) -> torch.Tensor:
        h1, h2 = hashing.hash_pair(self._words([rid]))
        return torch.stack([hashing.nonzero_key(h1), h2], dim=-1)  # (1, 2)

    def _commit_state(self, rid: int, slot: int, steps: int, done: int):
        val = self._words([slot, steps, done, 0])[None]  # (1, 4)
        res = ws.commit_vectorized(
            self.state, self._rid_key(rid)[:, None, :], val[:, None, :],
            torch.ones((1,), dtype=torch.bool, device=self.device))
        self.state = res.state

    def request_version(self, rid: int) -> int:
        look = ws.lookup(self.state, self._rid_key(rid))
        return int(u32.to_numpy(look.versions)[0])

    # ---- admission (O-I): order IDs, payloads join at assignment ----

    def submit(self, requests: list[Request]) -> None:
        ids = torch.stack(hashing.hash_pair(
            self._words([r.rid for r in requests])), dim=-1)  # (N, 2)
        order = orderer.consensus_order(ids).tolist()
        self.queue.extend(requests[i] for i in order)
        self.registry.counter("serving.requests.submitted").inc(len(requests))
        self.registry.gauge("serving.queue.depth").set(len(self.queue))

    # ---- scheduling loop ----

    def admit(self) -> None:
        """Prefill queued requests, in admission order, into free slots."""
        vocab = self.model.cfg.vocab
        for s in range(self.n_slots):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None]
            small = self.model.init_cache(1, prompt.shape[1])
            logits, small = self.prefill_fn(Batch(tokens=prompt), small)
            insert_prefill(self.cache, small, s)
            req.out.append(int(torch.argmax(logits[0][:vocab])))
            self.slot_req[s] = req
            self.pos[s] = len(req.prompt)
            self._commit_state(req.rid, s, 1, 0)
            self.registry.counter("serving.prefills").inc()
            self.registry.gauge("serving.queue.depth").set(len(self.queue))

    def decode(self) -> int:
        """One batched decode step over the active slots; retires finished
        requests. Returns the number of active slots."""
        active_mask = np.asarray(
            [r is not None and not r.done for r in self.slot_req])
        self.registry.gauge("serving.slots.active").set(
            int(active_mask.sum()))
        if not active_mask.any():
            return 0
        t0 = time.perf_counter()
        last_tok = np.asarray(
            [(r.out[-1] if r is not None and r.out else 0)
             for r in self.slot_req], np.int64)
        dev = self.device
        logits, self.cache = self.decode_fn(
            self.cache, torch.from_numpy(last_tok).to(dev),
            torch.from_numpy(self.pos.astype(np.int64)).to(dev),
            torch.from_numpy(active_mask).to(dev))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # syncs the step
        self.registry.histogram("serving.decode.latency").record(
            time.perf_counter() - t0)
        self.steps += 1
        for s, r in enumerate(self.slot_req):
            if r is None or not active_mask[s]:
                continue
            r.out.append(int(nxt[s]))
            self.pos[s] += 1
            self.tokens_out += 1
            if (len(r.out) >= r.max_new
                    or self.pos[s] >= self.max_len - 1):
                r.done = True
                self._commit_state(r.rid, s, len(r.out), 1)
                self.slot_req[s] = None  # slot freed (cyclic reuse)
                self.registry.counter("serving.requests.completed").inc()
        self.registry.counter("serving.tokens.out").inc(
            int(active_mask.sum()))
        return int(active_mask.sum())

    def step(self) -> int:
        """One engine step: assign slots, one batched decode. Returns the
        number of active slots."""
        self.admit()
        return self.decode()

    def run(self, requests: list[Request], *, max_steps: int = 10_000
            ) -> list[Request]:
        self.submit(requests)
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return requests

    # ---- observability ----

    def metrics(self) -> dict:
        """Flat snapshot of the serving metrics."""
        return self.registry.collect()

    def stats_text(self) -> str:
        """Prometheus text exposition of the serving metrics."""
        return self.registry.to_prometheus()

    def health(self, *, decode_p95_s: float = 1.0,
               max_queue_depth: int = 1024) -> health_mod.HealthVerdict:
        """Serving-side SLO verdict: decode p95 latency against
        ``decode_p95_s`` (degraded when over) and admission-queue depth
        against ``max_queue_depth`` (degraded when over, critical past
        double). Mirrors the verdict onto a ``serving.health`` gauge."""
        status = health_mod.HEALTHY
        reasons: list[str] = []
        p95 = self.registry.histogram("serving.decode.latency").percentile(95)
        if p95 == p95 and p95 != float("inf") and p95 > decode_p95_s:
            status = health_mod.DEGRADED
            reasons.append(
                f"decode p95 {p95:.3f}s over objective {decode_p95_s}s")
        depth = len(self.queue)
        if depth > 2 * max_queue_depth:
            status = health_mod.CRITICAL
            reasons.append(
                f"queue depth {depth} past 2x limit {max_queue_depth} "
                "(admission outrunning retirement)")
        elif depth > max_queue_depth:
            if status == health_mod.HEALTHY:
                status = health_mod.DEGRADED
            reasons.append(
                f"queue depth {depth} over limit {max_queue_depth}")
        self.registry.gauge("serving.health").set(
            health_mod.STATUS_RANK[status])
        return health_mod.HealthVerdict(
            status=status, reasons=reasons,
            channels={0: {"status": status, "reasons": reasons}})
