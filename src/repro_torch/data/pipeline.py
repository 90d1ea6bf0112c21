"""Deterministic, ID-ordered data pipeline (port of repro.data.pipeline, a
numpy copy; nothing here touches torch but the ``Batch`` it returns).

Every batch is a pure function of (step, dp_rank): no iterator state, no
files. Document IDs come from the step; token payloads are generated from
the ID at consumption time, so a restore from step N resumes the stream
bit-exactly and an elastic rescale re-partitions IDs, not buffers.

Task: affine-recurrence documents, token[t+1] = (m * token[t] + a) mod V
with per-document (m, a): in-context learnable, so a short run shows a
falling loss.

The fields of the returned :class:`~repro_torch.models.lm.Batch` are numpy
arrays; ``launch.train.device_batch`` moves them to a device. A vision
config gets stub ``prefix_embeds``, an encoder-decoder one (``enc_frac``)
stub encoder frames ``enc_embeds``, each from its own seed off the batch's
first document ID.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.lm import Batch

_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    dp_shards: int = 1
    seed: int = 0
    n_prefix: int = 0  # vision stub positions
    d_model: int = 0  # for stub embeddings
    enc_frac: int = 0  # encdec: encoder length = seq_len // enc_frac


def doc_ids_for_step(cfg: DataConfig, step: int) -> np.ndarray:
    """Global batch of document IDs for a step (metadata plane only)."""
    base = np.uint64(step) * np.uint64(cfg.global_batch)
    ids = base + np.arange(cfg.global_batch, dtype=np.uint64)
    return _mix64(ids ^ (np.uint64(cfg.seed) * _GOLD))


def tokens_for_ids(cfg: DataConfig, ids: np.ndarray) -> np.ndarray:
    """(B,) ids -> (B, seq_len+1) tokens via the affine recurrence."""
    b = ids.shape[0]
    v = cfg.vocab
    # Derive (m, a, x0) per doc; m odd so the map is a permutation mod 2^k.
    m = (_mix64(ids) % np.uint64(max(v // 4, 2))).astype(np.int64) * 2 + 1
    a = (_mix64(ids ^ _GOLD) % np.uint64(v)).astype(np.int64)
    x0 = (_mix64(ids + np.uint64(7)) % np.uint64(v)).astype(np.int64)
    toks = np.empty((b, cfg.seq_len + 1), np.int64)
    toks[:, 0] = x0
    for t in range(cfg.seq_len):
        toks[:, t + 1] = (toks[:, t] * m + a) % v
    return toks


def global_batch_for_step(cfg: DataConfig, step: int, dp_rank: int = 0
                          ) -> Batch:
    """The dp_rank's shard of the step's global batch (numpy fields)."""
    ids = doc_ids_for_step(cfg, step)
    per = cfg.global_batch // cfg.dp_shards
    ids = ids[dp_rank * per:(dp_rank + 1) * per]
    toks = tokens_for_ids(cfg, ids)
    inputs = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)

    prefix = enc = None
    if cfg.n_prefix and cfg.d_model:
        rng = np.random.default_rng(int(ids[0]) & 0x7FFFFFFF)
        prefix = rng.standard_normal(
            (per, cfg.n_prefix, cfg.d_model), dtype=np.float32
        )
        inputs = inputs[:, : cfg.seq_len - cfg.n_prefix]
        labels = labels[:, : cfg.seq_len - cfg.n_prefix]
    if cfg.enc_frac and cfg.d_model:
        rng = np.random.default_rng((int(ids[0]) >> 1) & 0x7FFFFFFF)
        enc = rng.standard_normal(
            (per, cfg.seq_len // cfg.enc_frac, cfg.d_model),
            dtype=np.float32)
    return Batch(tokens=inputs, labels=labels, prefix_embeds=prefix,
                 enc_embeds=enc)
