"""The dense language model (port of repro.models.lm, ``family="dense"``).

``LM`` is an ``nn.Module`` whose parameters mirror the JAX ``LM.init``
pytree, one entry of ``layers`` per layer (the JAX package stacks them for
``lax.scan``; here a Python loop walks them):

  LM(cfg, device=...).init(generator)       -> the module, weights drawn
  .to(device)                               -> weights moved (nn.Module)
  forward(batch)                            -> hidden states (B, S, D)
  logits(batch)                             -> (B, S, V) f32
  init_cache(batch_size, seq_len)           -> DecodeCache
  prefill(batch, cache)                     -> (last-token logits, cache)
  decode_step(cache, token, pos)            -> (logits, cache)

Caches are written IN PLACE (the JAX package returns updated copies): a
full-width cache is hundreds of MB. The other families (moe, ssm, hybrid,
encdec) raise ``NotImplementedError``; ``loss`` comes with the training
slice. The JAX package's mesh-sharding knobs (``mesh_axes``, ``shard_*``,
``remat``) have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class Batch:
    """Input bundle: tokens (B, S_text) int and, for a vision frontend,
    precomputed ``prefix_embeds`` (B, S_prefix, D) placed before them."""

    tokens: torch.Tensor
    prefix_embeds: torch.Tensor | None = None


@dataclasses.dataclass
class DecodeCache:
    """Self-attention K/V cache, each (L, B, S_max, Hkv, Dh)."""

    k: torch.Tensor
    v: torch.Tensor


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensors become parameters
    (no gradient), dicts sub-trees and lists ``ModuleList``s. Read like the
    JAX pytree: ``p["wq"]``, ``p.get("bq")``, ``p["layers"][i]``."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(x)
                                                    for x in val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported: the moe, "
            f"ssm, hybrid and encdec families come with the model-families "
            f"slice (ROADMAP.md)")


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "auto",
                 q_chunk: int = 2048, kv_chunk: int = 2048, device=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        self._device = resolve_device(device)
        self.params: ParamTree | None = None

    @property
    def device(self) -> torch.device:
        """Where the weights are (``.to(...)`` moves them), else where
        ``init`` will draw them."""
        return (self._device if self.params is None
                else self.params["embed"].device)

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> "LM":
        """Draw every weight with the JAX package's distributions from
        ``generator`` (on this model's device); returns the module."""
        cfg, dev, g = self.cfg, self.device, generator
        dt = cfg.torch_dtype
        tree = {"embed": layers.init_embedding(cfg.vocab_padded, cfg.d_model,
                                               dt, dev, g)}
        if not cfg.tie_embeddings:
            tree["lm_head"] = layers.init_embedding(
                cfg.vocab_padded, cfg.d_model, dt, dev, g)
        tree["layers"] = [{
            "attn": layers.init_attention(cfg, dev, g),
            "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, dt, dev, g),
            "norm1": layers.init_rmsnorm(cfg.d_model, dt, dev),
            "norm2": layers.init_rmsnorm(cfg.d_model, dt, dev),
        } for _ in range(cfg.n_layers)]
        tree["final_norm"] = layers.init_rmsnorm(cfg.d_model, dt, dev)
        return self.load_params(tree)

    def load_params(self, tree: dict) -> "LM":
        """Take ``tree`` (the JAX pytree's structure, ``layers`` a list of
        per-layer dicts) as this module's parameters; returns the module."""
        self.params = ParamTree(tree)
        return self

    # ----------------------------------------------------------- internals

    def _table(self) -> torch.Tensor:
        p = self.params
        return p["embed"] if self.cfg.tie_embeddings else p["lm_head"]

    def _embed_inputs(self, batch: Batch) -> torch.Tensor:
        x = layers.embed(self.params["embed"], batch.tokens)
        if batch.prefix_embeds is not None:
            x = torch.cat([batch.prefix_embeds.to(x.dtype), x], dim=1)
        return x

    def _attn_kwargs(self, seq: int) -> dict:
        impl = self.attn_impl
        if impl == "auto":
            impl = "chunked" if seq > 2 * self.q_chunk else "naive"
        return dict(impl=impl, q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)

    def _blocks(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: DecodeCache | None = None, cache_len: int = 0):
        """Every layer over x. Self-attention when ``cache`` is None
        (yields each layer's K/V), else cached decode at ``cache_len``."""
        cfg = self.cfg
        s = x.shape[1]
        kw = (self._attn_kwargs(s) if cache is None else
              dict(kv_cache=None, cache_len=cache_len))
        kvs = []
        for i, lp in enumerate(self.params["layers"]):
            if cache is not None:
                kw["kv_cache"] = (cache.k[i], cache.v[i])
            h, kv = layers.attention(
                lp["attn"], cfg, layers.rmsnorm(lp["norm1"], x, cfg.norm_eps),
                positions=positions, causal=True, **kw)
            kvs.append(kv)
            x = x + h
            x = x + layers.mlp(lp["mlp"], layers.rmsnorm(lp["norm2"], x,
                                                         cfg.norm_eps))
        return x, kvs

    def _last_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, D) hidden states -> last position's logits (B, V) f32."""
        x = layers.rmsnorm(self.params["final_norm"], x[:, -1:],
                           self.cfg.norm_eps)
        return layers.unembed(self._table(), x, transpose=True)[:, 0][
            :, : self.cfg.vocab]

    # -------------------------------------------------------------- forward

    def forward(self, batch: Batch) -> torch.Tensor:
        """Hidden states after final norm, (B, S, D)."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._blocks(x, positions)
        return layers.rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps)

    def logits(self, batch: Batch) -> torch.Tensor:
        """Full logits (B, S, V) f32 -- small models / tests only."""
        h = self.forward(batch)
        return layers.unembed(self._table(), h, transpose=True)[
            ..., : self.cfg.vocab]

    # ----------------------------------------------------------------- cache

    def init_cache(self, batch_size: int, seq_len: int) -> DecodeCache:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, seq_len, cfg.n_kv, cfg.head_dim)
        z = lambda: torch.zeros(shape, dtype=cfg.torch_dtype,
                                device=self.device)
        return DecodeCache(k=z(), v=z())

    # ------------------------------------------------------ prefill / decode

    def prefill(self, batch: Batch, cache: DecodeCache):
        """Process the prompt and fill ``cache`` (positions past the prompt
        are zeroed, as the JAX package pads); returns (last-token logits
        (B, V) f32, cache), the cache positioned at the prompt length."""
        x = self._embed_inputs(batch)
        s = x.shape[1]
        x, kvs = self._blocks(x, torch.arange(s, device=x.device))
        for i, (key, val) in enumerate(kvs):
            for c, new in ((cache.k, key), (cache.v, val)):
                c[i, :, :s] = new.to(c.dtype)
                c[i, :, s:] = 0
        return self._last_logits(x), cache

    def decode_step(self, cache: DecodeCache, token: torch.Tensor, pos: int):
        """One token for the whole batch at position ``pos``: token (B,)
        int. Returns (logits (B, V) f32, cache updated in place)."""
        pos = int(pos)
        x = layers.embed(self.params["embed"], token)[:, None, :]
        positions = torch.tensor([pos], device=x.device)
        x, _ = self._blocks(x, positions, cache=cache, cache_len=pos)
        return self._last_logits(x), cache
