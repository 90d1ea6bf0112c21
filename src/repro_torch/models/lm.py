"""The language model (port of repro.models.lm) for the dense, moe and ssm
families.

``LM`` is an ``nn.Module`` whose parameters mirror the JAX ``LM.init``
pytree, one entry of ``layers`` per layer (the JAX package stacks them for
``lax.scan``; here a Python loop walks them):

  LM(cfg, device=...).init(generator)       -> the module, weights drawn
  .to(device)                               -> weights moved (nn.Module)
  forward(batch)                            -> hidden states (B, S, D)
  loss(batch)                               -> (scalar CE, metrics)
  logits(batch)                             -> (B, S, V) f32
  init_cache(batch_size, seq_len)           -> DecodeCache
  prefill(batch, cache)                     -> (last-token logits, cache)
  decode_step(cache, token, pos)            -> (logits, cache)

Caches are written IN PLACE (the JAX package returns updated copies): a
full-width cache is hundreds of MB. A dense or moe layer is attention plus
an MLP (``models.moe.moe_mlp`` for moe, whose aux loss ``loss`` adds); an
ssm layer is a Mamba2 block (``models.ssm``). The hybrid and encdec
families raise ``NotImplementedError``. The JAX package's mesh-sharding
knobs (``mesh_axes``, ``shard_*``, ``remat``) have no counterpart here.

Weights are registered without a gradient, as serving wants them; the
trainer turns gradients on (``model.params.requires_grad_()``, done by
``training.train_step.init_state``) and updates the tensors in place.
``jax_leaves`` lists a params tree in the JAX pytree's flatten order, the
one order that the train step's digest, the checkpointer and ``convert``
use.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, moe, ssm


@dataclasses.dataclass(frozen=True)
class Batch:
    """Input bundle: tokens (B, S_text) int, the loss's ``labels`` (B,
    S_text) int (-1 = masked) and, for a vision frontend, precomputed
    ``prefix_embeds`` (B, S_prefix, D) placed before the tokens. The data
    pipeline fills the fields with numpy arrays; the model takes tensors."""

    tokens: torch.Tensor
    labels: torch.Tensor | None = None
    prefix_embeds: torch.Tensor | None = None


@dataclasses.dataclass
class DecodeCache:
    """Decode-time state; the fields a family does not use are None.

    k/v:            (L, B, S_max, Hkv, Dh) self-attention cache (dense, moe)
    conv/ssm_state: (L, B, K-1, d_inner+2N) in the model dtype / (L, B, H,
                    P, N) f32, the Mamba2 recurrent state (ssm)
    """

    k: torch.Tensor | None = None
    v: torch.Tensor | None = None
    conv: torch.Tensor | None = None
    ssm_state: torch.Tensor | None = None


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensors become parameters
    (no gradient until ``requires_grad_()``), dicts sub-trees and lists
    ``ModuleList``s. Read like the
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

    def tree(self) -> dict:
        """The parameters as the nested dict they were built from (the same
        tensors, ``layers`` a list)."""
        out = dict(self._parameters)
        for name, mod in self._modules.items():
            out[name] = (mod.tree() if isinstance(mod, ParamTree)
                         else [m.tree() for m in mod])
        return out


def map_tree(fn, tree):
    """``fn`` over every tensor of a params tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a params tree, in ``map_tree``'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def tree_unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves`` order over ``like``) as a tree of
    ``like``'s structure."""
    it = iter(leaves)
    return map_tree(lambda _: next(it), like)


def _jax_paths(tree: dict) -> list[tuple]:
    """The leaf paths of a params tree in the JAX pytree's flatten order:
    dict keys sorted at every level; under ``layers`` (a list of per-layer
    dicts here, one stacked dict in JAX) the paths of layer 0, each standing
    for the stacked leaf."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, (list, tuple)):
            out += [(key,) + p for p in _jax_paths(val[0])] if val else []
        elif isinstance(val, dict):
            out += [(key,) + p for p in _jax_paths(val)]
        else:
            out.append((key,))
    return out


def jax_leaves(tree: dict) -> list[list[torch.Tensor]]:
    """Each JAX leaf of a params tree, in the JAX flatten order, as the
    list of the port's tensors it stacks: one tensor for a leaf outside
    ``layers``, one a layer for a leaf under it."""
    out = []
    for path in _jax_paths(tree):
        node = tree[path[0]]
        if isinstance(node, (list, tuple)):
            group = []
            for layer in node:
                x = layer
                for key in path[1:]:
                    x = x[key]
                group.append(x)
            out.append(group)
        else:
            for key in path[1:]:
                node = node[key]
            out.append([node])
    return out


FAMILIES = ("dense", "moe", "ssm")
# The leaves kept f32 at any ``cfg.dtype`` (by name); every other leaf is
# in ``cfg.torch_dtype``.
F32_LEAVES = moe.F32_LEAVES | ssm.F32_LEAVES


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported: the hybrid "
            f"and encdec families come with a later model-families slice "
            f"(ROADMAP.md)")


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "auto",
                 q_chunk: int = 2048, kv_chunk: int = 2048,
                 ssd_chunk: int = 256, vocab_chunk: int = 512,
                 moe_capacity_factor: float = 1.25,
                 moe_dispatch: str = "sort", moe_groups: int = 1,
                 device=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        self.ssd_chunk = ssd_chunk
        self.vocab_chunk = vocab_chunk
        self.moe_cf = moe_capacity_factor
        self.moe_dispatch = moe_dispatch
        self.moe_groups = moe_groups
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

        def layer():
            if cfg.family == "ssm":
                return {"mamba": ssm.init_mamba(cfg, dev, g),
                        "norm": layers.init_rmsnorm(cfg.d_model, dt, dev)}
            mlp = ({"moe": moe.init_moe(cfg, dev, g)} if cfg.family == "moe"
                   else {"mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, dt,
                                                dev, g)})
            return {"attn": layers.init_attention(cfg, dev, g), **mlp,
                    "norm1": layers.init_rmsnorm(cfg.d_model, dt, dev),
                    "norm2": layers.init_rmsnorm(cfg.d_model, dt, dev)}

        tree["layers"] = [layer() for _ in range(cfg.n_layers)]
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

    def _moe_kwargs(self) -> dict:
        return dict(capacity_factor=self.moe_cf, dispatch=self.moe_dispatch,
                    groups=self.moe_groups)

    def _mlp(self, lp, x: torch.Tensor):
        """A dense or moe layer's MLP over x -> (y, aux or None)."""
        if "moe" in lp:
            return moe.moe_mlp(lp["moe"], self.cfg, x, **self._moe_kwargs())
        return layers.mlp(lp["mlp"], x), None

    def _blocks(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: DecodeCache | None = None, cache_len: int = 0):
        """Every layer over x -> (x, states, aux summed over the layers).
        Without ``cache``: self-attention over x, ``states`` each layer's
        K/V (dense, moe) or (conv tail, final SSM state) (ssm). With it:
        cached decode at ``cache_len``, the cache updated in place."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        states = []
        if cfg.family == "ssm":
            for i, lp in enumerate(self.params["layers"]):
                kw = ({} if cache is None else
                      dict(conv_state=cache.conv[i],
                           ssm_state=cache.ssm_state[i]))
                y, conv, st = ssm.mamba_forward(
                    lp["mamba"], cfg,
                    layers.rmsnorm(lp["norm"], x, cfg.norm_eps),
                    chunk=self.ssd_chunk, return_state=True, **kw)
                if cache is not None:
                    cache.conv[i] = conv.to(cache.conv.dtype)
                    cache.ssm_state[i] = st
                states.append((conv, st))
                x = x + y
            return x, states, aux
        s = x.shape[1]
        kw = (self._attn_kwargs(s) if cache is None else
              dict(kv_cache=None, cache_len=cache_len))
        for i, lp in enumerate(self.params["layers"]):
            if cache is not None:
                kw["kv_cache"] = (cache.k[i], cache.v[i])
            h, kv = layers.attention(
                lp["attn"], cfg, layers.rmsnorm(lp["norm1"], x, cfg.norm_eps),
                positions=positions, causal=True, **kw)
            states.append(kv)
            x = x + h
            y, a = self._mlp(lp, layers.rmsnorm(lp["norm2"], x,
                                                cfg.norm_eps))
            x = x + y
            if a is not None:
                aux = aux + a
        return x, states, aux

    def _last_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, D) hidden states -> last position's logits (B, V) f32."""
        x = layers.rmsnorm(self.params["final_norm"], x[:, -1:],
                           self.cfg.norm_eps)
        return layers.unembed(self._table(), x, transpose=True)[:, 0][
            :, : self.cfg.vocab]

    # -------------------------------------------------------------- forward

    def _forward(self, batch: Batch):
        """(hidden states after final norm (B, S, D), the MoE aux loss
        averaged over the layers: 0 for the other families)."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = self._blocks(x, positions)
        return (layers.rmsnorm(self.params["final_norm"], x,
                               self.cfg.norm_eps), aux / self.cfg.n_layers)

    def forward(self, batch: Batch) -> torch.Tensor:
        """Hidden states after final norm, (B, S, D)."""
        return self._forward(batch)[0]

    # ------------------------------------------------------------------ loss

    def loss(self, batch: Batch):
        """Chunked-vocab causal LM loss: (scalar loss f32, {"ce", "tokens"}
        and, for moe, "aux"). The loss is the CE, plus 0.01 x the aux loss
        for moe. Labels -1 are masked out; padded vocab rows are masked out of the
        log-sum-exp. The hidden states meet the vocab table ``vocab_chunk``
        positions at a time, so no (B, S, V) logits live at once in the
        forward (autograd keeps each chunk's for the backward, as the JAX
        scan's gradient does). The table is cast to f32 once for all
        chunks."""
        cfg = self.cfg
        h, aux = self._forward(batch)  # (B, S, D)
        if batch.prefix_embeds is not None:
            h = h[:, batch.prefix_embeds.shape[1]:]  # loss on text only
        labels = batch.labels
        b, s, d = h.shape
        w = self._table().float()  # (Vp, D), as layers.unembed casts it
        c = min(self.vocab_chunk, s)
        while s % c:
            c -= 1
        vpad = cfg.vocab_padded
        pad = (torch.arange(vpad, device=h.device) >= cfg.vocab
               if vpad != cfg.vocab else None)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.int32, device=h.device)
        for i in range(s // c):
            logits = h[:, i * c:(i + 1) * c].float() @ w.T  # (B, c, Vp)
            if pad is not None:  # mask padded vocab rows out of the lse
                logits = logits.masked_fill(pad, float("-inf"))
            lse = torch.logsumexp(logits, dim=-1)
            ys = labels[:, i * c:(i + 1) * c]
            mask = ys >= 0
            ll = torch.gather(logits, -1,
                              ys.clamp(min=0).long()[..., None])[..., 0]
            tot = tot + torch.where(mask, lse - ll, 0.0).sum()
            cnt = cnt + mask.sum(dtype=torch.int32)
        ce = tot / torch.clamp(cnt, min=1)
        metrics = {"ce": ce, "tokens": cnt}
        if cfg.family == "moe":
            metrics["aux"] = aux
            return ce + 0.01 * aux, metrics
        return ce, metrics

    def logits(self, batch: Batch) -> torch.Tensor:
        """Full logits (B, S, V) f32 -- small models / tests only."""
        h = self.forward(batch)
        return layers.unembed(self._table(), h, transpose=True)[
            ..., : self.cfg.vocab]

    # ----------------------------------------------------------------- cache

    def init_cache(self, batch_size: int, seq_len: int) -> DecodeCache:
        """Zeros: K/V of ``seq_len`` positions (dense, moe), or the conv
        tails and SSM states (ssm, whatever ``seq_len``)."""
        cfg = self.cfg
        z = lambda shape, dt=cfg.torch_dtype: torch.zeros(
            shape, dtype=dt, device=self.device)
        l = cfg.n_layers
        if cfg.family == "ssm":
            return DecodeCache(
                conv=z((l, batch_size, cfg.d_conv - 1,
                        cfg.d_inner + 2 * cfg.ssm_state)),
                ssm_state=z((l, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state), torch.float32))
        shape = (l, batch_size, seq_len, cfg.n_kv, cfg.head_dim)
        return DecodeCache(k=z(shape), v=z(shape))

    # ------------------------------------------------------ prefill / decode

    def prefill(self, batch: Batch, cache: DecodeCache):
        """Process the prompt and fill ``cache`` (K/V positions past the
        prompt are zeroed, as the JAX package pads; the SSM state and conv
        tails, cast to the cache's dtype, replace the old ones); returns
        (last-token logits (B, V) f32, cache), the cache positioned at the
        prompt length."""
        x = self._embed_inputs(batch)
        s = x.shape[1]
        x, states, _ = self._blocks(x, torch.arange(s, device=x.device))
        if self.cfg.family == "ssm":
            for i, (conv, st) in enumerate(states):
                cache.conv[i] = conv.to(cache.conv.dtype)
                cache.ssm_state[i] = st
            return self._last_logits(x), cache
        for i, (key, val) in enumerate(states):
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
        x, _, _ = self._blocks(x, positions, cache=cache, cache_len=pos)
        return self._last_logits(x), cache
