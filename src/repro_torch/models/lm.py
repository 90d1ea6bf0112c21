"""The language model (port of repro.models.lm) for the five families:
dense, moe, ssm, hybrid and encdec.

``LM`` is an ``nn.Module`` whose parameters mirror the JAX ``LM.init``
pytree, one entry of ``layers`` per layer (the JAX package stacks them for
``lax.scan``; here a Python loop walks them):

  LM(cfg, device=...).init(generator)       -> the module, weights drawn
  .to(device)                               -> weights moved (nn.Module)
  forward(batch)                            -> hidden states (B, S, D)
  loss(batch)                               -> (scalar CE, metrics)
  logits(batch)                             -> (B, S, V) f32
  init_cache(batch_size, seq_len, enc_len)  -> DecodeCache
  prefill(batch, cache)                     -> (last-token logits, cache)
  decode_step(cache, token, pos)            -> (logits, cache)

Caches are written IN PLACE (the JAX package returns updated copies): a
full-width cache is hundreds of MB. A dense or moe layer is attention plus
an MLP (``models.moe.moe_mlp`` for moe, whose aux loss ``loss`` adds); an
ssm layer is a Mamba2 block (``models.ssm``). A hybrid model (zamba2) runs
ONE weight-shared dense block (``shared_attn``) before each group of
``attn_every`` Mamba2 layers, each site with its own K/V cache. An encdec
model (seamless) encodes ``Batch.enc_embeds`` with non-causal dense layers
(``enc_layers``, ``enc_final_norm``) and decodes with self-attention,
cross-attention over the encoder's output and an MLP a layer.
The reference's encdec paths differ on purpose: ``forward`` (so ``logits``
and ``loss``) runs cross-attention through ``layers.attention(memory=)``,
with biases and qk_norm; ``prefill`` and ``decode_step`` project the cross
Q/K/V with bare ``@ wq/wk/wv``. The port copies each path as it is. The
JAX package's mesh-sharding knobs (``mesh_axes``, ``shard_*``, ``remat``)
have no counterpart here; :class:`MeshLM` serves the dense and moe
families over a (data, model) mesh in the layout of the reference's
dry-run (``launch.sharding``).

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
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import sharding
from repro_torch.models import layers, moe, ssm


@dataclasses.dataclass(frozen=True)
class Batch:
    """Input bundle: tokens (B, S_text) int, the loss's ``labels`` (B,
    S_text) int (-1 = masked), for a vision frontend precomputed
    ``prefix_embeds`` (B, S_prefix, D) placed before the tokens, and for
    the encdec family the encoder's input ``enc_embeds`` (B, S_enc, D),
    precomputed frame embeddings (the audio frontend is a stub). The data
    pipeline fills the fields with numpy arrays; the model takes tensors."""

    tokens: torch.Tensor
    labels: torch.Tensor | None = None
    prefix_embeds: torch.Tensor | None = None
    enc_embeds: torch.Tensor | None = None


@dataclasses.dataclass
class DecodeCache:
    """Decode-time state; the fields a family does not use are None.

    k/v:            (L, B, S_max, Hkv, Dh) self-attention cache (dense,
                    moe, encdec)
    cross_k/v:      (L, B, S_enc, Hkv, Dh) encdec cross-attention K/V
    conv/ssm_state: (L, B, K-1, d_inner+2N) in the model dtype / (L, B, H,
                    P, N) f32, the Mamba2 recurrent state (ssm, hybrid)
    hyb_k/v:        (sites, B, S_max, Hkv, Dh) the hybrid shared block's
                    K/V, one cache a site
    """

    k: torch.Tensor | None = None
    v: torch.Tensor | None = None
    cross_k: torch.Tensor | None = None
    cross_v: torch.Tensor | None = None
    conv: torch.Tensor | None = None
    ssm_state: torch.Tensor | None = None
    hyb_k: torch.Tensor | None = None
    hyb_v: torch.Tensor | None = None


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
    dict keys sorted at every level; under ``layers`` and ``enc_layers``
    (lists of per-layer dicts here, one stacked dict each in JAX) the paths
    of layer 0, each standing for the stacked leaf. A dict that is not a
    list (hybrid's ``shared_attn``) is a plain subtree."""
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
    the layer lists, one a layer for a leaf under one."""
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


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
# The leaves kept f32 at any ``cfg.dtype`` (by name); every other leaf is
# in ``cfg.torch_dtype``.
F32_LEAVES = moe.F32_LEAVES | ssm.F32_LEAVES


def attention_calls(cfg: ModelConfig) -> int:
    """Attention calls (so K5 forward launches on the card, and backward
    ones in a training step) of one pass over a batch (``loss``,
    ``prefill``): one an attention layer of dense and moe; hybrid's shared
    block once a group of ``attn_every`` layers; encdec's encoder layer
    once and its decoder layer twice (self- and cross-attention); none for
    ssm."""
    _check_family(cfg)
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.attn_every)
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "encdec": 2 * cfg.n_layers + cfg.enc_layers}[cfg.family]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")


def init_tree(cfg: ModelConfig, dev, g: torch.Generator,
              put=lambda path, sub: sub) -> dict:
    """Every weight of ``cfg`` drawn with the JAX package's distributions
    from ``g`` on ``dev``, as the params tree. Each top-level entry and each
    layer's dict passes through ``put(path, subtree)`` as soon as it is
    drawn (``MeshLM.init`` cuts it over a mesh there, so no whole model is
    ever on one device); the draws keep their order whatever ``put`` does."""
    dt = cfg.torch_dtype
    norm = lambda: layers.init_rmsnorm(cfg.d_model, dt, dev)
    tree = {"embed": put(("embed",), layers.init_embedding(
        cfg.vocab_padded, cfg.d_model, dt, dev, g))}
    if not cfg.tie_embeddings:
        tree["lm_head"] = put(("lm_head",), layers.init_embedding(
            cfg.vocab_padded, cfg.d_model, dt, dev, g))

    def dense_layer(moe_mlp: bool = False):
        mlp = ({"moe": moe.init_moe(cfg, dev, g)} if moe_mlp
               else {"mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, dt, dev,
                                            g)})
        return {"attn": layers.init_attention(cfg, dev, g), **mlp,
                "norm1": norm(), "norm2": norm()}

    def mamba_layer():
        return {"mamba": ssm.init_mamba(cfg, dev, g), "norm": norm()}

    def dec_layer():
        return {"self_attn": layers.init_attention(cfg, dev, g),
                "cross_attn": layers.init_attention(cfg, dev, g),
                "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, dt, dev, g),
                "norm1": norm(), "norm2": norm(), "norm3": norm()}

    def stack(name, make, n):
        return [put((name, i), make()) for i in range(n)]

    n, fam = cfg.n_layers, cfg.family
    if fam in ("dense", "moe"):
        tree["layers"] = stack("layers", lambda: dense_layer(fam == "moe"), n)
    elif fam in ("ssm", "hybrid"):
        tree["layers"] = stack("layers", mamba_layer, n)
        if fam == "hybrid":  # ONE param set, reused at every site
            tree["shared_attn"] = put(("shared_attn",), dense_layer())
    else:  # encdec
        tree["enc_layers"] = stack("enc_layers", dense_layer, cfg.enc_layers)
        tree["layers"] = stack("layers", dec_layer, n)
        tree["enc_final_norm"] = put(("enc_final_norm",), norm())
    tree["final_norm"] = put(("final_norm",), norm())
    return tree


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
        return self.load_params(init_tree(self.cfg, self.device, generator))

    def load_params(self, tree: dict) -> "LM":
        """Take ``tree`` (the JAX pytree's structure, ``layers`` and
        ``enc_layers`` lists of per-layer dicts) as this module's
        parameters; returns the module."""
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

    def _norm(self, lp, name: str, x: torch.Tensor) -> torch.Tensor:
        return layers.rmsnorm(lp[name], x, self.cfg.norm_eps)

    def _dense_layer(self, lp, x: torch.Tensor, positions, *, causal=True,
                     cache=None, i: int = 0, cache_len: int = 0):
        """Attention + MLP (dense or moe) -> (x, this call's K/V, aux or
        None). Over the whole of x without ``cache``; with it (a (k, v)
        pair of stacked caches), cached decode at ``cache_len`` into
        ``cache[0][i]``, ``cache[1][i]``."""
        kw = (self._attn_kwargs(x.shape[1]) if cache is None else
              dict(kv_cache=(cache[0][i], cache[1][i]), cache_len=cache_len))
        h, kv = layers.attention(
            lp["attn"], self.cfg, self._norm(lp, "norm1", x),
            positions=positions, causal=causal, **kw)
        x = x + h
        mlp_in = self._norm(lp, "norm2", x)
        if "moe" in lp:
            y, aux = moe.moe_mlp(lp["moe"], self.cfg, mlp_in,
                                 **self._moe_kwargs())
        else:
            y, aux = layers.mlp(lp["mlp"], mlp_in), None
        return x + y, kv, aux

    def _mamba_layers(self, x: torch.Tensor, start: int, end: int,
                      cache: DecodeCache | None = None):
        """Mamba2 layers start..end-1 over x -> (x, [(conv tail, final SSM
        state)] a layer). With ``cache``: decode from its conv tails and
        states, which are updated in place."""
        cfg = self.cfg
        states = []
        for i in range(start, end):
            lp = self.params["layers"][i]
            kw = ({} if cache is None else
                  dict(conv_state=cache.conv[i], ssm_state=cache.ssm_state[i]))
            y, conv, st = ssm.mamba_forward(
                lp["mamba"], cfg, self._norm(lp, "norm", x),
                chunk=self.ssd_chunk, return_state=True, **kw)
            if cache is not None:
                cache.conv[i] = conv.to(cache.conv.dtype)
                cache.ssm_state[i] = st
            states.append((conv, st))
            x = x + y
        return x, states

    def _hybrid_groups(self) -> list[tuple[int, int]]:
        """[(start, end)] of the Mamba2 layer groups, ``attn_every`` layers
        each (the last may be shorter); the shared block runs before each."""
        n, step = self.cfg.n_layers, self.cfg.attn_every
        return [(a, min(a + step, n)) for a in range(0, n, step)]

    def _blocks(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: DecodeCache | None = None, cache_len: int = 0):
        """The decoder-only stacks over x -> (x, states, aux summed over the
        layers). Without ``cache``: over the whole of x; ``states`` holds
        each attention's K/V (``"kv"``: dense, moe, and hybrid's one a
        site) and each Mamba2 layer's (conv tail, final state) (``"ssm"``).
        With it: cached decode at ``cache_len``, the cache updated in
        place."""
        fam = self.cfg.family
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        states = {"kv": [], "ssm": []}
        if fam == "ssm":
            x, states["ssm"] = self._mamba_layers(x, 0, self.cfg.n_layers,
                                                  cache)
        elif fam == "hybrid":
            kvc = None if cache is None else (cache.hyb_k, cache.hyb_v)
            for gi, (start, end) in enumerate(self._hybrid_groups()):
                x, kv, _ = self._dense_layer(
                    self.params["shared_attn"], x, positions, cache=kvc,
                    i=gi, cache_len=cache_len)
                states["kv"].append(kv)
                x, st = self._mamba_layers(x, start, end, cache)
                states["ssm"] += st
        else:  # dense, moe
            kvc = None if cache is None else (cache.k, cache.v)
            for i, lp in enumerate(self.params["layers"]):
                x, kv, a = self._dense_layer(lp, x, positions, cache=kvc,
                                             i=i, cache_len=cache_len)
                states["kv"].append(kv)
                if a is not None:
                    aux = aux + a
        return x, states, aux

    def _encode(self, batch: Batch) -> torch.Tensor:
        """The encoder over ``batch.enc_embeds`` (cast to the model dtype):
        non-causal dense layers with rope, then ``enc_final_norm``."""
        mem = batch.enc_embeds.to(self.cfg.torch_dtype)
        pos = torch.arange(mem.shape[1], device=mem.device)
        for lp in self.params["enc_layers"]:
            mem, _, _ = self._dense_layer(lp, mem, pos, causal=False)
        return self._norm(self.params, "enc_final_norm", mem)

    def _decode_stack(self, x: torch.Tensor, positions, memory):
        """The decoder layers of ``forward``: causal self-attention,
        cross-attention through ``layers.attention(memory=)``, MLP."""
        cfg, s = self.cfg, x.shape[1]
        for lp in self.params["layers"]:
            h, _ = layers.attention(
                lp["self_attn"], cfg, self._norm(lp, "norm1", x),
                positions=positions, causal=True, **self._attn_kwargs(s))
            x = x + h
            h, _ = layers.attention(
                lp["cross_attn"], cfg, self._norm(lp, "norm2", x),
                positions=positions, memory=memory, **self._attn_kwargs(s))
            x = x + h
            x = x + layers.mlp(lp["mlp"], self._norm(lp, "norm3", x))
        return x

    def _cross(self, lp, x: torch.Tensor, ck, cv, core) -> torch.Tensor:
        """The cached cross-attention of prefill and decode, as the
        reference writes it: Q a bare ``@ wq`` (no bias, no qk_norm), then
        ``core(q, ck, cv)`` and ``@ wo``; returns x plus it."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = (self._norm(lp, "norm2", x) @ lp["cross_attn"]["wq"].to(x.dtype)
             ).reshape(b, s, cfg.n_heads, cfg.head_dim)
        h = core(q, ck, cv).reshape(b, s, cfg.n_heads * cfg.head_dim)
        return x + h @ lp["cross_attn"]["wo"].to(x.dtype)

    def _last_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, D) hidden states -> last position's logits (B, V) f32."""
        x = self._norm(self.params, "final_norm", x[:, -1:])
        return layers.unembed(self._table(), x, transpose=True)[:, 0][
            :, : self.cfg.vocab]

    # -------------------------------------------------------------- forward

    def _forward(self, batch: Batch):
        """(hidden states after final norm (B, S, D), the MoE aux loss
        averaged over the layers: 0 for the other families)."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        if self.cfg.family == "encdec":
            x = self._decode_stack(x, positions, self._encode(batch))
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            x, _, aux = self._blocks(x, positions)
        return (self._norm(self.params, "final_norm", x),
                aux / self.cfg.n_layers)

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

    def init_cache(self, batch_size: int, seq_len: int,
                   enc_len: int = 0) -> DecodeCache:
        """Zeros: K/V of ``seq_len`` positions (dense, moe, encdec; hybrid
        one a site), the conv tails and SSM states (ssm, hybrid), and the
        cross K/V of ``enc_len`` frames (encdec; ``prefill`` replaces
        them with the encoder's, whatever their length)."""
        cfg = self.cfg
        z = lambda shape, dt=cfg.torch_dtype: torch.zeros(
            shape, dtype=dt, device=self.device)
        l, fam = cfg.n_layers, cfg.family
        kv = lambda n, s: (n, batch_size, s, cfg.n_kv, cfg.head_dim)
        if fam in ("dense", "moe"):
            return DecodeCache(k=z(kv(l, seq_len)), v=z(kv(l, seq_len)))
        if fam == "encdec":
            return DecodeCache(k=z(kv(l, seq_len)), v=z(kv(l, seq_len)),
                               cross_k=z(kv(l, enc_len)),
                               cross_v=z(kv(l, enc_len)))
        cache = DecodeCache(
            conv=z((l, batch_size, cfg.d_conv - 1,
                    cfg.d_inner + 2 * cfg.ssm_state)),
            ssm_state=z((l, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), torch.float32))
        if fam == "hybrid":
            shape = kv(len(self._hybrid_groups()), seq_len)
            cache.hyb_k, cache.hyb_v = z(shape), z(shape)
        return cache

    # ------------------------------------------------------ prefill / decode

    @staticmethod
    def _fill_kv(ck, cv, kvs, s: int) -> None:
        """Each K/V pair of ``kvs`` into positions 0..s-1 of ``ck[i]``,
        ``cv[i]``; the positions past s zeroed, as the JAX package pads."""
        for i, (key, val) in enumerate(kvs):
            for c, new in ((ck, key), (cv, val)):
                c[i, :, :s] = new.to(c.dtype)
                c[i, :, s:] = 0

    def prefill(self, batch: Batch, cache: DecodeCache):
        """Process the prompt and fill ``cache`` (K/V positions past the
        prompt are zeroed, as the JAX package pads; SSM states and conv
        tails, cast to the cache's dtype, and encdec's cross K/V replace the
        old ones); returns (last-token logits (B, V) f32, cache), the cache
        positioned at the prompt length."""
        if self.cfg.family == "encdec":
            return self._encdec_prefill(batch, cache)
        x = self._embed_inputs(batch)
        s = x.shape[1]
        x, states, _ = self._blocks(x, torch.arange(s, device=x.device))
        for i, (conv, st) in enumerate(states["ssm"]):
            cache.conv[i] = conv.to(cache.conv.dtype)
            cache.ssm_state[i] = st
        if self.cfg.family == "hybrid":
            self._fill_kv(cache.hyb_k, cache.hyb_v, states["kv"], s)
        elif self.cfg.family in ("dense", "moe"):
            self._fill_kv(cache.k, cache.v, states["kv"], s)
        return self._last_logits(x), cache

    def _encdec_prefill(self, batch: Batch, cache: DecodeCache):
        """The reference's encdec prefill: the encoder; each layer's cross
        K/V by a bare ``memory @ wk/wv``; the decoder over ``batch.tokens``
        alone (no prefix), its cross core K5 without the causal mask on the
        card, the plain version on the CPU."""
        cfg = self.cfg
        memory = self._encode(batch)
        b = memory.shape[0]
        shape = (b, -1, cfg.n_kv, cfg.head_dim)
        cks = [(memory @ lp["cross_attn"]["wk"].to(memory.dtype)
                ).reshape(shape) for lp in self.params["layers"]]
        cvs = [(memory @ lp["cross_attn"]["wv"].to(memory.dtype)
                ).reshape(shape) for lp in self.params["layers"]]
        x = layers.embed(self.params["embed"], batch.tokens)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        core = lambda q, k, v: fa_ops.flash_attention(q, k, v, causal=False)
        kvs = []
        for lp, ck, cv in zip(self.params["layers"], cks, cvs):
            h, kv = layers.attention(
                lp["self_attn"], cfg, self._norm(lp, "norm1", x),
                positions=positions, causal=True, **self._attn_kwargs(s))
            kvs.append(kv)
            x = self._cross(lp, x + h, ck, cv, core)
            x = x + layers.mlp(lp["mlp"], self._norm(lp, "norm3", x))
        self._fill_kv(cache.k, cache.v, kvs, s)
        cache.cross_k = torch.stack(cks).to(cache.cross_k.dtype)
        cache.cross_v = torch.stack(cvs).to(cache.cross_v.dtype)
        return self._last_logits(x), cache

    def decode_step(self, cache: DecodeCache, token: torch.Tensor, pos: int):
        """One token for the whole batch at position ``pos``: token (B,)
        int. Returns (logits (B, V) f32, cache updated in place)."""
        pos = int(pos)
        x = layers.embed(self.params["embed"], token)[:, None, :]
        positions = torch.tensor([pos], device=x.device)
        if self.cfg.family != "encdec":
            x, _, _ = self._blocks(x, positions, cache=cache, cache_len=pos)
            return self._last_logits(x), cache
        core = lambda q, k, v: layers.attn_grouped(q, k, v, causal=False)
        for i, lp in enumerate(self.params["layers"]):
            h, _ = layers.attention(
                lp["self_attn"], self.cfg, self._norm(lp, "norm1", x),
                positions=positions, kv_cache=(cache.k[i], cache.v[i]),
                cache_len=pos)
            x = self._cross(lp, x + h, cache.cross_k[i], cache.cross_v[i],
                            core)
            x = x + layers.mlp(lp["mlp"], self._norm(lp, "norm3", x))
        return self._last_logits(x), cache


# ---------------------------------------------------------------------------
# The LM over a (data, model) mesh
# ---------------------------------------------------------------------------

MESH_FAMILIES = ("dense", "moe")


@dataclasses.dataclass
class MeshCache:
    """A decode cache in ``launch.sharding.cache_pspecs``'s layout:
    ``parts[d][m]`` is position (d, m)'s :class:`DecodeCache`, its k/v (L,
    B / data, S / model, Hkv, Dh) on its device, written in place;
    ``specs`` the layout (a DecodeCache of specs)."""

    parts: list
    specs: DecodeCache
    mesh: object
    batch_size: int
    seq_len: int

    def gather(self, device) -> DecodeCache:
        """The whole cache on ``device`` (tests and checks)."""
        names = ("k", "v")
        got = sharding.gather(
            [[{f: getattr(c, f) for f in names} for c in row]
             for row in self.parts],
            {f: getattr(self.specs, f) for f in names}, self.mesh, device)
        return DecodeCache(**got)


class MeshLM:
    """The dense and moe LMs over a (data, model) :class:`~repro_torch.
    launch.mesh.Mesh`, in the layout of the reference's dry-run
    (``launch.sharding``): ``params[d][m]`` is position (d, m)'s params
    tree, each leaf its block (``param_specs``) on its device, the same
    for every data row. One controller runs every rank's share, layer by
    layer, and the ranks meet through the mesh's counted collectives
    (``models.layers``' mesh sub-layers, ``moe.moe_mlp_mesh``): vocab rows
    over ``model`` (the embedding ``psum``ed, the logits all-gathered),
    attention heads and MLP hidden Megatron-split (``psum`` after wo and
    w_down), experts over ``model`` or split inside, the batch over
    ``data``, the decode cache's sequence over ``model``.

      MeshLM(cfg, mesh).init(generator)   -> LM(cfg).init(generator)'s
                                             weights, cut layer by layer
      MeshLM.from_lm(lm, mesh)            -> a one-device LM's weights, cut
      init_cache(batch_size, seq_len)     -> MeshCache
      prefill(batch, cache)               -> (last-token logits (B, V) f32
                                              on mesh.first, cache)
      decode_step(cache, token, pos)      -> (logits, cache)

    ``prefill`` and ``decode_step`` take the one-device arguments (tensors
    on any device; each data row's share is copied to its ranks) and keep
    :class:`LM`'s semantics. Only the dense and moe families; a batch that
    does not divide over ``data`` (the reference then lays the cache's
    sequence over every axis) and a cache length that does not divide over
    ``model`` raise. Nothing reads a device value on the host.
    """

    def __init__(self, cfg: ModelConfig, mesh, *, attn_impl: str = "auto",
                 q_chunk: int = 2048, kv_chunk: int = 2048,
                 moe_capacity_factor: float = 1.25,
                 moe_dispatch: str = "sort"):
        if cfg.family not in MESH_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family over a mesh (its conv/"
                "SSM or cross-attention caches) is a later slice; the mesh "
                f"LM serves {MESH_FAMILIES}")
        from repro_torch.launch import specs as shapes

        self.cfg, self.mesh = cfg, mesh
        self.lm = LM(cfg, attn_impl=attn_impl, q_chunk=q_chunk,
                     kv_chunk=kv_chunk, device="meta")
        self.moe_cf, self.moe_dispatch = moe_capacity_factor, moe_dispatch
        self.specs = sharding.param_specs(shapes.param_shapes(self.lm), mesh)
        lspec = self.specs["layers"][0]
        self.heads = layers.head_plan(cfg, lspec["attn"], mesh.model_size)
        split = lambda spec, dim: spec[dim] == "model"
        self.vocab_split = split(self.specs["embed"], 0)
        self.head_split = split(self.specs[
            "embed" if cfg.tie_embeddings else "lm_head"], 0)
        if cfg.family == "moe":
            self.moe_mode = moe.moe_mesh_mode(lspec["moe"])
            self.shared_split = ("shared" in lspec["moe"] and split(
                lspec["moe"]["shared"]["w_gate"], -1))
        else:
            self.mlp_split = split(lspec["mlp"]["w_gate"], -1)
        self.params = None

    # ------------------------------------------------------------ weights

    def load(self, tree: dict) -> "MeshLM":
        """Cut a one-device params tree (``LM.params.tree()``) over the
        mesh: a copy on each position's device; returns self."""
        self.params = sharding.place(tree, self.specs, self.mesh)
        return self

    @classmethod
    def from_lm(cls, lm: LM, mesh, **kwargs) -> "MeshLM":
        kw = dict(attn_impl=lm.attn_impl, q_chunk=lm.q_chunk,
                  kv_chunk=lm.kv_chunk, moe_capacity_factor=lm.moe_cf,
                  moe_dispatch=lm.moe_dispatch, **kwargs)
        return cls(lm.cfg, mesh, **kw).load(lm.params.tree())

    def init(self, generator: torch.Generator, device=None) -> "MeshLM":
        """:meth:`LM.init`'s weights (the same draws from ``generator`` on
        ``device``, by default the mesh's first), each layer cut over the
        mesh as soon as it is drawn: at most one layer is ever whole."""
        mesh = self.mesh
        grid = [[{} for _ in row] for row in mesh.devices]

        def put(path, sub):
            spec = self.specs[path[0]]
            if len(path) > 1:
                spec = spec[path[1]]
            cut = sharding.place(sub, spec, mesh)
            for row, cut_row in zip(grid, cut):
                for tree, part in zip(row, cut_row):
                    if len(path) > 1:
                        tree.setdefault(path[0], []).append(part)
                    else:
                        tree[path[0]] = part

        init_tree(self.cfg, torch.device(device or mesh.first), generator,
                  put)
        self.params = grid
        return self

    def gather_params(self, device) -> dict:
        """The whole params tree on ``device`` (tests and checks)."""
        return sharding.gather(self.params, self.specs, self.mesh, device)

    # -------------------------------------------------------------- cache

    def _rows(self, b: int, seq_len: int) -> int:
        """The batch rows a data rank holds; raises where the reference's
        layout is another slice's or does not divide."""
        dp, mp = self.mesh.dp_size, self.mesh.model_size
        if b % dp or b < dp:
            raise NotImplementedError(
                f"batch {b} over data {dp}: the reference lays the cache's "
                "sequence over every axis (the batch-1 long-context layout), "
                "which is the ssm/hybrid long-context slice")
        if seq_len % mp:
            raise ValueError(f"cache length {seq_len} does not divide over "
                             f"model {mp}")
        return b // dp

    def init_cache(self, batch_size: int, seq_len: int,
                   enc_len: int = 0) -> MeshCache:
        """Zeros in the layout of ``cache_pspecs``: each position's k/v
        (L, B / data, S / model, Hkv, Dh)."""
        from repro_torch.launch import specs as shapes

        self._rows(batch_size, seq_len)
        specs = sharding.cache_pspecs(
            shapes.cache_shapes(self.lm, batch_size, seq_len), self.mesh)
        full = self.lm.init_cache(batch_size, seq_len, enc_len)
        parts = sharding.place(
            {"k": full.k, "v": full.v}, {"k": specs.k, "v": specs.v},
            self.mesh, put=lambda blk, path, dev: torch.zeros(
                blk.shape, dtype=blk.dtype, device=dev))
        return MeshCache([[DecodeCache(**p) for p in row] for row in parts],
                         specs, self.mesh, batch_size, seq_len)

    # ----------------------------------------------------------- internals

    def _norm(self, lp, name: str, xs: list) -> list:
        return [layers.rmsnorm(p[name], x, self.cfg.norm_eps)
                for p, x in zip(lp, xs)]

    def _layer(self, i: int, d: int) -> list:
        return [p["layers"][i] for p in self.params[d]]

    def _mlps(self, i: int, xs: list) -> list:
        """Layer i's MLP (dense or moe) with its residual, every row."""
        ins = [self._norm(self._layer(i, d), "norm2", row)
               for d, row in enumerate(xs)]
        if self.cfg.family == "moe":
            ys = moe.moe_mlp_mesh(
                [[lp["moe"] for lp in self._layer(i, d)]
                 for d in range(len(xs))], self.cfg, ins, self.moe_mode,
                self.shared_split, self.mesh, capacity_factor=self.moe_cf,
                dispatch=self.moe_dispatch)
        else:
            ys = [layers.mlp_mesh([lp["mlp"] for lp in self._layer(i, d)],
                                  ins[d], self.mlp_split, self.mesh, d)
                  for d in range(len(xs))]
        return [[x + y for x, y in zip(xr, yr)] for xr, yr in zip(xs, ys)]

    def _embed(self, tokens: torch.Tensor, b: int) -> list:
        """Each data row's tokens (its batch rows, copied to its ranks) ->
        embeddings, a row a list over its ranks."""
        out = []
        for d, row in enumerate(self.mesh.devices):
            toks = [tokens[d * b:(d + 1) * b].to(dev) for dev in row]
            out.append(layers.embed_mesh([p["embed"] for p in self.params[d]],
                                         toks, self.vocab_split, self.mesh,
                                         d))
        return out

    def _logits(self, xs: list) -> torch.Tensor:
        """Every row's last position -> logits (B, V) f32 on mesh.first."""
        head = "embed" if self.cfg.tie_embeddings else "lm_head"
        rows = []
        for d, xr in enumerate(xs):
            ps = self.params[d]
            h = self._norm(ps, "final_norm", [x[:, -1:] for x in xr])
            got = layers.logits_mesh([p[head] for p in ps], h,
                                     self.head_split, self.cfg.vocab,
                                     self.mesh, d)
            rows.append(got[0][:, 0])
        return self.mesh.collect(rows, 0, "logits_out")

    def _fill_kv(self, cache: MeshCache, i: int, d: int, kvs: list,
                 s: int) -> None:
        """Layer i's prompt K/V into row d's cache slices, positions past
        the prompt zeroed. Where every rank holds every KV head, each keeps
        its own positions; where each holds its own heads, one all-to-all
        (K and V together) turns heads into positions."""
        plan, parts = self.heads, cache.parts[d]
        sc = cache.seq_len // self.mesh.model_size
        span = lambda j: slice(min(j * sc, s), min((j + 1) * sc, s))
        if plan.kv_split and not plan.gather_kv:
            got = self.mesh.all_to_all(
                d, [[torch.stack(kv)[:, :, span(j)] for j in range(len(kvs))]
                    for kv in kvs], 3, "kv_reshard")
            kvs = [(g[0], g[1]) for g in got]
        else:
            kvs = [(k[:, span(m)], v[:, span(m)])
                   for m, (k, v) in enumerate(kvs)]
        for c, (k, v) in zip(parts, kvs):
            n = k.shape[1]
            for dst, new in ((c.k, k), (c.v, v)):
                dst[i, :, :n] = new.to(dst.dtype)
                dst[i, :, n:] = 0

    def _check(self, cache: MeshCache, b: int) -> int:
        if cache.mesh is not self.mesh or cache.batch_size != b:
            raise ValueError(f"a cache for batch {cache.batch_size} on "
                             f"{cache.mesh!r}, given batch {b} on "
                             f"{self.mesh!r}")
        return self._rows(b, cache.seq_len)

    # ------------------------------------------------------ prefill / decode

    def prefill(self, batch: Batch, cache: MeshCache):
        """The prompt over the mesh, filling ``cache``; returns (last-token
        logits (B, V) f32 on mesh.first, cache), as :meth:`LM.prefill`."""
        cfg, mesh = self.cfg, self.mesh
        b = self._check(cache, batch.tokens.shape[0])
        xs = self._embed(batch.tokens, b)
        if batch.prefix_embeds is not None:  # the vision prefix, every rank
            xs = [[torch.cat([batch.prefix_embeds[d * b:(d + 1) * b].to(
                x.device, x.dtype), x], dim=1) for x in xr]
                for d, xr in enumerate(xs)]
        s = xs[0][0].shape[1]
        if s > cache.seq_len:
            raise ValueError(f"prompt of {s} past the cache's {cache.seq_len}")
        kw = self.lm._attn_kwargs(s)
        pos = [[torch.arange(s, device=x.device) for x in xr] for xr in xs]
        for i in range(cfg.n_layers):
            for d, xr in enumerate(xs):
                lp = self._layer(i, d)
                outs, kvs = layers.attention_mesh(
                    [p["attn"] for p in lp], cfg, self._norm(lp, "norm1", xr),
                    self.heads, mesh, d, positions=pos[d], **kw)
                xs[d] = [x + o for x, o in zip(xr, outs)]
                self._fill_kv(cache, i, d, kvs, s)
            xs = self._mlps(i, xs)
        return self._logits(xs), cache

    def decode_step(self, cache: MeshCache, token: torch.Tensor, pos: int):
        """One token a sequence at position ``pos`` (a host int: the rank
        holding it is known without reading the card), token (B,) int;
        returns (logits (B, V) f32 on mesh.first, cache updated in place)."""
        cfg, mesh = self.cfg, self.mesh
        pos = int(pos)
        b = self._check(cache, token.shape[0])
        if not 0 <= pos < cache.seq_len:
            raise ValueError(f"position {pos} outside the cache's "
                             f"{cache.seq_len}")
        xs = [[x[:, None, :] for x in xr] for xr in self._embed(token, b)]
        at = [[torch.arange(pos, pos + 1, device=x.device) for x in xr]
              for xr in xs]
        for i in range(cfg.n_layers):
            for d, xr in enumerate(xs):
                lp = self._layer(i, d)
                outs = layers.attention_decode_mesh(
                    [p["attn"] for p in lp], cfg, self._norm(lp, "norm1", xr),
                    self.heads, mesh, d,
                    caches=[(c.k[i], c.v[i]) for c in cache.parts[d]],
                    pos=pos, positions=at[d])
                xs[d] = [x + o for x, o in zip(xr, outs)]
            xs = self._mlps(i, xs)
        return self._logits(xs), cache
