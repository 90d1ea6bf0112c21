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
have no counterpart here.

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
        norm = lambda: layers.init_rmsnorm(cfg.d_model, dt, dev)
        tree = {"embed": layers.init_embedding(cfg.vocab_padded, cfg.d_model,
                                               dt, dev, g)}
        if not cfg.tie_embeddings:
            tree["lm_head"] = layers.init_embedding(
                cfg.vocab_padded, cfg.d_model, dt, dev, g)

        def dense_layer(moe_mlp: bool = False):
            mlp = ({"moe": moe.init_moe(cfg, dev, g)} if moe_mlp
                   else {"mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, dt,
                                                dev, g)})
            return {"attn": layers.init_attention(cfg, dev, g), **mlp,
                    "norm1": norm(), "norm2": norm()}

        def mamba_layer():
            return {"mamba": ssm.init_mamba(cfg, dev, g), "norm": norm()}

        def dec_layer():
            return {"self_attn": layers.init_attention(cfg, dev, g),
                    "cross_attn": layers.init_attention(cfg, dev, g),
                    "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, dt, dev,
                                           g),
                    "norm1": norm(), "norm2": norm(), "norm3": norm()}

        n, fam = cfg.n_layers, cfg.family
        if fam in ("dense", "moe"):
            tree["layers"] = [dense_layer(fam == "moe") for _ in range(n)]
        elif fam in ("ssm", "hybrid"):
            tree["layers"] = [mamba_layer() for _ in range(n)]
            if fam == "hybrid":  # ONE param set, reused at every site
                tree["shared_attn"] = dense_layer()
        else:  # encdec
            tree["enc_layers"] = [dense_layer()
                                  for _ in range(cfg.enc_layers)]
            tree["layers"] = [dec_layer() for _ in range(n)]
            tree["enc_final_norm"] = norm()
        tree["final_norm"] = norm()
        return self.load_params(tree)

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
