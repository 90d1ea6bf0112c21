"""Architecture config schema + registry (port of repro.configs.base).

Every assigned architecture is a ``ModelConfig`` in its own module
(``src/repro_torch/configs/<id>.py``, a copy of the JAX package's)
exposing ``CONFIG`` (the exact published shape) and ``smoke_config()``
(a reduced same-family config for CPU tests). ``get(name)`` resolves
either by registry id.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description (one per assigned arch).

    ``family`` selects the block stack:
      dense   — pre-norm GQA transformer decoder
      moe     — dense attention + (shared + routed top-k) MoE MLPs
      ssm     — attention-free Mamba2 (SSD) stack
      hybrid  — Mamba2 stack with a weight-shared attention block every
                ``attn_every`` layers (zamba2)
      encdec  — encoder/decoder with cross attention (seamless)
    ``frontend`` (audio/vision) prepends precomputed embeddings — the
    modality encoder itself is a stub per the assignment.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    vocab: int
    # Attention (ignored for family == "ssm").
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    # Dense MLP width (per-expert width for MoE).
    d_ff: int = 0
    # MoE.
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    # SSM (Mamba2 / SSD).
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    expand: int = 2
    # Hybrid: shared attention block cadence (zamba2).
    attn_every: int = 0
    # Encoder-decoder.
    enc_layers: int = 0
    # Modality frontend stub: number of prefix embedding positions.
    frontend: Optional[str] = None  # "audio" | "vision"
    n_prefix: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"  # parameter/activation dtype for the big runs

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a multiple of 256 so the vocab dim
        shards over any production model-axis width (Megatron-style vocab
        padding). Padded logits are masked to -inf in the loss/sampler."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    @property
    def is_subquadratic(self) -> bool:
        """True iff long-context decode (500k) is runnable: attention-free
        or attention applied only at a fixed cadence with bounded state."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Exact parameter count (embeddings included once if tied)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # lm head
        hd = self.head_dim

        def attn_params() -> int:
            qkv = d * (self.n_heads + 2 * self.n_kv) * hd
            if self.qkv_bias:
                qkv += (self.n_heads + 2 * self.n_kv) * hd
            o = self.n_heads * hd * d
            qknorm = 2 * hd if self.qk_norm else 0
            return qkv + o + qknorm

        def dense_mlp(width: int) -> int:
            return 3 * d * width  # SwiGLU: gate, up, down

        def mamba_params() -> int:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * ns + nh)
            conv = (di + 2 * ns) * (self.d_conv + 1)  # conv_w + conv_b
            out = di * d
            extra = nh * 3 + di  # A_log, D, dt_bias, gated-norm scale
            return in_proj + conv + out + extra

        per_layer_norms = 2 * d
        if self.family == "dense":
            n += self.n_layers * (attn_params() + dense_mlp(self.d_ff)
                                  + per_layer_norms)
        elif self.family == "moe":
            router = d * self.n_experts
            experts = (self.n_experts + self.n_shared) * dense_mlp(self.d_ff)
            n += self.n_layers * (attn_params() + router + experts
                                  + per_layer_norms)
        elif self.family == "ssm":
            n += self.n_layers * (mamba_params() + d)
        elif self.family == "hybrid":
            n += self.n_layers * (mamba_params() + d)
            n += attn_params() + dense_mlp(self.d_ff) + per_layer_norms  # shared
        elif self.family == "encdec":
            # Encoder self-attn + MLP; decoder self-attn + cross-attn + MLP.
            n += self.enc_layers * (attn_params() + dense_mlp(self.d_ff)
                                    + per_layer_norms)
            n += self.n_layers * (2 * attn_params() + dense_mlp(self.d_ff)
                                  + 3 * d)
            n += d  # enc_final_norm
        n += d  # final norm
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        all_experts = self.n_experts * 3 * d * self.d_ff
        active_experts = self.top_k * 3 * d * self.d_ff
        return self.n_params() - self.n_layers * (all_experts - active_experts)


ARCH_IDS = (
    "qwen2-7b",
    "phi3-mini-3.8b",
    "qwen3-4b",
    "qwen2.5-14b",
    "seamless-m4t-medium",
    "zamba2-1.2b",
    "mamba2-2.7b",
    "moonshot-v1-16b-a3b",
    "qwen2-moe-a2.7b",
    "llava-next-34b",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get(name: str) -> ModelConfig:
    """Resolve an architecture id to its full published config."""
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MOD)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MOD[name]}").CONFIG


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MOD)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MOD[name]}").smoke_config()
