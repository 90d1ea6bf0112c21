"""phi3-mini-3.8b — dense decoder, RoPE SwiGLU, MHA-style GQA (kv=32).
[arXiv:2404.14219; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_head=96,
    d_ff=8192,
    vocab=32064,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        dtype="float32",
    )
