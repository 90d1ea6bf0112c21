"""qwen2.5-14b — dense GQA decoder, QKV bias. [hf:Qwen/Qwen2.5; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_head=128,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        qkv_bias=True,
        dtype="float32",
    )
