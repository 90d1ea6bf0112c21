"""qwen2-moe-a2.7b — MoE, 60 routed experts top-4 + 4 shared.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_head=128,
    d_ff=1408,  # per-expert width
    vocab=151936,
    n_experts=60,
    top_k=4,
    n_shared=4,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_head=16,
        d_ff=32,
        vocab=256,
        n_experts=6,
        top_k=2,
        n_shared=2,
        dtype="float32",
    )
